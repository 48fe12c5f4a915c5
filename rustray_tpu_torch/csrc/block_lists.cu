// Block lists: the interval test that builds the block walk's visit lists,
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  In the JAX package this prologue is XLA
// (rustray_tpu/ops/block_trace.py::_block_lists), which fuses it.  The
// port's torch version (ops/block_trace.py::_list_keys_twin, the twin) runs
// it as about 520 eager elementwise ops per call, each writing an (NB, C)
// f32 temporary: 4-5 KB of device memory traffic per (block, cluster) pair
// where the arithmetic needs none.  This kernel keeps the whole test in
// registers and writes only what the row sort reads.
//
// Contract, identical to the twin with S = 4 sub-blocks of BN / 4 rays:
//   o, d (NB*BN, 3) f32 dead-masked rays; alive (NB*BN,) u8; tmax (NB*BN,)
//   f32; w_lo, w_hi (C, 3) f32 world cluster boxes; cl_ok (C,) u8.
//   Per block and sub-block the alive-masked origin and direction bounds
//   (dead lanes read +-3e37), whether any lane is alive, the largest live
//   t_max, and per axis ax_ok = dlo > 1e-12 or dhi < -1e-12 with the
//   reciprocals ilo <= ihi of the direction bounds (1 where not ax_ok).
//   Per (block, cluster) pair and sub-block s, per axis the products of
//   (lo - ohi, lo - olo, hi - ohi, hi - olo) with ilo and ihi bound the
//   per-ray near plane from below and the far plane from above (-3e37 and
//   3e37 on an axis that is not ax_ok); entry = max(0, max of the nears),
//   exit = min of the fars; s may enter c if exit >= entry, entry <= its
//   t_max, c is ok and s is alive.
//   Out: key (NB, C) f32, the least entry over the sub-blocks that may
//   enter c, 3e38 where none may; cid (NB, C) i32 = c | qbits << 16, bit s
//   of qbits set where s may enter c; count (NB,) i32, the pairs with a set
//   bit.  The caller sorts each row of key (stable) and gathers cid.
//
// Design: one CTA of 256 threads per block.  Warps 0-3 reduce one
// sub-block each (lanes stride its rays, then a shuffle butterfly), 12
// threads take the reciprocals, and everything a pair needs from the block
// (48 bounds and reciprocals, 12 axis flags, 4 t_max) sits in shared
// memory.  The threads then stride over the clusters: each reads the
// cluster's box (24 bytes, L1/L2-resident: every CTA reads the same
// 62 KB), runs the four sub-blocks' chain in registers and writes key and
// cid coalesced.  A sub-block with no live lane, a cluster that is not ok
// and an axis that is not ax_ok take branches that are uniform over the
// CTA (or, for cl_ok, give the twin's result without the arithmetic); an
// all-dead block writes 3e38 and c with no arithmetic at all.  count is
// summed per CTA: an integer, so the same in any order.
//
// Bound: FP32 work.  Per live sub-block and ok cluster, 26 operations per
// ax_ok axis (4 differences, 8 products, 12 min/max, near and far) and 8
// to fold the axes, clamp, compare and fold the sub-block; at most 344 a
// pair (13.3 us per 1,000 live blocks of the bench scene's 2,593 clusters
// at 67 TFLOP/s) against 8 bytes of key and cid a pair (6.2 us per 1,000
// blocks at 3.35 TB/s), so a block with dead sub-blocks can be bound by
// its bytes.  chip_smoke.py phase 17 times it beside both.
//
// Floating point: built with -fmad=false and without --use_fast_math, so
// every difference, product and the division 1 / d round as IEEE f32 in the
// twin's operation order; the elementwise min/max are the NaN-propagating
// PTX forms (torch.minimum, torch.maximum and torch.clamp on the card run
// the same min/max instruction), and the reductions over a sub-block's rays
// use the compare-and-select of torch's amin/amax.  One difference is left
// open: a reduction over rays whose origins differ only in the sign of a
// zero returns the zero its order meets last, which torch's order may not
// match; that changes a result only where a cluster bound is itself -0.0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSub = 4;               // sub-blocks (quads) per block
constexpr float kInf = 3.0e38f;
constexpr float kBig = 3.0e37f;
constexpr float kTiny = 1e-12f;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// torch's amin / amax step: the NaN, else the strictly smaller (larger)
__device__ __forceinline__ float red_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

__device__ __forceinline__ float red_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

struct Block {
  float oh[kSub][3], ol[kSub][3], il[kSub][3], ih[kSub][3];
  float tmax[kSub];
  int ax_ok[kSub][3];
  int live[kSub];
  int count;
};

// The bounds of one axis for sub-block values (oh, ol, il, ih) against the
// box [lo, hi]: near, the least per-ray near plane, and far, the greatest
// per-ray far plane, in the twin's operation order.
__device__ __forceinline__ void axis_bounds(float lo, float hi, float oh,
                                            float ol, float il, float ih,
                                            float& near, float& far) {
  const float a1 = lo - oh, b1 = lo - ol;
  const float a2 = hi - oh, b2 = hi - ol;
  const float lo_lb = min_nan(min_nan(a1 * il, a1 * ih),
                              min_nan(b1 * il, b1 * ih));
  const float lo_ub = max_nan(max_nan(a1 * il, a1 * ih),
                              max_nan(b1 * il, b1 * ih));
  const float hi_lb = min_nan(min_nan(a2 * il, a2 * ih),
                              min_nan(b2 * il, b2 * ih));
  const float hi_ub = max_nan(max_nan(a2 * il, a2 * ih),
                              max_nan(b2 * il, b2 * ih));
  near = min_nan(lo_lb, hi_lb);
  far = max_nan(lo_ub, hi_ub);
}

__global__ void __launch_bounds__(kThreads) block_lists_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const unsigned char* __restrict__ alive, const float* __restrict__ tmax,
    const float* __restrict__ w_lo, const float* __restrict__ w_hi,
    const unsigned char* __restrict__ cl_ok, float* __restrict__ key,
    int* __restrict__ cid, int* __restrict__ count, int bn, int C) {
  __shared__ Block blk;
  __shared__ float dlo[kSub][3], dhi[kSub][3];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = bn / kSub;

  // 1. the sub-blocks' alive-masked bounds, one warp each
  if (warp < kSub) {
    float olo[3], ohi[3], lo_d[3], hi_d[3];
    for (int a = 0; a < 3; ++a) {
      olo[a] = lo_d[a] = __int_as_float(0x7f800000);    // +inf
      ohi[a] = hi_d[a] = __int_as_float(0xff800000);    // -inf
    }
    float tm = __int_as_float(0xff800000);
    bool any = false;
    const size_t base = static_cast<size_t>(b) * bn + warp * sub;
    for (int r = lane; r < sub; r += 32) {
      const size_t i = base + r;
      const bool a_ok = alive[i] != 0;
      any |= a_ok;
      for (int a = 0; a < 3; ++a) {
        const float ov = __ldg(o + 3 * i + a), dv = __ldg(d + 3 * i + a);
        olo[a] = red_min(olo[a], a_ok ? ov : kBig);
        ohi[a] = red_max(ohi[a], a_ok ? ov : -kBig);
        lo_d[a] = red_min(lo_d[a], a_ok ? dv : kBig);
        hi_d[a] = red_max(hi_d[a], a_ok ? dv : -kBig);
      }
      tm = red_max(tm, a_ok ? __ldg(tmax + i) : -kBig);
    }
    for (int off = 16; off > 0; off >>= 1) {
      for (int a = 0; a < 3; ++a) {
        olo[a] = red_min(olo[a], __shfl_xor_sync(kAll, olo[a], off));
        ohi[a] = red_max(ohi[a], __shfl_xor_sync(kAll, ohi[a], off));
        lo_d[a] = red_min(lo_d[a], __shfl_xor_sync(kAll, lo_d[a], off));
        hi_d[a] = red_max(hi_d[a], __shfl_xor_sync(kAll, hi_d[a], off));
      }
      tm = red_max(tm, __shfl_xor_sync(kAll, tm, off));
    }
    any = __any_sync(kAll, any);
    if (lane == 0) {
      for (int a = 0; a < 3; ++a) {
        blk.ol[warp][a] = olo[a];
        blk.oh[warp][a] = ohi[a];
        dlo[warp][a] = lo_d[a];
        dhi[warp][a] = hi_d[a];
      }
      blk.tmax[warp] = tm;
      blk.live[warp] = any;
    }
  }
  if (tid == 0) blk.count = 0;
  __syncthreads();
  // 2. per sub-block and axis: ax_ok and the reciprocals
  if (tid < kSub * 3) {
    const int s = tid / 3, a = tid % 3;
    const float lo = dlo[s][a], hi = dhi[s][a];
    const bool ok = (lo > kTiny) || (hi < -kTiny);
    const float i1 = 1.0f / (ok ? lo : 1.0f);
    const float i2 = 1.0f / (ok ? hi : 1.0f);
    blk.ax_ok[s][a] = ok;
    blk.il[s][a] = min_nan(i1, i2);
    blk.ih[s][a] = max_nan(i1, i2);
  }
  __syncthreads();

  float* key_row = key + static_cast<size_t>(b) * C;
  int* cid_row = cid + static_cast<size_t>(b) * C;
  const bool any_live = blk.live[0] | blk.live[1] | blk.live[2] |
                        blk.live[3];
  if (!any_live) {                       // 3. an all-dead block
    for (int c = tid; c < C; c += kThreads) {
      key_row[c] = kInf;
      cid_row[c] = c;
    }
    if (tid == 0) count[b] = 0;
    return;
  }

  // 4. every cluster against the four sub-blocks, in registers
  int n_possible = 0;
  for (int c = tid; c < C; c += kThreads) {
    float entry_min = kInf;
    int qbits = 0;
    if (cl_ok[c]) {
      const float lo[3] = {__ldg(w_lo + 3 * c), __ldg(w_lo + 3 * c + 1),
                           __ldg(w_lo + 3 * c + 2)};
      const float hi[3] = {__ldg(w_hi + 3 * c), __ldg(w_hi + 3 * c + 1),
                           __ldg(w_hi + 3 * c + 2)};
#pragma unroll
      for (int s = 0; s < kSub; ++s) {
        if (!blk.live[s]) continue;
        float entry = 0.0f, exit_ = 0.0f;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          float near = -kBig, far = kBig;
          if (blk.ax_ok[s][a])
            axis_bounds(lo[a], hi[a], blk.oh[s][a], blk.ol[s][a],
                        blk.il[s][a], blk.ih[s][a], near, far);
          entry = a == 0 ? near : max_nan(entry, near);
          exit_ = a == 0 ? far : min_nan(exit_, far);
        }
        entry = max_nan(entry, 0.0f);
        const bool poss = exit_ >= entry && entry <= blk.tmax[s];
        entry_min = min_nan(entry_min, poss ? entry : kInf);
        qbits |= static_cast<int>(poss) << s;
      }
    }
    key_row[c] = qbits ? entry_min : kInf;
    cid_row[c] = c | (qbits << 16);
    n_possible += qbits != 0;
  }
  for (int off = 16; off > 0; off >>= 1)
    n_possible += __shfl_xor_sync(kAll, n_possible, off);
  if (lane == 0 && n_possible) atomicAdd(&blk.count, n_possible);
  __syncthreads();
  if (tid == 0) count[b] = blk.count;
}

}  // namespace

// The visit-list keys of nb blocks of bn rays (bn a multiple of 4, at most
// 1024) against C clusters, on ``stream``.  Returns a cudaError_t.
extern "C" int rr_block_lists(const float* o, const float* d,
                              const unsigned char* alive, const float* tmax,
                              const float* w_lo, const float* w_hi,
                              const unsigned char* cl_ok, float* key,
                              int* cid, int* count, int nb, int bn, int C,
                              void* stream) {
  if (nb == 0) return 0;
  if (bn <= 0 || bn % kSub != 0 || bn > 1024 || C < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  block_lists_kernel<<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, alive, tmax, w_lo, w_hi, cl_ok, key, cid, count, bn, C);
  return static_cast<int>(cudaGetLastError());
}
