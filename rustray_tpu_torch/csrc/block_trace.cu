// Block walk: closest / any-hit ray x triangle traversal of per-block
// front-to-back cluster visit lists, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of rustray_tpu/ops/block_trace.py, as
// two variants of this one kernel (the ``gated`` argument):
//   gated = 1: _make_kernel_vmem (K1, packs up to 64 MB).  A list entry is
//     tested only by the quads its descriptor names; in any-hit mode a
//     lane freezes at its first hit in list order.
//   gated = 0: _make_kernel (K2, packs beyond 64 MB, which the TPU streams
//     from HBM).  Every lane tests every entry; in any-hit mode a lane
//     takes the group's nearest hit (lowest list position, then lowest
//     lane, on exact ties) and freezes only at the group's end.  On Hopper
//     the pack is read from global memory (L2) at any size, so K2 needs no
//     streaming kernel of its own: only its contract differs.
// Closest mode gives the same winners in both.  Contract, identical to the
// torch twin ops/block_trace.py::_walk_twin:
//   count (NB,) i32 list lengths; rays (NB, BN, 8) f32 rows
//   [ox oy oz dx dy dz t_max pad]; order (NB, cpad) i32 descriptors
//   (cluster id in bits 0-15, quad mask in bits 16-19); entry (NB, cpad)
//   f32 ascending entry distances; pack (C, 16, K) f32 triangle slabs
//   (rows n0 n1 n2 a.n g1x g1y g1z c1 g2x g2y g2z c2, 4 zero rows).
//   Out: t (NB, BN) f32, 3e38 on miss; idx (NB, BN) i32 = cid*K + lane.
//
// Design: one CTA per ray block, one thread per ray; the block's quad q
// (rays [q*BN/4, (q+1)*BN/4)) is one warp at BN=128, so the quad gate is a
// warp-uniform branch.  Each list entry's slab (12 used rows x K floats,
// 6 KB at K=128) is loaded cooperatively into shared memory; every thread
// then tests its ray against the K triangles in lane order with a strict
// '<', which gives the minimum t with the lowest-lane tie.  After each
// group of 8 entries the block recomputes its need (warp shuffles plus one
// shared-memory step across warps) and stops at the first group whose
// first entry distance exceeds it.
//
// Bound: FP32 ALU work (about 30 flops per ray x triangle test) and
// shared-memory broadcast reads (every lane of a warp reads the same slab
// word).  The slab pack of the 250k-triangle bench scene (about 21 MB)
// stays resident in the 50 MB L2, so slab loads rarely reach HBM.
//
// Floating point: built with -fmad=false (no mul+add contraction) and
// without --use_fast_math, so every product, sum and the division
// t = (a.n - o.n) / d.n rounds as IEEE f32 in the JAX package's operation
// order, exactly like the elementwise torch twin.

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 8;       // list entries per early-exit check
constexpr int kRows = 12;       // slab rows the test reads
constexpr float kInf = 3.0e38f;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Max over the CTA; ``red`` holds one float per warp.
__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();                    // red is free again
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < nwarps; ++w) m = fmaxf(m, red[w]);
  return m;
}

__global__ void __launch_bounds__(1024) block_walk_kernel(
    const int* __restrict__ count, const float* __restrict__ rays,
    const int* __restrict__ order, const float* __restrict__ entry,
    const float* __restrict__ pack, float* __restrict__ t_out,
    int* __restrict__ idx_out, int bn, int cpad, int K, int any_mode,
    int gated) {
  extern __shared__ float slab[];     // kRows x K
  __shared__ float red[32];

  const int b = blockIdx.x;
  const int r = threadIdx.x;
  // threads past BN (blockDim is BN rounded up to a warp) are dead lanes
  const bool lane_ok = r < bn;
  const float* ray = rays + (static_cast<size_t>(b) * bn + (lane_ok ? r : 0)) * 8;
  const float ox = ray[0], oy = ray[1], oz = ray[2];
  const float dx = ray[3], dy = ray[4], dz = ray[5];
  const float tmax = lane_ok ? ray[6] : -kInf;
  const int quad = lane_ok ? r / (bn / 4) : 4;

  float best_t = kInf;
  int best_i = 0;
  const int n = count[b];
  const int* ord = order + static_cast<size_t>(b) * cpad;
  const float* ent = entry + static_cast<size_t>(b) * cpad;
  float need = block_max(tmax, red);

  for (int j0 = 0; j0 < n; j0 += kGroup) {
    if (!(ent[j0] <= need)) break;    // need is CTA-uniform
    const int jend = min(j0 + kGroup, n);
    // the ungated variant's group winner: strict '<' in list order keeps
    // the earliest position on exact ties
    float grp_t = kInf;
    int grp_i = 0;
    for (int j = j0; j < jend; ++j) {
      const int desc = ord[j];
      const int cid = desc & 0xFFFF;
      const float* src = pack + static_cast<size_t>(cid) * 16 * K;
      __syncthreads();                // previous slab fully consumed
      for (int e = threadIdx.x; e < kRows * K; e += blockDim.x)
        slab[e] = src[e];
      __syncthreads();
      const bool listed =
          quad < 4 && (!gated || ((desc >> (16 + quad)) & 1));
      const bool frozen = any_mode && best_t < kInf;
      if (!listed || frozen) continue;
      float tile_t = kInf;
      int tile_k = 0;
      for (int k = 0; k < K; ++k) {
        const float n0 = slab[k], n1 = slab[K + k], n2 = slab[2 * K + k];
        const float an = slab[3 * K + k];
        const float g10 = slab[4 * K + k], g11 = slab[5 * K + k];
        const float g12 = slab[6 * K + k], c1 = slab[7 * K + k];
        const float g20 = slab[8 * K + k], g21 = slab[9 * K + k];
        const float g22 = slab[10 * K + k], c2 = slab[11 * K + k];
        const float d_n = dx * n0 + dy * n1 + dz * n2;
        const float o_n = ox * n0 + oy * n1 + oz * n2;
        const bool den = fabsf(d_n) > 1e-30f;
        const float t = (an - o_n) / (den ? d_n : 1.0f);
        const float px = ox + t * dx;
        const float py = oy + t * dy;
        const float pz = oz + t * dz;
        const float u = px * g10 + py * g11 + pz * g12 + c1;
        const float v = px * g20 + py * g21 + pz * g22 + c2;
        const bool hit = den && t >= 0.0f && u >= 0.0f && v >= 0.0f &&
                         u + v <= 1.0f && t <= tmax;
        if (hit && t < tile_t) {
          tile_t = t;
          tile_k = k;
        }
      }
      if (!gated) {
        if (tile_t < grp_t) {
          grp_t = tile_t;
          grp_i = cid * K + tile_k;
        }
        continue;
      }
      // closest: keep only a strictly nearer hit; any: the first hit
      // freezes the lane
      const bool better = any_mode ? tile_t < kInf : tile_t < best_t;
      if (better) {
        best_t = tile_t;
        best_i = cid * K + tile_k;
      }
    }
    if (!gated && (any_mode ? grp_t < kInf && best_t >= kInf
                            : grp_t < best_t)) {
      best_t = grp_t;
      best_i = grp_i;
    }
    float lane_need;
    if (!lane_ok)
      lane_need = -kInf;
    else if (any_mode)
      lane_need = best_t < kInf ? -kInf : tmax;
    else
      lane_need = fminf(best_t, tmax);
    need = block_max(lane_need, red);
  }
  if (lane_ok) {
    t_out[static_cast<size_t>(b) * bn + r] = best_t;
    idx_out[static_cast<size_t>(b) * bn + r] = best_i;
  }
}

}  // namespace

// Launch on ``stream``; returns cudaGetLastError() (0 = launched).
extern "C" int rr_block_trace(const int* count, const float* rays,
                              const int* order, const float* entry,
                              const float* pack, float* t_out, int* idx_out,
                              int nb, int bn, int cpad, int K, int any_mode,
                              int gated, void* stream) {
  if (nb == 0) return 0;
  const int threads = (bn + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(kRows) * K * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        block_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  block_walk_kernel<<<nb, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      count, rays, order, entry, pack, t_out, idx_out, bn, cpad, K, any_mode,
      gated);
  return static_cast<int>(cudaGetLastError());
}
