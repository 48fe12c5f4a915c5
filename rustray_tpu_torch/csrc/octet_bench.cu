// Octet kernel bench: cost-isolation variants of a per-octet walk, for
// Hopper (sm_90a).
//
// Replaces: tools/octet_kernel_bench.py::make_kernel (K4), the Pallas TPU
// kernel built by ``build`` there.  Contract, identical to that kernel and
// to the torch twin rustray_tpu_torch/tools/octet_kernel_bench.py::
// _bench_twin:
//   nlive (1,) i32 live octets; rays (n, 8) f32 rows [ox oy oz dx dy dz
//   t_max pad]; aabb (8, cpad) f32 rows lo.xyz, hi.xyz, 2 zero rows; pack
//   (n_pack, 16, 128) f32 triangle slabs.  Out: t (n,) f32, 3e38 on miss;
//   idx (n,) i32 = cid*128 + lane.  Octets at or past nlive write 3e38 / 0.
//   Each live octet first runs its exact (8, cpad) slab test into the
//   entry row e: per ray and cluster, tn = -3e37 and tf = 3e37 folded over
//   the three axes with max(tn, min(t0, t1)) and min(tf, max(t0, t1)),
//   entry = max(tn, 0), kept where tf >= entry and entry <= t_max (else
//   3e38); e is the minimum over the octet's 8 rays.  An inverted box (the
//   padding, disabled clusters) enters at 0.  Then, by variant:
//     kV1  the slab test only: writes 3e38 / 0;
//     kV2  intersects clusters 0..15 by index, in a loop unrolled kUnroll
//          times (v2 = 1, v2u = 16, v2u8 = 8);
//     kV3  also takes the 16 argmin-and-mask passes over e (lowest index on
//          ties; a pass sets the chosen entry to 3e38), but still
//          intersects cluster ``step``;
//     kV4  intersects the chosen clusters, each clamped to cpad - 1 and to
//          the pack's last row.
//   A ray keeps the minimum t over the visits; the lowest lane wins ties
//   within a slab and the earlier visit across slabs (strict '<').
//
// Design: one warp per octet, 256-thread CTAs on a persistent grid.
//   The CTA stages the box table's six rows in shared memory once (64.5 KB
//   at the bench scene's cpad of 2,688; in chunks of 4,096 clusters when
//   cpad is larger, restaged per group of 8 octets behind two barriers).
//   Each lane holds its octet's 8 rays (1/d, o/d, t_max: 56 registers) and
//   strides the clusters c = lane + 32 j, computing each entry in the
//   twin's operation order; e is never written to device memory.
//   The selection (kV3, kV4) is a per-lane candidate list: the lane's first
//   16 (entry, id) pairs below 3e38, kept sorted by strict insertion (ids
//   ascend within a lane, so equal entries keep the lower id first).  An
//   entry is either at most 3e37 (an accepted entry is at most tf, which
//   starts there; a NaN fails the comparisons and becomes 3e38) or 3e38.
//   Sixteen shuffle-butterfly lexicographic minima over the lists' heads,
//   each popped by its owner, give the passes while entries below 3e38
//   last: the first 16 of the row lie within the lanes' first 16s.  Once
//   they run out the twin's row is 3e38 throughout, and every later pass
//   picks cluster 0.  No CTA barrier is involved.  Design (a) of keeping e
//   rows in shared memory for 16 scans was not taken: 8 rows of 2,688 take
//   86 KB beside the 64.5 KB box table, one CTA per SM, and each pass would
//   rescan the row.
//   Visits: lane l tests triangles l, l + 32, l + 64, l + 96 of each slab,
//   one at a time, its 12 rows read into registers (each row read is
//   coalesced over the warp), against all 8 rays (in the warp's shared
//   memory, read as float4 broadcasts).  Each lane keeps, per ray, its
//   nearest hit over all 16 visits with the key visit * 128 + triangle
//   (strict '<', so the earlier key wins ties); one (t, key) butterfly per
//   ray after the last visit then gives the earliest visit's lowest
//   triangle among the nearest, as the twin's per-slab minimum and
//   strict fold do.  Rays in shared memory rather than registers and one
//   triangle at a time keep the kernel at 128 registers without spills
//   (two CTAs per SM); a per-visit butterfly, float4 slab reads of 4
//   triangles a lane, or rays held in registers all spilled or ran
//   slower on the card (PERF.md).  kV4's slabs are not staged with
//   cp.async: a double buffer per warp (96 KB a CTA) does not fit beside
//   the resident box table at two CTAs per SM.
//   A guard that never fires keeps the entries and the selection live
//   where no output reads them (kV1, kV2, kV3), so each variant costs what
//   it names.
//
// Bound: FP32 work.  28 operations per ray x cluster entry (6 products, 6
// differences, 6 min/max per axis, 6 folds, the clamp, 2 comparisons, the
// octet minimum) over the live octets; in kV2-kV4 31 per ray x triangle
// test (16 x 8 x 128 per octet); in kV3 and kV4 one comparison per entry
// of the row for the selection.  Bytes: the live rays, the box table, the
// visited slabs' 12 rows once, t and idx.  chip_smoke.py phase 9 prints
// both per variant.  Tensor cores do not apply: the work is exact f32
// comparisons, and no test sums products into an accumulator that an MMA
// could take.
//
// Floating point: built with -fmad=false and without --use_fast_math, so
// every product, difference and the divisions 1/d and (a.n - o.n) / d.n
// round as IEEE f32 in the twin's operation order; the min/max are the
// NaN-propagating PTX forms, like torch.minimum/maximum/clamp/amin.

#include <cuda_runtime.h>

namespace {

constexpr int kK = 128;               // triangles per slab
constexpr int kRows = 12;             // slab rows the test reads
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVisits = 16;
constexpr int kChunk = 4096;          // clusters staged at once (96 KB)
constexpr float kInf = 3.0e38f;
constexpr float kBig = 3.0e37f;
constexpr unsigned kAll = 0xffffffffu;
enum Variant { kV1 = 1, kV2 = 2, kV3 = 3, kV4 = 4 };

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

// Lexicographic (v, i) minimum over the warp; every lane gets it.
__device__ __forceinline__ void warp_lex_min(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kAll, v, off);
    const int oi = __shfl_xor_sync(kAll, i, off);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// One ray against triangle k; strict '<' keeps the earlier k on ties.
__device__ __forceinline__ void test_tri(
    float ox, float oy, float oz, float dx, float dy, float dz, float tmax,
    float n0, float n1, float n2, float an, float g10, float g11, float g12,
    float c1, float g20, float g21, float g22, float c2, int k,
    float& tile_t, int& tile_k) {
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

// Triangle ``key``'s slab rows (tr) against the octet's 8 rays (ray i at
// sr[8i .. 8i+6]: ox oy oz dx dy dz t_max, read as two float4 broadcasts),
// folded into each ray's running best (t, key) with strict '<'.
__device__ __forceinline__ void tri_rays(const float (&tr)[kRows],
                                         const float* sr, int key,
                                         float (&bt)[8], int (&bk)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 p = reinterpret_cast<const float4*>(sr)[2 * i];
    const float4 q = reinterpret_cast<const float4*>(sr)[2 * i + 1];
    test_tri(p.x, p.y, p.z, p.w, q.x, q.y, q.z, tr[0], tr[1], tr[2], tr[3],
             tr[4], tr[5], tr[6], tr[7], tr[8], tr[9], tr[10], tr[11], key,
             bt[i], bk[i]);
  }
}

// Entry of one ray (1/d, o/d, t_max) into staged box c of a chunk of
// ``cc`` clusters, in the twin's order: 3e38 unless it enters before t_max.
__device__ __forceinline__ float entry_of(const float* bx, int cc, int c,
                                          float ix, float iy, float iz,
                                          float ox, float oy, float oz,
                                          float tm) {
  float tn = -kBig, tf = kBig;
  float t0 = bx[c] * ix - ox, t1 = bx[3 * cc + c] * ix - ox;
  tn = max_nan(tn, min_nan(t0, t1));
  tf = min_nan(tf, max_nan(t0, t1));
  t0 = bx[cc + c] * iy - oy;
  t1 = bx[4 * cc + c] * iy - oy;
  tn = max_nan(tn, min_nan(t0, t1));
  tf = min_nan(tf, max_nan(t0, t1));
  t0 = bx[2 * cc + c] * iz - oz;
  t1 = bx[5 * cc + c] * iz - oz;
  tn = max_nan(tn, min_nan(t0, t1));
  tf = min_nan(tf, max_nan(t0, t1));
  const float entry = max_nan(tn, 0.0f);
  return (tf >= entry && entry <= tm) ? entry : kInf;
}

// A lane's candidates for the 16 argmin-and-mask passes over its clusters
// (offered in ascending id order): the first kVisits (entry, id) pairs
// below 3e38, sorted.
struct Candidates {
  float v[kVisits];
  int i[kVisits];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int p = 0; p < kVisits; ++p) {
      v[p] = kInf;
      i[p] = 0;
    }
  }

  __device__ __forceinline__ void offer(float x, int c) {
    if (x < v[kVisits - 1]) {         // strict: a later equal entry goes after
#pragma unroll
      for (int p = kVisits - 1; p > 0; --p) {
        if (x < v[p - 1]) {
          v[p] = v[p - 1];
          i[p] = i[p - 1];
        } else if (x < v[p]) {
          v[p] = x;
          i[p] = c;
        }
      }
      if (x < v[0]) {
        v[0] = x;
        i[0] = c;
      }
    }
  }

  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int p = 0; p < kVisits - 1; ++p) {
      v[p] = v[p + 1];
      i[p] = i[p + 1];
    }
    v[kVisits - 1] = kInf;
    i[kVisits - 1] = 0;
  }
};

// The 16 passes from the lanes' candidates: lane s < 16 returns pass s's
// cluster.  Once the entries below 3e38 are gone the twin's row is 3e38
// throughout, and every later pass picks cluster 0.
__device__ __forceinline__ int select16(Candidates& cd, int lane) {
  int pick = 0;
#pragma unroll
  for (int s = 0; s < kVisits; ++s) {
    float wv = cd.v[0];
    int wi = cd.i[0];
    warp_lex_min(wv, wi);
    if (!(wv < kInf)) break;           // warp-uniform: entries below 3e38 gone
    if (lane == s) pick = wi;
    if (cd.v[0] == wv && cd.i[0] == wi) cd.pop();   // the owner pops
  }
  return pick;
}

template <int kVariant, int kUnroll>
__global__ void __launch_bounds__(kThreads, 2) octet_bench_kernel(
    const int* __restrict__ nlive, const float* __restrict__ rays,
    const float* __restrict__ aabb, const float* __restrict__ pack,
    float* __restrict__ t_out, int* __restrict__ idx_out, int n_oct,
    int cpad, int n_pack) {
  extern __shared__ __align__(16) float bx[];        // [6][chunk]
  __shared__ __align__(16) float srays[kWarps][64];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk = min(cpad, kChunk);
  const int groups = (n_oct + kWarps - 1) / kWarps;
  const int n_live = min(__ldg(nlive), n_oct);
  float* sr = srays[warp];
  int staged = -1;                                   // chunk start staged
  float guard = kInf;
  int chain = 0;
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int oc = g * kWarps + warp;
    const bool live = oc < n_live;                   // warp-uniform
    const size_t r0 = static_cast<size_t>(oc) * 8;
    float ix[8], iy[8], iz[8], oix[8], oiy[8], oiz[8], tm[8];
    if (live) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float* r = rays + (r0 + i) * 8;
        float inv[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float dv = __ldg(r + 3 + a);
          const float sd =
              fabsf(dv) > 1e-30f ? dv : (dv >= 0.0f ? 1e-30f : -1e-30f);
          inv[a] = 1.0f / sd;
        }
        ix[i] = inv[0];
        iy[i] = inv[1];
        iz[i] = inv[2];
        oix[i] = __ldg(r + 0) * inv[0];
        oiy[i] = __ldg(r + 1) * inv[1];
        oiz[i] = __ldg(r + 2) * inv[2];
        tm[i] = __ldg(r + 6);
      }
    }
    Candidates cd;
    if (kVariant >= kV3) cd.init();
    for (int base = 0; base < cpad; base += chunk) {
      const int cc = min(chunk, cpad - base);
      if (staged != base) {                          // CTA-uniform
        __syncthreads();
        for (int k = threadIdx.x; k < 6 * cc; k += kThreads) {
          const int a = k / cc, c = k - a * cc;
          bx[a * chunk + c] = __ldg(aabb + a * cpad + base + c);
        }
        __syncthreads();
        staged = base;
      }
      if (!live) continue;
      for (int c = lane; c < cc; c += 32) {
        float m = kInf;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          m = min_nan(m, entry_of(bx, chunk, c, ix[i], iy[i], iz[i], oix[i],
                                  oiy[i], oiz[i], tm[i]));
        if (kVariant >= kV3)
          cd.offer(m, base + c);
        else
          guard = min_nan(guard, m);
      }
    }
    if (oc >= n_oct) continue;
    float my_t = kInf;
    int my_i = 0;
    if (live && kVariant != kV1) {
      int pick = 0;
      if (kVariant >= kV3) {
        pick = select16(cd, lane);
        chain += __reduce_add_sync(kAll, lane < kVisits ? pick : 0);
      }
      if (lane < 16)
        reinterpret_cast<float4*>(sr)[lane] =
            __ldg(reinterpret_cast<const float4*>(rays + r0 * 8) + lane);
      __syncwarp();
      // the cluster visit jg reads (every lane calls it)
      auto col = [&](int jg) {
        if (kVariant == kV4) jg = min(__shfl_sync(kAll, pick, jg), cpad - 1);
        return min(jg, n_pack - 1);
      };
      // per ray, this lane's nearest hit so far and its key: visit * 128 +
      // triangle, so the lowest key is the earliest visit, then the lowest
      // triangle of its slab
      float bt[8];
      int bk[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        bt[i] = kInf;
        bk[i] = 0;
      }
      // lane l tests triangles l + 32 q (q = 0..3) of the slab, each read
      // from the slab's 12 rows (coalesced over the warp) into registers
      auto visit = [&](int jg, int cid) {
        const float* slab = pack + static_cast<size_t>(cid) * 16 * kK + lane;
#pragma unroll 1
        for (int q = 0; q < 4; ++q) {
          float tr[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) tr[r] = __ldg(slab + r * kK + 32 * q);
          tri_rays(tr, sr, jg * kK + 32 * q + lane, bt, bk);
        }
      };
      if (kVariant == kV2) {
#pragma unroll (kUnroll)
        for (int jg = 0; jg < kVisits; ++jg) visit(jg, min(jg, n_pack - 1));
      } else {
#pragma unroll 1
        for (int jg = 0; jg < kVisits; ++jg) visit(jg, col(jg));
      }
      __syncwarp();                                  // sr free
      // ray i's lowest (t, key) over the warp, kept by lane i
      int key = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        warp_lex_min(bt[i], bk[i]);
        if (lane == i) {
          my_t = bt[i];
          key = bk[i];
        }
      }
      const int cid = col(key / kK);
      if (my_t < kInf) my_i = cid * kK + key % kK;
    }
    if (lane < 8) {
      t_out[r0 + lane] = my_t;
      idx_out[r0 + lane] = my_i;
    }
  }
  // never true (entries are >= 0 or 3e38, chosen ids >= 0): keeps the slab
  // test and the selection from being compiled away
  if (guard < -1.0f || chain < 0) idx_out[0] = -1;
}

template <int kVariant, int kUnroll>
int launch(const int* nlive, const float* rays, const float* aabb,
           const float* pack, float* t_out, int* idx_out, int n_oct,
           int cpad, int n_pack, cudaStream_t stream) {
  auto kernel = octet_bench_kernel<kVariant, kUnroll>;
  const size_t smem = 6 * static_cast<size_t>(min(cpad, kChunk)) *
                      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // persistent grid: CTAs per SM from the occupancy, times the SMs
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = min((n_oct + kWarps - 1) / kWarps,
                       sms * (per_sm > 0 ? per_sm : 1));
  kernel<<<grid, kThreads, smem, stream>>>(nlive, rays, aabb, pack, t_out,
                                           idx_out, n_oct, cpad, n_pack);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: 1 = v1, 2 = v2, 3 = v2u, 4 = v2u8, 5 = v3, 6 = v4.  Launch on
// ``stream``; returns cudaGetLastError() (0 = launched).  Slabs of K = 128
// triangles only.
extern "C" int rr_octet_bench(int variant, const int* nlive,
                              const float* rays, const float* aabb,
                              const float* pack, float* t_out, int* idx_out,
                              int n_oct, int cpad, int K, int n_pack,
                              void* stream) {
  if (n_oct == 0) return 0;
  if (K != kK || cpad <= 0 || n_pack <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 1: return launch<kV1, 1>(nlive, rays, aabb, pack, t_out, idx_out,
                                  n_oct, cpad, n_pack, s);
    case 2: return launch<kV2, 1>(nlive, rays, aabb, pack, t_out, idx_out,
                                  n_oct, cpad, n_pack, s);
    case 3: return launch<kV2, 16>(nlive, rays, aabb, pack, t_out, idx_out,
                                   n_oct, cpad, n_pack, s);
    case 4: return launch<kV2, 8>(nlive, rays, aabb, pack, t_out, idx_out,
                                  n_oct, cpad, n_pack, s);
    case 5: return launch<kV3, 1>(nlive, rays, aabb, pack, t_out, idx_out,
                                  n_oct, cpad, n_pack, s);
    case 6: return launch<kV4, 1>(nlive, rays, aabb, pack, t_out, idx_out,
                                  n_oct, cpad, n_pack, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
