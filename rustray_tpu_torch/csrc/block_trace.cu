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
//   f32 ascending entry distances; pack (C, 16, 128) f32 triangle slabs
//   (rows n0 n1 n2 a.n g1x g1y g1z c1 g2x g2y g2z c2, 4 zero rows).
//   Out: t (NB, BN) f32, 3e38 on miss; idx (NB, BN) i32 = cid*128 + lane;
//   visited (NB,) i32, the list entries the walk visited.
//
// Design.  The serial walk's time is its longest block's list: a few
// blocks visit hundreds of entries while the rest stop after a few, so one
// CTA per block leaves the card waiting on one CTA.  The walk is cut into
// work units of one group (GROUP = 8 list entries of one block, numbered
// block by block: ustart is the inclusive cumsum of ceil(count / 8)):
//   pass A (walk_units_kernel): a persistent grid walks all units.  A
//     unit's slabs (8 x 12 rows x 128 floats, 48 KB) are staged into shared
//     memory with cp.async one unit ahead, double-buffered, so the copies
//     of the next unit overlap the tests of this one.  The unit's (entry,
//     32-ray chunk) pairs that have a listed lane are compacted and spread
//     over the CTA's 8 warps; each lane tests its ray against the slab's
//     128 triangles (K is the compile-time kK, the loop reads float4s and
//     unrolls), lowest lane winning on a strict '<'.  Each ray then folds
//     its unit's entries in list order into one partial (t, idx): the
//     strictly nearest (earliest entry, then lowest lane, on ties), or, in
//     the gated any-hit mode, the first entry with a hit.  Partials go in
//     the workspace (ws_t, ws_i), one row of BN per unit.  Units past where
//     the walk will stop are computed too (at most count, not the entries
//     visited).
//   pass B (walk_fold_kernel): one CTA per block replays the walk's rule
//     over its units in list order: stop at the first unit whose first
//     entry distance exceeds the block's need, fold the partial as the
//     serial walk folds a group (closest: strictly nearer; any: the first
//     hit), recompute need.  The next unit's partial is loaded before the
//     current one is folded.
// Each mode's fold is a lexicographic minimum, so the result equals the
// serial walk's bit for bit (ops/block_trace.py::_walk_units_twin is this
// decomposition in torch, tested against _walk_twin).  No float atomics;
// nothing depends on the order in which CTAs run.
//
// Bound: FP32 work, 31 flops per ray x triangle test (d.n 5, o.n 5, the
// subtraction and division 2, the hit point 6, u 6, v 6, u+v 1) over the
// tests the serial walk needs (listed quads x 32 rays x 128 triangles per
// visited entry), against 67 TFLOP/s; the bytes bound (rays, visited list
// entries, each visited slab's 12 rows, outputs, at 3.35 TB/s) is smaller.
// chip_smoke.py phase 3 prints both per launch.
//
// Floating point: built with -fmad=false (no mul+add contraction) and
// without --use_fast_math, so every product, sum and the division
// t = (a.n - o.n) / d.n rounds as IEEE f32 in the JAX package's operation
// order, exactly like the elementwise torch twin.

#include <cuda_runtime.h>

namespace {

constexpr int kK = 128;               // triangles per slab
constexpr int kGroup = 8;             // list entries per unit
constexpr int kRows = 12;             // slab rows the test reads
constexpr int kSlab = kRows * kK;     // floats staged per slab (6,144 B)
constexpr int kCopies = kSlab / 4;    // 16-byte copies per slab
constexpr int kThreadsA = 256;
constexpr int kWarpsA = kThreadsA / 32;
constexpr float kInf = 3.0e38f;
static_assert(kGroup * 32 <= kThreadsA, "one thread per (entry, chunk)");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Unit {
  int b;    // ray block
  int j0;   // first list position
  int n;    // entries, 1..kGroup
};

// Unit u (< ustart[nb - 1]): its block is the first b with ustart[b] > u.
__device__ Unit find_unit(int u, const int* __restrict__ ustart,
                          const int* __restrict__ count, int nb) {
  int lo = 0, hi = nb - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ustart + mid) > u)
      hi = mid;
    else
      lo = mid + 1;
  }
  const int n = __ldg(count + lo);
  const int units = (n + kGroup - 1) / kGroup;
  Unit x;
  x.b = lo;
  x.j0 = (u - (__ldg(ustart + lo) - units)) * kGroup;
  x.n = min(kGroup, n - x.j0);
  return x;
}

// Issue the cp.async copies of unit x's slabs into ``slabs`` and its
// descriptors into ``desc``; one commit group per call.
__device__ void stage(const Unit& x, float* slabs, int* desc,
                      const int* __restrict__ order,
                      const float* __restrict__ pack, int cpad) {
  const int* ord = order + static_cast<size_t>(x.b) * cpad + x.j0;
  if (threadIdx.x < x.n) desc[threadIdx.x] = __ldg(ord + threadIdx.x);
  for (int c = threadIdx.x; c < x.n * kCopies; c += kThreadsA) {
    const int e = c / kCopies, w = c - e * kCopies;
    const int cid = __ldg(ord + e) & 0xFFFF;
    cp_async16(slabs + e * kSlab + w * 4,
               pack + static_cast<size_t>(cid) * 16 * kK + w * 4);
  }
  cp_async_commit();
}

// One ray against triangle k; strict '<' keeps the lowest lane on ties.
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

// Nearest hit of one ray in one staged slab: (t, lane), 3e38 on a miss.
__device__ __forceinline__ void slab_hit(const float* __restrict__ s,
                                         const float* __restrict__ ray,
                                         float& tile_t, int& tile_k) {
  const float ox = ray[0], oy = ray[1], oz = ray[2];
  const float dx = ray[3], dy = ray[4], dz = ray[5];
  const float tmax = ray[6];
  tile_t = kInf;
  tile_k = 0;
#pragma unroll 2
  for (int k0 = 0; k0 < kK; k0 += 4) {
    float4 r[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      r[i] = *reinterpret_cast<const float4*>(s + i * kK + k0);
#define RR_TEST(c, dk)                                                      \
  test_tri(ox, oy, oz, dx, dy, dz, tmax, r[0].c, r[1].c, r[2].c, r[3].c,    \
           r[4].c, r[5].c, r[6].c, r[7].c, r[8].c, r[9].c, r[10].c,         \
           r[11].c, k0 + dk, tile_t, tile_k)
    RR_TEST(x, 0);
    RR_TEST(y, 1);
    RR_TEST(z, 2);
    RR_TEST(w, 3);
#undef RR_TEST
  }
}

__global__ void __launch_bounds__(kThreadsA, 2) walk_units_kernel(
    const int* __restrict__ count, const int* __restrict__ ustart,
    const float* __restrict__ rays, const int* __restrict__ order,
    const float* __restrict__ pack, float* __restrict__ ws_t,
    int* __restrict__ ws_i, int nb, int bn, int cpad, int first_hit,
    int gated) {
  extern __shared__ __align__(16) float smem[];
  float* slabs = smem;                               // [2][kGroup][kSlab]
  float* res_t = smem + 2 * kGroup * kSlab;          // [kGroup][bn]
  int* res_k = reinterpret_cast<int*>(res_t + kGroup * bn);
  __shared__ int sdesc[2][kGroup];
  __shared__ short pairs[kGroup * 32];
  __shared__ int wsum[kWarpsA];

  const int total = __ldg(ustart + nb - 1);
  int u = blockIdx.x;
  if (u >= total) return;                            // CTA-uniform
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nchunk = (bn + 31) >> 5;                 // 32-ray chunks
  const int qsize = bn >> 2;                         // rays per quad
  Unit cur = find_unit(u, ustart, count, nb);
  stage(cur, slabs, sdesc[0], order, pack, cpad);
  for (int it = 0; u < total; ++it, u += gridDim.x) {
    const int buf = it & 1;
    const int un = u + gridDim.x;
    Unit nxt = cur;
    if (un < total) {
      nxt = find_unit(un, ustart, count, nb);
      stage(nxt, slabs + (buf ^ 1) * kGroup * kSlab, sdesc[buf ^ 1], order,
            pack, cpad);
    } else {
      cp_async_commit();                             // keep one per step
    }
    cp_async_wait<1>();                              // this unit's copies
    __syncthreads();
    const float* sl = slabs + buf * kGroup * kSlab;
    const int* ds = sdesc[buf];
    const float* ray_b = rays + static_cast<size_t>(cur.b) * bn * 8;

    // compact the (entry, chunk) pairs with a listed lane
    bool listed = false;
    if (tid < cur.n * nchunk) {
      const int e = tid / nchunk, c = tid - e * nchunk;
      if (!gated) {
        listed = true;
      } else {
        const int q0 = c * 32 / qsize;
        const int q1 = (min(c * 32 + 32, bn) - 1) / qsize;
        const int mask = ((2 << q1) - 1) & ~((1 << q0) - 1);
        listed = ((ds[e] >> 16) & mask) != 0;
      }
    }
    const unsigned bal = __ballot_sync(0xffffffffu, listed);
    if (lane == 0) wsum[warp] = __popc(bal);
    __syncthreads();
    int base = 0, npairs = 0;
    for (int w = 0; w < kWarpsA; ++w) {
      base += w < warp ? wsum[w] : 0;
      npairs += wsum[w];
    }
    if (listed) pairs[base + __popc(bal & ((1u << lane) - 1u))] = tid;
    __syncthreads();

    // one warp per pair, one lane per ray
    for (int p = warp; p < npairs; p += kWarpsA) {
      const int pos = pairs[p];
      const int e = pos / nchunk;
      const int r = (pos - e * nchunk) * 32 + lane;
      if (r < bn && (!gated || ((ds[e] >> (16 + r / qsize)) & 1))) {
        float tile_t;
        int tile_k;
        slab_hit(sl + e * kSlab, ray_b + r * 8, tile_t, tile_k);
        res_t[e * bn + r] = tile_t;
        res_k[e * bn + r] = tile_k;
      }
    }
    __syncthreads();

    // each ray folds the unit's entries in list order
    for (int r = tid; r < bn; r += kThreadsA) {
      const int q = r / qsize;
      float pt = kInf;
      int pi = 0;
      for (int e = 0; e < cur.n; ++e) {
        const int desc = ds[e];
        if (gated && !((desc >> (16 + q)) & 1)) continue;
        const float t = res_t[e * bn + r];
        const bool take = first_hit ? (pt >= kInf && t < kInf) : t < pt;
        if (take) {
          pt = t;
          pi = (desc & 0xFFFF) * kK + res_k[e * bn + r];
        }
      }
      ws_t[static_cast<size_t>(u) * bn + r] = pt;
      ws_i[static_cast<size_t>(u) * bn + r] = pi;
    }
    __syncthreads();                                 // buf and res free
    cur = nxt;
  }
  cp_async_wait<0>();
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Max over the CTA with one barrier; ``red`` (one float per warp) must
// alternate between two buffers from one call to the next.
__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < (blockDim.x >> 5); ++w) m = fmaxf(m, red[w]);
  return m;
}

__global__ void __launch_bounds__(1024) walk_fold_kernel(
    const int* __restrict__ count, const int* __restrict__ ustart,
    const float* __restrict__ rays, const float* __restrict__ entry,
    const float* __restrict__ ws_t, const int* __restrict__ ws_i,
    float* __restrict__ t_out, int* __restrict__ idx_out,
    int* __restrict__ visited_out, int bn, int cpad, int any_mode) {
  __shared__ float red[2][32];
  const int b = blockIdx.x;
  const int r = threadIdx.x;
  // threads past BN (blockDim is BN rounded up to a warp) are dead lanes
  const bool lane_ok = r < bn;
  const float tmax =
      lane_ok ? __ldg(rays + (static_cast<size_t>(b) * bn + r) * 8 + 6)
              : -kInf;
  const int n = __ldg(count + b);
  const int units = (n + kGroup - 1) / kGroup;
  const int u0 = __ldg(ustart + b) - units;
  const float* ent = entry + static_cast<size_t>(b) * cpad;

  float best_t = kInf;
  int best_i = 0;
  int visited = 0;
  float need = block_max(tmax, red[0]);
  float e_next = units > 0 ? __ldg(ent) : 0.0f;
  float p_t = kInf;
  int p_i = 0;
  if (units > 0 && lane_ok) {
    p_t = ws_t[static_cast<size_t>(u0) * bn + r];
    p_i = ws_i[static_cast<size_t>(u0) * bn + r];
  }
  for (int g = 0; g < units; ++g) {
    if (!(e_next <= need)) break;                    // CTA-uniform
    const float ct = p_t;
    const int ci = p_i;
    if (g + 1 < units) {                             // load ahead
      e_next = __ldg(ent + (g + 1) * kGroup);
      if (lane_ok) {
        p_t = ws_t[static_cast<size_t>(u0 + g + 1) * bn + r];
        p_i = ws_i[static_cast<size_t>(u0 + g + 1) * bn + r];
      }
    }
    // closest: keep only a strictly nearer hit; any: the first hit
    const bool take = any_mode ? (ct < kInf && best_t >= kInf) : ct < best_t;
    if (take) {
      best_t = ct;
      best_i = ci;
    }
    visited += min(kGroup, n - g * kGroup);
    float lane_need;
    if (!lane_ok)
      lane_need = -kInf;
    else if (any_mode)
      lane_need = best_t < kInf ? -kInf : tmax;
    else
      lane_need = fminf(best_t, tmax);
    need = block_max(lane_need, red[(g + 1) & 1]);
  }
  if (lane_ok) {
    t_out[static_cast<size_t>(b) * bn + r] = best_t;
    idx_out[static_cast<size_t>(b) * bn + r] = best_i;
  }
  if (r == 0) visited_out[b] = visited;
}

}  // namespace

// Launch pass A and pass B on ``stream``; returns cudaGetLastError() of
// the first launch that fails (0 = both launched).  ws_t / ws_i hold
// NB * ceil(cpad / 8) rows of BN.
extern "C" int rr_block_trace(const int* count, const int* ustart,
                              const float* rays, const int* order,
                              const float* entry, const float* pack,
                              float* ws_t, int* ws_i, float* t_out,
                              int* idx_out, int* visited, int nb, int bn,
                              int cpad, int any_mode, int gated,
                              void* stream) {
  if (nb == 0) return 0;
  if (bn <= 0 || bn % 4 != 0 || bn > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (2 * kGroup * kSlab + 2 * kGroup * bn) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      walk_units_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, walk_units_kernel, kThreadsA, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = sms * (per_sm > 0 ? per_sm : 1);
  walk_units_kernel<<<grid, kThreadsA, smem, st>>>(
      count, ustart, rays, order, pack, ws_t, ws_i, nb, bn, cpad,
      any_mode && gated, gated);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  walk_fold_kernel<<<nb, (bn + 31) / 32 * 32, 0, st>>>(
      count, ustart, rays, entry, ws_t, ws_i, t_out, idx_out, visited, bn,
      cpad, any_mode);
  return static_cast<int>(cudaGetLastError());
}
