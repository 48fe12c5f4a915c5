// Octet kernel bench: cost-isolation variants of a per-octet walk, for
// Hopper (sm_90a).
//
// Replaces: tools/octet_kernel_bench.py::make_kernel, the Pallas TPU
// kernel built by ``build`` there.  Contract, identical to that kernel and
// to the torch twin rustray_tpu_torch/tools/octet_kernel_bench.py::
// _bench_twin:
//   nlive (1,) i32 live octets; rays (n, 8) f32 rows [ox oy oz dx dy dz
//   t_max pad]; aabb (8, cpad) f32 rows lo.xyz, hi.xyz, 2 zero rows; pack
//   (C, 16, K) f32 triangle slabs.  Out: t (n,) f32, 3e38 on miss; idx (n,)
//   i32 = cid*K + lane.  Octets at or past nlive write 3e38 / 0.
//   Each live octet first runs its exact (8, cpad) slab test into the
//   entry row e (min over its rays; 3e38 where no ray enters before its
//   t_max), then by variant:
//     kV1  the slab test only: writes 3e38 / 0;
//     kV2  intersects clusters 0..15 by index, in a loop unrolled kUnroll
//          times (v2 = 1, v2u = 16, v2u8 = 8);
//     kV3  per step also takes e's argmin (lowest index on ties) and masks
//          it to 3e38, but still intersects cluster ``step``;
//     kV4  intersects the argmin cluster itself (clamped to cpad - 1 and
//          to the pack's last row, as the JAX interpreter clamps a dynamic
//          index).
//   A ray keeps the minimum t over the visits; the lowest lane wins ties
//   within a slab and the earliest visit across slabs.
//
// Design: one CTA of 256 threads per octet.  The slab test gives each
// thread clusters tid, tid + 256, ...; e lives in shared memory.  A visit
// gives warp w ray w and each lane triangles lane, lane + 32, ...; the
// warp then takes the (t, lane) minimum with shuffles.  The argmin of
// kV3/kV4 is a CTA reduction over e (shuffles plus one shared-memory step).
// A guard that never fires keeps the slab test and the argmin chain live
// where no output reads them (kV1, kV3), so each variant costs what it
// names.
//
// Bound: the slab test (about 20 flops per ray x cluster, 8 x cpad per
// octet) and, in kV2-kV4, 16 x 8 x K ray x triangle tests per octet;
// kV3/kV4 add 16 CTA-wide reductions with barriers.
//
// Floating point: built with -fmad=false and without --use_fast_math, like
// the twin's elementwise torch ops.

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 3.0e38f;
constexpr float kBig = 3.0e37f;
constexpr int kThreads = 256;
constexpr int kVisits = 16;
enum Variant { kV1 = 1, kV2 = 2, kV3 = 3, kV4 = 4 };

template <int kVariant, int kUnroll>
__global__ void __launch_bounds__(kThreads) octet_bench_kernel(
    const int* __restrict__ nlive, const float* __restrict__ rays,
    const float* __restrict__ aabb, const float* __restrict__ pack,
    float* __restrict__ t_out, int* __restrict__ idx_out, int cpad, int K,
    int n_pack) {
  extern __shared__ float e[];        // cpad entry distances
  __shared__ float r8[8][8];          // the octet's rays
  __shared__ float inv_s[8][3], oinv_s[8][3];
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (r >= __ldg(nlive)) {
    if (tid < 8) {
      t_out[r * 8 + tid] = kInf;
      idx_out[r * 8 + tid] = 0;
    }
    return;
  }
  if (tid < 64)
    r8[tid >> 3][tid & 7] = rays[static_cast<size_t>(r) * 64 + tid];
  __syncthreads();
  if (tid < 24) {
    const int i = tid / 3, a = tid % 3;
    const float dv = r8[i][3 + a];
    const float sd = fabsf(dv) > 1e-30f ? dv : (dv >= 0.0f ? 1e-30f : -1e-30f);
    const float iv = 1.0f / sd;
    inv_s[i][a] = iv;
    oinv_s[i][a] = r8[i][a] * iv;
  }
  __syncthreads();

  // ---- the exact (8, cpad) slab test ----
  float guard = kInf;
  for (int c = tid; c < cpad; c += kThreads) {
    float lo[3], hi[3];
    for (int a = 0; a < 3; ++a) {
      lo[a] = __ldg(aabb + a * cpad + c);
      hi[a] = __ldg(aabb + (3 + a) * cpad + c);
    }
    float emin = kInf;
    for (int i = 0; i < 8; ++i) {
      float tn = -kBig, tf = kBig;
      for (int a = 0; a < 3; ++a) {
        const float t0 = lo[a] * inv_s[i][a] - oinv_s[i][a];
        const float t1 = hi[a] * inv_s[i][a] - oinv_s[i][a];
        tn = fmaxf(tn, fminf(t0, t1));
        tf = fminf(tf, fmaxf(t0, t1));
      }
      const float entry = fmaxf(tn, 0.0f);
      const bool ok = tf >= entry && entry <= r8[i][6];
      emin = fminf(emin, ok ? entry : kInf);
    }
    e[c] = emin;
    guard = fminf(guard, emin);
  }
  __syncthreads();

  float best_t = kInf;                // ray ``warp``, same in every lane
  int best_i = 0;
  int chain = 0;
  if (kVariant != kV1) {
    const float ox = r8[warp][0], oy = r8[warp][1], oz = r8[warp][2];
    const float dx = r8[warp][3], dy = r8[warp][4], dz = r8[warp][5];
    const float tmax = r8[warp][6];
    auto visit = [&](int cid) {
      const float* slab = pack + static_cast<size_t>(cid) * 16 * K;
      float tile_t = kInf;
      int tile_k = K;
      for (int l = lane; l < K; l += 32) {
        const float n0 = __ldg(slab + l), n1 = __ldg(slab + K + l);
        const float n2 = __ldg(slab + 2 * K + l);
        const float an = __ldg(slab + 3 * K + l);
        const float g10 = __ldg(slab + 4 * K + l);
        const float g11 = __ldg(slab + 5 * K + l);
        const float g12 = __ldg(slab + 6 * K + l);
        const float c1 = __ldg(slab + 7 * K + l);
        const float g20 = __ldg(slab + 8 * K + l);
        const float g21 = __ldg(slab + 9 * K + l);
        const float g22 = __ldg(slab + 10 * K + l);
        const float c2 = __ldg(slab + 11 * K + l);
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
          tile_k = l;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ot = __shfl_xor_sync(0xffffffffu, tile_t, off);
        const int ok = __shfl_xor_sync(0xffffffffu, tile_k, off);
        if (ot < tile_t || (ot == tile_t && ok < tile_k)) {
          tile_t = ot;
          tile_k = ok;
        }
      }
      if (tile_t < best_t) {
        best_t = tile_t;
        best_i = cid * K + tile_k;
      }
    };
    // argmin of e, lowest index on ties, then e[argmin] = 3e38
    auto take_argmin = [&]() -> int {
      float v = kInf;
      int i = cpad;
      for (int c = tid; c < cpad; c += kThreads) {
        const float x = e[c];
        if (x < v || (x == v && c < i)) {
          v = x;
          i = c;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, i, off);
        if (ov < v || (ov == v && oi < i)) {
          v = ov;
          i = oi;
        }
      }
      if (lane == 0) {
        red_v[warp] = v;
        red_i[warp] = i;
      }
      __syncthreads();
      v = red_v[0];
      i = red_i[0];
      for (int w = 1; w < kThreads / 32; ++w) {
        if (red_v[w] < v || (red_v[w] == v && red_i[w] < i)) {
          v = red_v[w];
          i = red_i[w];
        }
      }
      __syncthreads();                // everyone has read e and red_*
      if (tid == 0 && i < cpad) e[i] = kInf;
      __syncthreads();
      return i;
    };
    if (kVariant == kV2) {
#pragma unroll (kUnroll)
      for (int jg = 0; jg < kVisits; ++jg) visit(min(jg, n_pack - 1));
    } else {
      for (int jg = 0; jg < kVisits; ++jg) {
        const int cv = take_argmin();
        chain += cv;
        const int c = kVariant == kV4 ? min(min(cv, cpad - 1), n_pack - 1)
                                      : min(jg, n_pack - 1);
        visit(c);
      }
    }
  }
  if (lane == 0 && warp < 8) {
    t_out[r * 8 + warp] = best_t;
    idx_out[r * 8 + warp] = best_i;
  }
  // never true (entries are >= 0 or 3e38, argmins >= 0): keeps the slab
  // test and the argmin chain from being compiled away
  if (guard < -1.0f || chain < 0) idx_out[r * 8] = -1;
}

template <int kVariant, int kUnroll>
int launch(const int* nlive, const float* rays, const float* aabb,
           const float* pack, float* t_out, int* idx_out, int n_oct,
           int cpad, int K, int n_pack, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(cpad) * sizeof(float);
  auto kernel = octet_bench_kernel<kVariant, kUnroll>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<n_oct, kThreads, smem, stream>>>(nlive, rays, aabb, pack, t_out,
                                            idx_out, cpad, K, n_pack);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: 1 = v1, 2 = v2, 3 = v2u, 4 = v2u8, 5 = v3, 6 = v4.  Launch on
// ``stream``; returns cudaGetLastError() (0 = launched).
extern "C" int rr_octet_bench(int variant, const int* nlive,
                              const float* rays, const float* aabb,
                              const float* pack, float* t_out, int* idx_out,
                              int n_oct, int cpad, int K, int n_pack,
                              void* stream) {
  if (n_oct == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 1: return launch<kV1, 1>(nlive, rays, aabb, pack, t_out, idx_out,
                                  n_oct, cpad, K, n_pack, s);
    case 2: return launch<kV2, 1>(nlive, rays, aabb, pack, t_out, idx_out,
                                  n_oct, cpad, K, n_pack, s);
    case 3: return launch<kV2, 16>(nlive, rays, aabb, pack, t_out, idx_out,
                                   n_oct, cpad, K, n_pack, s);
    case 4: return launch<kV2, 8>(nlive, rays, aabb, pack, t_out, idx_out,
                                  n_oct, cpad, K, n_pack, s);
    case 5: return launch<kV3, 1>(nlive, rays, aabb, pack, t_out, idx_out,
                                  n_oct, cpad, K, n_pack, s);
    case 6: return launch<kV4, 1>(nlive, rays, aabb, pack, t_out, idx_out,
                                  n_oct, cpad, K, n_pack, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
