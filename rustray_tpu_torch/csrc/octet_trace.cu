// Octet round: a branch-free slot stream of (octet, cluster) ray x
// triangle tests, for Hopper (sm_90a).
//
// Replaces: rustray_tpu/ops/octet_trace.py::_make_kernel, the Pallas TPU
// kernel that _run_round drives.  Contract, identical to that kernel and to
// the torch twin ops/octet_trace.py::_round_twin:
//   flags (steps,) i32, 0 = the row has no live slot; rays (n_rows, 8) f32
//   rows [ox oy oz dx dy dz t_max pad], n_rows = steps * (128/slots) * 8;
//   desc (steps, 128) i32, each row 128/slots octets x ``slots`` cluster
//   ids (empty slots name the pack's all-zero last row, a guaranteed
//   miss); pack (C, 16, K) f32 triangle slabs (rows n0 n1 n2 a.n g1x g1y
//   g1z c1 g2x g2y g2z c2, 4 zero rows).
//   Out: t (n_rows,) f32, 3e38 on miss; idx (n_rows,) i32 = cid*K + lane.
//   Per ray: the minimum t over all its octet's slots; the lowest lane wins
//   ties within a slab and the earliest slot across slabs.  A row whose
//   flag is 0 writes 3e38 / 0.
//
// Design (the simple one): one CTA per descriptor row and one thread per
// ray, so 1,024 threads (128 octets) at slots = 1 and 256 threads (32
// octets) at slots = 4.  Each thread walks its octet's slots in order and
// reads each slab through the read-only data path; the 8 threads of an
// octet read the same words, so a warp touches 4 slabs at a time.  Every
// output row is written, including the padded tail, whose all-zero rays
// give d.n = 0 and miss.
//
// Bound: FP32 ALU work (about 30 flops per ray x triangle test) and L1
// traffic of the slab words; the bench pack (about 21 MB) sits in the 50 MB
// L2.  Shared-memory staging of the slabs, wgmma and TMA are later work.
//
// Floating point: built with -fmad=false and without --use_fast_math, so
// the products, sums and the division t = (a.n - o.n) / d.n round as IEEE
// f32 in the JAX package's operation order, like the elementwise twin.

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 3.0e38f;

__global__ void __launch_bounds__(1024) octet_round_kernel(
    const int* __restrict__ flags, const float* __restrict__ rays,
    const int* __restrict__ desc, const float* __restrict__ pack,
    float* __restrict__ t_out, int* __restrict__ idx_out, int slots,
    int K) {
  const int s = blockIdx.x;
  const int tid = threadIdx.x;              // ray within the row
  const int opr = 128 / slots;              // octets per row
  const size_t row = static_cast<size_t>(s) * opr * 8 + tid;
  float best_t = kInf;
  int best_i = 0;
  if (__ldg(flags + s) > 0) {
    const float* ray = rays + row * 8;
    const float ox = __ldg(ray + 0), oy = __ldg(ray + 1), oz = __ldg(ray + 2);
    const float dx = __ldg(ray + 3), dy = __ldg(ray + 4), dz = __ldg(ray + 5);
    const float tmax = __ldg(ray + 6);
    const int* dsc = desc + static_cast<size_t>(s) * 128 + (tid >> 3) * slots;
    for (int k = 0; k < slots; ++k) {
      const int cid = __ldg(dsc + k);
      const float* slab = pack + static_cast<size_t>(cid) * 16 * K;
      float tile_t = kInf;
      int tile_k = 0;
      for (int l = 0; l < K; ++l) {
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
      if (tile_t < best_t) {                // earliest slot wins ties
        best_t = tile_t;
        best_i = cid * K + tile_k;
      }
    }
  }
  t_out[row] = best_t;
  idx_out[row] = best_i;
}

}  // namespace

// Launch on ``stream``; returns cudaGetLastError() (0 = launched).
extern "C" int rr_octet_round(const int* flags, const float* rays,
                              const int* desc, const float* pack,
                              float* t_out, int* idx_out, int steps,
                              int slots, int K, void* stream) {
  if (steps == 0) return 0;
  if (slots <= 0 || 128 % slots != 0) return static_cast<int>(
      cudaErrorInvalidValue);
  const int threads = 128 / slots * 8;
  octet_round_kernel<<<steps, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      flags, rays, desc, pack, t_out, idx_out, slots, K);
  return static_cast<int>(cudaGetLastError());
}
