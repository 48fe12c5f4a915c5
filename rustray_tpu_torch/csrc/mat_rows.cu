// Material rows: the backward of the per-ray material-row gather of
// ops/traverse.py::hit_attributes, for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package gathers each ray's row of the
// (M, 16) f32 material table with an XLA gather and leaves its transpose,
// a scatter-add, to XLA.  In the port, autograd turned the gather's
// backward into index_put_ with accumulate, which on CUDA sorts the indices
// and then walks each index's duplicates one after another
// (indexing_backward_kernel_small_stride): with a few dozen materials and
// millions of rays per level, most of them dead rays on material 0, a few
// warps ran serial sums while the rest of the card waited (21.5 s of a
// 23.9 s gradient step of the 1280x720 4-spp sponza frame).
//
// Contract: g (N, 16) f32 contiguous, mat (N,) i32; out (M, 16) f32 =
// zeros(M, 16).index_add_(0, mat, g), the rows of a material outside
// [0, M) dropped.  Deterministic: no float atomics, every sum taken in an
// order fixed by N and M alone, so two launches on the same input give the
// same bits.
//
// Design: two kernels.
//   mat_rows_kernel, grid (ctas, tiles): blockIdx.y selects a tile of
//   kTile materials; each of a CTA's 8 warps owns a contiguous range of
//   per_warp rays (a multiple of 32) and a private (kTile, 16) table in
//   shared memory.  Per group of 32 rays a warp loads the 32 materials
//   (one coalesced load, the next group's prefetched), takes a ballot of
//   the rays inside its tile, and loads only their rows: lane (h, c) reads
//   column c of ray 2j + h, so each load instruction covers two whole
//   64-byte rows and 16 loads per lane are in flight.  Lanes 0-15 then
//   apply the 32 rays in order, the odd ray's value shuffled down from
//   lane c + 16: a run of rays on one material is summed in a register
//   (Kahan-compensated, so a long run of one material keeps float64's
//   answer to about 1e-7) and added to the table only where the material
//   changes.  Lane c alone touches column c of its warp's table, so the
//   table needs no synchronisation until the CTA sums its 8 warps' tables
//   in warp order into its partial, (ctas, M, 16) in a scratch buffer.
//   mat_rows_sum_kernel: one warp per output entry sums the ctas partials,
//   lane l over partials l, l + 32, ... in order, then a fixed butterfly.
//
// Bound: bytes.  The least the function needs is N * (4 + 64) bytes read
// and M * 64 written (the partials add ctas * M * 64 written and read, at
// most 512 * M * 64): 35.7 MB at N = 524,288, 10.6 us at 3.35 TB/s.  Each
// further tile re-reads the materials (N * 4 bytes) but only its own rays'
// rows.  chip_smoke.py times it beside that bound, its plain twin
// (index_add_) and PyTorch's indexing backward on the same input.

#include <cuda_runtime.h>

namespace {

constexpr int kW = 16;          // floats per material row (MATF_W)
constexpr int kTile = 64;       // materials per tile (blockIdx.y)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 32;      // rays per warp step
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ int load_mat(const int* __restrict__ mat,
                                        long long r, long long end, int m0) {
  return r < end ? __ldg(mat + r) - m0 : -1;
}

__global__ void __launch_bounds__(kThreads) mat_rows_kernel(
    const float* __restrict__ g, const int* __restrict__ mat,
    float* __restrict__ partial, long long n, int m_count, int per_warp) {
  __shared__ float table[kWarps][kTile * kW];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = lane >> 4, col = lane & 15;
  const int m0 = blockIdx.y * kTile;
  const int mt = min(kTile, m_count - m0);
  float* mine = table[warp];
  for (int e = lane; e < mt * kW; e += 32) mine[e] = 0.0f;
  __syncwarp();

  const long long begin =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * per_warp;
  const long long end = min(n, begin + per_warp);
  int cur = -1;                  // the run's tile-relative material
  float acc = 0.0f, comp = 0.0f; // the run's sum and its Kahan compensation
  int mv_next = load_mat(mat, begin + lane, end, m0);
  for (long long base = begin; base < end; base += kGroup) {
    const int mv = mv_next;
    mv_next = load_mat(mat, base + kGroup + lane, end, m0);
    const bool in = static_cast<unsigned>(mv) < static_cast<unsigned>(mt);
    const unsigned live = __ballot_sync(kAll, in);
    if (live == 0) continue;
    float v[kGroup / 2];
#pragma unroll
    for (int j = 0; j < kGroup / 2; ++j) {
      const int src = 2 * j + half;
      v[j] = (live >> src) & 1u ? __ldg(g + (base + src) * kW + col) : 0.0f;
    }
    const bool same = __all_sync(kAll, !in || mv == cur);
#pragma unroll
    for (int j = 0; j < kGroup / 2; ++j) {
      const float odd = __shfl_down_sync(kAll, v[j], 16);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 2 * j + h;
        if (!((live >> k) & 1u)) continue;          // uniform over the warp
        const float val = h ? odd : v[j];
        const int m = same ? cur : __shfl_sync(kAll, mv, k);
        if (m != cur) {                             // uniform over the warp
          if (cur >= 0 && lane < kW) mine[cur * kW + col] += acc - comp;
          cur = m;
          acc = val;
          comp = 0.0f;
        } else {
          const float y = val - comp;
          const float t = acc + y;
          comp = (t - acc) - y;
          acc = t;
        }
      }
    }
  }
  if (cur >= 0 && lane < kW) mine[cur * kW + col] += acc - comp;
  __syncthreads();

  float* out = partial + (static_cast<size_t>(blockIdx.x) * m_count + m0) * kW;
  for (int e = tid; e < mt * kW; e += kThreads) {
    float s = table[0][e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += table[w][e];
    out[e] = s;
  }
}

__global__ void __launch_bounds__(kThreads) mat_rows_sum_kernel(
    const float* __restrict__ partial, float* __restrict__ out, int ctas,
    int entries) {
  const int e = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= entries) return;                         // a whole warp
  float s = 0.0f;
  for (int c = lane; c < ctas; c += 32)
    s += __ldg(partial + static_cast<size_t>(c) * entries + e);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kAll, s, off);
  if (lane == 0) out[e] = s;
}

}  // namespace

// out (m_count, 16) = the rows of g (n, 16) summed per material mat (n,),
// on ``stream``, through partial (ctas, m_count, 16) scratch.  The grid is
// (ctas, ceil(m_count / 64)) CTAs of 8 warps, each warp over per_warp rays
// (a multiple of 32, ctas * 8 * per_warp >= n); the caller derives both
// from n and m_count alone, so the sums' order, and so the bits, depend on
// nothing else.  Returns a cudaError_t.
extern "C" int rr_mat_rows(const float* g, const int* mat, float* partial,
                           float* out, long long n, int m_count, int ctas,
                           int per_warp, void* stream) {
  if (m_count == 0) return 0;
  if (n < 0 || m_count < 0 || ctas <= 0 || per_warp <= 0 ||
      per_warp % kGroup != 0 ||
      static_cast<long long>(ctas) * kWarps * per_warp < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(ctas, (m_count + kTile - 1) / kTile);
  mat_rows_kernel<<<grid, kThreads, 0, s>>>(g, mat, partial, n, m_count,
                                             per_warp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int entries = m_count * kW;
  mat_rows_sum_kernel<<<(entries + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      partial, out, ctas, entries);
  return static_cast<int>(cudaGetLastError());
}
