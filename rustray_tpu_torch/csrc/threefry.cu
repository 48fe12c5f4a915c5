// Threefry-2x32 on the card: the hash behind rng.fold_in and rng.uniform,
// with the bits of jax.random (threefry_partitionable), for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package draws its Monte-Carlo
// numbers with jax.random, which XLA compiles to fused 32-bit integer code.
// The port's plain twin (rng.py) carries the uint32 words in int64 tensors:
// each rotate is two shifts, an or and a mask, so one fold_in launched about
// 180 elementwise kernels and one uniform about 185, some 900 a wavefront
// level, most of the kernels a replayed frame launched.
//
// Contract: a key is two uint32 words held in int64 memory (only the low 32
// bits of each are read, as the twin masks them).  The key words are always
// read from device memory, never taken as launch arguments, so a captured
// CUDA graph draws from the key in its input buffer, which each replay
// rewrites.  The one exception is rr_threefry_uniform with null word
// pointers, where the words come as arguments: the eager path whose key
// folded on the host (its wrapper refuses it under stream capture).
//   threefry_fold_in_kernel, one thread: out[0..1] = threefry(key, (0, d))
//   as int64, d the fold datum, from a device int64 or an argument (17, 23
//   and a level's depth are constants of a captured program).
//   threefry_uniform_kernel: out[i] for i in [0, n) is the float32 in
//   [0, 1) whose mantissa is the top 23 bits of y0 ^ y1, (y0, y1) =
//   threefry(key, (i >> 32, i & 0xFFFFFFFF)) for the 64-bit counter i, then
//   clamped at 0 as the twin clamps.
//
// Bound: integer operations.  One element is 20 rounds of add, rotate (one
// funnel shift) and xor, 5 key injections of two adds, the counter's two
// initial adds, and the xor, shift, or, subtract and clamp of the float:
// about 80 32-bit operations, against a 4-byte store.  The adds may run
// as IMAD on the FMA pipe (nvcc puts most of them there: per element about
// 25 IMAD beside 20 SHF, 21 LOP3, 4 IADD3 and 2 LEA in the SASS), but the
// 20 funnel shifts, the 20 xors and the float's xor, shift and clamp, 43
// operations, run only on the integer pipe: 64 lanes an SM, 16.7 T ops/s
// over 132 SMs at 1.98 GHz, 2.6 ps an element, above the store's 1.2 ps at
// 3.35 TB/s: bound = max(43 n / 16.7e12, 4 n / 3.35e12) s.  Design: each
// thread hashes kVec consecutive counters (independent chains, so the
// integer pipes stay fed) and writes them with one 16-byte store; a
// grid-stride loop covers any n, the ragged last group stored element by
// element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr long long kMaxBlocks = 132 * 16;
constexpr uint32_t kParity = 0x1BD11BDAu;

struct Key {
  uint32_t k0, k1, k2;
};

__device__ __forceinline__ Key make_key(uint32_t k0, uint32_t k1) {
  return Key{k0, k1, k0 ^ k1 ^ kParity};
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

// rng.threefry2x32: 20 rounds, a key injection after every 4
__device__ __forceinline__ void threefry(const Key& k, uint32_t& x0,
                                         uint32_t& x1) {
  x0 += k.k0; x1 += k.k1;
  rounds<13, 15, 26, 6>(x0, x1);  x0 += k.k1; x1 += k.k2 + 1u;
  rounds<17, 29, 16, 24>(x0, x1); x0 += k.k2; x1 += k.k0 + 2u;
  rounds<13, 15, 26, 6>(x0, x1);  x0 += k.k0; x1 += k.k1 + 3u;
  rounds<17, 29, 16, 24>(x0, x1); x0 += k.k1; x1 += k.k2 + 4u;
  rounds<13, 15, 26, 6>(x0, x1);  x0 += k.k2; x1 += k.k0 + 5u;
}

__device__ __forceinline__ float draw(const Key& k, unsigned long long i) {
  uint32_t x0 = static_cast<uint32_t>(i >> 32);
  uint32_t x1 = static_cast<uint32_t>(i);
  threefry(k, x0, x1);
  const float f = __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
  return fmaxf(f, 0.0f);
}

__global__ void threefry_fold_in_kernel(const long long* __restrict__ w0,
                                        const long long* __restrict__ w1,
                                        const long long* __restrict__ data,
                                        uint32_t datum,
                                        long long* __restrict__ out) {
  const Key k = make_key(static_cast<uint32_t>(*w0),
                         static_cast<uint32_t>(*w1));
  uint32_t x0 = 0u;
  uint32_t x1 = data ? static_cast<uint32_t>(*data) : datum;
  threefry(k, x0, x1);
  out[0] = static_cast<long long>(x0);
  out[1] = static_cast<long long>(x1);
}

__global__ void __launch_bounds__(kThreads) threefry_uniform_kernel(
    const long long* __restrict__ w0, const long long* __restrict__ w1,
    uint32_t i0, uint32_t i1, float* __restrict__ out, long long n) {
  const Key k = w0 ? make_key(static_cast<uint32_t>(*w0),
                              static_cast<uint32_t>(*w1))
                   : make_key(i0, i1);
  const long long groups = (n + kVec - 1) / kVec;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       g < groups; g += stride) {
    const long long i = g * kVec;
    float v[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      v[j] = draw(k, static_cast<unsigned long long>(i + j));
    if (i + kVec <= n) {
      *reinterpret_cast<float4*>(out + i) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        if (i + j < n) out[i + j] = v[j];
    }
  }
}

}  // namespace

// fold_in: the key's words at w0 and w1 (int64), the datum at data (int64)
// or, where data is null, the argument datum; out two int64 words.
extern "C" int rr_threefry_fold_in(const long long* w0, const long long* w1,
                                   const long long* data, unsigned datum,
                                   long long* out, void* stream) {
  if (w0 == nullptr || w1 == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  threefry_fold_in_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      w0, w1, data, datum, out);
  return static_cast<int>(cudaGetLastError());
}

// uniform: n floats into out (16-byte aligned) under the key's words at w0
// and w1 (int64) or, where both are null, the argument words k0 and k1.
extern "C" int rr_threefry_uniform(const long long* w0, const long long* w1,
                                   unsigned k0, unsigned k1, float* out,
                                   long long n, void* stream) {
  if (n == 0) return 0;
  if (n < 0 || out == nullptr || (w0 == nullptr) != (w1 == nullptr) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = (n + kVec - 1) / kVec;
  const long long blocks_needed = (groups + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(
      blocks_needed < kMaxBlocks ? blocks_needed : kMaxBlocks);
  threefry_uniform_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      w0, w1, k0, k1, out, n);
  return static_cast<int>(cudaGetLastError());
}
