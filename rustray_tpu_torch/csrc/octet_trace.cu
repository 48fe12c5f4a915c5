// Octet rounds: the two kernels of one octet round-trace slice, with the
// cluster selection fused in, for Hopper (sm_90a).
//
// Replaces: rustray_tpu/ops/octet_trace.py::_make_kernel (K3), the Pallas
// TPU kernel that _run_round drives, together with the XLA selection that
// _trace_slice runs around it (the (N/8, C) entry matrix, the round-0
// argmin, the need filter and the four round-1 argmins).  The JAX design
// keeps selection out of its kernel for TPU reasons only: a loop step costs
// about 430 ns there and a branch 70 ns.  On Hopper a warp does a min, a
// top-4 or the skip of an empty slot in a few instructions, so both rounds
// take their selection in.
//
// Contract, identical to the torch twins ops/octet_trace.py::_round0_twin
// (octet_entries -> round0_desc -> round_inputs -> _round_twin) and
// _round1_twin (round1_desc -> _round_twin -> merge):
//   o, d (n, 3) f32 dead-masked rays (a dead ray has t_max < 0), n = 8 No,
//   octet j = rays 8j..8j+7; t_max (n,) f32; w_lo, w_hi (C, 3) f32 world
//   cluster boxes; cl_ok (C,) u8; pack (R, 16, 128) f32 triangle slabs
//   (rows n0 n1 n2 a.n g1x g1y g1z c1 g2x g2y g2z c2, 4 zero rows); dummy
//   the pack's all-zero last row.
//   round 0 -> e (No, C) f32, per octet and cluster the minimum over the
//     octet's rays of the exact slab entry (3e38 unless the ray enters
//     before its t_max and the cluster is ok); c0 (No,) i32, the row's
//     argmin (lowest id on ties, 0 for a row of 3e38); t (n,) f32 and idx
//     (n,) i32 = c0*128 + lane of each ray's nearest hit in slab c0 (3e38
//     and 0 on a miss or a row of 3e38).
//   round 1 (any_mode 0 or 1) -> need_o per octet, the maximum over its
//     rays of (any: -3e37 once t < 3e38, else t_max; closest: min(t,
//     t_max)), then * 1.0001 and + 1e-3, each rounded; the clusters left
//     are those other than c0 with e <= need_o; remaining (No,) i32 counts
//     them, slots (No, 4) i32 are the first four by (entry, id) and dummy
//     past them, over (No,) u8 = remaining > 4; each ray folds its slots'
//     nearest hits in slot order into its round-0 hit, strictly nearer
//     only: t (n,), idx (n,).  Within a slab the lowest lane wins ties.
//   Round 1 takes e as round 0 wrote it: a row whose 8 rays are all dead
//   holds 3e38 only, so that row's octet is skipped.
//
// Design: one warp per octet, 256-thread CTAs on a persistent grid.
//   round0_kernel.  The CTA stages the cluster boxes in shared memory once
//   (structure of arrays, 24 bytes a cluster; in chunks of 4,096 when C is
//   larger).  A cluster that is not ok gets a NaN lo.x: the NaN-propagating
//   min/max carry it into the entry, and a NaN entry fails the ok test, as
//   in the twin, so the loop never reads cl_ok.  Each lane holds the
//   octet's 8 rays (inv, o*inv, t_max) and strides over the clusters
//   (c = lane + 32 j): the 8-ray entry in the twin's operation order, the e
//   row written coalesced, and the lane's own (entry, c) minimum.  A
//   shuffle butterfly gives the row's lexicographic minimum c0.  The lanes
//   then split slab c0's 128 triangles, 4 each (float4 reads of its 12 rows,
//   coalesced), and each ray's (t, lane) minimum is reduced over the warp.
//   An octet whose 8 rays are all dead writes a 3e38 row and skips the
//   work (a warp-uniform branch).
//   round1_kernel.  Each warp reads its octet's e row coalesced, filters
//   it, counts what is left, keeps a per-lane top 4 by (entry, id) (ids
//   ascend within a lane, so a strict '<' keeps the lower id first) and
//   merges the 32 lists with 4 butterfly minima: the global first four lie
//   within the lanes' first fours, so the slots equal four repeated
//   argmin-and-mask passes.  Non-empty slots are tested in slot order; each
//   slab is staged in the warp's shared memory with cp.async while the
//   previous slot's tests run.  Empty slots cost nothing.
//   e is written by round 0 and read by round 1 (42.5 MB each way per
//   32,768-ray slice of the bench scene's 2,593 clusters, about 13 us at
//   3.35 TB/s), not recomputed in round 1 (about 2.2 G FP32 operations,
//   33 us at 67 TFLOP/s).
//
// Bound: FP32 work.  Round 0: 26 operations per ray x cluster entry (6
// products, 6 differences, 6 min/max per axis, 4 to fold the axes, the
// clamp, 2 comparisons, the octet minimum) over the live octets, and 31
// per ray x triangle test (d.n 5, o.n 5, the subtraction and division 2,
// the hit point 6, u 6, v 6, u+v 1) in slab c0; round 1: 3 per entry of a
// live octet's row and 31 per test of its non-empty slots.  Bytes: the
// boxes, the rays, the e row written and read, the named slabs' 12 rows
// and the outputs.  chip_smoke.py phase 3 prints both per launch.
// Tensor cores do not apply: the work is exact f32 comparisons, and no
// test sums products into an accumulator that an MMA could take.
//
// Floating point: built with -fmad=false and without --use_fast_math, so
// every product, sum and the divisions 1/d and (a.n - o.n) / d.n round as
// IEEE f32 in the JAX package's operation order, exactly like the
// elementwise torch twins; the min/max are the NaN-propagating PTX forms,
// like torch.minimum/maximum.

#include <cuda_runtime.h>

namespace {

constexpr int kK = 128;               // triangles per slab
constexpr int kRows = 12;             // slab rows the test reads
constexpr int kSlab = kRows * kK;     // floats staged per slab (6,144 B)
constexpr int kSlots = 4;             // round-1 clusters per octet
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4096;          // clusters staged at once (96 KB)
constexpr float kInf = 3.0e38f;
constexpr float kBig = 3.0e37f;
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

// One ray against triangle k; strict '<' keeps the lowest k on ties.
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

// The nearest hit of one ray (r: ox oy oz dx dy dz t_max) among the 128
// triangles the warp holds (this lane: 4*lane .. 4*lane+3), as (t, lane of
// the slab), the same on every lane; (3e38, 0) on a miss.
__device__ __forceinline__ void warp_slab_hit(const float4 (&s)[kRows],
                                              const float* r, int lane,
                                              float& t, int& k) {
  t = kInf;
  k = 0;
#define RR_TEST(c, dk)                                                      \
  test_tri(r[0], r[1], r[2], r[3], r[4], r[5], r[6], s[0].c, s[1].c,        \
           s[2].c, s[3].c, s[4].c, s[5].c, s[6].c, s[7].c, s[8].c, s[9].c,  \
           s[10].c, s[11].c, 4 * lane + dk, t, k)
  RR_TEST(x, 0);
  RR_TEST(y, 1);
  RR_TEST(z, 2);
  RR_TEST(w, 3);
#undef RR_TEST
  warp_lex_min(t, k);
}

// Stage rays 8*oc .. 8*oc+7 as rows [ox oy oz dx dy dz t_max pad] into
// ``sr`` (lanes 0-7, one ray each), then sync the warp.
__device__ __forceinline__ void stage_rays(float* sr, const float* o,
                                           const float* d, const float* tmax,
                                           int oc, int lane) {
  if (lane < 8) {
    const size_t r = static_cast<size_t>(oc) * 8 + lane;
    sr[lane * 8 + 0] = __ldg(o + r * 3 + 0);
    sr[lane * 8 + 1] = __ldg(o + r * 3 + 1);
    sr[lane * 8 + 2] = __ldg(o + r * 3 + 2);
    sr[lane * 8 + 3] = __ldg(d + r * 3 + 0);
    sr[lane * 8 + 4] = __ldg(d + r * 3 + 1);
    sr[lane * 8 + 5] = __ldg(d + r * 3 + 2);
    sr[lane * 8 + 6] = __ldg(tmax + r);
  }
  __syncwarp();
}

// True (on every lane) when any of the octet's rays has t_max >= 0.
__device__ __forceinline__ bool octet_live(const float* tmax, int oc,
                                           int lane) {
  const bool live =
      lane < 8 && __ldg(tmax + static_cast<size_t>(oc) * 8 + lane) >= 0.0f;
  return __any_sync(kAll, live);
}

// Slab entry of ray (inv, oinv, tm) into the staged box c of a chunk of
// ``cc`` clusters: 3e38 unless the ray enters before its t_max (a NaN from
// a poisoned box fails the test).
__device__ __forceinline__ float entry_of(const float* bx, int cc, int c,
                                          float ix, float iy, float iz,
                                          float ox, float oy, float oz,
                                          float tm) {
  const float t0x = bx[c] * ix - ox, t1x = bx[3 * cc + c] * ix - ox;
  const float t0y = bx[cc + c] * iy - oy, t1y = bx[4 * cc + c] * iy - oy;
  const float t0z = bx[2 * cc + c] * iz - oz, t1z = bx[5 * cc + c] * iz - oz;
  float tn = min_nan(t0x, t1x);
  float tf = max_nan(t0x, t1x);
  tn = max_nan(tn, min_nan(t0y, t1y));
  tf = min_nan(tf, max_nan(t0y, t1y));
  tn = max_nan(tn, min_nan(t0z, t1z));
  tf = min_nan(tf, max_nan(t0z, t1z));
  const float entry = max_nan(tn, 0.0f);
  return (tf >= entry && entry <= tm) ? entry : kInf;
}

// Two CTAs per SM: the register cap (128) costs a small spill but runs
// faster than one CTA of 138 registers (PERF.md, Findings).
__global__ void __launch_bounds__(kThreads, 2) round0_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmax, const float* __restrict__ w_lo,
    const float* __restrict__ w_hi, const unsigned char* __restrict__ cl_ok,
    const float* __restrict__ pack, float* __restrict__ e_out,
    int* __restrict__ c0_out, float* __restrict__ t_out,
    int* __restrict__ idx_out, int no, int C) {
  extern __shared__ __align__(16) float bx[];        // [6][chunk]
  __shared__ float srays[kWarps][64];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk = min(C, kChunk);
  const int groups = (no + kWarps - 1) / kWarps;
  float* sr = srays[warp];
  int staged = -1;                                   // chunk start staged
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int oc = g * kWarps + warp;
    const bool live = oc < no && octet_live(tmax, oc, lane);   // warp-uniform
    float ix[8], iy[8], iz[8], oix[8], oiy[8], oiz[8], tm[8];
    if (live) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const size_t r = static_cast<size_t>(oc) * 8 + i;
        float dv[3], ov[3], inv[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          dv[a] = __ldg(d + r * 3 + a);
          ov[a] = __ldg(o + r * 3 + a);
          const float sd = fabsf(dv[a]) > 1e-30f
                               ? dv[a]
                               : (dv[a] >= 0.0f ? 1e-30f : -1e-30f);
          inv[a] = 1.0f / sd;
        }
        ix[i] = inv[0];
        iy[i] = inv[1];
        iz[i] = inv[2];
        oix[i] = ov[0] * inv[0];
        oiy[i] = ov[1] * inv[1];
        oiz[i] = ov[2] * inv[2];
        tm[i] = __ldg(tmax + r);
      }
    }
    float best = kInf;
    int best_c = 0;
    for (int base = 0; base < C; base += chunk) {
      const int cc = min(chunk, C - base);
      if (staged != base) {                          // CTA-uniform
        __syncthreads();
        for (int c = threadIdx.x; c < cc; c += kThreads) {
          const int gc = base + c;
          bx[c] = cl_ok[gc] ? __ldg(w_lo + gc * 3 + 0) : __int_as_float(
              0x7fffffff);
          bx[chunk + c] = __ldg(w_lo + gc * 3 + 1);
          bx[2 * chunk + c] = __ldg(w_lo + gc * 3 + 2);
          bx[3 * chunk + c] = __ldg(w_hi + gc * 3 + 0);
          bx[4 * chunk + c] = __ldg(w_hi + gc * 3 + 1);
          bx[5 * chunk + c] = __ldg(w_hi + gc * 3 + 2);
        }
        __syncthreads();
        staged = base;
      }
      if (!live) continue;
      float* erow = e_out + static_cast<size_t>(oc) * C + base;
      for (int c = lane; c < cc; c += 32) {
        float m = kInf;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          m = fminf(m, entry_of(bx, chunk, c, ix[i], iy[i], iz[i], oix[i],
                                oiy[i], oiz[i], tm[i]));
        erow[c] = m;
        if (m < best) {                              // lowest c on ties
          best = m;
          best_c = base + c;
        }
      }
    }
    if (oc >= no) continue;
    float* erow = e_out + static_cast<size_t>(oc) * C;
    const size_t r0 = static_cast<size_t>(oc) * 8;
    if (!live) {
      for (int c = lane; c < C; c += 32) erow[c] = kInf;
      if (lane == 0) c0_out[oc] = 0;
      if (lane < 8) {
        t_out[r0 + lane] = kInf;
        idx_out[r0 + lane] = 0;
      }
      continue;
    }
    warp_lex_min(best, best_c);
    float my_t = kInf;
    int my_i = 0;
    if (best < kInf) {                               // warp-uniform
      const float* slab = pack + static_cast<size_t>(best_c) * 16 * kK;
      float4 s[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        s[i] = __ldg(reinterpret_cast<const float4*>(slab + i * kK) + lane);
      stage_rays(sr, o, d, tmax, oc, lane);
#pragma unroll 1
      for (int i = 0; i < 8; ++i) {
        float t;
        int k;
        warp_slab_hit(s, sr + i * 8, lane, t, k);
        if (lane == i && t < kInf) {
          my_t = t;
          my_i = best_c * kK + k;
        }
      }
      __syncwarp();                                  // sr free
    }
    if (lane == 0) c0_out[oc] = best_c;
    if (lane < 8) {
      t_out[r0 + lane] = my_t;
      idx_out[r0 + lane] = my_i;
    }
  }
}

// Stage slab ``cid``'s 12 rows into ``dst``: each lane copies (and later
// reads back) its own 4 triangles of each row; one commit group.
__device__ __forceinline__ void stage_slab(float* dst,
                                           const float* __restrict__ pack,
                                           int cid, int lane) {
  const float* src = pack + static_cast<size_t>(cid) * 16 * kK;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    cp_async16(dst + i * kK + 4 * lane, src + i * kK + 4 * lane);
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads) round1_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmax, const float* __restrict__ e,
    const int* __restrict__ c0_in, const float* __restrict__ t_in,
    const int* __restrict__ idx_in, const float* __restrict__ pack,
    float* __restrict__ t_out, int* __restrict__ idx_out,
    int* __restrict__ slots_out, int* __restrict__ rem_out,
    unsigned char* __restrict__ over_out, int no, int C, int any_mode,
    int dummy) {
  extern __shared__ __align__(16) float smem[];      // [kWarps][2][kSlab]
  __shared__ float srays[kWarps][64];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* bufs = smem + warp * 2 * kSlab;
  float* sr = srays[warp];
  for (int oc = blockIdx.x * kWarps + warp; oc < no;
       oc += gridDim.x * kWarps) {
    const size_t r0 = static_cast<size_t>(oc) * 8;
    // lanes 0-7: their ray's round-0 hit, which the slots fold into
    float my_t = kInf;
    int my_i = 0;
    float need = -kInf;
    if (lane < 8) {
      my_t = __ldg(t_in + r0 + lane);
      my_i = __ldg(idx_in + r0 + lane);
      const float tm = __ldg(tmax + r0 + lane);
      need = any_mode ? (my_t < kInf ? -kBig : tm) : fminf(my_t, tm);
    }
    const bool live = octet_live(tmax, oc, lane);    // warp-uniform
    int slot[kSlots] = {dummy, dummy, dummy, dummy};
    int remaining = 0;
    if (live) {
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)          // over lanes 0-7
        need = fmaxf(need, __shfl_xor_sync(kAll, need, off));
      need = __shfl_sync(kAll, need, 0);
      need = need * 1.0001f;
      need = need + 1e-3f;
      const int c0 = __ldg(c0_in + oc);
      const float* erow = e + static_cast<size_t>(oc) * C;
      float v0 = kInf, v1 = kInf, v2 = kInf, v3 = kInf;
      int i0 = 0, i1 = 0, i2 = 0, i3 = 0;
      int cnt = 0;
      for (int c = lane; c < C; c += 32) {
        float v = __ldg(erow + c);
        if (c == c0 || !(v <= need)) v = kInf;
        cnt += v < kInf;
        if (v < v3) {                                // strict: lower id first
          if (v < v0) {
            v3 = v2; i3 = i2; v2 = v1; i2 = i1; v1 = v0; i1 = i0;
            v0 = v; i0 = c;
          } else if (v < v1) {
            v3 = v2; i3 = i2; v2 = v1; i2 = i1;
            v1 = v; i1 = c;
          } else if (v < v2) {
            v3 = v2; i3 = i2;
            v2 = v; i2 = c;
          } else {
            v3 = v; i3 = c;
          }
        }
      }
      remaining = __reduce_add_sync(kAll, cnt);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        float wv = v0;
        int wi = i0;
        warp_lex_min(wv, wi);
        if (wv < kInf) {                             // warp-uniform
          slot[s] = wi;
          if (v0 == wv && i0 == wi) {                // the owner pops
            v0 = v1; i0 = i1; v1 = v2; i1 = i2; v2 = v3; i2 = i3;
            v3 = kInf; i3 = 0;
          }
        }
      }
      // the slots are filled in order: the first dummy ends them
      if (slot[0] != dummy) {                        // warp-uniform
        stage_rays(sr, o, d, tmax, oc, lane);
        stage_slab(bufs, pack, slot[0], lane);
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          if (slot[s] == dummy) break;
          if (s + 1 < kSlots && slot[s + 1] != dummy)
            stage_slab(bufs + ((s + 1) & 1) * kSlab, pack, slot[s + 1], lane);
          else
            cp_async_commit();                       // keep one per step
          cp_async_wait<1>();                        // slot s has landed
          const float* b = bufs + (s & 1) * kSlab;
          float4 sl[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            sl[i] = *reinterpret_cast<const float4*>(b + i * kK + 4 * lane);
          const int cid = slot[s];
#pragma unroll 1
          for (int i = 0; i < 8; ++i) {
            float t;
            int k;
            warp_slab_hit(sl, sr + i * 8, lane, t, k);
            if (lane == i && t < my_t) {             // earliest slot on ties
              my_t = t;
              my_i = cid * kK + k;
            }
          }
        }
        cp_async_wait<0>();
        __syncwarp();                                // sr free
      }
    }
    if (lane < 8) {
      t_out[r0 + lane] = my_t;
      idx_out[r0 + lane] = my_i;
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      if (lane == s) slots_out[static_cast<size_t>(oc) * kSlots + s] = slot[s];
    if (lane == 0) {
      rem_out[oc] = remaining;
      over_out[oc] = remaining > kSlots;
    }
  }
}

// Persistent grid: CTAs per SM from the occupancy at ``smem`` bytes, times
// the SMs, at most ``ctas``.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t smem, int ctas, int* grid) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, smem);
  if (e != cudaSuccess) return e;
  *grid = min(ctas, sms * (per_sm > 0 ? per_sm : 1));
  return cudaSuccess;
}

}  // namespace

// Round 0 on ``stream``; returns cudaGetLastError() (0 = launched).
extern "C" int rr_octet_round0(const float* o, const float* d,
                               const float* tmax, const float* w_lo,
                               const float* w_hi, const unsigned char* cl_ok,
                               const float* pack, float* e, int* c0,
                               float* t, int* idx, int no, int C,
                               void* stream) {
  if (no == 0) return 0;
  if (C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 6 * static_cast<size_t>(min(C, kChunk)) * sizeof(float);
  int grid = 0;
  cudaError_t err = persistent_grid(round0_kernel, smem,
                                    (no + kWarps - 1) / kWarps, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  round0_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      o, d, tmax, w_lo, w_hi, cl_ok, pack, e, c0, t, idx, no, C);
  return static_cast<int>(cudaGetLastError());
}

// Round 1 on ``stream``; returns cudaGetLastError() (0 = launched).
extern "C" int rr_octet_round1(const float* o, const float* d,
                               const float* tmax, const float* e,
                               const int* c0, const float* t_in,
                               const int* idx_in, const float* pack,
                               float* t, int* idx, int* slots,
                               int* remaining, unsigned char* over, int no,
                               int C, int any_mode, int dummy, void* stream) {
  if (no == 0) return 0;
  if (C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kWarps * 2 * kSlab * sizeof(float);
  int grid = 0;
  cudaError_t err = persistent_grid(round1_kernel, smem,
                                    (no + kWarps - 1) / kWarps, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  round1_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      o, d, tmax, e, c0, t_in, idx_in, pack, t, idx, slots, remaining, over,
      no, C, any_mode, dummy);
  return static_cast<int>(cudaGetLastError());
}
