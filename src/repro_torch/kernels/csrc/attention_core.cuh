// The first design's core of the paged attention kernels, now used by
// paged_attention (#7, paged_attention.cu) alone -- the decode append and
// the suffix prefill moved to flash_paged.cuh, and #7 follows next --
// plus the helpers that every attention kernel shares (conversions, warp
// reductions, launch and dtype dispatch).  attend_rows: one CTA attends
// R query rows of one (sequence, kv head) through that sequence's block
// table with an online softmax in f32.
//
// Layouts (element offsets):
//   K pool (NB, BT, KVH, HD): ((blk * BT + t) * KVH + h) * HD + d
//   V pool rows:               ((blk * BT + t) * KVH + h) * VS + d, d < VD
//     VS is V's row stride: VD for a (NB, BT, KVH, VD) pool, HD when V is
//     the first VD lanes of the K pool's rows (MLA latent mode)
//   tables (B, MB) int32, NULL (-1) entries clamped to block 0 and
//   masked by the per-row key range [lo, hi).
//
// Shared memory, in floats: qs[R][HD] (q * scale), ps[R][BT] (scores,
// then probabilities of the current block), acc[R][VD], and per row
// m, l, alpha; lo/hi bounds as ints.  The CTA walks the table one block
// of BT tokens at a time:
//   1. scores: warp w takes tokens w, w + nwarps, ...; each lane reads a
//      strided slice of the K row once (coalesced across the warp) and
//      keeps R partial dot products, reduced by warp shuffles;
//   2. softmax: one warp per row updates (m, l) and turns scores into
//      probabilities;
//   3. values: thread d owns value column d and folds p[r][t] * V[t][d]
//      into acc[r][d] for all rows -- each V element is read once.
// Every K and V element of the visited blocks is read from device
// memory exactly once per CTA: the kernels are bound by those bytes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;
constexpr float kNeg = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

struct Smem {
  float* qs;     // [R][HD]
  float* ps;     // [R][BT]
  float* acc;    // [R][VD]
  float* m;      // [R]
  float* l;      // [R]
  float* alpha;  // [R]
  int* lo;       // [R] first valid key position
  int* hi;       // [R] one past the last valid key position
  float* kn;     // [HD] override K row (decode: the appended token)
  float* vn;     // [VD]
};

__host__ __device__ inline size_t smem_bytes(int R, int HD, int VD, int BT) {
  return sizeof(float) * ((size_t)R * (HD + BT + VD) + 3 * R + HD + VD) +
         sizeof(int) * 2 * R;
}

__device__ inline Smem carve(void* base, int R, int HD, int VD, int BT) {
  Smem s;
  float* f = reinterpret_cast<float*>(base);
  s.qs = f;             f += R * HD;
  s.ps = f;             f += R * BT;
  s.acc = f;            f += R * VD;
  s.m = f;              f += R;
  s.l = f;              f += R;
  s.alpha = f;          f += R;
  s.kn = f;             f += HD;
  s.vn = f;             f += VD;
  s.lo = reinterpret_cast<int*>(f);
  s.hi = s.lo + R;
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Attend the R rows staged in `s` (qs, lo, hi filled; m/l/acc are
// initialised here) over key positions [key_lo, key_hi), the union of
// the rows' ranges.  `pos_new` >= 0 names one position whose K/V row
// is taken from s.kn / s.vn instead of the pool (the decode kernel's
// freshly appended token: reading it back from the pool would race
// with other CTAs parked on the same sink block).
template <typename T>
__device__ void attend_rows(const Smem& s, int R, const T* __restrict__ k_pool,
                            const T* __restrict__ v_pool,
                            const int* __restrict__ table, int MB, int BT,
                            int KVH, int h, int HD, int VD, int VS, int key_lo,
                            int key_hi, int pos_new, float softcap) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < R * VD; i += kThreads) s.acc[i] = 0.f;
  for (int r = tid; r < R; r += kThreads) {
    s.m[r] = kNeg;
    s.l[r] = 0.f;
  }
  __syncthreads();
  if (key_hi <= key_lo) return;
  const int j0 = key_lo / BT;
  const int j1 = min((key_hi + BT - 1) / BT, MB);
  for (int j = j0; j < j1; ++j) {
    const int phys = max(table[j], 0);
    // 1. scores
    for (int t = warp; t < BT; t += kWarps) {
      const int pos = j * BT + t;
      float part[kMaxRows];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) part[r] = 0.f;
      const bool live = pos >= key_lo && pos < key_hi;
      if (live) {
        const T* krow = k_pool + ((size_t)(phys * BT + t) * KVH + h) * HD;
        for (int d = lane; d < HD; d += 32) {
          const float kd = (pos == pos_new) ? s.kn[d] : to_f(krow[d]);
#pragma unroll
          for (int r = 0; r < kMaxRows; ++r)
            if (r < R) part[r] += s.qs[r * HD + d] * kd;
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < R) {
          float v = warp_sum(part[r]);
          if (softcap > 0.f) v = softcap * tanhf(v / softcap);
          const bool ok = live && pos >= s.lo[r] && pos < s.hi[r];
          if (lane == r) s.ps[r * BT + t] = ok ? v : kNeg;
        }
      }
    }
    __syncthreads();
    // 2. online softmax, one warp per row
    for (int r = warp; r < R; r += kWarps) {
      float bmax = kNeg;
      for (int t = lane; t < BT; t += 32) bmax = fmaxf(bmax, s.ps[r * BT + t]);
      bmax = warp_max(bmax);
      const float m_old = s.m[r];
      const float m_new = fmaxf(m_old, bmax);
      float psum = 0.f;
      for (int t = lane; t < BT; t += 32) {
        const float x = s.ps[r * BT + t];
        const float p = (x <= kNeg) ? 0.f : expf(x - m_new);
        s.ps[r * BT + t] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float a = (m_old <= kNeg) ? 0.f : expf(m_old - m_new);
        s.alpha[r] = a;
        s.m[r] = m_new;
        s.l[r] = s.l[r] * a + psum;
      }
    }
    __syncthreads();
    // 3. values
    const int t_lo = max(key_lo - j * BT, 0);
    const int t_hi = min(key_hi - j * BT, BT);
    for (int d = tid; d < VD; d += kThreads) {
      float a[kMaxRows];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (r < R) a[r] = s.acc[r * VD + d] * s.alpha[r];
      for (int t = t_lo; t < t_hi; ++t) {
        const int pos = j * BT + t;
        const float vd = (pos == pos_new)
                             ? s.vn[d]
                             : to_f(v_pool[((size_t)(phys * BT + t) * KVH + h) * VS + d]);
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r)
          if (r < R) a[r] += s.ps[r * BT + t] * vd;
      }
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (r < R) s.acc[r * VD + d] = a[r];
    }
    __syncthreads();
  }
}

// Stores each row's normalised accumulator acc[r] / l[r] as O.  Row r
// goes to out + (r / G) * group_stride + (r % G) * VD: the G query heads
// of one position are contiguous and positions lie group_stride elements
// apart (decode holds one position per CTA: G = R).
template <typename O>
__device__ void store_rows(const Smem& s, int R, int VD, int G, size_t group_stride,
                           O* __restrict__ out) {
  for (int i = threadIdx.x; i < R * VD; i += kThreads) {
    const int r = i / VD, d = i - r * VD;
    out[(r / G) * group_stride + (size_t)(r % G) * VD + d] =
        from_f<O>(s.acc[i] / fmaxf(s.l[r], 1e-30f));
  }
}

// Host side.  Launches `kern` on grid x kThreads with `smem` bytes of
// dynamic shared memory, opting in above the default 48 KB (HD = 288
// needs more).  Returns the launch's cudaError_t (0 on success); the
// kernel runs on `stream` asynchronously.
template <typename... P, typename... A>
int launch(void (*kern)(P...), dim3 grid, size_t smem, cudaStream_t stream,
           A... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T> struct Type { using type = T; };

// Calls fn(Type<T>()) with the element type of dtype code 0 (float32) or
// 1 (bfloat16); any other code is refused.
template <typename Fn> int dispatch(int dtype, Fn&& fn) {
  if (dtype == 0) return fn(Type<float>());
  if (dtype == 1) return fn(Type<__nv_bfloat16>());
  return (int)cudaErrorInvalidValue;
}

}  // namespace rt
