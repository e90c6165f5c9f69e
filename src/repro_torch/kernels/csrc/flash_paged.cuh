// Shared pieces of the paged attention kernels built for Hopper: the
// split-key decode append (#1, paged_append.cu), the tensor-core suffix
// prefill (#2, paged_prefill.cu) and the split-key decode without an
// append (#7, paged_attention.cu, absorbed MLA's kernel).
//
// What held the first design back (one CTA per (sequence, kv head, chunk
// of 16 query rows), since removed): it walked its row's blocks one
// after another, read K as 2-byte elements straight from device memory
// and V one dependent load after another per thread, so a call kept
// almost no loads in flight and waited on memory latency (~0.2 ms for
// 0.26 us of bytes at gemma-2b's decode shapes).  What this header gives
// instead:
//
// * stage_rows: a block's K or V tile (its rows of one kv head) is copied
//   into shared memory by the Tensor Memory Accelerator, one bulk copy
//   (cp.async.bulk) per key row, all of a tile's copies in flight at once
//   and completing on an mbarrier that counts their bytes.  Only the live
//   key rows are read from the pool; the rows around them that a kernel
//   multiplies by p = 0 are zero-filled by plain stores, the rest are not
//   touched; one row may be taken from a given vector instead (the
//   decode token being appended, which must not be read back from the
//   pool while another CTA writes it).  Threads spend one instruction per
//   row on the copies, where 16-byte cp.asyncs cost one per 16 bytes;
// * pipeline: walks blocks [j0, j1) with one or two stages -- with two,
//   the next block's copies are in flight while the current one is
//   computed;
// * merge_kernel: combines the float32 partials (m, l, acc) of a row's
//   key splits, and optionally one more term given as (score, value), by
//   the log-sum-exp rule (#1 and #7);
// * vectorised conversions from shared memory to float32.
//
// The kernels themselves split the work across CTAs (decode: the key
// range; prefill: tiles of query rows), see their files.
#pragma once

#include "attention_core.cuh"
#include "tma.cuh"

namespace fp {

// largest dynamic shared memory of one block on an H100
constexpr size_t kSmemLimit = 232448;

// Elements of T in one 16-byte vector.
template <typename T>
__host__ __device__ constexpr int vec_elems() { return 16 / (int)sizeof(T); }

// The 16/sizeof(T) elements at p (16-byte aligned shared memory) as floats.
__device__ __forceinline__ void load_vec(const float* p, float* f) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// Bytes that stage_rows copies in bulk: the rows of [t_lo, t_hi) but t_new.
__device__ __forceinline__ unsigned staged_bytes(int W, int es, int t_lo, int t_hi,
                                                 int t_new) {
  const int n = t_hi - t_lo - (t_new >= t_lo && t_new < t_hi ? 1 : 0);
  return (unsigned)(n * W * es);
}

// Stages rows [r_lo, r_hi) of one kv head's tile of block `phys` into
// dst (row stride DS elements): row t in [t_lo, t_hi) (a subset of
// [0, BT)) by a bulk copy of the first W elements of the pool row
// ((phys * BT + t) * KVH + h) * PS (PS >= W: the pool's row width)
// completing on `bar`; row t_new (if >= 0) from `row_new` by plain
// stores; every other row of [r_lo, r_hi) zero-filled; rows outside the
// range are left as they are.  The caller arrives on `bar` expecting
// staged_bytes(...) for this call.  W * sizeof(T) must be a multiple of
// 16, the pool and dst rows 16-byte aligned.
template <typename T>
__device__ void stage_rows(T* dst, int DS, const T* __restrict__ pool, int PS,
                           int phys, int BT, int KVH, int h, int W, int r_lo, int r_hi,
                           int t_lo, int t_hi, int t_new,
                           const T* __restrict__ row_new, uint64_t* bar) {
  constexpr int E = vec_elems<T>();
  const int tid = threadIdx.x, nt = blockDim.x;
  const T* base = pool + ((size_t)phys * BT * KVH + h) * PS;
  for (int t = t_lo + tid; t < t_hi; t += nt)
    if (t != t_new)
      bulk_copy(dst + (size_t)t * DS, base + (size_t)t * KVH * PS,
                (unsigned)(W * sizeof(T)), bar);
  bool wrote = false;
  if (t_new >= r_lo && t_new < r_hi) {
    for (int e = tid; e < W; e += nt) dst[(size_t)t_new * DS + e] = row_new[e];
    wrote = true;
  }
  const int nv = W / E;
  const int zlo = max(t_lo - r_lo, 0), zhi = max(r_hi - t_hi, 0);  // rows below, above
  for (int i = tid; i < (zlo + zhi) * nv; i += nt) {
    const int k = i / nv, v = i - k * nv;
    const int t = k < zlo ? r_lo + k : t_hi + (k - zlo);
    *reinterpret_cast<uint4*>(dst + (size_t)t * DS + v * E) = make_uint4(0, 0, 0, 0);
    wrote = true;
  }
  if (wrote) fence_proxy_async();
}

// Runs compute(j, buf) for each block j in [j0, j1) once its tiles are
// in shared memory; stage(j, buf, bar) stages block j into buffer buf,
// its bulk copies completing on bar (the stage arrives on bar once,
// expecting their bytes).  init() runs once, after the first block's
// copies are issued, so that the CTA's other loads overlap them.  With
// two stages the copies of block j + 1 fly while block j is computed.
// `bars` are two mbarriers in shared memory.  Every thread of the CTA
// must call it; compute(...) is bracketed by __syncthreads(), and
// pipeline returns after a __syncthreads().
template <typename Stage, typename Init, typename Compute>
__device__ void pipeline(int j0, int j1, int stages, uint64_t* bars, Stage&& stage,
                         Init&& init, Compute&& compute) {
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (j0 < j1) stage(j0, 0, &bars[0]);
  init();
  if (j0 >= j1) {
    __syncthreads();
    return;
  }
  for (int j = j0; j < j1; ++j) {
    const int it = j - j0;
    const int buf = stages == 2 ? it & 1 : 0;
    const unsigned parity = stages == 2 ? (it >> 1) & 1 : it & 1;
    if (stages == 2 && j + 1 < j1) stage(j + 1, buf ^ 1, &bars[buf ^ 1]);
    mbar_wait(&bars[buf], parity);
    __syncthreads();
    compute(j, buf);
    __syncthreads();
    if (stages == 1 && j + 1 < j1) stage(j + 1, 0, &bars[0]);
  }
}

// The log-sum-exp merge of a row's key splits, one CTA per (b * KVH + h,
// query row r) of G rows per kv head.  part holds, per (b * KVH + h) and
// split s, m[G], l[G] and acc[G][VD] in float32 (the split's running max,
// its sum of e^(x - m) and its unnormalised sum of e^(x - m) v).  With
// self_s non-null, one more term enters as a split of its own with
// m = self_s[(b * KVH + h) * G + r], l = 1 and acc = the value
// self_v[(b * KVH + h) * VD + d] (float32): the new token's term of
// absorbed MLA decode, whose score the caller computes in float32.
//   O = (sum_s w_s acc_s + w_self v_self) / (sum_s w_s l_s + w_self),
//   w_s = e^(m_s - M), M = the max of m_s over the splits with l_s > 0
//   (and of the self score);
// a row with no key and no self term gives 0.  Warp 0 forms the weights;
// then thread d sums column d over the splits (independent loads,
// coalesced across d).  Dynamic shared memory: S floats.
template <typename O>
__global__ void __launch_bounds__(rt::kThreads)
merge_kernel(const float* __restrict__ part, const float* __restrict__ self_s,
             const float* __restrict__ self_v, O* __restrict__ out, int S, int G,
             int VD) {
  extern __shared__ float w[];
  __shared__ float L, w_self;
  const int bh = blockIdx.x / G, r = blockIdx.x % G;
  const int tid = threadIdx.x;
  const size_t stride = (size_t)G * (VD + 2);
  const float* pb = part + (size_t)bh * S * stride;
  if (tid < 32) {
    const float s_self = self_s ? self_s[(size_t)bh * G + r] : rt::kNeg;
    float M = s_self;
    for (int sp = tid; sp < S; sp += 32)
      if (pb[sp * stride + G + r] > 0.f) M = fmaxf(M, pb[sp * stride + r]);
    M = rt::warp_max(M);
    float sum = 0.f;
    for (int sp = tid; sp < S; sp += 32) {
      const float l = pb[sp * stride + G + r];
      const float ws = l > 0.f ? expf(pb[sp * stride + r] - M) : 0.f;
      w[sp] = ws;
      sum += ws * l;
    }
    sum = rt::warp_sum(sum);
    if (tid == 0) {
      const float a = self_s ? expf(s_self - M) : 0.f;
      w_self = a;
      L = sum + a;
    }
  }
  __syncthreads();
  const float inv = L > 0.f ? 1.f / L : 0.f;
  const float* acc = pb + 2 * G + (size_t)r * VD;
  const float* vs = self_v ? self_v + (size_t)bh * VD : nullptr;
  for (int d = tid; d < VD; d += rt::kThreads) {
    float o = vs ? w_self * vs[d] : 0.f;
#pragma unroll 4
    for (int sp = 0; sp < S; ++sp)
      if (w[sp] > 0.f) o += w[sp] * acc[sp * stride + d];
    out[((size_t)bh * G + r) * VD + d] = rt::from_f<O>(o * inv);
  }
}

// A bump allocator over the dynamic shared memory, with every region
// 128-byte aligned; the host runs the same carve on a null base to size
// the launch.
struct Carve {
  char* p;
  size_t used = 0;
  __host__ __device__ explicit Carve(void* base) : p((char*)base) {}
  template <typename U> __host__ __device__ U* take(size_t n) {
    U* r = reinterpret_cast<U*>(p + used);
    used += (n * sizeof(U) + 127) & ~(size_t)127;
    return r;
  }
};

}  // namespace fp
