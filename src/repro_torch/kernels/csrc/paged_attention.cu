// Decode attention over the paged pool without an append, on the first
// design's core (attention_core.cuh); the decode append with its split
// key range lives in paged_append.cu.
//
// paged_attention: flash decode of one query token over the seq_lens
// cached tokens, with no append.
//
// Replaces the Pallas kernel repro/kernels/paged_attention.py
// (paged_attention).  Window > 0 keeps pos >= lens - window (the
// Pallas kernel's convention, one position wider than the append
// kernel's); a row with no key gives 0.  MLA latent mode: V is the
// first VD lanes of the K pool's rows (v_pool == k_pool, V row stride
// HD); absorbed MLA decode runs G = 40 query heads over one latent
// "kv head" of HD = 288.  The core holds at most kMaxRows query rows
// per CTA, so the grid is (b * KVH + h, chunk of kMaxRows query rows):
// every chunk reads the K/V of its row once (ceil(G / 16) = 3 reads of
// the latent at G = 40, the repeats mostly from L2), which also spreads
// a 4-slot decode over 3x more CTAs.
//
// Bound on the H100: decode attention does ~2 * G flops per K/V byte
// (80 at G = 40), below the card's ~295 flop/byte balance, so the time
// is the K/V bytes of the visited blocks over 3.35 TB/s.  The design
// reads each of those bytes once per CTA (coalesced across a warp) and
// keeps scores and the running softmax in shared memory; one CTA per
// (b, h, chunk) leaves most SMs idle at small batch -- splitting the key
// range across CTAs (flash-decoding) is the next step for long contexts.
#include "attention_core.cuh"

namespace {

template <typename T, typename O>
__global__ void __launch_bounds__(rt::kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool, const int* __restrict__ tables,
                       const int* __restrict__ lens, O* __restrict__ out, int KVH,
                       int G, int HD, int VD, int VS, int BT, int MB, float scale,
                       float softcap, int window) {
  extern __shared__ float4 smem_raw[];
  const int b = blockIdx.x / KVH, h = blockIdx.x % KVH;
  const int g0 = blockIdx.y * rt::kMaxRows;
  const int R = min(rt::kMaxRows, G - g0);
  const int tid = threadIdx.x;
  rt::Smem s = rt::carve(smem_raw, R, HD, VD, BT);
  const int len = lens[b];
  const T* qb = q + (((size_t)b * KVH + h) * G + g0) * HD;
  for (int i = tid; i < R * HD; i += rt::kThreads) s.qs[i] = rt::to_f(qb[i]) * scale;
  const int key_hi = min(max(len, 0), MB * BT);
  const int key_lo = window > 0 ? max(len - window, 0) : 0;
  for (int r = tid; r < R; r += rt::kThreads) {
    s.lo[r] = key_lo;
    s.hi[r] = key_hi;
  }
  __syncthreads();
  rt::attend_rows<T>(s, R, k_pool, v_pool, tables + (size_t)b * MB, MB, BT, KVH, h,
                     HD, VD, VS, key_lo, key_hi, -1, softcap);
  rt::store_rows(s, R, VD, R, 0, out + (((size_t)b * KVH + h) * G + g0) * VD);
}

}  // namespace

// v_pool may be k_pool (MLA latent mode); VS is V's row stride in
// elements (VD for a separate V pool, HD for the latent pool).  dtype
// (q and the pools) and out_dtype: 0 = float32, 1 = bfloat16; the output
// is q's dtype or float32 (absorbed MLA un-absorbs from float32, as the
// reference does).  Returns the launch's cudaError_t.
extern "C" int rt_paged_attention(const void* q, const void* k_pool,
                                  const void* v_pool, const int* tables,
                                  const int* lens, void* out, int B, int KVH, int G,
                                  int HD, int VD, int VS, int BT, int MB,
                                  float scale, float softcap, int window, int dtype,
                                  int out_dtype, void* stream) {
  if (B <= 0) return 0;
  if (G < 1 || VD > VS || (out_dtype != dtype && out_dtype != 0))
    return (int)cudaErrorInvalidValue;
  const int R = G < rt::kMaxRows ? G : rt::kMaxRows;
  const dim3 grid(B * KVH, (G + rt::kMaxRows - 1) / rt::kMaxRows);
  auto run = [&](auto t, auto o) {
    using T = typename decltype(t)::type;
    using O = typename decltype(o)::type;
    return rt::launch(paged_attention_kernel<T, O>, grid,
                      rt::smem_bytes(R, HD, VD, BT), (cudaStream_t)stream,
                      (const T*)q, (const T*)k_pool, (const T*)v_pool, tables, lens,
                      (O*)out, KVH, G, HD, VD, VS, BT, MB, scale, softcap, window);
  };
  return rt::dispatch(dtype, [&](auto t) {
    return out_dtype == dtype ? run(t, t) : run(t, rt::Type<float>());
  });
}
