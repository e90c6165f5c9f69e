// paged_attention_append: the fused decode tail for one layer.
//
// Replaces the Pallas kernel repro/kernels/paged_attention.py
// (paged_attention_append), which on the model path stands for
// write_token_paged + _paged_ref + _merge_self.  For each (sequence b,
// kv head h) one CTA
//   1. writes the new token's K/V row into the tail block
//      tables[b, min(lens // BT, MB - 1)] at offset lens - jt * BT,
//      dropped when the table is full (torch's index_put_ has no drop
//      mode, so the mask is explicit here and in the plain version);
//   2. attends the G query rows that share this kv head over the
//      lens + 1 positions (window > 0 keeps pos >= lens + 1 - window,
//      softcap > 0 caps the logits), with the appended row taken from
//      shared memory rather than read back.
//
// Bound on the H100: decode attention does ~2 * G flops per K/V byte,
// far below the card's ~295 flop/byte balance, so the time is the K/V
// bytes of the visited blocks over 3.35 TB/s.  The design reads each of
// those bytes once per CTA (coalesced across a warp) and keeps scores
// and the running softmax in shared memory; one CTA per (b, h) leaves
// most SMs idle at small batch -- splitting the key range across CTAs
// (flash-decoding) is the next step for long contexts.
#include "attention_core.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
paged_attention_append_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                              const T* __restrict__ v_new, T* k_pool, T* v_pool,
                              const int* __restrict__ tables,
                              const int* __restrict__ lens, T* __restrict__ out,
                              int KVH, int G, int HD, int VD, int BT, int MB,
                              float scale, float softcap, int window) {
  extern __shared__ float4 smem_raw[];
  const int b = blockIdx.x / KVH, h = blockIdx.x % KVH;
  const int tid = threadIdx.x;
  rt::Smem s = rt::carve(smem_raw, G, HD, VD, BT);
  const int* table = tables + (size_t)b * MB;
  const int len = lens[b];
  const int jt = min(len / BT, MB - 1);
  const int off = len - jt * BT;
  const bool append = off < BT;          // a full table drops the write
  const T* kn = k_new + ((size_t)b * KVH + h) * HD;
  const T* vn = v_new + ((size_t)b * KVH + h) * VD;
  if (append) {
    const int tail = max(table[jt], 0);
    T* kdst = k_pool + ((size_t)(tail * BT + off) * KVH + h) * HD;
    T* vdst = v_pool + ((size_t)(tail * BT + off) * KVH + h) * VD;
    for (int d = tid; d < HD; d += rt::kThreads) kdst[d] = kn[d];
    for (int d = tid; d < VD; d += rt::kThreads) vdst[d] = vn[d];
  }
  for (int d = tid; d < HD; d += rt::kThreads) s.kn[d] = rt::to_f(kn[d]);
  for (int d = tid; d < VD; d += rt::kThreads) s.vn[d] = rt::to_f(vn[d]);
  const T* qb = q + ((size_t)b * KVH + h) * G * HD;
  for (int i = tid; i < G * HD; i += rt::kThreads) s.qs[i] = rt::to_f(qb[i]) * scale;
  const int key_hi = min(len + 1, MB * BT);
  const int key_lo = window > 0 ? max(len + 1 - window, 0) : 0;
  for (int r = tid; r < G; r += rt::kThreads) {
    s.lo[r] = key_lo;
    s.hi[r] = key_hi;
  }
  __syncthreads();
  rt::attend_rows<T>(s, G, k_pool, v_pool, table, MB, BT, KVH, h, HD, VD, key_lo,
                     key_hi, append ? len : -1, softcap);
  T* ob = out + ((size_t)b * KVH + h) * G * VD;
  for (int i = tid; i < G * VD; i += rt::kThreads) {
    const int r = i / VD;
    ob[i] = rt::from_f<T>(s.acc[i] / fmaxf(s.l[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new, void* k_pool,
           void* v_pool, const int* tables, const int* lens, void* out, int B,
           int KVH, int G, int HD, int VD, int BT, int MB, float scale,
           float softcap, int window, cudaStream_t stream) {
  const size_t smem = rt::smem_bytes(G, HD, VD, BT);
  auto kern = paged_attention_append_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<B * KVH, rt::kThreads, smem, stream>>>(
      (const T*)q, (const T*)k_new, (const T*)v_new, (T*)k_pool, (T*)v_pool, tables,
      lens, (T*)out, KVH, G, HD, VD, BT, MB, scale, softcap, window);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launch (0 on success); the kernel runs on `stream` asynchronously.
extern "C" int rt_paged_attention_append(
    const void* q, const void* k_new, const void* v_new, void* k_pool, void* v_pool,
    const int* tables, const int* lens, void* out, int B, int KVH, int G, int HD,
    int VD, int BT, int MB, float scale, float softcap, int window, int dtype,
    void* stream) {
  if (G < 1 || G > rt::kMaxRows) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k_new, v_new, k_pool, v_pool, tables, lens, out, B, KVH,
                         G, HD, VD, BT, MB, scale, softcap, window, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_new, v_new, k_pool, v_pool, tables, lens, out,
                                 B, KVH, G, HD, VD, BT, MB, scale, softcap, window,
                                 st);
  return (int)cudaErrorInvalidValue;
}
