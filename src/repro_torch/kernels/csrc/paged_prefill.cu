// paged_prefill_attention: suffix prefill through the block table.
//
// Replaces the Pallas kernel repro/kernels/paged_prefill.py
// (paged_prefill_attention), which on the model path stands for
// _paged_prefill_ref inside gqa_prefill_paged.  Query i of row b sits at
// absolute position q_starts[b] + i and attends causally to keys
// < kv_lens[b] (window > 0 keeps kv >= q - window + 1); rows with every
// key masked give 0.  The suffix's own K/V is already in the pool.
//
// One CTA per (b, kv head, chunk of QC queries), with QC * G <= 16 rows
// so the G query heads sharing a kv head and QC neighbouring positions
// share every K/V tile read.  Bound on the H100: at these shapes the
// work is ~2 * QC * G flops per K/V byte read (32 at QC * G = 16),
// still below the tensor-core balance point, and the kernel uses CUDA
// cores rather than wgmma -- it is simple and right first; a wgmma
// tiling of (rows x BT) score tiles is the step that makes it fast.
// The causal bound skips blocks past the chunk's last query.
#include "attention_core.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                     const T* __restrict__ v_pool, const int* __restrict__ tables,
                     const int* __restrict__ kv_lens,
                     const int* __restrict__ q_starts, T* __restrict__ out, int SQ,
                     int KVH, int G, int QC, int HD, int VD, int BT, int MB,
                     float scale, float softcap, int window) {
  extern __shared__ float4 smem_raw[];
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int i0 = chunk * QC;
  const int nq = min(QC, SQ - i0);
  const int R = nq * G;
  rt::Smem s = rt::carve(smem_raw, QC * G, HD, VD, BT);
  const int start = q_starts[b];
  const int kv_len = kv_lens[b];
  for (int idx = tid; idx < R * HD; idx += rt::kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int i = i0 + r / G, g = r % G;
    s.qs[idx] = rt::to_f(q[(((size_t)b * SQ + i) * KVH + h) * G * HD + g * HD + d]) * scale;
  }
  int key_lo = 1 << 30, key_hi = 0;
  for (int r = 0; r < R; ++r) {          // uniform across the CTA
    const int qa = start + i0 + r / G;
    const int hi = min(qa + 1, kv_len);
    const int lo = window > 0 ? max(qa - window + 1, 0) : 0;
    if (tid == 0) {
      s.lo[r] = lo;
      s.hi[r] = hi;
    }
    if (hi > lo) {
      key_lo = min(key_lo, lo);
      key_hi = max(key_hi, hi);
    }
  }
  __syncthreads();
  rt::attend_rows<T>(s, R, k_pool, v_pool, tables + (size_t)b * MB, MB, BT, KVH, h,
                     HD, VD, VD, key_lo, key_hi, -1, softcap);
  rt::store_rows(s, R, VD, G, (size_t)KVH * G * VD,
                 out + (((size_t)b * SQ + i0) * KVH + h) * G * VD);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int rt_paged_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool, const int* tables,
    const int* kv_lens, const int* q_starts, void* out, int B, int SQ, int KVH,
    int G, int HD, int VD, int BT, int MB, float scale, float softcap, int window,
    int dtype, void* stream) {
  if (G < 1 || G > rt::kMaxRows || SQ < 1) return (int)cudaErrorInvalidValue;
  const int QC = rt::kMaxRows / G;
  return rt::dispatch(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    return rt::launch(paged_prefill_kernel<T>, dim3((SQ + QC - 1) / QC, KVH, B),
                      rt::smem_bytes(QC * G, HD, VD, BT), (cudaStream_t)stream,
                      (const T*)q, (const T*)k_pool, (const T*)v_pool, tables,
                      kv_lens, q_starts, (T*)out, SQ, KVH, G, QC, HD, VD, BT, MB,
                      scale, softcap, window);
  });
}
