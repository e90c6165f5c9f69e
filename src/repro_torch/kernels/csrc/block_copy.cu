// Block movement: copy_pool_blocks, gather_blocks, scatter_blocks (and
// block_copy as their single-layer case).
//
// Replaces the Pallas kernels of repro/kernels/block_copy.py
// (copy_pool_blocks, gather_blocks, scatter_blocks, block_copy): the
// device half of copy-on-write fulfilment and compaction, swap-out and
// swap-in.  All four are one operation -- move whole blocks of
// `blk_bytes` bytes between two layer-stacked arrays, optionally
// through an id list on either side:
//
//   dst[l, dst_idx ? dst_idx[i] : i] = src[l, src_idx ? src_idx[i] : i]
//
// One CTA per (i, layer) copies one block with 16-byte vector loads
// and stores when the block size and both bases allow it.  Bound on
// the H100: pure data movement, 2 * n * L * blk_bytes over 3.35 TB/s;
// a KV block of gemma-2b is 32 KB per layer, so each CTA moves one
// contiguous 32 KB span at full coalescing.  The callers guarantee
// disjoint source and destination ids (copy plans) and distinct
// scatter ids, which the Python wrappers assert before launching.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
block_move_kernel(const char* __restrict__ src, long long src_layer,
                  const int* __restrict__ src_idx, char* __restrict__ dst,
                  long long dst_layer, const int* __restrict__ dst_idx,
                  long long blk_bytes, int vec16) {
  const int i = blockIdx.x, l = blockIdx.y;
  const long long sb = src_idx ? src_idx[i] : i;
  const long long db = dst_idx ? dst_idx[i] : i;
  const char* s = src + l * src_layer + sb * blk_bytes;
  char* d = dst + l * dst_layer + db * blk_bytes;
  if (vec16) {
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    uint4* d4 = reinterpret_cast<uint4*>(d);
    const long long n4 = blk_bytes / 16;
    for (long long k = threadIdx.x; k < n4; k += kThreads) d4[k] = s4[k];
  } else {
    for (long long k = threadIdx.x; k < blk_bytes; k += kThreads) d[k] = s[k];
  }
}

}  // namespace

// Layer strides and the block size are in bytes.  n blocks on each of
// L layers.  Returns the launch's cudaError_t.
extern "C" int rt_block_move(const void* src, long long src_layer_bytes,
                             const int* src_idx, void* dst,
                             long long dst_layer_bytes, const int* dst_idx, int n,
                             int L, long long blk_bytes, void* stream) {
  if (n <= 0 || L <= 0) return 0;
  const int vec16 = (blk_bytes % 16 == 0) && (src_layer_bytes % 16 == 0) &&
                    (dst_layer_bytes % 16 == 0) &&
                    ((uintptr_t)src % 16 == 0) && ((uintptr_t)dst % 16 == 0);
  dim3 grid(n, L);
  block_move_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const char*)src, src_layer_bytes, src_idx, (char*)dst, dst_layer_bytes,
      dst_idx, blk_bytes, vec16);
  return (int)cudaGetLastError();
}
