// Block movement: copy_pool_blocks, gather_blocks, scatter_blocks (and
// block_copy as their single-layer case).
//
// Replaces the Pallas kernels of repro/kernels/block_copy.py
// (copy_pool_blocks, gather_blocks, scatter_blocks, block_copy): the
// device half of copy-on-write fulfilment and compaction, swap-out and
// swap-in.  All four are one operation -- move whole blocks of
// `blk` bytes between two layer-stacked arrays, optionally through an id
// list on either side:
//
//   dst[l, dst_ids ? dst_ids[i] : i] = src[l, src_ids ? src_ids[i] : i]
//
// Bound on the H100: pure data movement, 2 * n * L * blk bytes over
// 3.35 TB/s.  What held the first design back (one CTA per (block,
// layer), ids uploaded by a blocking copy) and what this one does:
//
// * The plan rides in the launch.  Up to kMaxParamIds ids (sources and
//   destinations together) travel in the kernel's parameter block, a
//   __grid_constant__ struct the host fills from its own memory: no id
//   upload, no host sync, and no dependent global load of an id before
//   a CTA's first data load.  The Pallas kernels prefetch the plan into
//   SMEM the same way (scalar prefetch).  A larger plan (a compaction
//   or a swap of more blocks) passes a device pointer to ids that the
//   wrapper uploaded from pinned memory without blocking.  The whole
//   parameter block stays within the 4 KB that every CUDA 12 toolkit
//   allows.
// * A grid that covers the card.  Every block is cut into chunks of
//   `chunk` bytes (a power of two, 16 B to 32 KB; the last chunk of a
//   block may be shorter), one CTA per (block, chunk) and layer: the
//   wrapper picks the chunk (ops.plan_block_move) so that a small plan
//   still gives at least one CTA per SM, while a large one keeps 32 KB
//   chunks, several MB in flight at once.
// * TMA bulk copies.  One elected thread loads its chunk into shared
//   memory with one cp.async.bulk on an mbarrier and writes it back with
//   one bulk store (cp.async.bulk.global.shared::cta.bulk_group), so a
//   CTA costs a few instructions however large its chunk.  A chunk whose
//   two addresses are not both 16-byte aligned (blocks whose size is not
//   a multiple of 16, or a pool view at an odd offset) and the sub-16-
//   byte tail of an aligned one are copied by all threads in 4-byte
//   words or bytes.  (Against a 16-byte vector loop with 4 loads in
//   flight per thread, TMA tied at the serving path's plans and led on
//   large gathers and scatters, on the H100: PERF.md.)
//
// Offsets are 64-bit (a 62-layer latent pool of 1024 blocks passes
// 2^31 bytes).  The callers guarantee disjoint source and destination
// ids (copy plans) and distinct destinations, which the Python wrappers
// check before launching, so no two chunks of one launch overlap.
#include "tma.cuh"

namespace {

constexpr int kThreads = 128;
// ids that fit in the parameter block (ops.MAX_PARAM_IDS)
constexpr int kMaxParamIds = 960;
// largest chunk: the dynamic shared memory of one CTA (ops.MAX_CHUNK_BYTES)
constexpr long long kMaxChunk = 32768;

struct MoveArgs {
  const char* src;
  char* dst;
  long long src_layer, dst_layer;  // bytes between layers
  long long blk, chunk;            // bytes per block and per chunk
  const int* ids_dev;              // staged ids on the device, or null
  int cpb;                         // chunks per block
  int src_off, dst_off;            // offsets of the source / destination
                                   // ids in the id list, -1 = identity
  int ids[kMaxParamIds];           // the id list when ids_dev is null
};
static_assert(sizeof(MoveArgs) <= 4096, "the parameter block exceeds 4 KB");

__device__ __forceinline__ long long plan_id(const MoveArgs& a, int off, int i) {
  if (off < 0) return i;
  return a.ids_dev ? a.ids_dev[off + i] : a.ids[off + i];
}

// All threads: `bytes` from s to d (not both 16-byte aligned) in 4-byte
// words where both are 4-byte aligned, then bytes.
__device__ __forceinline__ void copy_loop(char* __restrict__ d, const char* __restrict__ s,
                                          long long bytes) {
  long long done = 0;
  if ((((uintptr_t)d | (uintptr_t)s) & 3) == 0) {
    const long long n = bytes >> 2;
    const uint32_t* s1 = reinterpret_cast<const uint32_t*>(s);
    uint32_t* d1 = reinterpret_cast<uint32_t*>(d);
    for (long long k = threadIdx.x; k < n; k += kThreads) d1[k] = s1[k];
    done = n << 2;
  }
  for (long long k = done + threadIdx.x; k < bytes; k += kThreads) d[k] = s[k];
}

// Grid (n * cpb, L): CTA (i * cpb + c, l) moves chunk c of block i on
// layer l.
__global__ void __launch_bounds__(kThreads)
block_move_kernel(const __grid_constant__ MoveArgs a) {
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ uint64_t bar;
  const int i = blockIdx.x / a.cpb, c = blockIdx.x - i * a.cpb;
  const long long l = blockIdx.y;
  const long long off = (long long)c * a.chunk;
  const long long bytes = min(a.chunk, a.blk - off);
  const char* s = a.src + l * a.src_layer + plan_id(a, a.src_off, i) * a.blk + off;
  char* d = a.dst + l * a.dst_layer + plan_id(a, a.dst_off, i) * a.blk + off;
  if ((((uintptr_t)s | (uintptr_t)d) & 15) != 0) {
    copy_loop(d, s, bytes);
    return;
  }
  const long long n16 = bytes & ~15ll;
  if (threadIdx.x == 0 && n16 > 0) {
    fp::mbar_init(&bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fp::mbar_expect(&bar, (unsigned)n16);
    fp::bulk_copy(stage, s, (unsigned)n16, &bar);
    fp::mbar_wait(&bar, 0);
    fp::bulk_store(d, stage, (unsigned)n16);
  }
  for (long long k = n16 + threadIdx.x; k < bytes; k += kThreads) d[k] = s[k];
}

}  // namespace

// Moves n blocks of blk bytes on each of L layers, in chunks of `chunk`
// bytes (a power of two from 16 to kMaxChunk).  Layer strides and sizes
// are in bytes.  The id list holds the source ids at src_off and the
// destination ids at dst_off (-1: the identity on that side); it is read
// from host memory (host_ids, at most kMaxParamIds ids, copied into the
// launch) or else from device memory (dev_ids).  Returns the launch's
// cudaError_t.
extern "C" int rt_block_move(const void* src, long long src_layer_bytes, void* dst,
                             long long dst_layer_bytes, int n, int L,
                             long long blk_bytes, long long chunk_bytes,
                             const int* host_ids, const int* dev_ids, int n_ids,
                             int src_off, int dst_off, void* stream) {
  if (n <= 0 || L <= 0) return 0;
  if (chunk_bytes < 16 || chunk_bytes > kMaxChunk || (chunk_bytes & (chunk_bytes - 1)) ||
      blk_bytes <= 0 || L > 65535 || n_ids < 0 ||
      (n_ids > 0 && (host_ids != nullptr) == (dev_ids != nullptr)) ||
      (host_ids != nullptr && n_ids > kMaxParamIds) ||
      (src_off >= 0 && (long long)src_off + n > n_ids) ||
      (dst_off >= 0 && (long long)dst_off + n > n_ids))
    return (int)cudaErrorInvalidValue;
  const long long cpb = (blk_bytes + chunk_bytes - 1) / chunk_bytes;
  if ((long long)n * cpb > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  MoveArgs a;
  a.src = (const char*)src;
  a.dst = (char*)dst;
  a.src_layer = src_layer_bytes;
  a.dst_layer = dst_layer_bytes;
  a.blk = blk_bytes;
  a.chunk = chunk_bytes;
  a.ids_dev = host_ids ? nullptr : dev_ids;
  a.cpb = (int)cpb;
  a.src_off = src_off;
  a.dst_off = dst_off;
  for (int k = 0; host_ids && k < n_ids; ++k) a.ids[k] = host_ids[k];
  const size_t smem = (size_t)(chunk_bytes < blk_bytes ? chunk_bytes : blk_bytes);
  block_move_kernel<<<dim3((unsigned)(n * cpb), L), kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
