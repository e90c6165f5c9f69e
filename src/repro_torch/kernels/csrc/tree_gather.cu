// TreeArray streaming: tree_gather, tree_block_sum, tree_gather_rows.
//
// Replaces the Pallas kernels of repro/kernels/tree_gather.py:
//
//   tree_gather      out[i, :] = leaves[table[i], :]     (n, leaf), any dtype
//   tree_block_sum   out[i]    = sum(float(leaves[table[i], :]))   (n,) f32
//   tree_gather_rows out[i, :] = pool[leaf_table[row[i] / rpb],
//                                     row[i] % rpb, :]   (n, W), any dtype
//
// The Pallas versions prefetch the table into SMEM and let the
// BlockSpec index map steer one DMA per grid step.  Here each CTA owns
// one logical leaf (or one row), reads its own id once, and streams the
// leaf with 16-byte loads, neighbouring threads on neighbouring
// addresses; the CTAs run in parallel, so the card keeps hundreds of
// leaves in flight at once instead of a prefetch depth of one.
// tree_gather_rows resolves `leaf_table[row / rpb]` and `row % rpb`
// itself, fusing the jnp resolution that the Pallas wrapper does
// before its call.
//
// Bound on the H100: all three are data movement or a reduction at
// about 0 flop/byte, so HBM at 3.35 TB/s is the only limit:
// tree_gather moves 2 * n * leaf_bytes, tree_block_sum n * leaf_bytes,
// tree_gather_rows 2 * n * row_bytes.  A 32 KB leaf per CTA (the
// paper's block) with 256 threads is 8 vector loads per thread, and
// the ~1000 resident CTAs keep several MB in flight, enough to cover
// the memory latency.
//
// Offsets are 64-bit throughout: at a 4 GB TreeArray
// leaf_id * leaf_bytes reaches 2^32.
//
// Ids outside the pool: an id < 0 or >= num_blocks (and, for rows, a
// row < 0 or past the leaf table) is never dereferenced.  tree_gather
// and tree_gather_rows write zeros for it and tree_block_sum writes 0.
// (The plain PyTorch versions follow torch indexing instead: negative
// ids wrap and ids past the end raise.  Tables from TreeArray are
// always in range, and the wrappers add no host sync to check.)
//
// Alignment: where the leaf's (or row's) byte size is not a multiple
// of 16, or a base is not 16-byte aligned, the 16-byte body covers
// what it can and a scalar loop inside the kernel covers the rest.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Copy `nbytes` bytes from s to d with all threads of the CTA: 16-byte
// words where both pointers allow it, else 4-byte words, then bytes.
__device__ __forceinline__ void copy_span(char* __restrict__ d,
                                          const char* __restrict__ s,
                                          long long nbytes) {
  const uintptr_t a = (uintptr_t)d | (uintptr_t)s;
  long long done = 0;
  if ((a & 15) == 0) {
    const long long n16 = nbytes >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    uint4* d4 = reinterpret_cast<uint4*>(d);
#pragma unroll 4
    for (long long k = threadIdx.x; k < n16; k += kThreads) d4[k] = s4[k];
    done = n16 << 4;
  } else if ((a & 3) == 0) {
    const long long n4 = nbytes >> 2;
    const uint32_t* s1 = reinterpret_cast<const uint32_t*>(s);
    uint32_t* d1 = reinterpret_cast<uint32_t*>(d);
    for (long long k = threadIdx.x; k < n4; k += kThreads) d1[k] = s1[k];
    done = n4 << 2;
  }
  for (long long k = done + threadIdx.x; k < nbytes; k += kThreads) d[k] = s[k];
}

__device__ __forceinline__ void zero_span(char* __restrict__ d,
                                          long long nbytes) {
  for (long long k = threadIdx.x; k < nbytes; k += kThreads) d[k] = 0;
}

__global__ void __launch_bounds__(kThreads)
tree_gather_kernel(const char* __restrict__ leaves,
                   const int* __restrict__ table, char* __restrict__ out,
                   long long leaf_bytes, int num_blocks) {
  const long long i = blockIdx.x;
  const int id = table[i];
  char* d = out + i * leaf_bytes;
  if (id < 0 || id >= num_blocks) {
    zero_span(d, leaf_bytes);
    return;
  }
  copy_span(d, leaves + (long long)id * leaf_bytes, leaf_bytes);
}

// bf16 -> f32 is exact: the bf16 bits are the high half of the f32.
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// One CTA sums one logical leaf: float32 accumulator per thread over
// 16-byte words, a scalar loop for what the words do not cover, then a
// warp-shuffle and shared-memory reduction.  kBf16 selects the input.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
tree_block_sum_kernel(const char* __restrict__ leaves,
                      const int* __restrict__ table, float* __restrict__ out,
                      long long leaf, int num_blocks) {
  constexpr int kEs = kBf16 ? 2 : 4;        // element size in bytes
  constexpr int kPerWord = 16 / kEs;        // elements per 16-byte word
  const long long i = blockIdx.x;
  const int id = table[i];
  float acc = 0.f;
  if (id >= 0 && id < num_blocks) {
    const char* s = leaves + (long long)id * leaf * kEs;
    long long done = 0;
    if (((uintptr_t)s & 15) == 0) {
      const long long nw = leaf / kPerWord;
      const uint4* s4 = reinterpret_cast<const uint4*>(s);
#pragma unroll 4
      for (long long k = threadIdx.x; k < nw; k += kThreads) {
        const uint4 v = s4[k];
        if (kBf16) {
          acc += bf16_lo(v.x) + bf16_hi(v.x) + bf16_lo(v.y) + bf16_hi(v.y) +
                 bf16_lo(v.z) + bf16_hi(v.z) + bf16_lo(v.w) + bf16_hi(v.w);
        } else {
          acc += __uint_as_float(v.x) + __uint_as_float(v.y) +
                 __uint_as_float(v.z) + __uint_as_float(v.w);
        }
      }
      done = nw * kPerWord;
    }
    for (long long k = done + threadIdx.x; k < leaf; k += kThreads) {
      if (kBf16) {
        const uint16_t h = reinterpret_cast<const uint16_t*>(s)[k];
        acc += __uint_as_float((uint32_t)h << 16);
      } else {
        acc += reinterpret_cast<const float*>(s)[k];
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  __shared__ float warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) out[i] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
tree_gather_rows_kernel(const char* __restrict__ pool,
                        const int* __restrict__ row_ids,
                        const int* __restrict__ leaf_table,
                        char* __restrict__ out, long long row_bytes, int rpb,
                        int num_logical, int num_blocks) {
  const long long i = blockIdx.x;
  const int row = row_ids[i];
  char* d = out + i * row_bytes;
  const int lb = row >= 0 ? row / rpb : -1;
  const int phys = (lb >= 0 && lb < num_logical) ? leaf_table[lb] : -1;
  if (phys < 0 || phys >= num_blocks) {
    zero_span(d, row_bytes);
    return;
  }
  const long long r = (long long)phys * rpb + row % rpb;
  copy_span(d, pool + r * row_bytes, row_bytes);
}

}  // namespace

// Each entry point launches one CTA per logical leaf (or row) on
// `stream` and returns the launch's cudaError_t.  n == 0 launches
// nothing (the wrappers never ask for it).

extern "C" int rt_tree_gather(const void* leaves, const int* table, void* out,
                              int n, long long leaf_bytes, int num_blocks,
                              void* stream) {
  if (n <= 0) return 0;
  tree_gather_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(
      (const char*)leaves, table, (char*)out, leaf_bytes, num_blocks);
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16 (as ops._DTYPES).  `leaf` is in elements.
extern "C" int rt_tree_block_sum(const void* leaves, const int* table,
                                 float* out, int n, long long leaf,
                                 int num_blocks, int dtype, void* stream) {
  if (n <= 0) return 0;
  if (dtype == 0) {
    tree_block_sum_kernel<false><<<n, kThreads, 0, (cudaStream_t)stream>>>(
        (const char*)leaves, table, out, leaf, num_blocks);
  } else if (dtype == 1) {
    tree_block_sum_kernel<true><<<n, kThreads, 0, (cudaStream_t)stream>>>(
        (const char*)leaves, table, out, leaf, num_blocks);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int rt_tree_gather_rows(const void* pool, const int* row_ids,
                                   const int* leaf_table, void* out, int n,
                                   long long row_bytes, int rpb,
                                   int num_logical, int num_blocks,
                                   void* stream) {
  if (n <= 0) return 0;
  tree_gather_rows_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(
      (const char*)pool, row_ids, leaf_table, (char*)out, row_bytes, rpb,
      num_logical, num_blocks);
  return (int)cudaGetLastError();
}
