// Helpers that every paged attention kernel shares (paged_append.cu,
// paged_prefill.cu and paged_attention.cu, through flash_paged.cuh):
// conversions between the element types and float32, warp reductions,
// the launch with its shared-memory opt-in, and the dtype dispatch.
//
// Layouts (element offsets) used by those kernels:
//   K pool (NB, BT, KVH, HD): ((blk * BT + t) * KVH + h) * HD + d
//   V pool rows:               ((blk * BT + t) * KVH + h) * VS + d, d < VD
//     VS is V's row stride: VD for a (NB, BT, KVH, VD) pool, HD when V is
//     the first VD lanes of the K pool's rows (MLA latent mode)
//   tables (B, MB) int32, NULL (-1) entries clamped to block 0 and
//   masked by length.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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
