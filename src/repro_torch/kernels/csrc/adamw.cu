// AdamW update of one parameter leaf in one pass: adamw_update.
//
// Replaces no Pallas kernel.  The reference's update is plain jnp
// (repro/optim/adamw.py, `upd` inside `apply_updates`), which XLA fuses
// into one elementwise pass per leaf; the port's plain version
// (ref.adamw_update_ref) runs it as ~8 tensor ops, each a float32 pass
// over the leaf.  This kernel is that fusion written by hand:
//
//   g     = g * scale                       (the clip scale)
//   m     = b1 * m + (1 - b1) * g
//   v     = b2 * v + (1 - b2) * g * g
//   delta = (m / b1c) / (sqrt(v / b2c) + eps) + wd * p
//   p     = p - lr * delta                  (rounded to p's dtype)
//
// all in float32.  Each product, sum and quotient rounds where the
// plain version's tensor ops round on the card (PyTorch's CUDA
// `a + alpha * b` and `addcmul` contract to one fma), written with
// explicit _rn intrinsics so nvcc cannot contract them otherwise: the
// kernel gives the plain version's bits.
//
// p and g are float32 or bfloat16 (a bf16 tree may hold float32
// leaves), m and v float32.  scale, lr, b1c and b2c are 0-d float32
// tensors on the card, read through pointers at run time, so a
// captured CUDA graph reads each replay's values; the constants b1,
// 1 - b1, b2, 1 - b2, eps and wd come as floats.
//
// Bound on the H100: reading p, g, m, v once and writing p, m, v once is
// 22 bytes a bf16 parameter (28 in float32) at ~15 flop, so HBM at
// 3.35 TB/s is the only limit.  Each thread takes 4 consecutive
// elements a step (16-byte loads of m and v, 8- or 16-byte loads of p
// and g), neighbouring threads on neighbouring addresses, in a
// grid-stride loop over at most 8 CTAs an SM; where a pointer is not
// aligned for that, the whole leaf takes the scalar loop, which also
// covers the tail past the last whole vector.  Offsets are 64-bit.
// Nothing is allocated and nothing waits for the host.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Consts {
  float b1, c1, b2, c2, eps, wd;
};

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ void load4(const float* p, long long i,
                                               float (&x)[4]) {
    const float4 t = reinterpret_cast<const float4*>(p)[i];
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  }
  static __device__ __forceinline__ void store4(float* p, long long i,
                                                const float (&x)[4]) {
    reinterpret_cast<float4*>(p)[i] = make_float4(x[0], x[1], x[2], x[3]);
  }
  static __device__ __forceinline__ float load1(const float* p, long long i) {
    return p[i];
  }
  static __device__ __forceinline__ void store1(float* p, long long i,
                                                float x) {
    p[i] = x;
  }
};

// bf16 -> f32 is exact: the bf16 bits are the high half of the f32;
// f32 -> bf16 rounds to nearest even, as PyTorch's copy_ does.
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                               long long i, float (&x)[4]) {
    const uint2 t = reinterpret_cast<const uint2*>(p)[i];
    x[0] = __uint_as_float(t.x << 16);
    x[1] = __uint_as_float(t.x & 0xffff0000u);
    x[2] = __uint_as_float(t.y << 16);
    x[3] = __uint_as_float(t.y & 0xffff0000u);
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, long long i,
                                                const float (&x)[4]) {
    uint2 t;
    t.x = bf16_bits(x[0]) | (bf16_bits(x[1]) << 16);
    t.y = bf16_bits(x[2]) | (bf16_bits(x[3]) << 16);
    reinterpret_cast<uint2*>(p)[i] = t;
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p,
                                                long long i) {
    return __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ void store1(__nv_bfloat16* p, long long i,
                                                float x) {
    p[i] = __float2bfloat16_rn(x);
  }
};

// One element, in the plain version's order and roundings.
__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       float scale, float lr, float b1c,
                                       float b2c, const Consts& c) {
  g = __fmul_rn(g, scale);
  m = __fmaf_rn(g, c.c1, __fmul_rn(m, c.b1));
  v = __fmaf_rn(__fmul_rn(g, g), c.c2, __fmul_rn(v, c.b2));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, b2c)), c.eps);
  float delta = __fdiv_rn(__fdiv_rn(m, b1c), den);
  delta = __fmaf_rn(p, c.wd, delta);
  p = __fsub_rn(p, __fmul_rn(delta, lr));
}

// Elements [0, 4 * nvec) as nvec vectors of 4, then [4 * nvec, n) one by
// one; nvec is 0 when a pointer is not aligned for the vectors.
template <typename PT, typename GT>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(PT* __restrict__ p, const GT* __restrict__ g,
             float* __restrict__ m, float* __restrict__ v,
             const float* __restrict__ scale_p,
             const float* __restrict__ lr_p, const float* __restrict__ b1c_p,
             const float* __restrict__ b2c_p, long long n, long long nvec,
             Consts c) {
  const float scale = *scale_p, lr = *lr_p, b1c = *b1c_p, b2c = *b2c_p;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long i = first; i < nvec; i += stride) {
    float pp[4], gg[4], mm[4], vv[4];
    Io<PT>::load4(p, i, pp);
    Io<GT>::load4(g, i, gg);
    Io<float>::load4(m, i, mm);
    Io<float>::load4(v, i, vv);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      update(pp[k], gg[k], mm[k], vv[k], scale, lr, b1c, b2c, c);
    Io<PT>::store4(p, i, pp);
    Io<float>::store4(m, i, mm);
    Io<float>::store4(v, i, vv);
  }
  for (long long i = 4 * nvec + first; i < n; i += stride) {
    float pp = Io<PT>::load1(p, i), mm = m[i], vv = v[i];
    update(pp, Io<GT>::load1(g, i), mm, vv, scale, lr, b1c, b2c, c);
    Io<PT>::store1(p, i, pp);
    m[i] = mm;
    v[i] = vv;
  }
}

template <typename PT, typename GT>
void launch(void* p, const void* g, float* m, float* v, const float* scale,
            const float* lr, const float* b1c, const float* b2c, long long n,
            long long nvec, const Consts& c, int grid, cudaStream_t stream) {
  adamw_kernel<PT, GT><<<grid, kThreads, 0, stream>>>(
      (PT*)p, (const GT*)g, m, v, scale, lr, b1c, b2c, n, nvec, c);
}

}  // namespace

// One launch of `grid` CTAs on `stream` over the n elements of one leaf,
// updated in place; returns the launch's cudaError_t.  p_dtype and
// g_dtype: 0 float32, 1 bfloat16 (as ops._DTYPES).  c1 = 1 - b1 and
// c2 = 1 - b2 as the wrapper rounds them from double.  n == 0 launches
// nothing (the wrapper never asks for it).
extern "C" int rt_adamw_update(void* p, const void* g, float* m, float* v,
                               const float* scale, const float* lr,
                               const float* b1c, const float* b2c,
                               long long n, long long nvec, int p_dtype,
                               int g_dtype, float b1, float c1, float b2,
                               float c2, float eps, float wd, int grid,
                               void* stream) {
  if (n <= 0) return 0;
  const Consts c{b1, c1, b2, c2, eps, wd};
  cudaStream_t s = (cudaStream_t)stream;
  if (p_dtype == 0 && g_dtype == 0) {
    launch<float, float>(p, g, m, v, scale, lr, b1c, b2c, n, nvec, c, grid, s);
  } else if (p_dtype == 1 && g_dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(p, g, m, v, scale, lr, b1c, b2c, n,
                                         nvec, c, grid, s);
  } else if (p_dtype == 1 && g_dtype == 0) {
    launch<__nv_bfloat16, float>(p, g, m, v, scale, lr, b1c, b2c, n, nvec, c,
                                 grid, s);
  } else if (p_dtype == 0 && g_dtype == 1) {
    launch<float, __nv_bfloat16>(p, g, m, v, scale, lr, b1c, b2c, n, nvec, c,
                                 grid, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
