// paged_prefill_attention: suffix prefill through the block table, on
// tensor-core tiles over K/V staged in shared memory.
//
// Replaces the Pallas kernel repro/kernels/paged_prefill.py
// (paged_prefill_attention), which on the model path stands for
// _paged_prefill_ref inside gqa_prefill_paged.  Query i of row b sits at
// absolute position q_starts[b] + i and attends causally to keys
// < kv_lens[b] (window > 0 keeps kv >= q - window + 1); rows with every
// key masked give 0.  The suffix's own K/V is already in the pool.
//
// What held the first design back: 16 query rows per CTA (2 positions at
// G = 8), so every CTA re-read every K/V block up to its causal bound,
// each thread walking a block's keys one dependent device load after
// another, with the dot products in float32 on CUDA cores.
//
// This design: one CTA per (b, kv head, tile of kRT = 16 query rows),
// rows being positions x G, so the G heads that share a kv head also
// share every staged K/V tile (2 positions per CTA at G = 8; a 64-query
// suffix gives 32 CTAs).  The CTA walks the blocks from the tile's first
// key to its last query (blocks wholly before the window or past the
// last query are skipped); each block's K and V tiles are staged by
// bulk copies, one per live key row (dead rows not read),
// double-buffered, and the Q tile by bulk copies beside the first block.
// Per block, padded to KT = BT rounded up to 16 keys:
//   1. S = Q K^T: bfloat16 on tensor cores (wmma 16x16x16 fragments,
//      float32 accumulation).  At KT = 64 the 4 column tiles times 2
//      halves of the head dimension give each of the 8 warps one
//      fragment and half the depth, with two accumulators in turn; the
//      partial tiles are summed by the softmax;
//   2. softmax, one half-warp per row: scale, softcap, mask (kv < kv_len,
//      kv <= q, the window), online (m, l) update, and O's row rescaled
//      by e^(m_old - m_new) (skipped when the max did not move);
//   3. O += P V on tensor cores, O a float32 tile in shared memory
//      (loaded into and stored from accumulator fragments, so no warp
//      holds 16 x VD accumulators in registers), over the 16-key slices
//      that hold live keys; each warp takes VD / 128 column tiles at once
//      and loads each P fragment once for them.  The
//      reference keeps P in float32 for P V; here P is split into two
//      bfloat16 terms, hi = bf16(p) and lo = bf16(p - hi), and both are
//      multiplied by V, which leaves an error of ~2^-16 of p.
// Float32 pools (the reduced configs, float32 decode checks) run the
// same tiling with both products on CUDA cores in float32 (TF32 stays
// off in the port).
//
// Bound on the H100: a 64-query suffix over ~185 keys is ~2 * 16 flops
// per K/V byte per CTA and moves well under a megabyte, so the time is
// latency: a few dependent block loads, which the staging keeps to one
// round trip per block, and each block's chain of products and
// reductions, which the split of S across warps and the independent
// accumulators shorten.
#include "flash_paged.cuh"

#include <mma.h>

#include <type_traits>

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kRT = 16;  // query rows per CTA: one MMA row tile
constexpr int kMaxPV = 4;  // PV column tiles a warp holds at once (VD <= 512)

struct PrefillSmem {
  void* k;      // [stages][KT][HD + E] T
  void* v;      // [stages][KT][VD + E] T
  void* qs;     // [kRT][HD + E] T
  float* sc;    // [parts][kRT][KT + 4] partial scores; part 0 then holds p
  bf16* p_hi;   // [kRT][KT + 8] (bfloat16 pools only)
  bf16* p_lo;   // [kRT][KT + 8]
  float* o;     // [kRT][VD + 4]
  float* m;     // [kRT]
  float* l;     // [kRT]
  int* lo;      // [kRT] first valid key position of the row
  int* hi;      // [kRT] one past its last
  uint64_t* bars;  // [2] mbarriers of the two stages
  int* tbl;     // [MB] the row's block table
};

// Warps that share one S column tile, each over a slice of the head
// dimension (bfloat16 only; float32 computes S whole).
__host__ __device__ inline int s_parts(bool mma, int KT) {
  const int nc = KT / 16;
  return (mma && nc <= rt::kWarps && rt::kWarps % nc == 0) ? rt::kWarps / nc : 1;
}

__host__ __device__ inline PrefillSmem carve_prefill(void* base, int es, bool mma,
                                                     int stages, int HD, int VD,
                                                     int KT, int MB, size_t* bytes) {
  const int E = 16 / es;
  fp::Carve c(base);
  PrefillSmem s;
  s.k = c.take<char>((size_t)stages * KT * (HD + E) * es);
  s.v = c.take<char>((size_t)stages * KT * (VD + E) * es);
  s.qs = c.take<char>((size_t)kRT * (HD + E) * es);
  s.sc = c.take<float>((size_t)s_parts(mma, KT) * kRT * (KT + 4));
  s.p_hi = mma ? c.take<bf16>((size_t)kRT * (KT + 8)) : nullptr;
  s.p_lo = mma ? c.take<bf16>((size_t)kRT * (KT + 8)) : nullptr;
  s.o = c.take<float>((size_t)kRT * (VD + 4));
  s.m = c.take<float>(kRT);
  s.l = c.take<float>(kRT);
  s.lo = c.take<int>(kRT);
  s.hi = c.take<int>(kRT);
  s.bars = c.take<uint64_t>(2);
  s.tbl = c.take<int>(MB);
  if (bytes) *bytes = c.used;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(rt::kThreads, 1)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                     const T* __restrict__ v_pool, const int* __restrict__ tables,
                     const int* __restrict__ kv_lens,
                     const int* __restrict__ q_starts, T* __restrict__ out, int SQ,
                     int KVH, int G, int HD, int VD, int BT, int MB, int stages,
                     float scale, float softcap, int window) {
  extern __shared__ float4 smem_raw[];
  constexpr bool kMma = std::is_same<T, bf16>::value;
  constexpr int E = fp::vec_elems<T>();
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int KT = (BT + 15) & ~15, parts = s_parts(kMma, KT);
  const int KS = HD + E, VS = VD + E, QS = HD + E, SS = KT + 4, PS = KT + 8,
            OS = VD + 4;
  const PrefillSmem s =
      carve_prefill(smem_raw, sizeof(T), kMma, stages, HD, VD, KT, MB, nullptr);
  T* ks = static_cast<T*>(s.k);
  T* vs = static_cast<T*>(s.v);
  T* qs = static_cast<T*>(s.qs);
  // the row's table entries load beside q_starts[b] and kv_lens[b], not
  // after them (the pipeline's first barrier orders them before use)
  for (int i = tid; i < MB; i += rt::kThreads) s.tbl[i] = max(tables[(size_t)b * MB + i], 0);
  const int R = SQ * G, r0 = tile * kRT;
  const int start = q_starts[b], kv_len = kv_lens[b];
  // row rr (position rr / G, head rr % G) attends keys [lo, hi)
  auto range = [&](int rr) {
    const int qa = start + rr / G;
    return make_int2(window > 0 ? max(qa - window + 1, 0) : 0, min(qa + 1, kv_len));
  };
  int key_lo = 1 << 30, key_hi = 0;  // the union of the rows' ranges
  for (int rr = r0; rr < min(r0 + kRT, R); ++rr) {
    const int2 k = range(rr);
    if (k.y > k.x) {
      key_lo = min(key_lo, k.x);
      key_hi = max(key_hi, k.y);
    }
  }
  const int j0 = key_lo / BT, j1 = min((key_hi + BT - 1) / BT, MB);
  auto stage = [&](int j, int buf, uint64_t* bar) {
    const int phys = s.tbl[j];
    const int t_lo = max(key_lo - j * BT, 0), t_hi = min(key_hi - j * BT, BT);
    // the Q tile rides on the first block's barrier: row r is
    // q[b, rr / G, h, rr % G], rows past R zero
    const int nq = j == j0 ? max(min(kRT, R - r0), 0) : 0;
    if (tid == 0)
      fp::mbar_expect(bar, fp::staged_bytes(HD + VD, sizeof(T), t_lo, t_hi, -1) +
                               (unsigned)(nq * HD * sizeof(T)));
    for (int r = tid; r < nq; r += rt::kThreads) {
      const int rr = r0 + r;
      fp::bulk_copy(qs + r * QS,
                    q + ((((size_t)b * SQ + rr / G) * KVH + h) * G + rr % G) * HD,
                    (unsigned)(HD * sizeof(T)), bar);
    }
    if (j == j0 && nq < kRT) {
      for (int i = tid; i < (kRT - nq) * HD; i += rt::kThreads)
        qs[(nq + i / HD) * QS + i % HD] = rt::from_f<T>(0.f);
      fp::fence_proxy_async();
    }
    // K: the live rows only (dead columns of S are masked by a select);
    // V: the live rows' 16-row MMA slices, dead rows zero-filled (p = 0)
    fp::stage_rows<T>(ks + (size_t)buf * KT * KS, KS, k_pool, HD, phys, BT, KVH, h,
                      HD, t_lo, t_hi, t_lo, t_hi, -1, nullptr, bar);
    fp::stage_rows<T>(vs + (size_t)buf * KT * VS, VS, v_pool, VD, phys, BT, KVH, h,
                      VD, t_lo & ~15, (t_hi + 15) & ~15, t_lo, t_hi, -1, nullptr, bar);
  };
  auto init = [&]() {
    for (int i = tid; i < kRT * OS; i += rt::kThreads) s.o[i] = 0.f;
    for (int r = tid; r < kRT; r += rt::kThreads) {
      const int2 k = r0 + r < R ? range(r0 + r) : make_int2(0, 0);
      s.lo[r] = k.x;
      s.hi[r] = k.y;
      s.m[r] = rt::kNeg;
      s.l[r] = 0.f;
    }
  };
  auto compute = [&](int j, int buf) {
    const T* kb = ks + (size_t)buf * KT * KS;
    const T* vb = vs + (size_t)buf * KT * VS;
    // 1. S = Q K^T (scaled in the softmax)
    if constexpr (kMma) {
      const int nc = KT / 16;
      for (int f = warp; f < nc * parts; f += rt::kWarps) {
        const int cf = f % nc, part = f / nc;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c0, c1;
        wmma::fill_fragment(c0, 0.f);
        wmma::fill_fragment(c1, 0.f);
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> k0f, k1f;
        int k0 = part * 16;
        for (; k0 + 16 * parts < HD; k0 += 32 * parts) {
          wmma::load_matrix_sync(a0, qs + k0, QS);
          wmma::load_matrix_sync(k0f, kb + cf * 16 * KS + k0, KS);
          wmma::load_matrix_sync(a1, qs + k0 + 16 * parts, QS);
          wmma::load_matrix_sync(k1f, kb + cf * 16 * KS + k0 + 16 * parts, KS);
          wmma::mma_sync(c0, a0, k0f, c0);
          wmma::mma_sync(c1, a1, k1f, c1);
        }
        if (k0 < HD) {
          wmma::load_matrix_sync(a0, qs + k0, QS);
          wmma::load_matrix_sync(k0f, kb + cf * 16 * KS + k0, KS);
          wmma::mma_sync(c0, a0, k0f, c0);
        }
#pragma unroll
        for (int i = 0; i < c0.num_elements; ++i) c0.x[i] += c1.x[i];
        wmma::store_matrix_sync(s.sc + (size_t)part * kRT * SS + cf * 16, c0, SS,
                                wmma::mem_row_major);
      }
    } else {
      for (int i = tid; i < kRT * KT; i += rt::kThreads) {
        const int r = i / KT, t = i - r * KT;
        float acc = 0.f;
        for (int d = 0; d < HD; d += E) {
          float qv[E], kv[E];
          fp::load_vec(qs + r * QS + d, qv);
          fp::load_vec(kb + (size_t)t * KS + d, kv);
#pragma unroll
          for (int e = 0; e < E; ++e) acc += qv[e] * kv[e];
        }
        s.sc[r * SS + t] = acc;
      }
    }
    __syncthreads();
    // 2. online softmax, one half-warp per row; O's row rescaled here
    {
      const int r = warp * 2 + (lane >> 4), l16 = lane & 15;
      const int lo = s.lo[r], hi = s.hi[r];
      float* sr = s.sc + r * SS;
      float bmax = rt::kNeg;
      for (int t = l16; t < KT; t += 16) {
        const int pos = j * BT + t;
        float x = sr[t];
        for (int pt = 1; pt < parts; ++pt) x += sr[(size_t)pt * kRT * SS + t];
        x *= scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        x = (t < BT && pos >= lo && pos < hi) ? x : rt::kNeg;
        sr[t] = x;
        bmax = fmaxf(bmax, x);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, o));
      const float m_old = s.m[r];
      const float m_new = fmaxf(m_old, bmax);
      float psum = 0.f;
      for (int t = l16; t < KT; t += 16) {
        const float x = sr[t];
        const float p = (x <= rt::kNeg) ? 0.f : expf(x - m_new);
        sr[t] = p;
        psum += p;
        if constexpr (kMma) {
          const bf16 ph = __float2bfloat16(p);
          s.p_hi[r * PS + t] = ph;
          s.p_lo[r * PS + t] = __float2bfloat16(p - __bfloat162float(ph));
        }
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      const float a = (m_old <= rt::kNeg) ? 0.f : expf(m_old - m_new);
      if (a != 1.f) {
        float4* o4 = reinterpret_cast<float4*>(s.o + r * OS);
#pragma unroll 4
        for (int d = l16; d < VD / 4; d += 16) {
          float4 v = o4[d];
          v.x *= a; v.y *= a; v.z *= a; v.w *= a;
          o4[d] = v;
        }
      }
      __syncwarp();
      if (l16 == 0) {
        s.m[r] = m_new;
        s.l[r] = s.l[r] * a + psum;
      }
    }
    __syncthreads();
    // 3. O += P V
    if constexpr (kMma) {
      const int nd = VD / 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[kMaxPV];
#pragma unroll
      for (int i = 0; i < kMaxPV; ++i) {
        const int f = warp + i * rt::kWarps;
        if (f < nd) wmma::load_matrix_sync(c[i], s.o + f * 16, OS, wmma::mem_row_major);
      }
      const int t_lo = max(key_lo - j * BT, 0), t_hi = min(key_hi - j * BT, BT);
      for (int k0 = t_lo & ~15; k0 < t_hi; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ph, pl;
        wmma::load_matrix_sync(ph, s.p_hi + k0, PS);
        wmma::load_matrix_sync(pl, s.p_lo + k0, PS);
#pragma unroll
        for (int i = 0; i < kMaxPV; ++i) {
          const int f = warp + i * rt::kWarps;
          if (f < nd) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
            wmma::load_matrix_sync(vf, vb + k0 * VS + f * 16, VS);
            wmma::mma_sync(c[i], ph, vf, c[i]);
            wmma::mma_sync(c[i], pl, vf, c[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxPV; ++i) {
        const int f = warp + i * rt::kWarps;
        if (f < nd) wmma::store_matrix_sync(s.o + f * 16, c[i], OS, wmma::mem_row_major);
      }
    } else {
      const int t_lo = max(key_lo - j * BT, 0), t_hi = min(key_hi - j * BT, BT);
      for (int i = tid; i < kRT * VD; i += rt::kThreads) {
        const int r = i / VD, d = i - r * VD;
        float acc = s.o[r * OS + d];
        for (int t = t_lo; t < t_hi; ++t)
          acc += s.sc[r * SS + t] * rt::to_f(vb[(size_t)t * VS + d]);
        s.o[r * OS + d] = acc;
      }
    }
  };
  fp::pipeline(j0, j1, stages, s.bars, stage, init, compute);
  for (int i = tid; i < kRT * VD; i += rt::kThreads) {
    const int r = i / VD, d = i - r * VD, rr = r0 + r;
    if (rr >= R) continue;
    out[(((size_t)b * SQ + rr / G) * KVH + h) * G * VD + (size_t)(rr % G) * VD + d] =
        rt::from_f<T>(s.o[r * OS + d] / fmaxf(s.l[r], 1e-30f));
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  bfloat16 needs HD and VD multiples
// of 16 (the MMA tiles) and VD <= 512, float32 multiples of 4 (16-byte
// copies); q and the pools must be 16-byte aligned.  Returns the
// launch's cudaError_t.
extern "C" int rt_paged_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool, const int* tables,
    const int* kv_lens, const int* q_starts, void* out, int B, int SQ, int KVH,
    int G, int HD, int VD, int BT, int MB, float scale, float softcap, int window,
    int dtype, void* stream) {
  if (G < 1 || SQ < 1) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  return rt::dispatch(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    constexpr bool mma = std::is_same<T, bf16>::value;
    const int align = mma ? 16 : 4;
    if (HD % align || VD % align || (mma && VD > 16 * rt::kWarps * kMaxPV))
      return (int)cudaErrorInvalidValue;
    const int KT = (BT + 15) & ~15;
    size_t smem = 0;
    int stages = 2;
    carve_prefill(nullptr, sizeof(T), mma, stages, HD, VD, KT, MB, &smem);
    if (smem > fp::kSmemLimit) {
      stages = 1;
      carve_prefill(nullptr, sizeof(T), mma, stages, HD, VD, KT, MB, &smem);
    }
    if (smem > fp::kSmemLimit) return (int)cudaErrorInvalidValue;
    const dim3 grid((SQ * G + kRT - 1) / kRT, KVH, B);
    return rt::launch(paged_prefill_kernel<T>, grid, smem, (cudaStream_t)stream,
                      (const T*)q, (const T*)k_pool, (const T*)v_pool, tables,
                      kv_lens, q_starts, (T*)out, SQ, KVH, G, HD, VD, BT, MB,
                      stages, scale, softcap, window);
  });
}
