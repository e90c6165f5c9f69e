// paged_attention: flash decode of one query token per row over the
// seq_lens cached tokens, with no append -- absorbed MLA's decode
// attention -- split across CTAs over the key range.
//
// Replaces the Pallas kernel repro/kernels/paged_attention.py
// (paged_attention).  GQA/MQA with softcap and scale; window > 0 keeps
// pos >= lens - window (the Pallas kernel's convention, one position
// wider than the append kernel's), window <= 0 is global; NULL (-1)
// table entries are clamped to block 0 and masked by length, lengths
// above MB * BT clamped; a row with no key gives 0.  MLA latent mode:
// V is the first VD lanes of the K pool's rows (v_pool == k_pool, V row
// stride HD); absorbed MLA decode runs G = 40 query heads over one
// latent "kv head" of HD = 288 with VD = 256.  Optionally one more term
// enters the softmax: a score and a value per (row, head) given in
// float32 -- the new token of absorbed MLA decode, which the reference
// merges after attending the cache (_merge_self), with its score in
// float32 where the cached keys' scores take q rounded to the pool dtype.
//
// Bound on the H100: ~2 * G flops per K/V byte (80 at G = 40, ~20 in
// float32 per float), below the card's ~295 flop/byte balance in bf16,
// so the bound is the latent bytes of the cached keys over 3.35 TB/s
// (~0.0002 ms at MiniCPM3-4B's recorded call: 624 cached keys).  At that size
// the time is latency, so the design puts many CTAs and copies in flight
// and reads each latent row once for all heads:
//
// 1. split kernel, grid (B * KVH, S): split s takes the W key positions
//    [s * W, (s + 1) * W), W a multiple or a divisor of BT, from the
//    host's plan (ops.plan_decode_splits, from shapes only: 12 splits of
//    32 keys, 48 CTAs, at the recorded call).  A split whose range holds
//    no live key writes an empty partial and exits.  One CTA holds all
//    G heads of its (row, kv head), padded to GP = 16 * ceil(G / 16)
//    rows, so each key row is read from device memory once.  Each
//    block's K tile (its live rows, KT = W or BT rows rounded up to 16)
//    is staged in shared memory by bulk copies (fp::stage_rows),
//    double-buffered when a split spans more than one block; in latent
//    mode the 288-wide row is staged once and V read from its first 256
//    lanes in shared memory, a separate V pool stages its VD lanes.  q
//    is loaded while the first copies fly.  Per tile:
//      S = Q K^T: bfloat16 on tensor cores (wmma 16x16x16, float32
//        accumulation), the (GP / 16) x (live column tiles) fragments
//        split over the head dimension between warps when there are
//        fewer than 16 of them; the partial tiles are summed by the
//        softmax;
//      softmax, one half-warp per row: scale, softcap, mask, online
//        (m, l) update, O's row rescaled by e^(m_old - m_new); P split
//        into hi = bf16(p) and lo = bf16(p - hi), so P V keeps P's
//        float32 precision to ~2^-18 of p;
//      O += P V on tensor cores over the 16-key slices that hold live
//        keys (dead rows of a slice zero-filled), O a float32 tile in
//        shared memory; warp w takes V's column tiles 2w, 2w + 1 (+16...)
//        for all row tiles, loading each P fragment once per slice.
//    Float32 pools, and bfloat16 widths that are not multiples of 16, run
//    the same tiling with both products on CUDA cores (chosen on the
//    host from dtype and shape).  The split writes (m, l, acc[G][VD]) in
//    float32 to a workspace;
// 2. merge kernel (fp::merge_kernel, shared with #1), one CTA per query
//    row: the log-sum-exp merge of the S partials and the extra term.
#include "flash_paged.cuh"

#include <mma.h>

#include <type_traits>

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kMaxHeads = 64;  // query heads one CTA holds: 4 MMA row tiles
constexpr int kMaxRT = kMaxHeads / 16;

struct DecodeSmem {
  void* k;      // [stages][KT][HD + E] T
  void* v;      // [stages][KT][VD + E] T (a separate V pool only)
  void* qs;     // [GP][HD + E] T
  float* sc;    // [parts][GP][KT + 4] partial scores; part 0 then holds p
  bf16* p_hi;   // [GP][KT + 8] (tensor-core route only)
  bf16* p_lo;   // [GP][KT + 8]
  float* o;     // [GP][VD + 4]
  float* m;     // [GP]
  float* l;     // [GP]
  uint64_t* bars;  // [2] mbarriers of the two stages
};

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

// Warps that share one S fragment, each over a slice of the head
// dimension: enough that the fragments x parts give every warp about
// two, at most 4 (tensor-core route; the CUDA-core route computes S
// whole).
__host__ __device__ inline int s_parts(bool mma, int nfrag) {
  if (!mma) return 1;
  const int p = (2 * rt::kWarps + nfrag - 1) / nfrag;
  return p < 1 ? 1 : (p > 4 ? 4 : p);
}

__host__ __device__ inline DecodeSmem carve_decode(void* base, int es, bool mma,
                                                   bool shared_kv, int stages,
                                                   int GP, int HD, int VD, int KT,
                                                   size_t* bytes) {
  const int E = 16 / es;
  fp::Carve c(base);
  DecodeSmem s;
  s.k = c.take<char>((size_t)stages * KT * (HD + E) * es);
  s.v = shared_kv ? nullptr : c.take<char>((size_t)stages * KT * (VD + E) * es);
  s.qs = c.take<char>((size_t)GP * (HD + E) * es);
  s.sc = c.take<float>((size_t)s_parts(mma, GP / 16 * (KT / 16)) * GP * (KT + 4));
  s.p_hi = mma ? c.take<bf16>((size_t)GP * (KT + 8)) : nullptr;
  s.p_lo = mma ? c.take<bf16>((size_t)GP * (KT + 8)) : nullptr;
  s.o = c.take<float>((size_t)GP * (VD + 4));
  s.m = c.take<float>(GP);
  s.l = c.take<float>(GP);
  s.bars = c.take<uint64_t>(2);
  if (bytes) *bytes = c.used;
  return s;
}

template <typename T, bool kMma>
__global__ void __launch_bounds__(rt::kThreads, 1)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ tables,
                    const int* __restrict__ lens, float* __restrict__ part,
                    int KVH, int G, int HD, int VD,
                    int VS, int BT, int MB, int W, int stages, float scale,
                    float softcap, int window) {
  extern __shared__ float4 smem_raw[];
  constexpr int E = fp::vec_elems<T>();
  const int bh = blockIdx.x, split = blockIdx.y, S = gridDim.y;
  const int b = bh / KVH, h = bh % KVH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool shared_kv = v_pool == k_pool && VS == HD;
  const int GP = round16(G), nr = GP / 16;
  const int KT = round16(min(W, BT));
  const int KS = HD + E, QS = HD + E, SS = KT + 4, PS = KT + 8, OS = VD + 4;
  const int VSS = shared_kv ? KS : VD + E;  // V's row stride in shared memory
  const int parts = s_parts(kMma, nr * (KT / 16));
  const DecodeSmem s = carve_decode(smem_raw, sizeof(T), kMma, shared_kv, stages,
                                    GP, HD, VD, KT, nullptr);
  T* ks = static_cast<T*>(s.k);
  T* vs = shared_kv ? ks : static_cast<T*>(s.v);
  T* qs = static_cast<T*>(s.qs);
  const int* table = tables + (size_t)b * MB;
  // the split's first table entry, loaded beside lens[b], not after it
  const int j_first = min(split * W / BT, MB - 1);
  const int phys_first = max(table[j_first], 0);
  const int len = lens[b];
  const int key_hi = min(max(len, 0), MB * BT);
  const int key_lo = window > 0 ? max(len - window, 0) : 0;
  const int lo = max(key_lo, split * W), hi = min(key_hi, (split + 1) * W);
  float* pm = part + ((size_t)bh * S + split) * G * (VD + 2);  // m[G] l[G] acc
  if (hi <= lo) {
    for (int r = tid; r < G; r += rt::kThreads) {
      pm[r] = rt::kNeg;
      pm[G + r] = 0.f;
    }
    return;
  }
  // a split narrower than a block takes rows [tb, tb + W) of it; tile row
  // i holds block row tb + i
  const int tb = W < BT ? split * W - (split * W / BT) * BT : 0;
  auto stage = [&](int j, int buf, uint64_t* bar) {
    const int phys = j == j_first ? phys_first : max(table[j], 0);
    const int t_lo = max(lo - j * BT, 0), t_hi = min(hi - j * BT, BT);
    // the 16-row MMA slices that hold the live rows
    const int r_lo = tb + ((t_lo - tb) & ~15), r_hi = tb + round16(t_hi - tb);
    if (tid == 0)
      fp::mbar_expect(bar, fp::staged_bytes(shared_kv ? HD : HD + VD, sizeof(T),
                                            t_lo, t_hi, -1));
    // K: the live rows (dead columns of S are masked by a select); in
    // latent mode also V, so the slices' dead rows are zero-filled (p = 0)
    T* kd = ks + (size_t)buf * KT * KS - (size_t)tb * KS;
    fp::stage_rows<T>(kd, KS, k_pool, HD, phys, BT, KVH, h, HD,
                      shared_kv ? r_lo : t_lo, shared_kv ? r_hi : t_hi, t_lo, t_hi,
                      -1, nullptr, bar);
    if (!shared_kv) {
      T* vd = vs + (size_t)buf * KT * VSS - (size_t)tb * VSS;
      fp::stage_rows<T>(vd, VSS, v_pool, VS, phys, BT, KVH, h, VD, r_lo, r_hi, t_lo,
                        t_hi, -1, nullptr, bar);
    }
  };
  auto init = [&]() {
    // q: rows r < G from (bh, r), rows up to GP zero; 16-byte vectors
    const T* qb = q + (size_t)bh * G * HD;
    const int nv = HD / E;
    for (int i = tid; i < GP * nv; i += rt::kThreads) {
      const int r = i / nv, v = i - r * nv;
      *reinterpret_cast<uint4*>(qs + (size_t)r * QS + v * E) =
          r < G ? *reinterpret_cast<const uint4*>(qb + (size_t)r * HD + v * E)
                : make_uint4(0, 0, 0, 0);
    }
    for (int i = tid; i < GP * OS; i += rt::kThreads) s.o[i] = 0.f;
    for (int r = tid; r < GP; r += rt::kThreads) {
      s.m[r] = rt::kNeg;
      s.l[r] = 0.f;
    }
  };
  auto compute = [&](int j, int buf) {
    const T* kb = ks + (size_t)buf * KT * KS;
    const T* vb = vs + (size_t)buf * KT * VSS;
    // live rows of this tile, in tile coordinates
    const int i_lo = max(lo - j * BT, 0) - tb, i_hi = min(hi - j * BT, BT) - tb;
    // 1. S = Q K^T (scaled in the softmax), the live column tiles only
    if constexpr (kMma) {
      const int c_lo = i_lo >> 4, ncl = ((i_hi + 15) >> 4) - c_lo;
      const int nks = HD / 16, nf = nr * ncl;
      for (int f = warp; f < nf * parts; f += rt::kWarps) {
        const int pt = f / nf, rem = f - pt * nf;
        const int rtl = rem / ncl, ct = c_lo + rem % ncl;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c0, c1;
        wmma::fill_fragment(c0, 0.f);
        wmma::fill_fragment(c1, 0.f);
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> k0f, k1f;
        const T* qa = qs + (size_t)rtl * 16 * QS;
        const T* kc = kb + (size_t)ct * 16 * KS;
        int st = pt;
        for (; st + parts < nks; st += 2 * parts) {
          wmma::load_matrix_sync(a0, qa + st * 16, QS);
          wmma::load_matrix_sync(k0f, kc + st * 16, KS);
          wmma::load_matrix_sync(a1, qa + (st + parts) * 16, QS);
          wmma::load_matrix_sync(k1f, kc + (st + parts) * 16, KS);
          wmma::mma_sync(c0, a0, k0f, c0);
          wmma::mma_sync(c1, a1, k1f, c1);
        }
        if (st < nks) {
          wmma::load_matrix_sync(a0, qa + st * 16, QS);
          wmma::load_matrix_sync(k0f, kc + st * 16, KS);
          wmma::mma_sync(c0, a0, k0f, c0);
        }
#pragma unroll
        for (int i = 0; i < c0.num_elements; ++i) c0.x[i] += c1.x[i];
        wmma::store_matrix_sync(s.sc + ((size_t)pt * GP + rtl * 16) * SS + ct * 16, c0,
                                SS, wmma::mem_row_major);
      }
    } else {
      const int n = i_hi - i_lo;
      for (int i = tid; i < G * n; i += rt::kThreads) {
        const int r = i / n, t = i_lo + (i - r * n);
        float acc = 0.f;
        for (int d = 0; d < HD; d += E) {
          float qv[E], kv[E];
          fp::load_vec(qs + (size_t)r * QS + d, qv);
          fp::load_vec(kb + (size_t)t * KS + d, kv);
#pragma unroll
          for (int e = 0; e < E; ++e) acc += qv[e] * kv[e];
        }
        s.sc[r * SS + t] = acc;
      }
    }
    __syncthreads();
    // 2. online softmax, one half-warp per row; O's row rescaled here
    for (int r = warp * 2 + (lane >> 4); r < GP; r += 2 * rt::kWarps) {
      const int l16 = lane & 15;
      float* sr = s.sc + (size_t)r * SS;
      float bmax = rt::kNeg;
      for (int t = l16; t < KT; t += 16) {
        float x = sr[t];
        for (int pt = 1; pt < parts; ++pt) x += sr[(size_t)pt * GP * SS + t];
        x *= scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        x = (r < G && t >= i_lo && t < i_hi) ? x : rt::kNeg;
        sr[t] = x;
        bmax = fmaxf(bmax, x);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, o));
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
        float4* o4 = reinterpret_cast<float4*>(s.o + (size_t)r * OS);
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
    // 3. O += P V over the 16-key slices that hold live keys
    if constexpr (kMma) {
      const int nd = VD / 16, k_lo = i_lo & ~15;
      for (int cg = warp * 2; cg < nd; cg += 2 * rt::kWarps) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[kMaxRT][2];
#pragma unroll
        for (int rtl = 0; rtl < kMaxRT; ++rtl)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (rtl < nr && cg + i < nd)
              wmma::load_matrix_sync(c[rtl][i],
                                     s.o + (size_t)rtl * 16 * OS + (cg + i) * 16, OS,
                                     wmma::mem_row_major);
        for (int k0 = k_lo; k0 < i_hi; k0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ph[kMaxRT],
              pl[kMaxRT];
#pragma unroll
          for (int rtl = 0; rtl < kMaxRT; ++rtl) {
            if (rtl < nr) {
              wmma::load_matrix_sync(ph[rtl], s.p_hi + rtl * 16 * PS + k0, PS);
              wmma::load_matrix_sync(pl[rtl], s.p_lo + rtl * 16 * PS + k0, PS);
            }
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (cg + i < nd) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
              wmma::load_matrix_sync(vf, vb + (size_t)k0 * VSS + (cg + i) * 16, VSS);
#pragma unroll
              for (int rtl = 0; rtl < kMaxRT; ++rtl) {
                if (rtl < nr) {
                  wmma::mma_sync(c[rtl][i], ph[rtl], vf, c[rtl][i]);
                  wmma::mma_sync(c[rtl][i], pl[rtl], vf, c[rtl][i]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int rtl = 0; rtl < kMaxRT; ++rtl)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (rtl < nr && cg + i < nd)
              wmma::store_matrix_sync(s.o + (size_t)rtl * 16 * OS + (cg + i) * 16,
                                      c[rtl][i], OS, wmma::mem_row_major);
      }
    } else {
      for (int i = tid; i < G * VD; i += rt::kThreads) {
        const int r = i / VD, d = i - r * VD;
        float acc = s.o[r * OS + d];
        for (int t = i_lo; t < i_hi; ++t)
          acc += s.sc[r * SS + t] * rt::to_f(vb[(size_t)t * VSS + d]);
        s.o[r * OS + d] = acc;
      }
    }
  };
  fp::pipeline(lo / BT, (hi + BT - 1) / BT, stages, s.bars, stage, init, compute);
  for (int r = tid; r < G; r += rt::kThreads) {
    pm[r] = s.m[r];
    pm[G + r] = s.l[r];
  }
  for (int i = tid; i < G * VD; i += rt::kThreads) {
    const int r = i / VD, d = i - r * VD;
    pm[2 * G + i] = s.o[r * OS + d];
  }
}

template <typename T, typename O>
int run_decode(const void* q, const void* k_pool, const void* v_pool,
               const int* tables, const int* lens, const float* self_s,
               const float* self_v, void* out, void* part, int B, int KVH, int G,
               int HD, int VD, int VS, int BT, int MB, int S, int W, float scale,
               float softcap, int window, cudaStream_t stream) {
  constexpr int E = fp::vec_elems<T>();
  const bool shared_kv = v_pool == k_pool && VS == HD;
  if (HD % E || VS % E || VD % E) return (int)cudaErrorInvalidValue;
  // the route, from dtype and shape: tensor cores for bfloat16 tiles of 16
  const bool mma = std::is_same<T, bf16>::value && HD % 16 == 0 && VD % 16 == 0;
  const int GP = round16(G), KT = round16(W < BT ? W : BT);
  size_t smem = 0;
  int stages = W > BT ? 2 : 1;
  carve_decode(nullptr, sizeof(T), mma, shared_kv, stages, GP, HD, VD, KT, &smem);
  if (smem > fp::kSmemLimit && stages == 2) {
    stages = 1;
    carve_decode(nullptr, sizeof(T), mma, shared_kv, stages, GP, HD, VD, KT, &smem);
  }
  if (smem > fp::kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kern = mma ? decode_split_kernel<T, std::is_same<T, bf16>::value>
                  : decode_split_kernel<T, false>;
  const int rc = rt::launch(kern, dim3(B * KVH, S), smem, stream, (const T*)q,
                            (const T*)k_pool, (const T*)v_pool, tables, lens,
                            (float*)part, KVH, G, HD, VD, VS, BT, MB, W, stages, scale,
                            softcap, window);
  if (rc != 0) return rc;
  return rt::launch(fp::merge_kernel<O>, dim3(B * KVH * G), (size_t)S * sizeof(float),
                    stream, (const float*)part, self_s, self_v, (O*)out, S, G, VD);
}

}  // namespace

// q (B, KVH, G, HD); v_pool may be k_pool (MLA latent mode); VS is V's
// row stride in elements (VD for a separate V pool, HD for the latent
// pool).  self_s (B, KVH, G) and self_v (B, KVH, VD), float32, both null
// or both given: the extra term's score and value.  The split kernel
// runs on a (B * KVH, S) grid, each split taking W key positions (W a
// multiple or a divisor of BT), then the merge kernel.  `part` is a
// float32 workspace of B * KVH * S * G * (VD + 2) elements.  dtype (q
// and the pools) and out_dtype: 0 = float32, 1 = bfloat16; the output is
// q's dtype or float32 (absorbed MLA un-absorbs from float32, as the
// reference does).  HD, VD and VS must fill whole 16-byte vectors and q
// and the pools be 16-byte aligned; G <= 64.  Returns the first failing
// launch's cudaError_t (0 on success); the kernels run on `stream`
// asynchronously.
extern "C" int rt_paged_attention(const void* q, const void* k_pool,
                                  const void* v_pool, const int* tables,
                                  const int* lens, const float* self_s,
                                  const float* self_v, void* out, void* part, int B,
                                  int KVH, int G, int HD, int VD, int VS, int BT,
                                  int MB, int S, int W, float scale, float softcap,
                                  int window, int dtype, int out_dtype, void* stream) {
  if (B <= 0) return 0;
  if (G < 1 || G > kMaxHeads || VD < 1 || VD > VS ||
      (out_dtype != dtype && out_dtype != 0) ||
      (self_s == nullptr) != (self_v == nullptr) || S < 1 || W < 1 ||
      (W % BT && BT % W) || (S - 1) * W >= MB * BT || S * W < MB * BT)
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto t, auto o) {
    using T = typename decltype(t)::type;
    using O = typename decltype(o)::type;
    return run_decode<T, O>(q, k_pool, v_pool, tables, lens, self_s, self_v, out, part,
                            B, KVH, G, HD, VD, VS, BT, MB, S, W, scale, softcap, window,
                            (cudaStream_t)stream);
  };
  return rt::dispatch(dtype, [&](auto t) {
    return out_dtype == dtype ? run(t, t) : run(t, rt::Type<float>());
  });
}
