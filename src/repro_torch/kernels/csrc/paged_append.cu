// paged_attention_append: the fused decode tail for one layer (GQA/MQA),
// split across CTAs over the key range (flash decoding).
//
// Replaces the Pallas kernel repro/kernels/paged_attention.py
// (paged_attention_append), which on the model path stands for
// write_token_paged + _paged_ref + _merge_self.  Semantics: write the new
// token's K/V row into the tail block tables[b, min(lens // BT, MB - 1)]
// at offset lens - jt * BT (dropped when the table is full), then attend
// the G query rows that share a kv head over the lens + 1 positions
// (window > 0 keeps pos >= lens + 1 - window, softcap > 0 caps the
// logits).  NULL (-1) table entries are clamped to block 0 and masked by
// length.
//
// Bound on the H100: ~2 * G flops per K/V byte (16 at gemma-2b's G = 8),
// far below the card's ~295 flop/byte balance, so the bound is the K/V
// bytes of the live keys over 3.35 TB/s and tensor cores would gain
// nothing.  The first design gave one CTA per (b, kv head) -- 4 CTAs at
// gemma-2b's 4 slots -- each walking its blocks one dependent load after
// another.  This one:
//
// 1. split kernel, grid (B * KVH, S): split s takes the W key positions
//    [s * W, (s + 1) * W), W a multiple or a divisor of BT.  S and W come
//    from the host's plan (ops.plan_decode_splits: shapes only, never the
//    lengths, so no host sync); a split whose range holds no live key
//    writes an empty partial and exits.  The split that holds position
//    lens writes the new row to the pool and takes that row from
//    k_new/v_new, never from the pool (empty slots share a sink block,
//    whose rows other CTAs may be writing).  Each block's K and V tiles
//    are staged in shared memory by bulk copies, one per live key row,
//    double-buffered when a split spans more than one block; q is loaded
//    while the first copies fly.
//    The live keys go in chunks of 32, one per lane:
//      scores: warp w takes the 16-byte vectors w, w + 8, ... of the
//        head dimension; lane t reads its key's vectors (K rows padded
//        by 16 bytes, so the lanes' reads hit distinct banks) against
//        q * scale (float32, the same address across the warp) and keeps
//        G partial dot products -- no shuffles; the 8 warps' partials
//        meet in shared memory;
//      softmax: warp r takes row r, lane t sums its key's 8 partials and
//        the row's max and sum come from two warp reductions;
//      values: thread d owns value column d, reads V from shared memory
//        and p four keys at a time.
//    Only the live K rows are staged; V also the few rows that share a
//    group of four with a live one, zero-filled.
//    The split writes (m, l, acc[G][VD]) in float32 to a workspace, or,
//    when S == 1, the normalised output itself;
// 2. merge kernel (fp::merge_kernel, shared with #7), grid (B * KVH * G),
//    one CTA per query row: combines the S partials with the log-sum-exp
//    rule,
//      O = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s,  M = max m_s,
//    over the splits with l_s > 0; a row with no key gives 0.
#include "flash_paged.cuh"

namespace {

// query rows (heads sharing a kv head) one CTA holds in registers
constexpr int kMaxRows = 16;

struct AppendSmem {
  void* k;      // [stages][BT32][HD + E] T
  void* v;      // [stages][BT32][VD] T
  float* qs;    // [G][HD]  q * scale
  float* part;  // [8][G][32] partial scores of a chunk of 32 keys
  float* ps;    // [G][32] probabilities of the chunk
  float* acc;   // [G][VD]
  float* m;     // [G]
  float* l;     // [G]
  float* alpha; // [G]
  uint64_t* bars;  // [2] mbarriers of the two stages
};

// BT rounded up to a whole chunk of 32 keys (the padding rows are zeros)
__host__ __device__ inline int round32(int n) { return (n + 31) & ~31; }

__host__ __device__ inline AppendSmem carve_append(void* base, int es, int stages,
                                                   int G, int HD, int VD, int BT,
                                                   size_t* bytes) {
  const int BT32 = round32(BT), E = 16 / es;
  fp::Carve c(base);
  AppendSmem s;
  s.k = c.take<char>((size_t)stages * BT32 * (HD + E) * es);
  s.v = c.take<char>((size_t)stages * BT32 * VD * es);
  s.qs = c.take<float>((size_t)G * HD);
  s.part = c.take<float>((size_t)rt::kWarps * G * 32);
  s.ps = c.take<float>((size_t)G * 32);
  s.acc = c.take<float>((size_t)G * VD);
  s.m = c.take<float>(G);
  s.l = c.take<float>(G);
  s.alpha = c.take<float>(G);
  s.bars = c.take<uint64_t>(2);
  if (bytes) *bytes = c.used;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(rt::kThreads, 1)
append_split_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                    const T* __restrict__ v_new, T* k_pool, T* v_pool,
                    const int* __restrict__ tables, const int* __restrict__ lens,
                    T* __restrict__ out, float* __restrict__ part, int KVH, int G,
                    int HD, int VD, int BT, int MB, int W, int stages,
                    float scale, float softcap, int window) {
  extern __shared__ float4 smem_raw[];
  constexpr int E = fp::vec_elems<T>();
  const int bh = blockIdx.x, split = blockIdx.y, S = gridDim.y;
  const int b = bh / KVH, h = bh % KVH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int BT32 = round32(BT), KS = HD + E, nv = HD / E;
  const AppendSmem s =
      carve_append(smem_raw, sizeof(T), stages, G, HD, VD, BT, nullptr);
  T* ks = static_cast<T*>(s.k);
  T* vs = static_cast<T*>(s.v);
  const int* table = tables + (size_t)b * MB;
  // the split's first table entry, loaded beside lens[b], not after it
  const int j_first = min(split * W / BT, MB - 1);
  const int phys_first = max(table[j_first], 0);
  const int len = lens[b];
  const int jt = min(len / BT, MB - 1);
  const int off = len - jt * BT;
  const bool append = off < BT;  // a full table drops the write
  const T* kn = k_new + (size_t)bh * HD;
  const T* vn = v_new + (size_t)bh * VD;
  if (append && len / W == split) {
    const int tail = max(table[jt], 0);
    T* kdst = k_pool + ((size_t)(tail * BT + off) * KVH + h) * HD;
    T* vdst = v_pool + ((size_t)(tail * BT + off) * KVH + h) * VD;
    for (int d = tid; d < HD; d += rt::kThreads) kdst[d] = kn[d];
    for (int d = tid; d < VD; d += rt::kThreads) vdst[d] = vn[d];
  }
  const int key_hi = min(len + 1, MB * BT);
  const int key_lo = window > 0 ? max(len + 1 - window, 0) : 0;
  const int lo = max(key_lo, split * W), hi = min(key_hi, (split + 1) * W);
  float* pm = part + ((size_t)bh * S + split) * G * (VD + 2);  // m[G] l[G] acc
  if (hi <= lo) {
    if (S > 1) {
      for (int r = tid; r < G; r += rt::kThreads) {
        pm[r] = rt::kNeg;
        pm[G + r] = 0.f;
      }
    } else {
      for (int i = tid; i < G * VD; i += rt::kThreads)
        out[(size_t)bh * G * VD + i] = rt::from_f<T>(0.f);
    }
    return;
  }
  const int pos_new = append ? len : -1;
  auto stage = [&](int j, int buf, uint64_t* bar) {
    const int phys = j == j_first ? phys_first : max(table[j], 0);
    const int t_lo = max(lo - j * BT, 0), t_hi = min(hi - j * BT, BT);
    const int t_new = (pos_new >= j * BT && pos_new < (j + 1) * BT) ? pos_new - j * BT : -1;
    if (tid == 0)
      fp::mbar_expect(bar, fp::staged_bytes(HD + VD, sizeof(T), t_lo, t_hi, t_new));
    // K: the live rows only (a dead lane's score is masked by a select);
    // V: also the rows that share a group of 4 with a live one (p = 0)
    fp::stage_rows<T>(ks + (size_t)buf * BT32 * KS, KS, k_pool, HD, phys, BT, KVH, h,
                      HD, t_lo, t_hi, t_lo, t_hi, t_new, kn, bar);
    fp::stage_rows<T>(vs + (size_t)buf * BT32 * VD, VD, v_pool, VD, phys, BT, KVH, h,
                      VD, t_lo & ~3, (t_hi + 3) & ~3, t_lo, t_hi, t_new, vn, bar);
  };
  auto init = [&]() {
    const T* qb = q + (size_t)bh * G * HD;
    for (int i = tid; i < G * HD; i += rt::kThreads) s.qs[i] = rt::to_f(qb[i]) * scale;
    for (int i = tid; i < G * VD; i += rt::kThreads) s.acc[i] = 0.f;
    for (int r = tid; r < G; r += rt::kThreads) {
      s.m[r] = rt::kNeg;
      s.l[r] = 0.f;
    }
  };
  auto compute = [&](int j, int buf) {
    const T* kb = ks + (size_t)buf * BT32 * KS;
    const T* vb = vs + (size_t)buf * BT32 * VD;
    const int t_lo = max(lo - j * BT, 0), t_hi = min(hi - j * BT, BT);
    for (int t0 = t_lo & ~31; t0 < t_hi; t0 += 32) {
      // 1. partial scores: lane = key t0 + lane, warp = a slice of HD
      {
        float acc_r[kMaxRows];
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) acc_r[r] = 0.f;
        const T* krow = kb + (size_t)(t0 + lane) * KS;
        for (int v = warp; v < nv; v += rt::kWarps) {
          float kv[E];
          fp::load_vec(krow + v * E, kv);
#pragma unroll
          for (int r = 0; r < kMaxRows; ++r) {
            if (r < G) {
              float qv[E];
#pragma unroll
              for (int c = 0; c < E; c += 4) fp::load_vec(s.qs + r * HD + v * E + c, qv + c);
#pragma unroll
              for (int e = 0; e < E; ++e) acc_r[r] += qv[e] * kv[e];
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r)
          if (r < G) s.part[(warp * G + r) * 32 + lane] = acc_r[r];
      }
      __syncthreads();
      // 2. online softmax over the chunk, warp r for row r
      for (int r = warp; r < G; r += rt::kWarps) {
        const int t = t0 + lane;
        float x = 0.f;
#pragma unroll
        for (int w = 0; w < rt::kWarps; ++w) x += s.part[(w * G + r) * 32 + lane];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        x = (t >= t_lo && t < t_hi) ? x : rt::kNeg;
        const float m_old = s.m[r];
        const float m_new = fmaxf(m_old, rt::warp_max(x));
        const float p = (x <= rt::kNeg) ? 0.f : expf(x - m_new);
        s.ps[r * 32 + lane] = p;
        const float psum = rt::warp_sum(p);
        if (lane == 0) {
          const float a = (m_old <= rt::kNeg) ? 0.f : expf(m_old - m_new);
          s.alpha[r] = a;
          s.m[r] = m_new;
          s.l[r] = s.l[r] * a + psum;
        }
      }
      __syncthreads();
      // 3. values, thread d owns column d; keys outside [t_lo, t_hi) have
      //    p = 0 and zero-filled V rows
      const float4* ps4 = reinterpret_cast<const float4*>(s.ps);
      const int c_lo = (max(t_lo, t0) - t0) / 4, c_hi = (min(t_hi, t0 + 32) - t0 + 3) / 4;
      for (int d = tid; d < VD; d += rt::kThreads) {
        float a[kMaxRows];
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r)
          if (r < G) a[r] = s.acc[r * VD + d] * s.alpha[r];
        for (int c = c_lo; c < c_hi; ++c) {
          const T* vt = vb + (size_t)(t0 + 4 * c) * VD + d;
          const float v0 = rt::to_f(vt[0]), v1 = rt::to_f(vt[VD]),
                      v2 = rt::to_f(vt[2 * VD]), v3 = rt::to_f(vt[3 * VD]);
#pragma unroll
          for (int r = 0; r < kMaxRows; ++r) {
            if (r < G) {
              const float4 p = ps4[r * 8 + c];
              a[r] += p.x * v0 + p.y * v1 + p.z * v2 + p.w * v3;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r)
          if (r < G) s.acc[r * VD + d] = a[r];
      }
      __syncthreads();
    }
  };
  fp::pipeline(lo / BT, (hi + BT - 1) / BT, stages, s.bars, stage, init, compute);
  if (S == 1) {
    for (int i = tid; i < G * VD; i += rt::kThreads) {
      const int r = i / VD;
      out[(size_t)bh * G * VD + i] = rt::from_f<T>(s.acc[i] / fmaxf(s.l[r], 1e-30f));
    }
    return;
  }
  for (int r = tid; r < G; r += rt::kThreads) {
    pm[r] = s.m[r];
    pm[G + r] = s.l[r];
  }
  for (int i = tid; i < G * VD; i += rt::kThreads) pm[2 * G + i] = s.acc[i];
}

}  // namespace

// Launches the split kernel on a (B * KVH, S) grid, each split taking W
// key positions (W a multiple or a divisor of BT), then (S > 1) the merge
// kernel.  `part` is a float32 workspace of B * KVH * S * G * (VD + 2)
// elements (unused when S == 1).  dtype: 0 = float32, 1 = bfloat16.  HD
// and VD must fill whole 16-byte vectors and the pools be 16-byte
// aligned.  Returns the first failing launch's cudaError_t (0 on
// success); the kernels run on `stream` asynchronously.
extern "C" int rt_paged_attention_append(
    const void* q, const void* k_new, const void* v_new, void* k_pool, void* v_pool,
    const int* tables, const int* lens, void* out, void* part, int B, int KVH,
    int G, int HD, int VD, int BT, int MB, int S, int W, float scale,
    float softcap, int window, int dtype, void* stream) {
  if (B <= 0) return 0;
  if (G < 1 || G > kMaxRows || S < 1 || W < 1 || (W % BT && BT % W) ||
      (S - 1) * W >= MB * BT || S * W < MB * BT)
    return (int)cudaErrorInvalidValue;
  return rt::dispatch(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    constexpr int E = fp::vec_elems<T>();
    if (HD % E || VD % E) return (int)cudaErrorInvalidValue;
    size_t smem = 0;
    int stages = W > BT ? 2 : 1;
    carve_append(nullptr, sizeof(T), stages, G, HD, VD, BT, &smem);
    if (smem > fp::kSmemLimit && stages == 2) {
      stages = 1;
      carve_append(nullptr, sizeof(T), stages, G, HD, VD, BT, &smem);
    }
    if (smem > fp::kSmemLimit) return (int)cudaErrorInvalidValue;
    const int rc = rt::launch(append_split_kernel<T>, dim3(B * KVH, S), smem,
                              (cudaStream_t)stream, (const T*)q, (const T*)k_new,
                              (const T*)v_new, (T*)k_pool, (T*)v_pool, tables, lens,
                              (T*)out, (float*)part, KVH, G, HD, VD, BT, MB, W,
                              stages, scale, softcap, window);
    if (rc != 0 || S == 1) return rc;
    return rt::launch(fp::merge_kernel<T>, dim3(B * KVH * G),
                      (size_t)S * sizeof(float), (cudaStream_t)stream,
                      (const float*)part, (const float*)nullptr,
                      (const float*)nullptr, (T*)out, S, G, VD);
  });
}
