// Split-latent MLA decode over two paged pools, in two passes:
// paged_latent_scores (pass 1) and paged_latent_values (pass 2).
//
// Replaces no Pallas kernel.  The reference's split decode
// (repro/models/attention.py, mla_decode_split) is jnp: a gather of the
// lora and rope streams through the block table, two contractions
// summed into one score, the masked softmax merged with the new token's
// self term, and the probabilities applied to the lora stream.  These
// kernels compute that without the gathered (B, MB * BT, lora) copy.
// The score is the sum of two contractions, so on a model axis whose
// ranks each hold a piece of the lora lanes (Lp of kv_lora) pass 1 gives
// partial scores, the caller sums them over the ranks (one all-reduce,
// the self column riding along), and pass 2 applies the summed softmax
// to the rank's own lanes.  One card, or a whole stream, runs the two
// passes with nothing between them.
//
// Pass 1, rt_paged_latent_scores: q_lat (B, H, Lp) float32 and,
// optionally, q_r (B, H, R) float32 -- both scaled by the caller -- over
// the lora pool (NB, BT, Lp) and the rope pool (NB, BT, R) of float32 or
// bfloat16, through tables (B, MB) int32 (NULL entries clamped to block
// 0) and lens (B,) int32.  Output s (B, H, MB * BT + 1) float32: column
// t the score of cached position t (lora sum, then the rope sum added,
// as the reference adds them) where t < lens, 0 past it -- the mask is
// applied after the ranks' sum, never before -- and the last column the
// new token's score from c_self (B, Lp) and r_self (B, R) float32.
// Grid (B, ceil((MB * BT + 1) / 32)); a CTA stages its row's queries
// and its 32 positions' key rows in shared memory as float32 and gives
// each lane a position and each warp a set of heads (see latent_scores).
// Only valid keys are read, and a CTA whose positions all lie past the
// row's length (and hold no self column) writes its zeros and stages
// nothing, so a short row in a long table costs its live tiles.
//
// Pass 2, rt_paged_latent_values: s as above (summed), the lora pool,
// tables, lens and c_self.  Two launches: latent_probs, grid (B, H),
// takes the masked maximum over the valid positions and the self score,
// the softmax's denominator, and writes the normalised probabilities
// into the workspace p (B, H, MB * BT + 1) (the self term's in its last
// column); latent_apply, grid (B, ceil(Lp / 128), ceil(MB * BT / 512)),
// sums p * c over its split of the valid positions for every head and
// its 128 lora lanes, tile by staged tile, and with one split adds the
// self term p_self * c_self; with several, latent_reduce adds the
// splits' partials (a float32 workspace (B, splits, H, Lp)) in a fixed
// order and the self term.  Output (B, H, Lp) float32; no atomics, so
// every run gives the same bits.
//
// Both buffers are sized from MB * BT by the wrapper (2 MB a row at
// DeepSeek-V2-Lite's 32k context), never from a fixed tile, so any block
// size is taken.
//
// Bound on the H100: the valid keys' bytes (Lp + R lanes a key in pass
// 1, Lp in pass 2) at 3.35 TB/s; the products are ~2 H flop a byte,
// far below the tensor cores' ridge, so HBM is the only limit.  This
// first version is simple: CUDA-core FMAs out of shared memory (pass 1)
// and registers (pass 2), no tensor cores and no cp.async pipeline;
// PERF.md has its times beside the bound.
#include "attention_core.cuh"

namespace {

using rt::kThreads;
using rt::kWarps;
using rt::to_f;
using rt::warp_max;
using rt::warp_sum;

constexpr int kTok = 32;        // positions of a staged tile, one a lane
constexpr int kMaxHeads = 64;   // heads per warp at most kMaxHeads / kWarps
constexpr int kLanes = 128;     // lora lanes a CTA of latent_apply takes
constexpr int kLanesPer = kLanes / 32;
constexpr int kPosPerCta = 512;  // positions a CTA of latent_apply takes

// Pass 1.  One CTA: positions [blockIdx.y * kTok, + kTok) of row b, the
// self column among them if it falls in the range.  The row's queries
// (H x (Lp + R): q_lat's lanes, then q_r's) and the tile's key rows (a
// cached key, or the self row) are staged in shared memory as float32,
// a warp a row; then lane j takes position j of the tile and warp w the
// HPW heads w, w + 8, ...: each key lane read from shared memory (the
// rows' stride odd, so the 32 lanes hit 32 banks) feeds the warp's
// heads, whose query lanes are broadcast reads.
template <typename T, int HPW>
__global__ void __launch_bounds__(kThreads)
latent_scores(const float* __restrict__ q_lat, const float* __restrict__ q_r,
              const T* __restrict__ c_pool, const T* __restrict__ r_pool,
              const int* __restrict__ tables, const int* __restrict__ lens,
              const float* __restrict__ c_self, const float* __restrict__ r_self,
              float* __restrict__ s, int H, int Lp, int R, int BT, int MB) {
  extern __shared__ float sm[];
  const int W = Lp + R;                  // a row's lanes
  const int KS = W | 1;                  // the staged keys' row stride
  float* sq = sm;                        // H * W queries
  float* sk = sm + H * W;                // kTok * KS keys
  const int b = blockIdx.x;
  const int N = MB * BT;
  const int t0 = blockIdx.y * kTok;
  const int len = min(max(lens[b], 0), N);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sb = s + (size_t)b * H * (N + 1);
  if (t0 >= len && t0 + kTok <= N) {     // no valid position, no self column:
    const int t = t0 + lane;             // zeros, and nothing staged
    for (int h = warp; h < H; h += kWarps) sb[(size_t)h * (N + 1) + t] = 0.f;
    return;
  }
  for (int h = warp; h < H; h += kWarps) {
    const float* ql = q_lat + ((size_t)b * H + h) * Lp;
    for (int d = lane; d < Lp; d += 32) sq[h * W + d] = ql[d];
    if (R > 0) {
      const float* qr = q_r + ((size_t)b * H + h) * R;
      for (int d = lane; d < R; d += 32) sq[h * W + Lp + d] = qr[d];
    }
  }
  for (int j = warp; j < kTok; j += kWarps) {
    const int t = t0 + j;
    float* dst = sk + j * KS;
    if (t == N) {                        // the new token's own row
      for (int d = lane; d < Lp; d += 32) dst[d] = c_self[(size_t)b * Lp + d];
      for (int d = lane; d < R; d += 32) dst[Lp + d] = r_self[(size_t)b * R + d];
    } else if (t < len) {                // rows past the length stay unread
      const int blk = max(tables[b * MB + t / BT], 0);
      const size_t row = (size_t)blk * BT + t % BT;
      const T* cr = c_pool + row * Lp;
      for (int d = lane; d < Lp; d += 32) dst[d] = to_f(cr[d]);
      const T* rr = r_pool + row * R;
      for (int d = lane; d < R; d += 32) dst[Lp + d] = to_f(rr[d]);
    }
  }
  __syncthreads();
  const int t = t0 + lane;
  if (t > N) return;
  if (t >= len && t != N) {              // masked after the ranks' sum
#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      const int h = warp + i * kWarps;
      if (h < H) sb[(size_t)h * (N + 1) + t] = 0.f;
    }
    return;
  }
  const float* kr = sk + lane * KS;
  float al[HPW], ar[HPW];
#pragma unroll
  for (int i = 0; i < HPW; ++i) al[i] = ar[i] = 0.f;
  // heads past H read rows of the buffer that are never written out
  for (int d = 0; d < Lp; ++d) {
    const float k = kr[d];
#pragma unroll
    for (int i = 0; i < HPW; ++i)
      al[i] = fmaf(sq[(warp + i * kWarps) * W + d], k, al[i]);
  }
  for (int d = Lp; d < W; ++d) {
    const float k = kr[d];
#pragma unroll
    for (int i = 0; i < HPW; ++i)
      ar[i] = fmaf(sq[(warp + i * kWarps) * W + d], k, ar[i]);
  }
  // the lora sum, then the rope sum added, as the reference adds them
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int h = warp + i * kWarps;
    if (h < H) sb[(size_t)h * (N + 1) + t] = al[i] + ar[i];
  }
}

// Block-wide reduction of one value a thread (max or sum); every thread
// gets the result.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();                      // red may hold an earlier result
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// Pass 2, first launch.  One CTA per (row, head): the masked softmax over
// the valid positions and the self score, normalised, into p.
__global__ void __launch_bounds__(kThreads)
latent_probs(const float* __restrict__ s, const int* __restrict__ lens,
             float* __restrict__ p, int H, int N) {
  __shared__ float red[kWarps];
  const int b = blockIdx.x, h = blockIdx.y;
  const int len = min(max(lens[b], 0), N);
  const float* sb = s + ((size_t)b * H + h) * (N + 1);
  float* pb = p + ((size_t)b * H + h) * (N + 1);
  const float s_self = sb[N];
  float m = rt::kNeg;
  for (int t = threadIdx.x; t < len; t += kThreads) m = fmaxf(m, sb[t]);
  m = fmaxf(block_reduce<true>(m, red), s_self);
  float l = 0.f;
  for (int t = threadIdx.x; t < len; t += kThreads) l += expf(sb[t] - m);
  const float p_self = expf(s_self - m);
  l = block_reduce<false>(l, red) + p_self;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int t = threadIdx.x; t < len; t += kThreads)
    pb[t] = expf(sb[t] - m) * inv;
  if (threadIdx.x == 0) pb[N] = p_self * inv;
}

// Pass 2, second launch.  One CTA per (row, kLanes lora lanes, split of
// kPosPerCta positions): the split's valid positions in tiles of kTok,
// each tile's lora rows and probabilities staged in shared memory; lane
// l takes the lanes l, l + 32, l + 64, l + 96 and warp w the HPW heads
// w, w + 8, ...  With one split (MB * BT <= kPosPerCta) the output is
// written with the self term; otherwise each split's partial sums go to
// `part` and latent_reduce adds them.
template <typename T, int HPW>
__global__ void __launch_bounds__(kThreads)
latent_apply(const float* __restrict__ p, const T* __restrict__ c_pool,
             const int* __restrict__ tables, const int* __restrict__ lens,
             const float* __restrict__ c_self, float* __restrict__ out,
             float* __restrict__ part, int H, int Lp, int BT, int MB, int S) {
  __shared__ float sc[kTok][kLanes];
  __shared__ float sp[kMaxHeads][kTok];
  const int b = blockIdx.x, d0 = blockIdx.y * kLanes, split = blockIdx.z;
  const int N = MB * BT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = min(max(lens[b], 0), N);
  const int lo = split * kPosPerCta, hi = min(lo + kPosPerCta, len);
  const float* pb = p + (size_t)b * H * (N + 1);
  float acc[HPW][kLanesPer];
#pragma unroll
  for (int i = 0; i < HPW; ++i)
#pragma unroll
    for (int k = 0; k < kLanesPer; ++k) acc[i][k] = 0.f;
  for (int t0 = lo; t0 < hi; t0 += kTok) {
    const int n = min(kTok, hi - t0);
    for (int j = warp; j < n; j += kWarps) {
      const int t = t0 + j;
      const int blk = max(tables[b * MB + t / BT], 0);
      const T* cr = c_pool + ((size_t)blk * BT + t % BT) * Lp;
#pragma unroll
      for (int k = 0; k < kLanesPer; ++k) {
        const int d = d0 + k * 32 + lane;
        sc[j][k * 32 + lane] = d < Lp ? to_f(cr[d]) : 0.f;
      }
    }
    for (int h = warp; h < H; h += kWarps)
      sp[h][lane] = lane < n ? pb[(size_t)h * (N + 1) + t0 + lane] : 0.f;
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      float c[kLanesPer];
#pragma unroll
      for (int k = 0; k < kLanesPer; ++k) c[k] = sc[j][k * 32 + lane];
#pragma unroll
      for (int i = 0; i < HPW; ++i) {
        // heads past H read rows of sp that are never written out
        const float pv = sp[warp + i * kWarps][j];
#pragma unroll
        for (int k = 0; k < kLanesPer; ++k) acc[i][k] = fmaf(pv, c[k], acc[i][k]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int h = warp + i * kWarps;
    if (h >= H) continue;
#pragma unroll
    for (int k = 0; k < kLanesPer; ++k) {
      const int d = d0 + k * 32 + lane;
      if (d >= Lp) continue;
      if (S == 1)
        out[((size_t)b * H + h) * Lp + d] =
            fmaf(pb[(size_t)h * (N + 1) + N], c_self[(size_t)b * Lp + d], acc[i][k]);
      else
        part[(((size_t)b * S + split) * H + h) * Lp + d] = acc[i][k];
    }
  }
}

// Pass 2, third launch where there are several splits: one CTA per (row,
// head) adds the splits' partial sums in split order and the self term.
__global__ void __launch_bounds__(kThreads)
latent_reduce(const float* __restrict__ p, const float* __restrict__ part,
              const float* __restrict__ c_self, float* __restrict__ out, int H,
              int Lp, int N, int S) {
  const int b = blockIdx.x, h = blockIdx.y;
  const float ps = p[((size_t)b * H + h) * (N + 1) + N];
  for (int d = threadIdx.x; d < Lp; d += kThreads) {
    float v = 0.f;
    for (int i = 0; i < S; ++i) v += part[(((size_t)b * S + i) * H + h) * Lp + d];
    out[((size_t)b * H + h) * Lp + d] = fmaf(ps, c_self[(size_t)b * Lp + d], v);
  }
}

// Calls fn(Heads<n>()) with n the heads a warp takes: ceil(H / kWarps)
// rounded up to a power of two (fewer instantiations to build; a warp's
// heads past H are computed and never written out).
template <int n> struct Heads { static constexpr int value = n; };
template <typename Fn> int with_heads(int H, Fn&& fn) {
  const int n = (H + kWarps - 1) / kWarps;
  if (n <= 1) return fn(Heads<1>());
  if (n <= 2) return fn(Heads<2>());
  if (n <= 4) return fn(Heads<4>());
  if (n <= 8) return fn(Heads<8>());
  return (int)cudaErrorInvalidValue;
}

bool shapes_ok(int H, int Lp, int R, int BT, int MB) {
  return H >= 1 && H <= kMaxHeads && Lp >= 1 && R >= 0 && BT >= 1 && MB >= 1;
}

constexpr size_t kMaxSmem = 232448;

}  // namespace

extern "C" int rt_paged_latent_scores(const float* q_lat, const float* q_r,
                                      const void* c_pool, const void* r_pool,
                                      const int* tables, const int* lens,
                                      const float* c_self, const float* r_self,
                                      float* s, int B, int H, int Lp, int R,
                                      int BT, int MB, int dtype, void* stream) {
  if (B <= 0) return 0;
  const bool rope = q_r != nullptr;
  if (!shapes_ok(H, Lp, R, BT, MB) || (rope && (r_pool == nullptr ||
                                                r_self == nullptr || R < 1)))
    return (int)cudaErrorInvalidValue;
  const int Rs = rope ? R : 0;
  const int W = Lp + Rs;
  const size_t smem = ((size_t)H * W + (size_t)kTok * (W | 1)) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int N = MB * BT;
  const dim3 grid(B, (N + 1 + kTok - 1) / kTok);
  return rt::dispatch(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    return with_heads(H, [&](auto hp) {
      constexpr int HPW = decltype(hp)::value;
      return rt::launch(latent_scores<T, HPW>, grid, smem, (cudaStream_t)stream,
                        q_lat, rope ? q_r : nullptr, (const T*)c_pool,
                        (const T*)r_pool, tables, lens, c_self,
                        rope ? r_self : nullptr, s, H, Lp, Rs, BT, MB);
    });
  });
}

extern "C" int rt_paged_latent_values(const float* s, const void* c_pool,
                                      const int* tables, const int* lens,
                                      const float* c_self, float* p, float* part,
                                      float* out, int B, int H, int Lp, int BT,
                                      int MB, int S, int dtype, void* stream) {
  if (B <= 0) return 0;
  const int N = MB * BT;
  if (!shapes_ok(H, Lp, 0, BT, MB) || S != (N + kPosPerCta - 1) / kPosPerCta ||
      (S > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  int rc = rt::launch(latent_probs, dim3(B, H), 0, (cudaStream_t)stream, s, lens,
                      p, H, N);
  if (rc != 0) return rc;
  const dim3 grid(B, (Lp + kLanes - 1) / kLanes, S);
  rc = rt::dispatch(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    return with_heads(H, [&](auto hp) {
      constexpr int HPW = decltype(hp)::value;
      return rt::launch(latent_apply<T, HPW>, grid, 0, (cudaStream_t)stream, p,
                        (const T*)c_pool, tables, lens, c_self, out, part, H, Lp,
                        BT, MB, S);
    });
  });
  if (rc != 0 || S == 1) return rc;
  return rt::launch(latent_reduce, dim3(B, H), 0, (cudaStream_t)stream, p, part,
                    c_self, out, H, Lp, N, S);
}
