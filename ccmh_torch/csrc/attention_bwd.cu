// Fused multi-head self-attention backward for the short sequences of the
// CLIP towers (vision L=50, text L=32..77; head dim 64).
//
// Replaces: ccmh/ops/attention.py `_pallas_backward` / `_bwd_kernel` (the
// Pallas TPU kernel).  Same function: per (batch element, head), q, k, v are
// cut from the RAW packed [B, L, 3D] rows with the [3D] projection bias added
// in the INPUT type (the forward's fold); g [B, L, D] arrives in the input
// type.  With the softmax recomputed in fp32,
//   logits = (q . k) * scale + mask,   probs = softmax(logits),
//   dprobs = g . v,                    dlogits = probs * (dprobs - sum_j dprobs * probs),
//   probs_c = probs -> T,              dlogits_c = (dlogits * scale) -> T,
//   dq = dlogits_c . k,  dk = dlogits_c^T . q,  dv = probs_c^T . g,
// each product accumulated in fp32 and stored in T into one packed
// [B, L, 3D] dqkv.  d(qkv_b) is the (B, L) sum of dqkv, a torch reduction
// outside the kernel as in ccmh; the mask gets no gradient.
//
// What bounds it on an H100: bytes.  At B=256 the vision call (L=50, H=12)
// reads 59 MB of qkv and 20 MB of g and writes 59 MB of dqkv in bf16 (41 us
// at 3.35 TB/s; fp32 82 us), the text call 25 + 8 + 25 MB (18 us; fp32 35
// us).  Its five products, 10 B H L^2 Dh = 4.9 GFLOP at vision, take 5 us
// at the bf16 tensor-core peak and 30 us as 3xTF32 (50 with the padding of
// L to 64), under the byte time in both types.
//
// Design: one block per (batch element, head), so dk and dv, which sum over
// the queries, reduce inside the block with no atomics, and no [L, L] tile
// touches device memory; pad16(L) / 16 warps (4 at L=50, 2 at L=32).  All
// five products run on the tensor cores with mma.sync (bf16 m16n8k16; fp32
// as 3xTF32 m16n8k8, see mma_tiles.cuh).  q, k, v and g are read once from
// device memory into shared memory in T, 16 bytes at a time where aligned
// (scalar loads otherwise), the bias added in T as the forward adds it (on
// the way in in bf16, in a pass over shared memory in fp32).
//   1. query-major: each warp owns 16 queries.  S = q k^T and dP = g v^T
//      stay in registers, and so do the softmax (row max and sum shuffled
//      over the 4 lanes of each row; each mask element read once, by the
//      lane that holds it) and the VJP.  dS_c is repacked in registers as
//      the A operand of dq = dS_c k (k through ldmatrix.trans).  probs_c
//      and dS_c are written to shared memory in T as two [L, L] tiles.
//   2. after one __syncthreads, key-major: each warp owns 16 keys and sums
//      dv = probs_c^T g and dk = dS_c^T q over the queries, the transposed
//      tiles read by ldmatrix.trans.
// k and v are dead after phase 1, so each warp stages its dq, dk and dv
// tiles over its own k and v rows in T and stores them with coalesced
// 16-byte stores where aligned.  Register arrays are sized by a class: L
// and Dh up to 64, or up to 128.  The three output products unroll their
// 16-key blocks in bf16 only: the fp32 (3xTF32) code is six times larger
// and ran 60% slower unrolled (PERF.md).  Blocks an SM are what registers
// and shared memory allow (4 at vision bf16, 2 in fp32); holding bf16 to
// 5 blocks measured no faster.
//
// Shared memory, 4 pad16(L) ld + 2 pad16(L) ldt + 3 pad16(Dh) elements of
// T with ld = pad16(Dh) + 8 | 4 and ldt = pad16(L) + 8 | 4 (bf16 | fp32),
// at Dh=64: L=32 23.9 KB bf16 / 44.8 KB fp32; L=50 55.7 / 105.2 KB; L=77
// 74.6 / 141.6 KB; L=128 143.7 KB bf16 (Dh=128: 209.7 KB).  In fp32 at
// L=128 (275 KB at Dh=64) it does not fit the 227 KB a block can have, so
// there the kernel runs in two phases with two of the four operands in
// shared memory at a time (the recompute path, RECOMPUTE below):
//   A. k, v in shared memory, the warp's q and g fragments read from device
//      memory: as phase 1, writing dq and each row's max, sum and
//      sum_j dprobs * probs, and no tiles;
//   B. q, g in shared memory, the warp's 16 keys' k and v fragments read
//      from device memory: for each 16-query tile it recomputes S and dP in
//      phase A's orientation (queries as rows, at the same tile positions,
//      so the same bits), the probabilities from A's statistics, and passes
//      the weights through a per-warp [16][20] scratch tile to transpose
//      them; dv in one pass over the queries, dk in a second.
// 2 pad16(L) ld 4 + 12 pad16(L) + 1280 warps bytes: 81.4 KB at L=128, Dh=64;
// 146.9 KB at L=Dh=128.

#include <type_traits>

#include "attention_long.cuh"
#include "mma_tiles.cuh"

namespace {

using namespace ccmh::mma;

constexpr int kMaxL = 128;
constexpr int kMaxDh = 128;
constexpr int kScratchLd = 20;   // the recompute path's [16][20] fp32 scratch

template <typename T>
size_t tiles_smem(int L, int Dh) {
  const int Lp = pad16(L);
  return (size_t)(4 * Lp * tile_ld<T>(Dh) + 2 * Lp * tile_ld<T>(L) + 3 * pad16(Dh)) *
         sizeof(T);
}

size_t recompute_smem(int L, int Dh) {
  const int Lp = pad16(L);
  return (size_t)(2 * Lp * tile_ld<float>(Dh) + 3 * Lp + Lp / 16 * 16 * kScratchLd) *
         sizeof(float);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// acc[j] += X[m0 + 0..15] Y^T over the head dim, X and Y row-major [rows][Dh]
// tiles in shared memory (S = q k^T, dP = g v^T): every key tile below n_kt
template <typename T, int N>
__device__ __forceinline__ void rows_by_rows(float (&acc)[N][4], const T* X, const T* Y,
                                             int ld, int m0, int n_kt, int n_dk, int lane) {
  using F = Frag<T>;
  for (int kb = 0; kb < n_dk; ++kb) {
    const typename F::A a = F::a_rows(X, ld, m0, kb * 16, lane);
#pragma unroll
    for (int jp = 0; jp < N / 2; ++jp) {
      if (jp < n_kt) {
        typename F::B b0, b1;
        F::b_rows(b0, b1, Y, ld, jp * 16, kb * 16, lane);
        F::mma(acc[2 * jp], a, b0);
        F::mma(acc[2 * jp + 1], a, b1);
      }
    }
  }
}

// acc[j] += A Y over n_kb 16-blocks, A given block by block by a_of(kb)
// (a [16][16] operand), Y a row-major [rows][Dh] tile (p v, dS k, ...)
// (bf16: the kb loop is unrolled to KB, so that a_of indexes register
// arrays; fp32: not unrolled, which measured faster, the 3xTF32 code being
// six times larger)
template <typename T, int N>
__device__ __forceinline__ void times_rows_block(float (&acc)[N][4], const typename Frag<T>::A& a,
                                                 const T* Y, int ld, int kb, int n_dk,
                                                 int lane) {
  using F = Frag<T>;
#pragma unroll
  for (int np = 0; np < N / 2; ++np) {
    if (np < n_dk) {
      typename F::B b0, b1;
      F::b_cols(b0, b1, Y, ld, kb * 16, np * 16, lane);
      F::mma(acc[2 * np], a, b0);
      F::mma(acc[2 * np + 1], a, b1);
    }
  }
}

template <typename T, int KB, int N, typename AOf>
__device__ __forceinline__ void times_rows(float (&acc)[N][4], AOf a_of, const T* Y, int ld,
                                           int n_kb, int n_dk, int lane) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
      if (kb < n_kb) times_rows_block<T, N>(acc, a_of(kb), Y, ld, kb, n_dk, lane);
  } else {
#pragma unroll 1
    for (int kb = 0; kb < n_kb; ++kb)
      times_rows_block<T, N>(acc, a_of(kb), Y, ld, kb, n_dk, lane);
  }
}

// The VJP of the softmax on a warp's tiles, in place: s holds probs and
// becomes probs_c (0 for padded queries), dp holds dprobs and becomes
// dlogits_c; `dot` returns sum_j dprobs * probs of the two rows.
template <typename T, int N>
__device__ __forceinline__ void softmax_vjp(float (&s)[N][4], float (&dp)[N][4], int n_tiles,
                                            float scale, int m0, int L, int lane,
                                            float (&dot)[2]) {
  const int g = lane >> 2;
  dot[0] = dot[1] = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j < n_tiles) {
      dot[0] = fmaf(dp[j][0], s[j][0], dot[0]);
      dot[0] = fmaf(dp[j][1], s[j][1], dot[0]);
      dot[1] = fmaf(dp[j][2], s[j][2], dot[1]);
      dot[1] = fmaf(dp[j][3], s[j][3], dot[1]);
    }
  }
  dot[0] = quad_sum(dot[0]);
  dot[1] = quad_sum(dot[1]);
  const bool live0 = m0 + g < L, live1 = m0 + g + 8 < L;
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = s[j][e];
      dp[j][e] = ccmh::round_to<T>(p * (dp[j][e] - dot[e >> 1]) * scale);
      s[j][e] = (e < 2 ? live0 : live1) ? ccmh::round_to<T>(p) : 0.f;
    }
  }
}

template <typename T, int LMAX, int DMAX>
__device__ __forceinline__ void tiles_body(T* smem, const T* __restrict__ qkv,
                                           const T* __restrict__ qkv_b,
                                           const float* __restrict__ mask,
                                           const T* __restrict__ gin, T* __restrict__ dqkv,
                                           int L, int H, int Dh, float scale, bool vec) {
  using F = Frag<T>;
  const int Lp = pad16(L), ld = tile_ld<T>(Dh), ldt = tile_ld<T>(L);
  const int b = blockIdx.x, h = blockIdx.y;
  const int D = H * Dh, D3 = 3 * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* sq = smem;
  T* sk = sq + Lp * ld;
  T* sv = sk + Lp * ld;
  T* sg = sv + Lp * ld;
  T* tp = sg + Lp * ld;     // probs_c [query][key]
  T* ts = tp + Lp * ldt;    // dS_c [query][key]
  T* sb = ts + Lp * ldt;    // fp32: the bias, [3][pad16(Dh)]

  load_tile<T>(sg, ld, gin + (size_t)b * L * D + h * Dh, D, L, Dh, nullptr, vec);
  load_qkv<T>(sq, Lp, ld, sb, qkv + (size_t)b * L * D3 + h * Dh, D, D3, L, Dh,
              qkv_b ? qkv_b + h * Dh : nullptr, vec);
  finish_qkv<T>(sq, Lp, ld, sb, L, Dh, qkv_b != nullptr, vec);

  const int m0 = warp * 16;
  const int n_kt = Lp / 16, n_dk = pad16(Dh) / 16;
  T* out = dqkv + (size_t)b * L * D3 + h * Dh;
  const int rows = min(16, L - m0);   // >= 1: m0 < L

  // ---- phase 1: the warp's 16 queries
  float dq[DMAX / 8][4];
  {
    float s[LMAX / 8][4], dp[LMAX / 8][4];
    zero(s);
    rows_by_rows<T>(s, sq, sk, ld, m0, n_kt, n_dk, lane);
    float mx[2], sum[2], dot[2];
    softmax_tile(s, (L + 7) / 8, scale, mask, m0, L, lane, mx, sum);
    zero(dp);
    rows_by_rows<T>(dp, sg, sv, ld, m0, n_kt, n_dk, lane);
    softmax_vjp<T>(s, dp, (L + 7) / 8, scale, m0, L, lane, dot);
    stage_acc<T>(tp + m0 * ldt, ldt, s, 2 * n_kt, lane);
    stage_acc<T>(ts + m0 * ldt, ldt, dp, 2 * n_kt, lane);
    zero(dq);
    times_rows<T, LMAX / 16>(dq, [&](int kb) { return F::a_acc(dp[2 * kb], dp[2 * kb + 1]); }, sk, ld,
                  n_kt, n_dk, lane);
  }
  __syncthreads();   // the tiles are complete; k and v are read no more

  stage_acc<T>(sk + m0 * ld, ld, dq, 2 * n_dk, lane);
  __syncwarp();
  store_rows<T>(out + (size_t)m0 * D3, D3, sk + m0 * ld, ld, rows, Dh, vec, lane);

  // ---- phase 2: the warp's 16 keys (m0 .. m0 + 15)
  float acc[DMAX / 8][4];
  zero(acc);
  times_rows<T, LMAX / 16>(acc, [&](int kb) { return F::a_cols(tp, ldt, m0, kb * 16, lane); }, sg, ld,
                n_kt, n_dk, lane);
  stage_acc<T>(sv + m0 * ld, ld, acc, 2 * n_dk, lane);
  __syncwarp();
  store_rows<T>(out + (size_t)m0 * D3 + 2 * D, D3, sv + m0 * ld, ld, rows, Dh, vec, lane);
  zero(acc);
  times_rows<T, LMAX / 16>(acc, [&](int kb) { return F::a_cols(ts, ldt, m0, kb * 16, lane); }, sq, ld,
                n_kt, n_dk, lane);
  stage_acc<T>(sk + m0 * ld, ld, acc, 2 * n_dk, lane);   // dq's rows, stored above
  __syncwarp();
  store_rows<T>(out + (size_t)m0 * D3 + D, D3, sk + m0 * ld, ld, rows, Dh, vec, lane);
}

// ---- the recompute path (fp32 only)

// A fragment ("rows" order) of rows m0.. of a head in device memory:
// X[r][c] = src[r * src_ld + c] (+ bias[c]) for r < L, c < Dh, else 0
__device__ __forceinline__ Frag<float>::A a_rows_global(const float* __restrict__ src,
                                                        size_t src_ld,
                                                        const float* __restrict__ bias,
                                                        int m0, int k0, int L, int Dh,
                                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
  auto x = [&](int r, int c) {
    if (r >= L || c >= Dh) return 0.f;
    const float v = src[r * src_ld + c];
    return bias != nullptr ? v + bias[c] : v;
  };
  Frag<float>::A a;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int c = k0 + 8 * s + t;
    Frag<float>::set_a(a, s, x(m0 + g, c), x(m0 + g + 8, c), x(m0 + g, c + 4),
                       x(m0 + g + 8, c + 4));
  }
  return a;
}

// B fragments ("rows" order) of rows n0 .. n0 + 15 of a head in device memory
__device__ __forceinline__ void b_rows_global(Frag<float>::B& b0, Frag<float>::B& b1,
                                              const float* __restrict__ src, size_t src_ld,
                                              const float* __restrict__ bias, int n0, int k0,
                                              int L, int Dh, int lane) {
  const int g = lane >> 2, t = lane & 3;
  auto y = [&](int r, int c) {
    if (r >= L || c >= Dh) return 0.f;
    const float v = src[r * src_ld + c];
    return bias != nullptr ? v + bias[c] : v;
  };
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int c = k0 + 8 * s + t;
    Frag<float>::set_b(b0, s, y(n0 + g, c), y(n0 + g, c + 4));
    Frag<float>::set_b(b1, s, y(n0 + g + 8, c), y(n0 + g + 8, c + 4));
  }
}

// An accumulator tile set's values at rows r0 + g, r0 + g + 8 and columns
// 8 j + 2 t (+1) into device memory (row stride D3), where r < L and c < Dh
template <int N>
__device__ __forceinline__ void store_acc(float* __restrict__ dst, size_t dst_ld,
                                          const float (&acc)[N][4], int r0, int L, int Dh,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + (e >> 1) * 8, c = 8 * j + 2 * t + (e & 1);
      if (r < L && c < Dh) dst[r * dst_ld + c] = acc[j][e];
    }
  }
}

template <int LMAX, int DMAX>
__device__ __forceinline__ void recompute_body(float* smem, const float* __restrict__ qkv,
                                               const float* __restrict__ qkv_b,
                                               const float* __restrict__ mask,
                                               const float* __restrict__ gin,
                                               float* __restrict__ dqkv, int L, int H, int Dh,
                                               float scale, bool vec) {
  using F = Frag<float>;
  const int Lp = pad16(L), ld = tile_ld<float>(Dh);
  const int b = blockIdx.x, h = blockIdx.y;
  const int D = H * Dh, D3 = 3 * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* x0 = smem;                  // k in A, q in B
  float* x1 = x0 + Lp * ld;          // v in A, g in B
  float* row_max = x1 + Lp * ld;
  float* row_sum = row_max + Lp;
  float* row_dot = row_sum + Lp;
  float* scratch = row_dot + Lp + warp * 16 * kScratchLd;
  const int n_kt = Lp / 16, n_dk = pad16(Dh) / 16;
  const int m0 = warp * 16;

  const float* base = qkv + (size_t)b * L * D3 + h * Dh;
  const float* gbase = gin + (size_t)b * L * D + h * Dh;
  const float* bias_q = qkv_b ? qkv_b + h * Dh : nullptr;
  const float* bias_k = qkv_b ? qkv_b + D + h * Dh : nullptr;
  const float* bias_v = qkv_b ? qkv_b + 2 * D + h * Dh : nullptr;
  float* out = dqkv + (size_t)b * L * D3 + h * Dh;

  // ---- phase A: k | v in shared memory; the warp's 16 queries
  load_tile<float>(x0, ld, base + D, D3, L, Dh, bias_k, vec);
  load_tile<float>(x1, ld, base + 2 * D, D3, L, Dh, bias_v, vec);
  if (vec) {
    cp_async_wait_all();
    if (qkv_b != nullptr) {
      __syncthreads();
      add_bias<float>(x0, ld, L, Dh, bias_k);
      add_bias<float>(x1, ld, L, Dh, bias_v);
    }
  }
  __syncthreads();
  {
    float s[LMAX / 8][4], dp[LMAX / 8][4];
    zero(s);
    zero(dp);
    for (int kb = 0; kb < n_dk; ++kb) {
      const F::A aq = a_rows_global(base, D3, bias_q, m0, kb * 16, L, Dh, lane);
      const F::A ag = a_rows_global(gbase, D, nullptr, m0, kb * 16, L, Dh, lane);
#pragma unroll
      for (int jp = 0; jp < LMAX / 16; ++jp) {
        if (jp < n_kt) {
          F::B b0, b1;
          F::b_rows(b0, b1, x0, ld, jp * 16, kb * 16, lane);
          F::mma(s[2 * jp], aq, b0);
          F::mma(s[2 * jp + 1], aq, b1);
          F::b_rows(b0, b1, x1, ld, jp * 16, kb * 16, lane);
          F::mma(dp[2 * jp], ag, b0);
          F::mma(dp[2 * jp + 1], ag, b1);
        }
      }
    }
    float mx[2], sum[2], dot[2];
    softmax_tile(s, (L + 7) / 8, scale, mask, m0, L, lane, mx, sum);
    softmax_vjp<float>(s, dp, (L + 7) / 8, scale, m0, L, lane, dot);
    if (t == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = m0 + g + 8 * e;
        row_max[i] = mx[e];
        row_sum[i] = sum[e];
        row_dot[i] = dot[e];
      }
    }
    float dq[DMAX / 8][4];
    zero(dq);
    times_rows<float, LMAX / 16>(dq, [&](int kb) { return F::a_acc(dp[2 * kb], dp[2 * kb + 1]); }, x0,
                      ld, n_kt, n_dk, lane);
    store_acc(out, D3, dq, m0, L, Dh, lane);
  }
  __syncthreads();   // k and v are read no more; the row statistics are in

  // ---- phase B: q | g in shared memory; the warp's 16 keys
  load_tile<float>(x0, ld, base, D3, L, Dh, bias_q, vec);
  load_tile<float>(x1, ld, gbase, D, L, Dh, nullptr, vec);
  if (vec) {
    cp_async_wait_all();
    if (qkv_b != nullptr) {
      __syncthreads();
      add_bias<float>(x0, ld, L, Dh, bias_q);
    }
  }
  __syncthreads();

#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {   // dv, then dk
    float acc[DMAX / 8][4];
    zero(acc);
    for (int qt = 0; qt < n_kt; ++qt) {
      const int q0 = qt * 16;
      float st[2][4], dpt[2][4];
      zero(st);
      zero(dpt);
      for (int kb = 0; kb < n_dk; ++kb) {
        F::B b0, b1;
        F::A a = F::a_rows(x0, ld, q0, kb * 16, lane);
        b_rows_global(b0, b1, base + D, D3, bias_k, m0, kb * 16, L, Dh, lane);
        F::mma(st[0], a, b0);
        F::mma(st[1], a, b1);
        if (pass == 1) {
          a = F::a_rows(x1, ld, q0, kb * 16, lane);
          b_rows_global(b0, b1, base + 2 * D, D3, bias_v, m0, kb * 16, L, Dh, lane);
          F::mma(dpt[0], a, b0);
          F::mma(dpt[1], a, b1);
        }
      }
      // the weights of queries q0 + g (+8) and keys m0 + 8 j + 2 t (+1)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = q0 + g + (e >> 1) * 8, c = m0 + 8 * j + 2 * t + (e & 1);
          float w = 0.f;
          if (i < L) {
            const float p = expf(logit(st[j][e], scale, mask, i, c, L) - row_max[i]) *
                            (1.f / row_sum[i]);
            w = pass == 0 ? p : p * (dpt[j][e] - row_dot[i]) * scale;
          }
          scratch[(g + (e >> 1) * 8) * kScratchLd + 8 * j + 2 * t + (e & 1)] = w;
        }
      }
      __syncwarp();
      times_rows<float, 1>(acc, [&](int) { return F::a_cols(scratch, kScratchLd, 0, 0, lane); },
                        pass == 0 ? x1 + q0 * ld : x0 + q0 * ld, ld, 1, n_dk, lane);
      __syncwarp();
    }
    store_acc(out + (pass == 0 ? 2 * D : D), D3, acc, m0, L, Dh, lane);
  }
}

template <typename T, int LMAX, int DMAX, bool RECOMPUTE>
__global__ void __launch_bounds__(LMAX / 16 * 32)
attention_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ qkv_b,
                     const float* __restrict__ mask, const T* __restrict__ g,
                     T* __restrict__ dqkv, int L, int H, int Dh, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (RECOMPUTE)
    recompute_body<LMAX, DMAX>(reinterpret_cast<float*>(smem_raw), qkv, qkv_b, mask, g, dqkv,
                               L, H, Dh, scale, vec != 0);
  else
    tiles_body<T, LMAX, DMAX>(reinterpret_cast<T*>(smem_raw), qkv, qkv_b, mask, g, dqkv, L, H,
                              Dh, scale, vec != 0);
}

template <typename T, int LMAX, int DMAX, bool RECOMPUTE>
cudaError_t launch_class(const void* qkv, const void* qkv_b, const float* mask, const void* g,
                         void* dqkv, int B, int L, int H, int Dh, float scale, bool vec,
                         size_t smem, cudaStream_t stream) {
  auto kernel = attention_bwd_kernel<T, LMAX, DMAX, RECOMPUTE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, H);
  kernel<<<grid, pad16(L) / 16 * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(qkv_b), mask, static_cast<const T*>(g),
      static_cast<T*>(dqkv), L, H, Dh, scale, vec ? 1 : 0);
  return cudaGetLastError();
}

template <typename T, bool RECOMPUTE>
cudaError_t launch_sized(const void* qkv, const void* qkv_b, const float* mask, const void* g,
                         void* dqkv, int B, int L, int H, int Dh, float scale, bool vec,
                         size_t smem, cudaStream_t stream) {
  // (the recompute path is taken only past L = 64)
  const bool small_l = !RECOMPUTE && pad16(L) <= 64, small_d = pad16(Dh) <= 64;
  if (small_l && small_d)
    return launch_class<T, 64, 64, RECOMPUTE>(qkv, qkv_b, mask, g, dqkv, B, L, H, Dh, scale,
                                              vec, smem, stream);
  if (small_l)
    return launch_class<T, 64, 128, RECOMPUTE>(qkv, qkv_b, mask, g, dqkv, B, L, H, Dh, scale,
                                               vec, smem, stream);
  if (small_d)
    return launch_class<T, 128, 64, RECOMPUTE>(qkv, qkv_b, mask, g, dqkv, B, L, H, Dh, scale,
                                               vec, smem, stream);
  return launch_class<T, 128, 128, RECOMPUTE>(qkv, qkv_b, mask, g, dqkv, B, L, H, Dh, scale,
                                              vec, smem, stream);
}

template <typename T>
cudaError_t launch(int device, const void* qkv, const void* qkv_b, const float* mask,
                   const void* g, void* dqkv, int B, int L, int H, int Dh, float scale,
                   cudaStream_t stream) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                           device);
  if (err != cudaSuccess) return err;
  const bool vec = (Dh * sizeof(T)) % 16 == 0 && aligned16(qkv) && aligned16(g) &&
                   aligned16(dqkv) && (qkv_b == nullptr || aligned16(qkv_b));
  const size_t smem = tiles_smem<T>(L, Dh);
  if (smem <= (size_t)optin)
    return launch_sized<T, false>(qkv, qkv_b, mask, g, dqkv, B, L, H, Dh, scale, vec, smem,
                                  stream);
  if constexpr (std::is_same<T, float>::value) {
    const size_t small = recompute_smem(L, Dh);
    if (small <= (size_t)optin)
      return launch_sized<T, true>(qkv, qkv_b, mask, g, dqkv, B, L, H, Dh, scale, vec, small,
                                   stream);
  }
  return cudaErrorInvalidValue;   // no shape up to L = Dh = 128 comes here
}

// ---------------------------------------------------------------------------
// The long path, L > 128 (attention_long.cuh): three kernels in stream
// order, each a block per (batch element, head, 64-row tile) of 4 warps,
// every output element summed by one warp in a fixed order (no atomics:
// the same bits every run, which bit-equal resume and remat need):
//   1. stats, query-major: the k and v tiles stream past the block's q and
//      g tiles for each row's softmax max, 1 / sum and D_i = sum_j p_ij dp_ij
//      over the unrounded p (RowStats), written as fp32 into the row's own
//      dq slot of dqkv (its Dh elements of T hold the 12 bytes);
//   2. dk and dv, key-major: the q and g tiles and their rows' statistics
//      stream past the block's k and v tiles; each warp recomputes its 16
//      keys' logits and dp against them, p and dS = p (dp - D_i) scale,
//      rounded to T, and sums dv += p_c^T g and dk += dS_c^T q in registers;
//   3. dq, query-major: the k and v tiles stream past the block's q and g
//      tiles; each warp reads its rows' statistics, sums dq += dS_c k, and
//      overwrites them with dq.
// So no scratch beyond dqkv, and the grid has L / 64 times the blocks of a
// block per head (which it outran: PERF.md).  Each warp stages its outputs
// over its own rows of a resident tile and stores them 16 bytes at a time
// where aligned.  Shared memory 4 x 64 ld elements of T (+ 768 bytes of
// statistics in kernel 2): Dh = 64 36.9 KB bf16 / 69.6 KB fp32, Dh = 128
// 69.6 / 135.2 KB.
//
// What bounds it on an H100: at ViT-L/14 (B = 64, L = 257, H = 16) bf16 the
// bytes (101 MB of qkv and 34 MB of g read, 101 MB of dqkv written: 70 us),
// fp32 the 3xTF32 products.  The kernels take nine products where five
// suffice (q k^T and g v^T three times each), the price of streaming
// without atomics or a device-memory [L, L] tile.

// fp32 statistics in a 2-byte aligned slot of T (a bf16 row slice need not
// be 4-byte aligned)
__device__ __forceinline__ void put_stat(void* slot, int k, float x) {
  unsigned short* p = static_cast<unsigned short*>(slot) + 2 * k;
  const uint32_t u = __float_as_uint(x);
  p[0] = static_cast<unsigned short>(u & 0xffffu);
  p[1] = static_cast<unsigned short>(u >> 16);
}

__device__ __forceinline__ float get_stat(const void* slot, int k) {
  const unsigned short* p = static_cast<const unsigned short*>(slot) + 2 * k;
  return __uint_as_float(static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 16));
}

// what the three kernels share: the block's tile, head and pointers
template <typename T>
struct LongBwd {
  const T* base;     // the head's q slice of row 0 of qkv (k at + D, v at + 2 D)
  const T* gbase;    // the head's slice of row 0 of g
  T* obase;          // the head's dq slice of row 0 of dqkv
  const T *bq, *bk, *bv;
  int D, D3, t0, nt, n_t;

  __device__ LongBwd(const T* qkv, const T* qkv_b, const T* g, T* dqkv, int L, int H, int Dh) {
    using namespace ccmh::attn_long;
    n_t = (L + kTile - 1) / kTile;
    const int tile = blockIdx.x % n_t, h = (blockIdx.x / n_t) % H, b = blockIdx.x / (n_t * H);
    D = H * Dh;
    D3 = 3 * D;
    base = qkv + (size_t)b * L * D3 + h * Dh;
    gbase = g + (size_t)b * L * D + h * Dh;
    obase = dqkv + (size_t)b * L * D3 + h * Dh;
    bq = qkv_b ? qkv_b + h * Dh : nullptr;
    bk = qkv_b ? bq + D : nullptr;
    bv = qkv_b ? bq + 2 * D : nullptr;
    t0 = tile * kTile;
    nt = min(kTile, L - t0);
  }
};

// the k and v tiles of key tile kt
template <typename T>
__device__ __forceinline__ void load_kv(const LongBwd<T>& a, T* sk, T* sv, int ld, int kt, int L,
                                        int Dh, bool vec) {
  using namespace ccmh::attn_long;
  const int k0 = kt * kTile, nk = min(kTile, L - k0);
  load_tile<T>(sk, ld, a.base + a.D + (size_t)k0 * a.D3, a.D3, nk, Dh, a.bk, vec);
  load_tile<T>(sv, ld, a.base + 2 * a.D + (size_t)k0 * a.D3, a.D3, nk, Dh, a.bv, vec);
}

template <typename T>
__global__ void __launch_bounds__(ccmh::attn_long::kThreads)
attention_bwd_long_stats(const T* __restrict__ qkv, const T* __restrict__ qkv_b,
                         const float* __restrict__ mask, const T* __restrict__ g,
                         T* __restrict__ dqkv, int L, int H, int Dh, float scale, int vec) {
  using namespace ccmh::attn_long;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = tile_ld<T>(Dh);
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sg = sq + kTile * ld;
  T* sk = sg + kTile * ld;
  T* sv = sk + kTile * ld;
  const LongBwd<T> a(qkv, qkv_b, g, dqkv, L, H, Dh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = warp * 16, i0 = a.t0 + m0 + (lane >> 2);
  const bool active = m0 < a.nt;
  const int n_dk = pad16(Dh) / 16;

  load_tile<T>(sq, ld, a.base + (size_t)a.t0 * a.D3, a.D3, a.nt, Dh, a.bq, vec);
  load_tile<T>(sg, ld, a.gbase + (size_t)a.t0 * a.D, a.D, a.nt, Dh, nullptr, vec);
  RowStats st;
  st.init();
  for (int kt = 0; kt < a.n_t; ++kt) {
    const int k0 = kt * kTile, nk = min(kTile, L - k0);
    if (kt > 0) __syncthreads();
    load_kv(a, sk, sv, ld, kt, L, Dh, vec);
    land(vec);
    if (vec && qkv_b != nullptr) {
      if (kt == 0) fold_bias<T>(sq, ld, a.nt, Dh, a.bq, vec);
      fold_bias<T>(sk, ld, nk, Dh, a.bk, vec);
      fold_bias<T>(sv, ld, nk, Dh, a.bv, vec);
      __syncthreads();
    }
    if (active) {
      for (int n0 = 0; n0 < nk; n0 += kChunk) {
        const int n_blk = chunk_blocks(n0, nk);
        float s[4][4], dp[4][4];
        rows_chunk<T>(s, sq, sk, ld, m0, n0, n_blk, n_dk, lane);
        rows_chunk<T>(dp, sg, sv, ld, m0, n0, n_blk, n_dk, lane);
        logits_rows(s, n_blk, scale, mask, i0, k0 + n0, L, lane);
        st.add(s, dp, n_blk);
      }
    }
  }
  st.finish();
  if (active && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 8 * r;
      if (i < L) {
        T* slot = a.obase + (size_t)i * a.D3;
        const float inv = 1.f / st.l[r];
        put_stat(slot, 0, st.mx[r]);
        put_stat(slot, 1, inv);
        put_stat(slot, 2, st.dn[r] * inv);
      }
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(ccmh::attn_long::kThreads)
attention_bwd_long_dkdv(const T* __restrict__ qkv, const T* __restrict__ qkv_b,
                        const float* __restrict__ mask, const T* __restrict__ g,
                        T* __restrict__ dqkv, int L, int H, int Dh, float scale, int vec) {
  using namespace ccmh::attn_long;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = tile_ld<T>(Dh);
  T* sk = reinterpret_cast<T*>(smem_raw);
  T* sv = sk + kTile * ld;
  T* sq = sv + kTile * ld;
  T* sg = sq + kTile * ld;
  float* s_mx = reinterpret_cast<float*>(sg + kTile * ld);   // the q tile's statistics
  float* s_inv = s_mx + kTile;
  float* s_d = s_inv + kTile;
  const LongBwd<T> a(qkv, qkv_b, g, dqkv, L, H, Dh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int m0 = warp * 16;
  const int j0 = a.t0 + m0 + (lane >> 2);     // the warp's keys j0 and j0 + 8
  const bool active = m0 < a.nt;
  const int n_dk = pad16(Dh) / 16;

  load_tile<T>(sk, ld, a.base + a.D + (size_t)a.t0 * a.D3, a.D3, a.nt, Dh, a.bk, vec);
  load_tile<T>(sv, ld, a.base + 2 * a.D + (size_t)a.t0 * a.D3, a.D3, a.nt, Dh, a.bv, vec);
  float dk[DMAX / 8][4], dv[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }
  for (int qt = 0; qt < a.n_t; ++qt) {
    const int q0 = qt * kTile, nq = min(kTile, L - q0);
    if (qt > 0) __syncthreads();
    load_tile<T>(sq, ld, a.base + (size_t)q0 * a.D3, a.D3, nq, Dh, a.bq, vec);
    load_tile<T>(sg, ld, a.gbase + (size_t)q0 * a.D, a.D, nq, Dh, nullptr, vec);
    if (threadIdx.x < nq) {
      const T* slot = a.obase + (size_t)(q0 + threadIdx.x) * a.D3;
      s_mx[threadIdx.x] = get_stat(slot, 0);
      s_inv[threadIdx.x] = get_stat(slot, 1);
      s_d[threadIdx.x] = get_stat(slot, 2);
    }
    land(vec);
    if (vec && qkv_b != nullptr) {
      if (qt == 0) {
        fold_bias<T>(sk, ld, a.nt, Dh, a.bk, vec);
        fold_bias<T>(sv, ld, a.nt, Dh, a.bv, vec);
      }
      fold_bias<T>(sq, ld, nq, Dh, a.bq, vec);
      __syncthreads();
    }
    if (active) {
      for (int n0 = 0; n0 < nq; n0 += kChunk) {
        const int n_blk = chunk_blocks(n0, nq);
        float s[4][4], dp[4][4];
        rows_chunk<T>(s, sk, sq, ld, m0, n0, n_blk, n_dk, lane);    // [keys][queries]
        rows_chunk<T>(dp, sv, sg, ld, m0, n0, n_blk, n_dk, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j0 + 8 * (e >> 1);
            const int r = n0 + 8 * j + 2 * t + (e & 1);     // the query's row in the tile
            float p = 0.f, ds = 0.f;
            if (j / 2 < n_blk && key < L && r < nq) {
              const float x = logit(s[j][e], scale, mask, q0 + r, key, L);
              p = expf(x - s_mx[r]) * s_inv[r];
              ds = p * (dp[j][e] - s_d[r]) * scale;
            }
            s[j][e] = p;
            dp[j][e] = ds;
          }
#pragma unroll
        for (int jb = 0; jb < 2; ++jb)
          if (jb < n_blk) {
            acc_times<T>(dv, s[2 * jb], s[2 * jb + 1], sg, ld, n0 + jb * 16, n_dk, lane);
            acc_times<T>(dk, dp[2 * jb], dp[2 * jb + 1], sq, ld, n0 + jb * 16, n_dk, lane);
          }
      }
    }
  }
  if (active) {
    __syncwarp();
    stage_acc<T>(sk + m0 * ld, ld, dk, 2 * n_dk, lane);
    stage_acc<T>(sv + m0 * ld, ld, dv, 2 * n_dk, lane);
    __syncwarp();
    const int rows = min(16, a.nt - m0);
    T* out = a.obase + (size_t)(a.t0 + m0) * a.D3;
    store_rows<T>(out + a.D, a.D3, sk + m0 * ld, ld, rows, Dh, vec, lane);
    store_rows<T>(out + 2 * a.D, a.D3, sv + m0 * ld, ld, rows, Dh, vec, lane);
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(ccmh::attn_long::kThreads)
attention_bwd_long_dq(const T* __restrict__ qkv, const T* __restrict__ qkv_b,
                      const float* __restrict__ mask, const T* __restrict__ g,
                      T* __restrict__ dqkv, int L, int H, int Dh, float scale, int vec) {
  using namespace ccmh::attn_long;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = tile_ld<T>(Dh);
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sg = sq + kTile * ld;
  T* sk = sg + kTile * ld;
  T* sv = sk + kTile * ld;
  const LongBwd<T> a(qkv, qkv_b, g, dqkv, L, H, Dh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = warp * 16, i0 = a.t0 + m0 + (lane >> 2);
  const bool active = m0 < a.nt;
  const int n_dk = pad16(Dh) / 16;

  // the warp's rows' statistics (kernel 1's), read before its dq overwrites them
  float mx[2], inv[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    mx[r] = inv[r] = dd[r] = 0.f;
    if (active && i < L) {
      const T* slot = a.obase + (size_t)i * a.D3;
      mx[r] = get_stat(slot, 0);
      inv[r] = get_stat(slot, 1);
      dd[r] = get_stat(slot, 2);
    }
  }
  load_tile<T>(sq, ld, a.base + (size_t)a.t0 * a.D3, a.D3, a.nt, Dh, a.bq, vec);
  load_tile<T>(sg, ld, a.gbase + (size_t)a.t0 * a.D, a.D, a.nt, Dh, nullptr, vec);
  float dq[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  for (int kt = 0; kt < a.n_t; ++kt) {
    const int k0 = kt * kTile, nk = min(kTile, L - k0);
    if (kt > 0) __syncthreads();
    load_kv(a, sk, sv, ld, kt, L, Dh, vec);
    land(vec);
    if (vec && qkv_b != nullptr) {
      if (kt == 0) fold_bias<T>(sq, ld, a.nt, Dh, a.bq, vec);
      fold_bias<T>(sk, ld, nk, Dh, a.bk, vec);
      fold_bias<T>(sv, ld, nk, Dh, a.bv, vec);
      __syncthreads();
    }
    if (active) {
      for (int n0 = 0; n0 < nk; n0 += kChunk) {
        const int n_blk = chunk_blocks(n0, nk);
        float s[4][4], dp[4][4];
        rows_chunk<T>(s, sq, sk, ld, m0, n0, n_blk, n_dk, lane);
        rows_chunk<T>(dp, sg, sv, ld, m0, n0, n_blk, n_dk, lane);
        logits_rows(s, n_blk, scale, mask, i0, k0 + n0, L, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float p = expf(s[j][e] - mx[r]) * inv[r];
            s[j][e] = p * (dp[j][e] - dd[r]) * scale;     // dS scale, rounded to T below
          }
#pragma unroll
        for (int jb = 0; jb < 2; ++jb)
          if (jb < n_blk)
            acc_times<T>(dq, s[2 * jb], s[2 * jb + 1], sk, ld, n0 + jb * 16, n_dk, lane);
      }
    }
  }
  if (active) {
    __syncwarp();
    stage_acc<T>(sq + m0 * ld, ld, dq, 2 * n_dk, lane);
    __syncwarp();
    store_rows<T>(a.obase + (size_t)(a.t0 + m0) * a.D3, a.D3, sq + m0 * ld, ld,
                  min(16, a.nt - m0), Dh, vec, lane);
  }
}

template <typename T, int DMAX>
cudaError_t launch_long_class(const void* qkv, const void* qkv_b, const float* mask,
                              const void* g, void* dqkv, int B, int L, int H, int Dh,
                              float scale, bool vec, cudaStream_t stream) {
  using namespace ccmh::attn_long;
  const size_t tiles = (size_t)4 * kTile * tile_ld<T>(Dh) * sizeof(T);
  const size_t stats = (size_t)3 * kTile * sizeof(float);
  const long long blocks = (long long)B * H * ((L + kTile - 1) / kTile);
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const T* q = static_cast<const T*>(qkv);
  const T* qb = static_cast<const T*>(qkv_b);
  const T* gg = static_cast<const T*>(g);
  T* out = static_cast<T*>(dqkv);
  const int v = vec ? 1 : 0;
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_long_stats<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)tiles);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_bwd_long_dkdv<T, DMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)(tiles + stats));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_bwd_long_dq<T, DMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tiles);
  if (err != cudaSuccess) return err;
  attention_bwd_long_stats<T><<<(unsigned)blocks, kThreads, tiles, stream>>>(
      q, qb, mask, gg, out, L, H, Dh, scale, v);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attention_bwd_long_dkdv<T, DMAX><<<(unsigned)blocks, kThreads, tiles + stats, stream>>>(
      q, qb, mask, gg, out, L, H, Dh, scale, v);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attention_bwd_long_dq<T, DMAX><<<(unsigned)blocks, kThreads, tiles, stream>>>(
      q, qb, mask, gg, out, L, H, Dh, scale, v);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_long(const void* qkv, const void* qkv_b, const float* mask, const void* g,
                        void* dqkv, int B, int L, int H, int Dh, float scale,
                        cudaStream_t stream) {
  // kernel 1 keeps each row's three fp32 statistics in the row's dq slot
  if (Dh * sizeof(T) < 3 * sizeof(float)) return cudaErrorInvalidValue;
  const bool vec = (Dh * sizeof(T)) % 16 == 0 && aligned16(qkv) && aligned16(g) &&
                   aligned16(dqkv) && (qkv_b == nullptr || aligned16(qkv_b));
  if (pad16(Dh) <= 64)
    return launch_long_class<T, 64>(qkv, qkv_b, mask, g, dqkv, B, L, H, Dh, scale, vec,
                                    stream);
  return launch_long_class<T, 128>(qkv, qkv_b, mask, g, dqkv, B, L, H, Dh, scale, vec,
                                   stream);
}

}  // namespace

// qkv and dqkv [B, L, 3*H*Dh], g [B, L, H*Dh], all contiguous in `dtype`;
// qkv_b [3*H*Dh] in `dtype` or null; mask [L, L] fp32 or null; scale is
// 1/sqrt(Dh) rounded to fp32 by the caller.  Launches on `stream` of card
// `device` and returns cudaGetLastError() (0 = launched).
extern "C" int ccmh_attention_bwd(int device, const void* qkv, const void* qkv_b,
                                  const float* mask, const void* g, void* dqkv, int B,
                                  int L, int H, int Dh, float scale, int dtype,
                                  void* stream) {
  if (B < 1 || H < 1 || H > 65535 || L < 1 || L > ccmh::attn_long::kMaxL || Dh < 1 ||
      Dh > kMaxDh)
    return (int)cudaErrorInvalidValue;
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: name the card of the tensors
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ccmh::kFloat32:
      return (int)(L > kMaxL ? launch_long<float>(qkv, qkv_b, mask, g, dqkv, B, L, H, Dh,
                                                  scale, s)
                             : launch<float>(device, qkv, qkv_b, mask, g, dqkv, B, L, H, Dh,
                                             scale, s));
    case ccmh::kBFloat16:
      return (int)(L > kMaxL ? launch_long<__nv_bfloat16>(qkv, qkv_b, mask, g, dqkv, B, L, H,
                                                          Dh, scale, s)
                             : launch<__nv_bfloat16>(device, qkv, qkv_b, mask, g, dqkv, B, L,
                                                     H, Dh, scale, s));
    default:
      return (int)cudaErrorInvalidValue;
  }
}
