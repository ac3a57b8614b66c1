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

#include "attention_bwd32_plan.cuh"
#include "attention_family.cuh"
#include "attention_long.cuh"
#include "mma_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace {

using namespace ccmh::mma;

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
// The long path, L > 128, for the shapes the wgmma kernels below do not
// take (fp32, a head dim other than 64, a pointer not 16-byte aligned:
// long_family), in attention_long.cuh: three kernels in stream order, each a block per (batch element, head, 64-row tile) of 4 warps,
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

// ---------------------------------------------------------------------------
// The long path on Hopper's warpgroup products: L > 128 in bf16 with Dh = 64
// and 16-byte aligned pointers (long_family), every CLIP tower past 128
// tokens and MITH's concept transformers past K = 128.  Replaces
// ccmh/ops/attention.py `_pallas_backward` / `_bwd_kernel` past 128 tokens,
// with its rounding points (the file's head): the softmax recomputed in
// fp32, D_i = sum_j p_ij dp_ij over the unrounded p, p and dS scale rounded
// to bf16 before the three output products, which sum in fp32.
//
// What bounds it on an H100: at ViT-L/14 (B = 64, L = 257, H = 16) bytes,
// 101 MB of qkv and 34 MB of g read and 101 MB of dqkv written, 70 us at
// 3.35 TB/s, against the function's 10 B H L^2 Dh = 43 GFLOP, 44 us at the
// bf16 peak; at @336 (L = 577) the products, 218 GFLOP, 221 us.  The three
// kernels below take nine products where the function has five (q k^T and
// g v^T three times each): 1.8x the function's operations, the price of
// gradients without atomics or device-memory scratch; and three
// exponentials a logit, one a kernel.  At ViT-L/14 the three took 142,
// 218 and 156 us (torch.profiler), and without the bias fold the whole
// backward ran 16-20% faster (PERF.md).
//
// Design: the dataflow of the mma.sync kernels above, which makes the
// gradients the same bits every run (remat and resume need them so), on
// 64-row warpgroup tiles:
//   1. stats, query-major: a block's q and g tiles stay; the k and v tiles
//      stream past them; S = q k^T and dP = g v^T (wgmma, both operands
//      K-major) give each row's max, sum and D_i (Stats64, once a 64-key
//      tile), written as (max log2 e + log2 sum, D, max, log2 sum) fp32
//      into the row's 16 bytes of the statistics buffer, [B, H, L, 4] fp32,
//      which the wrapper allocates (p = 2^(x log2 e - the first), the
//      normalisation inside the exponent; in a call with a mask 2^((x -
//      max) log2 e - log2 sum): wgmma_tiles.cuh Tile);
//   2. dk and dv, key-major: a block's k and v tiles stay; the q and g
//      tiles and those rows' 16 bytes of statistics stream past (a third
//      TMA map reads the buffer); S^T = k q^T and dP^T = v g^T give p and
//      dS scale, rounded to bf16 in registers as the A operand of
//      dv += p^T g and dk += dS^T q (g and q the MN-major B operands);
//   3. dq, query-major: as 1, each thread's rows' statistics read first,
//      dq += dS k (k MN-major).
// Up to kBwdOnePassMaxL keys (ViT-B/16, ViT-L/14) kernels 1 and 3 give way
// to one query-side kernel that holds each row's probabilities in
// registers (attention_bwd_onepass_q below), and kernel 2 follows it.
// Each output element is summed by one warpgroup, tile after tile in a
// fixed order.  Tiles land by TMA through a ring of kBwdStages buffers, as
// in the forward (attention.cu), the bias folded in bf16 through the
// swizzle by the block's threads; each writer's fence.proxy.async.shared::cta
// and then the block's __syncthreads put the folded tile before the async
// proxy's reads (wgmma) -- without the fence a product may see the tile
// unfolded -- and release the buffer that the next copies overwrite.
// Shared memory: 1 KB slack + 2 resident tiles (16 KB) + 2 stages of 16 KB
// (+ 1 KB of statistics a stage in kernel 2): 49 / 51 KB; registers set
// the blocks an SM (4, 2, 3).  A streamed tile of <= 16 rows (the class
// token's, L = 64 n + 1) takes m64n16k16 products, a quarter of the
// columns (2-8% of the whole at the towers).  A third stage, two
// warpgroups a block (sharing each streamed tile) and q and g (k and v) as
// register operands all measured slower (PERF.md).

constexpr int kBwdStages = 2;   // streamed buffers in the ring
constexpr int kStatsBytes = ccmh::wg::kRows * 16;   // a tile's rows' (lse2, D, m, log2 sum)
enum BwdKernel { kStatsPass = 0, kDkDv = 1, kDq = 2 };

// blocks an SM: the register file at 127 (stats), 174 (dk dv) and 168
// (dq) registers a thread, without a spill
template <int KIND, int STAGES, bool MASK>
__global__ void __launch_bounds__(ccmh::wg::kWgThreads,
                                  KIND == kStatsPass ? 4 : KIND == kDq ? 3 : 2)
attention_bwd_wgmma(const __grid_constant__ CUtensorMap qkv_map,
                    const __grid_constant__ CUtensorMap g_map,
                    const __grid_constant__ CUtensorMap stats_map,
                    const __nv_bfloat16* __restrict__ qkv_b, const float* __restrict__ mask,
                    __nv_bfloat16* __restrict__ dqkv, float* __restrict__ stats, int L, int H,
                    float scale, int n_t) {
  using namespace ccmh::wg;
  constexpr bool KEYS = KIND == kDkDv;   // key-major: k, v stay; q, g, statistics stream
  constexpr int kStage = 2 * kTileBytes + (KEYS ? kStatsBytes : 0);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* r0 = align1024(smem_raw);   // resident: q | k
  unsigned char* r1 = r0 + kTileBytes;       // resident: g | v
  unsigned char* ring = r1 + kTileBytes;     // STAGES x (k, v | q, g, statistics)
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * kStage);
  uint64_t* rbar = full + STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int tile = blockIdx.x % n_t, h = (blockIdx.x / n_t) % H, b = blockIdx.x / (n_t * H);
  const int D = H * kDh, D3 = 3 * D;
  const int t0 = tile * kRows, nt = min(kRows, L - t0);   // the block's resident rows
  const int i0 = t0 + 16 * warp + (lane >> 2);   // the thread's rows i0, i0 + 8 (queries | keys)
  const bf16* bq = qkv_b ? qkv_b + h * kDh : nullptr;
  const CUtensorMap* mq = &qkv_map;
  const CUtensorMap* mg = &g_map;
  const CUtensorMap* ms = &stats_map;

  // streamed tile `step` (64 rows from step * 64): k and v, or q, g and
  // their rows' statistics
  auto fetch = [&](int step) {
    unsigned char* st = ring + (step % STAGES) * kStage;
    uint64_t* bar = &full[step % STAGES];
    const int row = step * kRows;
    bar_expect_tx(bar, kStage);
    if (KEYS) {
      tma_load(st, mq, bar, h * kDh, row, b);
      tma_load(st + kTileBytes, mg, bar, h * kDh, row, b);
      tma_load(st + 2 * kTileBytes, ms, bar, 0, row, b * H + h);
    } else {
      tma_load(st, mq, bar, D + h * kDh, row, b);
      tma_load(st + kTileBytes, mq, bar, 2 * D + h * kDh, row, b);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) bar_init(&full[s], 1);
    bar_init(rbar, 1);
    bar_init_fence();
    bar_expect_tx(rbar, 2 * kTileBytes);
    if (KEYS) {
      tma_load(r0, mq, rbar, D + h * kDh, t0, b);
      tma_load(r1, mq, rbar, 2 * D + h * kDh, t0, b);
    } else {
      tma_load(r0, mq, rbar, h * kDh, t0, b);
      tma_load(r1, mg, rbar, h * kDh, t0, b);
    }
    for (int s = 0; s < STAGES && s < n_t; ++s) fetch(s);
  }
  __syncthreads();
  // the bias chunks of the streamed tiles: q | k and - | v
  const uint4 cb_a = bias_chunk(bq ? (KEYS ? bq : bq + D) : nullptr, tid);
  const uint4 cb_b = bias_chunk(bq && !KEYS ? bq + 2 * D : nullptr, tid);
  bar_wait(rbar, 0);
  if (bq != nullptr) {
    fold_tile(r0, nt, bias_chunk(KEYS ? bq + D : bq, tid), tid);
    if (KEYS) fold_tile(r1, nt, bias_chunk(bq + 2 * D, tid), tid);
  }

  // kernel 3: the thread's rows' statistics
  RowLse rl[2] = {};
  float dd[2] = {0.f, 0.f};
  if (KIND == kDq) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 8 * r;
      if (i < L) {
        const float4 v =
            *reinterpret_cast<const float4*>(stats + (((size_t)b * H + h) * L + i) * 4);
        rl[r] = {v.x, v.z, v.w};
        dd[r] = v.y;
      }
    }
  }
  Stats64 st;
  st.init();
  float acc0[32], acc1[32];   // dq | dk, and dv
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
  for (int step = 0; step < n_t; ++step) {
    unsigned char* sa = ring + (step % STAGES) * kStage;   // k | q
    unsigned char* sb = sa + kTileBytes;                   // v | g
    const float* sst = reinterpret_cast<const float*>(sb + kTileBytes);   // q's statistics
    const int s0 = step * kRows, ns = min(kRows, L - s0);
    bar_wait(&full[step % STAGES], (step / STAGES) & 1);
    if (bq != nullptr) {
      fold_tile(sa, ns, cb_a, tid);
      if (!KEYS) fold_tile(sb, ns, cb_b, tid);
    }
    fence_async_smem();   // the folds (and the resident tiles') before the async proxy reads them
    __syncthreads();      // ... and every warp done with step - 1's buffer
    if (tid == 0 && step >= 1 && step - 1 + STAGES < n_t) fetch(step - 1 + STAGES);
    // the step over N columns of the streamed tile: 64, or 16 for a last
    // tile of <= 16 rows (the class token of L = 64 n + 1)
    auto cols = [&](auto n) {
      constexpr int N = decltype(n)::value;
      // S = q k^T, dP = g v^T (query-major); S^T = k q^T, dP^T = v g^T (key-major)
      float s[N / 2], dp[N / 2];
      fence_regs(s);
      fence_regs(dp);
      wg_fence();
      rows_times<N>(s, r0, sa);
      rows_times<N>(dp, r1, sb);
      wg_commit();
      wg_wait0();
      fence_regs(s);
      fence_regs(dp);
      if (KIND == kStatsPass) {
        const Tile tile(mask, s0, L, scale);
        logits<N>(s, tile, scale, mask, i0, s0, L, t);
        st.add<true, MASK, N>(s, dp, tile);
        return;
      }
      if (KIND == kDq) {
        const Tile tile(mask, s0, L, scale);
        logits<N>(s, tile, scale, mask, i0, s0, L, t);
        probs<MASK, N>(s, tile, rl);
#pragma unroll
        for (int x = 0; x < N / 2; ++x) {
          const int r = (x >> 1) & 1;
          s[x] = s[x] * (dp[x] - dd[r]) * scale;     // dS scale, rounded to bf16 by to_a
        }
        uint32_t a[N / 16][4];
        to_a<N>(a, s);
        run(acc0, [&] { acc_times(acc0, a, sa); });   // dq += dS k
        return;
      }
      // key-major: rows are keys i0 + 8 r, columns the queries s0 + c; a
      // query past L (its q, g and statistics rows are TMA's zero fill) gets
      // p = 0, so it adds nothing to dv or dk
      const Tile tile(mask, t0, L, scale);   // the block's keys all below L, no mask
      if (!tile.plain) {
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = s0 + 8 * j + 2 * t + (e & 1);
            s[4 * j + e] = logit(s[4 * j + e], scale, mask, i, i0 + 8 * (e >> 1), L);
          }
      }
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * j + e, c = 8 * j + 2 * t + (e & 1);
          const float4 q = *reinterpret_cast<const float4*>(sst + 4 * c);   // (lse2, D, m, l2)
          const float p = s0 + c < L ? prob<MASK>(s[x], tile, {q.x, q.z, q.w}) : 0.f;
          s[x] = p;
          dp[x] = p * (dp[x] - q.y) * scale;
        }
      uint32_t ap[N / 16][4], ads[N / 16][4];
      to_a<N>(ap, s);
      to_a<N>(ads, dp);
      fence_regs(acc0);
      fence_regs(acc1);
      wg_fence();
      acc_times(acc1, ap, sb);    // dv += p^T g
      acc_times(acc0, ads, sa);   // dk += dS^T q
      wg_commit();
      wg_wait0();
      fence_regs(acc0);
      fence_regs(acc1);
    };
    if (ns <= 16)
      cols(std::integral_constant<int, 16>());
    else
      cols(std::integral_constant<int, 64>());
  }

  if (KIND == kStatsPass) {
    st.finish();
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + 8 * r;
        if (i < L) {
          const RowLse q = st.row(r);
          *reinterpret_cast<float4*>(stats + (((size_t)b * H + h) * L + i) * 4) =
              make_float4(q.lse2, st.dn[r] * (1.f / st.l[r]), q.m, q.l2);
        }
      }
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    if (i < L) {
      bf16* row = dqkv + ((size_t)b * L + i) * D3 + h * kDh + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(row + (KEYS ? D : 0) + 8 * j) =
            pack_bf16(acc0[4 * j + 2 * r], acc0[4 * j + 2 * r + 1]);
        if (KEYS)
          *reinterpret_cast<uint32_t*>(row + 2 * D + 8 * j) =
              pack_bf16(acc1[4 * j + 2 * r], acc1[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 long path's query side in one pass, up to kBwdOnePassMaxL = 272
// keys (attention_family.cuh attention_bwd_family: ViT-B/16's 197 and
// ViT-L/14's 256 and 257 tokens): kernels 1 and 3 above as one kernel,
// which kernel 2 follows.  The same function and rounding points: q + b,
// k + b, v + b and g in bf16; logits (q . k) * scale + mask in fp32; p =
// softmax in fp32 from the row's whole max and sum; D_i = sum_j p_ij dP_ij
// over the fp32 p and the fp32 dP = g v^T; dS = p (dP - D) scale rounded
// to bf16; dq = dS k summed in fp32, stored in bf16.
//
// What bounds it on an H100: bytes.  At ViT-L/14 it reads qkv and g and
// writes dq and the statistics, 173 MB, 52 us at 3.35 TB/s; its products
// (q k^T, g v^T twice and dS k: 35 GFLOP) take 35 us at the bf16 peak.
// With kernel 2 the backward takes eight products where the function has
// five (q k^T twice, g v^T three times; the three kernels nine) and two
// exponentials a logit (three), and each head's k and v land and are
// folded once on the query side (kernels 1 and 3: once a query tile
// each).  At ViT-L/14 it took 154 us and kernel 2 195 us, where kernels 1
// and 3 took 116 and 136 (torch.profiler, PERF.md); 21 us of the 154 are
// the D sweep.
//
// Design: a block per (batch element, head), one warpgroup, as #1's
// one-pass forward (attention.cu): every k and v tile of the head lands at
// once by TMA and is folded with its bias once a block (v while the first
// S runs); the block walks over the head's query tiles, q (folded) and g
// landed by TMA, g through two buffers so that the next tile's lands under
// this one's work.  A query tile:
//   * S = q k^T over every key tile in one group of products: NT tiles of
//     64 keys, and one of 16 for a last tile of <= 16 keys (TAIL, the class
//     token of L = 64 n + 1): ViT-L/14 4 x 64 + 16 = 272 columns, 136
//     registers a thread; ViT-B/16 3 x 64 + 16, 104.  The next q tile lands
//     meanwhile into q's buffer;
//   * the row's max by quad shuffles, e in place with one ex2 a logit in
//     the call's form (tile_exp: without a mask 2^(s scale log2 e - m log2
//     e), one multiply-add on a full tile; with one 2^((x - m) log2 e)),
//     the row's sum from the same registers, p = e * (1 / sum) in fp32,
//     kept in the same registers;
//   * D = sum_j p_ij dP_ij, dP = g v^T one key tile at a time in fp32
//     accumulators, reduced by quad shuffles;
//   * a second sweep over the key tiles: dP again, dS = p (dP - D) scale
//     rounded to bf16 as the register A operand of dq += dS k (k the
//     MN-major operand, the transpose bit), the next tile's dP in the same
//     group of products; the next q tile folded under the last group;
//   * dq stored into its slot of dqkv, each row's (m log2 e + log2 sum, D,
//     m, log2 sum) into the statistics buffer for kernel 2, whose
//     exponentials form p = 2^(s c - (m log2 e + log2 sum)), or with a mask
//     2^((x - m) log2 e - log2 sum) (its rounding may differ from e * (1 /
//     sum) here in the last fp32 bits, far under bf16's rounding of p).
// No atomics and a fixed order of sums: two calls give the same bits.
// Shared memory 1 KB of slack + q + 2 g + 2 KT tiles (ViT-L/14 105 KB) and
// 172-248 registers a thread: two blocks an SM, which overlap one's
// softmax and sweeps with the other's products.  Measured and lost
// (PERF.md): the D sweep with the next tile's dP in flight (wait_group 1)
// ran slower; five key tiles (a limit of 336) spill at 255 registers, and
// with a tail ptxas serialises the products.
template <int NT, bool TAIL, bool MASK>
__global__ void __launch_bounds__(ccmh::wg::kWgThreads, 2)
attention_bwd_onepass_q(const __grid_constant__ CUtensorMap qkv_map,
                        const __grid_constant__ CUtensorMap g_map,
                        const __nv_bfloat16* __restrict__ qkv_b, const float* __restrict__ mask,
                        __nv_bfloat16* __restrict__ dqkv, float* __restrict__ stats, int L,
                        int H, float scale) {
  using namespace ccmh::wg;
  constexpr int KT = NT + (TAIL ? 1 : 0);      // k tiles, and v tiles
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align1024(smem_raw);
  unsigned char* sg = sq + kTileBytes;            // two g buffers
  unsigned char* sk = sg + 2 * kTileBytes;        // KT k tiles
  unsigned char* sv = sk + KT * kTileBytes;       // KT v tiles
  uint64_t* kbar = reinterpret_cast<uint64_t*>(sv + KT * kTileBytes);
  uint64_t* vbar = kbar + 1;
  uint64_t* qbar = kbar + 2;
  uint64_t* gbar = kbar + 3;                      // one a g buffer
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int n_qt = (L + kRows - 1) / kRows;     // the head's query tiles
  const int D = H * kDh;
  const bf16* bq = qkv_b ? qkv_b + h * kDh : nullptr;
  const CUtensorMap* map = &qkv_map;
  const CUtensorMap* gmap = &g_map;

  if (tid == 0) {
    for (int i = 0; i < 5; ++i) bar_init(kbar + i, 1);   // k, v, q and the two g buffers
    bar_init_fence();
    bar_expect_tx(qbar, kTileBytes);
    tma_load(sq, map, qbar, h * kDh, 0, b);
    bar_expect_tx(gbar, kTileBytes);
    tma_load(sg, gmap, gbar, h * kDh, 0, b);
    bar_expect_tx(kbar, KT * kTileBytes);
    for (int j = 0; j < KT; ++j) tma_load(sk + j * kTileBytes, map, kbar, D + h * kDh, j * kRows, b);
    bar_expect_tx(vbar, KT * kTileBytes);
    for (int j = 0; j < KT; ++j)
      tma_load(sv + j * kTileBytes, map, vbar, 2 * D + h * kDh, j * kRows, b);
  }
  __syncthreads();
  const uint4 cb_q = bias_chunk(bq, tid);
  bar_wait(kbar, 0);
  if (bq != nullptr) {
    const uint4 cb_k = bias_chunk(bq + D, tid);
#pragma unroll
    for (int j = 0; j < KT; ++j) fold_tile(sk + j * kTileBytes, min(kRows, L - j * kRows), cb_k, tid);
  }
  bar_wait(qbar, 0);
  if (bq != nullptr) fold_tile(sq, min(kRows, L), cb_q, tid);
  fence_async_smem();     // k's and the first q's folds, published by the loop's first sync

  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * kRows;
    const int i0 = q0 + 16 * warp + (lane >> 2);   // the thread's query rows i0, i0 + 8
    unsigned char* sgt = sg + (qt & 1) * kTileBytes;
    // q's fold published; every warp done with the last tile's g buffer,
    // which takes the next tile's g
    __syncthreads();
    if (tid == 0 && qt + 1 < n_qt) {
      uint64_t* bar = gbar + ((qt + 1) & 1);
      bar_expect_tx(bar, kTileBytes);
      tma_load(sg + ((qt + 1) & 1) * kTileBytes, gmap, bar, h * kDh, q0 + kRows, b);
    }
    // the next q tile folded under the last group of products
    auto fold_next_q = [&] {
      if (qt + 1 < n_qt) {
        bar_wait(qbar, (qt + 1) & 1);
        if (bq != nullptr) fold_tile(sq, min(kRows, L - q0 - kRows), cb_q, tid);
        fence_async_smem();
      }
    };

    float s[NT][32];
    float st[TAIL ? 8 : 1];
#pragma unroll
    for (int j = 0; j < NT; ++j) fence_regs(s[j]);
    fence_regs(st);
    wg_fence();
#pragma unroll
    for (int j = 0; j < NT; ++j) rows_times<64>(s[j], sq, sk + j * kTileBytes);
    if constexpr (TAIL) rows_times<16>(st, sq, sk + NT * kTileBytes);
    wg_commit();
    if (qt == 0) {
      // v lands and is folded while the first tile's S runs
      bar_wait(vbar, 0);
      if (bq != nullptr) {
        const uint4 cb_v = bias_chunk(bq + 2 * D, tid);
#pragma unroll
        for (int j = 0; j < KT; ++j)
          fold_tile(sv + j * kTileBytes, min(kRows, L - j * kRows), cb_v, tid);
      }
      fence_async_smem();
    }
    wg_wait0();
#pragma unroll
    for (int j = 0; j < NT; ++j) fence_regs(s[j]);
    fence_regs(st);
    // every warp's products are done with q: its buffer takes the next
    // tile (the first tile: v's fold published too)
    __syncthreads();
    if (tid == 0 && qt + 1 < n_qt) {
      bar_expect_tx(qbar, kTileBytes);
      tma_load(sq, map, qbar, h * kDh, q0 + kRows, b);
    }

    // p = softmax in fp32, in place
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const Tile tile(mask, j * kRows, L, scale);
      logits<64>(s[j], tile, scale, mask, i0, j * kRows, L, t);
      tile_max<64>(s[j], tile, mx);
    }
    if constexpr (TAIL) {
      const Tile tile(mask, NT * kRows, L, scale);
      logits<16>(st, tile, scale, mask, i0, NT * kRows, L, t);
      tile_max<16>(st, tile, mx);
    }
    float mb[2], l[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      mb[r] = MASK ? finite_max(mx[r]) : max_log2e(mx[r]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) tile_exp<MASK, 64>(s[j], Tile(mask, j * kRows, L, scale), mb, l);
    if constexpr (TAIL) tile_exp<MASK, 16>(st, Tile(mask, NT * kRows, L, scale), mb, l);
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      inv[r] = 1.f / l[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int x = 0; x < 32; ++x) s[j][x] *= inv[(x >> 1) & 1];
    if constexpr (TAIL) {
#pragma unroll
      for (int x = 0; x < 8; ++x) st[x] *= inv[(x >> 1) & 1];
    }

    // D = sum_j p dP over the row
    bar_wait(gbar + (qt & 1), (qt >> 1) & 1);
    float dn[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float dp[32];
      run(dp, [&] { rows_times<64>(dp, sgt, sv + j * kTileBytes); });
#pragma unroll
      for (int x = 0; x < 32; ++x) dn[(x >> 1) & 1] += s[j][x] * dp[x];
    }
    if constexpr (TAIL) {
      float dp[8];
      run(dp, [&] { rows_times<16>(dp, sgt, sv + NT * kTileBytes); });
#pragma unroll
      for (int x = 0; x < 8; ++x) dn[(x >> 1) & 1] += st[x] * dp[x];
    }
    float dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) dd[r] = quad_sum(dn[r]);

    // dq = dS k over the key tiles, each dP taken again
    float dq[32], dp[32];
    float dpt[TAIL ? 8 : 1];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;
    run(dp, [&] { rows_times<64>(dp, sgt, sv); });
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int x = 0; x < 32; ++x) dp[x] = s[j][x] * (dp[x] - dd[(x >> 1) & 1]) * scale;
      uint32_t a[4][4];
      to_a<64>(a, dp);
      fence_regs(dq);
      fence_regs(dp);
      fence_regs(dpt);
      wg_fence();
      acc_times(dq, a, sk + j * kTileBytes);
      if (j + 1 < NT) {
        rows_times<64>(dp, sgt, sv + (j + 1) * kTileBytes);
      } else if constexpr (TAIL) {
        rows_times<16>(dpt, sgt, sv + NT * kTileBytes);
      }
      wg_commit();
      if (j + 1 == NT && !TAIL) fold_next_q();
      wg_wait0();
      fence_regs(dq);
      fence_regs(dp);
      fence_regs(dpt);
    }
    if constexpr (TAIL) {
#pragma unroll
      for (int x = 0; x < 8; ++x) dpt[x] = st[x] * (dpt[x] - dd[(x >> 1) & 1]) * scale;
      uint32_t a[1][4];
      to_a<16>(a, dpt);
      fence_regs(dq);
      wg_fence();
      acc_times(dq, a, sk + NT * kTileBytes);
      wg_commit();
      fold_next_q();
      wg_wait0();
      fence_regs(dq);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 8 * r;
      if (i < L) {
        bf16* row = dqkv + ((size_t)b * L + i) * 3 * D + h * kDh + 2 * t;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(row + 8 * j) =
              pack_bf16(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
        if (t == 0) {
          const float l2 = log2f(l[r]);
          *reinterpret_cast<float4*>(stats + (((size_t)b * H + h) * L + i) * 4) =
              make_float4(max_log2e(mx[r]) + l2, dd[r], finite_max(mx[r]), l2);
        }
      }
    }
  }
}

template <int KIND>
cudaError_t launch_bwd_wgmma_kernel(const CUtensorMap& mq, const CUtensorMap& mg,
                                    const CUtensorMap& ms, const void* qkv_b, const float* mask,
                                    void* dqkv, float* stats, int B, int L, int H, float scale,
                                    cudaStream_t stream) {
  using namespace ccmh::wg;
  constexpr int S = kBwdStages;
  const size_t smem = 1024 + 2 * kTileBytes +
                      (size_t)S * (2 * kTileBytes + (KIND == kDkDv ? kStatsBytes : 0)) +
                      8 * (S + 1);
  auto kernel = mask ? attention_bwd_wgmma<KIND, S, true> : attention_bwd_wgmma<KIND, S, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_t = (L + kRows - 1) / kRows;
  const long long blocks = (long long)B * H * n_t;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kWgThreads, smem, stream>>>(
      mq, mg, ms, static_cast<const bf16*>(qkv_b), mask, static_cast<bf16*>(dqkv), stats, L, H,
      scale, n_t);
  return cudaGetLastError();
}

template <int NT, bool TAIL>
cudaError_t launch_bwd_onepass_tiles(const CUtensorMap& mq, const CUtensorMap& mg,
                                     const void* qkv_b, const float* mask, void* dqkv,
                                     float* stats, int B, int L, int H, float scale,
                                     cudaStream_t stream) {
  using namespace ccmh::wg;
  constexpr int KT = NT + (TAIL ? 1 : 0);      // k tiles, and v tiles
  const size_t smem = 1024 + (size_t)(3 + 2 * KT) * kTileBytes + 8 * 5;
  auto kernel = mask ? attention_bwd_onepass_q<NT, TAIL, true>
                     : attention_bwd_onepass_q<NT, TAIL, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kWgThreads, smem, stream>>>(
      mq, mg, static_cast<const bf16*>(qkv_b), mask, static_cast<bf16*>(dqkv), stats, L, H,
      scale);
  return cudaGetLastError();
}

// the one-pass query side for 128 < L <= kBwdOnePassMaxL: NT tiles of 64
// keys, and one of 16 where the last tile holds <= 16 keys
cudaError_t launch_bwd_onepass(const CUtensorMap& mq, const CUtensorMap& mg, const void* qkv_b,
                               const float* mask, void* dqkv, float* stats, int B, int L, int H,
                               float scale, cudaStream_t stream) {
  using namespace ccmh::wg;
  const int rem = L % kRows;
  const bool tail = rem != 0 && rem <= 16;
  const int nt = L / kRows + (rem > 16 ? 1 : 0);
  switch (2 * nt + (tail ? 1 : 0)) {
    case 5:
      return launch_bwd_onepass_tiles<2, true>(mq, mg, qkv_b, mask, dqkv, stats, B, L, H, scale,
                                               stream);
    case 6:
      return launch_bwd_onepass_tiles<3, false>(mq, mg, qkv_b, mask, dqkv, stats, B, L, H, scale,
                                                stream);
    case 7:
      return launch_bwd_onepass_tiles<3, true>(mq, mg, qkv_b, mask, dqkv, stats, B, L, H, scale,
                                               stream);
    case 8:
      return launch_bwd_onepass_tiles<4, false>(mq, mg, qkv_b, mask, dqkv, stats, B, L, H, scale,
                                                stream);
    case 9:
      return launch_bwd_onepass_tiles<4, true>(mq, mg, qkv_b, mask, dqkv, stats, B, L, H, scale,
                                               stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// the bf16 wgmma backward: the one-pass query side and kernel 2 (onepass),
// or kernels 1, 2 and 3
cudaError_t launch_wgmma(const void* qkv, const void* qkv_b, const float* mask, const void* g,
                         void* dqkv, float* stats, int B, int L, int H, float scale,
                         bool onepass, cudaStream_t stream) {
  using namespace ccmh::wg;
  const uint64_t D = (uint64_t)H * kDh;
  CUtensorMap mq, mg, ms;
  cudaError_t err = make_map(&mq, qkv, kMapBf16, 3 * D, L, B, 3 * D, kDh);
  if (err == cudaSuccess) err = make_map(&mg, g, kMapBf16, D, L, B, D, kDh);
  // the statistics as [B H][L][4] fp32: a tile's rows in one box
  if (err == cudaSuccess) err = make_map(&ms, stats, kMapF32Plain, 4, L, (uint64_t)B * H, 4, 4);
  if (err == cudaSuccess)
    err = onepass ? launch_bwd_onepass(mq, mg, qkv_b, mask, dqkv, stats, B, L, H, scale, stream)
                  : launch_bwd_wgmma_kernel<kStatsPass>(mq, mg, ms, qkv_b, mask, dqkv, stats, B,
                                                        L, H, scale, stream);
  if (err == cudaSuccess)
    err = launch_bwd_wgmma_kernel<kDkDv>(mq, mg, ms, qkv_b, mask, dqkv, stats, B, L, H, scale,
                                         stream);
  if (err == cudaSuccess && !onepass)
    err = launch_bwd_wgmma_kernel<kDq>(mq, mg, ms, qkv_b, mask, dqkv, stats, B, L, H, scale,
                                       stream);
  return err;
}

// ---------------------------------------------------------------------------
// The fp32 long path on the same warpgroup products: L > 128 in fp32 with
// Dh = 64 and 16-byte aligned pointers (long_family), every CLIP tower past
// 128 tokens in ccmh's default compute type.  Replaces ccmh/ops/attention.py
// `_pallas_backward` / `_bwd_kernel` past 128 tokens in fp32, every step in
// fp32, the products as 3xTF32 on wgmma .tf32 (wgmma_tiles.cuh).
//
// What bounds it on an H100: the products.  At ViT-L/14 (B = 64, L = 257,
// H = 16) the function's 43 GFLOP take 262 us at a third of the 495
// TFLOP/s TF32 peak (its 472 MB of qkv, g and dqkv 141 us at 3.35 TB/s);
// the three kernels take nine products where the function has five, as the
// bf16 kernels do.
//
// Design: the bf16 kernels' three-kernel dataflow (stats; dk and dv
// key-major; dq query-major; no atomics, so the gradients are the same bits
// every run; the rows' statistics (lse2, D, m, log2 sum) in fp32 over the
// first 16 bytes of each row's dq slot), with what .tf32 asks for: a
// product reads each operand as hi and lo, and one that sums over a
// streamed tile's rows reads a transposed copy, in the order in which the
// accumulator's columns enter as the register A operand: dq += dS k reads
// k^T (kernel 3); dv += p^T g and dk += dS^T q read g^T and q^T (kernel 2).
//
// Kernels 2 and 3 (attention_bwd_wgmma32_ws) are warp-specialised, three
// warpgroups a block, one block an SM (attention_bwd32_plan.cuh has the
// plan and the grid, which the CPU tests check):
//   * a producer warpgroup, its registers cut to kProducerRegs, lands each
//     stage of 32 streamed rows by TMA (k, v | q, g and, in kernel 2, the
//     32 queries' statistics) in place in a ring of kDqStages = 3 |
//     kDkDvStages = 2, folds the bias into it in fp32 and writes its lo and
//     the transposed copies with their lo (loops not unrolled: unrolled,
//     they spilled at 40 and 56 registers), and signals the stage on an
//     mbarrier (every producer thread arrives after its fence.proxy.async);
//   * two consumer warpgroups, raised to kConsumerRegs, each with 64
//     resident rows (queries | keys: a block holds 128, and the head's last
//     block may hold 64 or fewer, its second consumer idle), run only the
//     products and the softmax arithmetic on each stage and release it on a
//     second barrier (lane 0 of each warp once its products are done).  So
//     each split byte feeds both consumers, the producer's split overlaps
//     their products, and no __syncthreads is left in the step loop;
//   * a folded tile is its own hi operand: the tensor cores ignore the low
//     13 mantissa bits of a raw fp32 operand (chip_smoke.py checks it before
//     the first fp32 long launch), so only lo = x - hi is stored beside it,
//     and p and dS are their own hi as register A operands.  hi is bit for
//     bit split_tz's, every output element is summed in the k-step order of
//     the 64-row kernels this replaced (32-row stages take the same 8-row
//     k-steps in the same order), and the gradients are those kernels' bits;
//   * the consumer's first resident tensor (q | k) is folded in place with
//     its lo beside it in shared memory; the second (g | v) lands where that
//     lo goes and is read into register A operands (a_rows32) first.
// Shared memory: 1 KB slack + 64 KB resident + 3 x 48 KB | 2 x (64 KB +
// 512 bytes of statistics) + barriers: 209 | 194 KB.  A streamed stage of
// <= 16 rows (the class token's) takes m64n16k8 products and 16-row splits.
// Registers a thread: 168 at launch (ptxas), 40 in the producer and 232 in
// the consumers after setmaxnreg, no spill.  Measured slower or spilling
// (PERF.md): kernel 3 two stages deep (the next S and dP over this
// softmax; spills at 232), the consumers taking turns to start their
// products, kernel 2's q and g landed in a ring of their own, kernel 1 on
// the same three-warpgroup plan.
constexpr int kProducerRegs = 40;    // the producer warpgroup's registers a thread
constexpr int kConsumerRegs = 232;   // the consumers': 40 + 2 x 232 = 3 x 168

template <int KIND, bool MASK>
__global__ void __launch_bounds__(ccmh::bwd32::kThreads, 1)
attention_bwd_wgmma32_ws(const __grid_constant__ CUtensorMap qkv_map,
                   const __grid_constant__ CUtensorMap g_map,
                   const float* __restrict__ qkv_b, const float* __restrict__ mask,
                   float* __restrict__ dqkv, int L, int H, float scale, int n_b) {
  using namespace ccmh::wg;
  namespace p32 = ccmh::bwd32;
  static_assert(KIND == kDkDv || KIND == kDq, "kernel 1 is attention_bwd_wgmma32_stats");
  constexpr bool KEYS = KIND == kDkDv;   // key-major: k, v stay; q, g, statistics stream
  constexpr int S = KEYS ? p32::kDkDvStages : p32::kDqStages;
  constexpr int kStage = KEYS ? p32::kDkDvStageBytes : p32::kDqStageBytes;
  constexpr int kHalf = p32::kHalfTile;   // [32][64] | [64][32] fp32
  constexpr int kSR = p32::kStreamRows;
  extern __shared__ unsigned char smem_raw[];
  // consumer c: resident folded tile at res + 2 c kTile32, its lo after it
  unsigned char* res = align1024(smem_raw);
  // stage tiles: 0 k | q, folded; 1 its lo; 2 v | g; 3 its lo; 4 (k | q)^T;
  // 5 its lo; KEYS: 6 g^T, 7 its lo
  unsigned char* ring = res + p32::kResidentBytes;
  float* sst = reinterpret_cast<float*>(ring + S * kStage);   // KEYS: S x 32 x (lse2, D, m, l2)
  uint64_t* landed = reinterpret_cast<uint64_t*>(ring + S * kStage +
                                                 (KEYS ? S * p32::kDkDvStatsBytes : 0));
  uint64_t* ready = landed + S;    // the stage split: the producer's 128 threads
  uint64_t* freed = ready + S;     // the stage done: 4 warps a consumer with rows
  uint64_t* rbar = freed + S;      // a consumer's resident tiles
  const int tid = threadIdx.x, wgi = tid >> 7;
  const int blk = blockIdx.x % n_b, h = (blockIdx.x / n_b) % H, b = blockIdx.x / (n_b * H);
  const int D = H * kDh, D3 = 3 * D;
  const int t0 = blk * p32::kBlockRows;
  const int nc = L - t0 > p32::kConsumerRows ? 2 : 1;   // consumers with rows
  const int n_s = (L + kSR - 1) / kSR;
  const float* bq = qkv_b ? qkv_b + h * kDh : nullptr;
  const CUtensorMap* mq = &qkv_map;
  const CUtensorMap* mg = &g_map;
  // the statistics of row i, over the first 16 bytes of its dq slot
  auto slot = [&](int i) { return dqkv + ((size_t)b * L + i) * D3 + h * kDh; };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      bar_init(&landed[s], 1);
      bar_init(&ready[s], kWgThreads);
      bar_init(&freed[s], 4 * nc);
    }
    bar_init(&rbar[0], 1);
    bar_init(&rbar[1], 1);
    bar_init_fence();
  }
  __syncthreads();

  if (wgi == 0) {
    // the producer: land, fold, split and transpose each stage
    regs_dec<kProducerRegs>();
    const float* b_a = bq ? (KEYS ? bq : bq + D) : nullptr;   // streamed q | k
    const float* b_b = bq && !KEYS ? bq + 2 * D : nullptr;    // streamed g (none) | v
    for (int s = 0; s < n_s; ++s) {
      const int sl = s % S, s0 = s * kSR, ns = min(kSR, L - s0);
      unsigned char* st = ring + sl * kStage;
      if (s >= S) bar_wait(&freed[sl], ((s / S) - 1) & 1);
      if (tid == 0) {
        bar_expect_tx(&landed[sl], 2 * kHalf);
        if (KEYS) {
          tma_half32(st, mq, &landed[sl], h * kDh, s0, b);
          tma_half32(st + 2 * kHalf, mg, &landed[sl], h * kDh, s0, b);
        } else {
          tma_half32(st, mq, &landed[sl], D + h * kDh, s0, b);
          tma_half32(st + 2 * kHalf, mq, &landed[sl], 2 * D + h * kDh, s0, b);
        }
      }
      if (KEYS && tid < kSR) {
        const int i = s0 + tid;
        *reinterpret_cast<float4*>(sst + 4 * (sl * kSR + tid)) =
            i < L ? *reinterpret_cast<const float4*>(slot(i)) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      bar_wait(&landed[sl], (s / S) & 1);
      auto split = [&](auto nr) {
        constexpr int NR = decltype(nr)::value;
        fold_lo<kSR, NR>(st, st + kHalf, ns, b_a, tid);
        fold_lo<kSR, NR>(st + 2 * kHalf, st + 3 * kHalf, ns, b_b, tid);
        named_sync(1, kWgThreads);   // the folded tiles before their transposes
        transpose_lo<kSR, NR>(st + 4 * kHalf, st + 5 * kHalf, st, tid);
        if constexpr (KEYS)
          transpose_lo<kSR, NR>(st + 6 * kHalf, st + 7 * kHalf, st + 2 * kHalf, tid);
      };
      if (ns <= 16)
        split(std::integral_constant<int, 16>());
      else
        split(std::integral_constant<int, kSR>());
      fence_async_smem();   // the split before the consumers' wgmma reads it
      bar_arrive(&ready[sl]);
    }
    return;
  }

  // a consumer: 64 resident rows from r0
  regs_inc<kConsumerRegs>();
  const int c = wgi - 1, ctid = tid - kWgThreads * wgi;
  const int warp = ctid >> 5, lane = tid & 31, t = lane & 3;
  const int r0 = t0 + c * p32::kConsumerRows, nr = min(p32::kConsumerRows, L - r0);
  if (nr <= 0) return;
  unsigned char* rh = res + 2 * c * kTile32;   // q | k, folded
  unsigned char* rl = rh + kTile32;            // its lo; g | v land here first
  const int i0 = r0 + 16 * warp + (lane >> 2);   // the thread's rows i0, i0 + 8 (queries | keys)
  const float* b_h = bq ? (KEYS ? bq + D : bq) : nullptr;   // resident k | q
  const float* b_r = bq && KEYS ? bq + 2 * D : nullptr;      // resident v | g (none)
  if (ctid == 0) {
    // 32-row boxes below L: rows r0 (and r0 + 32), both column atoms
    const int boxes = nr > kSR ? 2 : 1;
    bar_expect_tx(&rbar[c], boxes * 4 * (kHalf / 2));
    for (int x = 0; x < boxes; ++x)
      for (int a = 0; a < 2; ++a) {
        const int off = a * kAtomBytes + x * (kAtomBytes / 2), col = h * kDh + 32 * a;
        const int row = r0 + kSR * x;
        if (KEYS) {
          tma_load(rh + off, mq, &rbar[c], D + col, row, b);
          tma_load(rl + off, mq, &rbar[c], 2 * D + col, row, b);
        } else {
          tma_load(rh + off, mq, &rbar[c], col, row, b);
          tma_load(rl + off, mg, &rbar[c], col, row, b);
        }
      }
  }
  bar_wait(&rbar[c], 0);
  uint32_t xh[8][4], xl[8][4];   // v | g, split: the A operand of dP^T = v g^T | dP = g v^T
  a_rows32(xh, xl, rl, nr, b_r, warp, lane);
  named_sync(2 + c, kWgThreads);   // every warp has read v | g
  fold_lo<kRows, kRows>(rh, rl, nr, b_h, ctid);
  fence_async_smem();
  named_sync(2 + c, kWgThreads);

  // kernel 3: the thread's rows' statistics, read before its dq overwrites them
  RowLse rls[2] = {};
  float dd[2] = {0.f, 0.f};
  if (KIND == kDq) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 8 * r;
      if (i < L) {
        const float4 v = *reinterpret_cast<const float4*>(slot(i));
        rls[r] = {v.x, v.z, v.w};
        dd[r] = v.y;
      }
    }
  }

  float acc0[32], acc1[32];   // dq | dk, and dv
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
  auto stage = [&](int s) -> const unsigned char* { return ring + (s % S) * kStage; };
  auto wait_ready = [&](int s) { bar_wait(&ready[s % S], (s / S) & 1); };
  // the warp's products are done with stage s
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) bar_arrive(&freed[s % S]);
  };
  auto settle = [&] {
    wg_wait0();
    fence_regs(acc0);
    if constexpr (KEYS) fence_regs(acc1);
  };
  // S = q k^T, dP = g v^T (query-major); S^T = k q^T, dP^T = v g^T
  // (key-major) over stage s's N columns, started
  auto start = [&](auto n, auto& sv, auto& dp, int s) {
    constexpr int N = decltype(n)::value;
    const unsigned char* st = stage(s);
    fence_regs(sv);
    fence_regs(dp);
    wg_fence();
    rows_times32<N, kSR>(sv, rh, rl, st, st + kHalf);
    rows_times32<N, kSR>(dp, xh, xl, st + 2 * kHalf, st + 3 * kHalf);
    wg_commit();
  };
  // from stage s's S and dP (done) to its output products, started
  auto finish = [&](auto n, auto& sv, auto& dp, int s) {
    constexpr int N = decltype(n)::value;
    const unsigned char* st = stage(s);
    const int s0 = s * kSR;
    fence_regs(sv);
    fence_regs(dp);
    if constexpr (!KEYS) {
      // dS scale into registers of its own (the accumulators stay as the
      // products left them), from the logits in the Tile form of the
      // 64-key tile that holds this stage
      const Tile tile(mask, s0 & ~(kRows - 1), L, scale);
      float ds[N / 2];
#pragma unroll
      for (int x = 0; x < N / 2; ++x) {
        const int r = (x >> 1) & 1;
        const float y = tile.plain ? sv[x]
                                   : logit(sv[x], scale, mask, i0 + 8 * r,
                                           s0 + 8 * (x >> 2) + 2 * t + (x & 1), L);
        ds[x] = prob<MASK>(y, tile, rls[r]) * (dp[x] - dd[r]) * scale;
      }
      uint32_t al[N / 8][4];
      lo_a32<N>(al, ds);
      fence_regs(acc0);
      wg_fence();
      acc_times32_raw<N / 8>(acc0, ds, al, st + 4 * kHalf, st + 5 * kHalf);   // dq += dS k
      wg_commit();
    } else {
      // key-major: rows are keys i0 + 8 r, columns the queries s0 + c; a
      // query past L (its q, g and statistics rows zeros) gets p = 0
      const Tile tile(mask, r0, L, scale);
      const float* sq = sst + 4 * (s % S) * kSR;
      // p and dS scale of element x (column cc), from the query's (lse2, D, m, l2)
      auto p_ds = [&](int x, int cc) {
        const float4 q = *reinterpret_cast<const float4*>(sq + 4 * cc);
        const float p = s0 + cc < L ? prob<MASK>(sv[x], tile, {q.x, q.z, q.w}) : 0.f;
        sv[x] = p;
        dp[x] = p * (dp[x] - q.y) * scale;
      };
      if (MASK || !tile.plain) {
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * j + e;
            sv[x] = logit(sv[x], scale, mask, s0 + 8 * j + 2 * t + (e & 1), i0 + 8 * (e >> 1), L);
          }
      }
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p_ds(4 * j + e, 8 * j + 2 * t + (e & 1));
      uint32_t alp[N / 8][4], als[N / 8][4];
      lo_a32<N>(alp, sv);
      lo_a32<N>(als, dp);
      fence_regs(acc0);
      fence_regs(acc1);
      wg_fence();
      acc_times32_raw<N / 8>(acc1, sv, alp, st + 6 * kHalf, st + 7 * kHalf);   // dv += p^T g
      acc_times32_raw<N / 8>(acc0, dp, als, st + 4 * kHalf, st + 5 * kHalf);   // dk += dS^T q
      wg_commit();
    }
  };
  // one stage at a time: its products, then its softmax, then its output
  // products
  auto one = [&](auto n, int s) {
    constexpr int N = decltype(n)::value;
    float sv[N / 2], dp[N / 2];
    wait_ready(s);
    start(n, sv, dp, s);
    wg_wait0();
    finish(n, sv, dp, s);
    settle();
    release(s);
  };
  // the full stages; a last one of <= 16 rows takes m64n16k8 products
  const int tail = L - (n_s - 1) * kSR <= 16 ? 1 : 0, nf = n_s - tail;
  for (int s = 0; s < nf; ++s) one(std::integral_constant<int, kSR>(), s);
  if (tail) one(std::integral_constant<int, 16>(), nf);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    if (i < L) {
      float* row = slot(i) + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(row + (KEYS ? D : 0) + 8 * j) =
            make_float2(acc0[4 * j + 2 * r], acc0[4 * j + 2 * r + 1]);
        if (KEYS)
          *reinterpret_cast<float2*>(row + 2 * D + 8 * j) =
              make_float2(acc1[4 * j + 2 * r], acc1[4 * j + 2 * r + 1]);
      }
    }
  }
}

// Kernel 1 in fp32, apart: it takes only S = q k^T and dP = g v^T, so it
// keeps q's A fragments in registers (a_rows32) and splits the landed k and
// v tiles in place (hi over the landed values, lo beside them): six tiles,
// 97 KB, two blocks an SM where the ten tiles of kernels 2 and 3's layout
// allowed one.  The next tiles' copies go out once the products have read
// the landed tiles; the SM's other block covers them.
template <bool MASK>
__global__ void __launch_bounds__(ccmh::wg::kWgThreads, 2)
attention_bwd_wgmma32_stats(const __grid_constant__ CUtensorMap qkv_map,
                      const __grid_constant__ CUtensorMap g_map,
                      const float* __restrict__ qkv_b, const float* __restrict__ mask,
                      float* __restrict__ dqkv, int L, int H, float scale, int n_t) {
  using namespace ccmh::wg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* gh = align1024(smem_raw);   // g, landed and split in place: hi
  unsigned char* gl = gh + kTile32;          //   and lo
  unsigned char* kh = gl + kTile32;          // k, landed and split in place (q lands in kl)
  unsigned char* kl = kh + kTile32;
  unsigned char* vh = kl + kTile32;          // v
  unsigned char* vl = vh + kTile32;
  uint64_t* sbar = reinterpret_cast<uint64_t*>(vl + kTile32);
  uint64_t* rbar = sbar + 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int tile = blockIdx.x % n_t, h = (blockIdx.x / n_t) % H, b = blockIdx.x / (n_t * H);
  const int D = H * kDh, D3 = 3 * D;
  const int t0 = tile * kRows, nt = min(kRows, L - t0);
  const int i0 = t0 + 16 * warp + (lane >> 2);   // the thread's query rows i0, i0 + 8
  const float* bq = qkv_b ? qkv_b + h * kDh : nullptr;
  const float* bk = qkv_b ? bq + D : nullptr;
  const float* bv = qkv_b ? bq + 2 * D : nullptr;
  const CUtensorMap* mq = &qkv_map;

  auto fetch = [&](int step) {
    bar_expect_tx(sbar, 2 * kTile32);
    tma_tile32(kh, mq, sbar, D + h * kDh, step * kRows, b);
    tma_tile32(vh, mq, sbar, 2 * D + h * kDh, step * kRows, b);
  };
  if (tid == 0) {
    bar_init(sbar, 1);
    bar_init(rbar, 1);
    bar_init_fence();
    bar_expect_tx(rbar, 2 * kTile32);
    tma_tile32(kl, mq, rbar, h * kDh, t0, b);
    tma_tile32(gh, &g_map, rbar, h * kDh, t0, b);
    fetch(0);
  }
  __syncthreads();
  uint32_t qh[8][4], ql[8][4];   // q + b, split: the A operand of S = q k^T
  bar_wait(rbar, 0);
  a_rows32(qh, ql, kl, nt, bq, warp, lane);
  split_tile<64>(gh, gl, gh, nt, nullptr, tid);

  Stats64 st;
  st.init();
  for (int step = 0; step < n_t; ++step) {
    const int s0 = step * kRows, ns = min(kRows, L - s0);
    bar_wait(sbar, step & 1);
    __syncthreads();   // q's fragments read before kl is overwritten
    auto cols = [&](auto n) {
      constexpr int N = decltype(n)::value;
      split_tile<N>(kh, kl, kh, ns, bk, tid);
      split_tile<N>(vh, vl, vh, ns, bv, tid);
      fence_async_smem();   // the splits (and g's) before the async proxy reads them
      __syncthreads();
      float s[N / 2], dp[N / 2];
      fence_regs(s);
      fence_regs(dp);
      wg_fence();
      rows_times32<N>(s, qh, ql, kh, kl);
      rows_times32<N>(dp, gh, gl, vh, vl);
      wg_commit();
      wg_wait0();
      fence_regs(s);
      fence_regs(dp);
      __syncthreads();   // every warp's products done with the landed tiles
      if (tid == 0 && step + 1 < n_t) fetch(step + 1);
      const Tile tile(mask, s0, L, scale);
      logits<N>(s, tile, scale, mask, i0, s0, L, t);
      st.add<true, MASK, N>(s, dp, tile);
    };
    if (ns <= 16)
      cols(std::integral_constant<int, 16>());
    else
      cols(std::integral_constant<int, 64>());
  }
  st.finish();
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 8 * r;
      if (i < L) {
        const RowLse q = st.row(r);
        *reinterpret_cast<float4*>(dqkv + ((size_t)b * L + i) * D3 + h * kDh) =
            make_float4(q.lse2, st.dn[r] * (1.f / st.l[r]), q.m, q.l2);
      }
    }
  }
}

cudaError_t launch_bwd_wgmma32_stats(const CUtensorMap& mq, const CUtensorMap& mg,
                                     const void* qkv_b, const float* mask, void* dqkv, int B,
                                     int L, int H, float scale, cudaStream_t stream) {
  using namespace ccmh::wg;
  const size_t smem = 1024 + (size_t)6 * kTile32 + 16;
  auto kernel = mask ? attention_bwd_wgmma32_stats<true> : attention_bwd_wgmma32_stats<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_t = (L + kRows - 1) / kRows;
  const long long blocks = (long long)B * H * n_t;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kWgThreads, smem, stream>>>(
      mq, mg, static_cast<const float*>(qkv_b), mask, static_cast<float*>(dqkv), L, H, scale, n_t);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_bwd_ws32(const CUtensorMap& mq, const CUtensorMap& mg, const void* qkv_b,
                            const float* mask, void* dqkv, int B, int L, int H, float scale,
                            cudaStream_t stream) {
  namespace p32 = ccmh::bwd32;
  const int smem = KIND == kDkDv ? p32::kDkDvSmem : p32::kDqSmem;
  auto kernel =
      mask ? attention_bwd_wgmma32_ws<KIND, true> : attention_bwd_wgmma32_ws<KIND, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_b = p32::blocks_a_head(L);
  const long long blocks = (long long)B * H * n_b;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, p32::kThreads, smem, stream>>>(
      mq, mg, static_cast<const float*>(qkv_b), mask, static_cast<float*>(dqkv), L, H, scale, n_b);
  return cudaGetLastError();
}

// kernel 1 on 64-row boxes; kernels 2 and 3 on 32-row boxes (their stages;
// a resident tile lands as two)
cudaError_t launch_wgmma32(const void* qkv, const void* qkv_b, const float* mask, const void* g,
                           void* dqkv, int B, int L, int H, float scale, cudaStream_t stream) {
  using namespace ccmh::wg;
  const uint64_t D = (uint64_t)H * kDh;
  const uint32_t half = ccmh::bwd32::kStreamRows;
  CUtensorMap mq, mg, mq32, mg32;
  cudaError_t err = make_map(&mq, qkv, kMapF32, 3 * D, L, B, 3 * D, 32);
  if (err == cudaSuccess) err = make_map(&mg, g, kMapF32, D, L, B, D, 32);
  if (err == cudaSuccess) err = make_map(&mq32, qkv, kMapF32, 3 * D, L, B, 3 * D, 32, half);
  if (err == cudaSuccess) err = make_map(&mg32, g, kMapF32, D, L, B, D, 32, half);
  if (err == cudaSuccess)
    err = launch_bwd_wgmma32_stats(mq, mg, qkv_b, mask, dqkv, B, L, H, scale, stream);
  if (err == cudaSuccess)
    err = launch_bwd_ws32<kDkDv>(mq32, mg32, qkv_b, mask, dqkv, B, L, H, scale, stream);
  if (err == cudaSuccess)
    err = launch_bwd_ws32<kDq>(mq32, mg32, qkv_b, mask, dqkv, B, L, H, scale, stream);
  return err;
}

// Which kernels the C entry launches, by the rule of attention_family.cuh
int long_family(const void* qkv, const void* qkv_b, const void* g, const void* dqkv, int L,
                int Dh, int dtype) {
  return ccmh::attention_bwd_family(L, Dh, dtype, qkv, qkv_b, g, dqkv);
}

}  // namespace

// The kernel family ccmh_attention_bwd launches for these arguments: 0 the
// short kernel, 1 the long mma.sync kernels, 2 the long wgmma kernels (three
// in bf16), 3 the bf16 one-pass query side and kernel 2 (the wrapper counts
// its launches by family).
extern "C" int ccmh_attention_bwd_family(const void* qkv, const void* qkv_b, const void* g,
                                         const void* dqkv, int L, int Dh, int dtype) {
  return long_family(qkv, qkv_b, g, dqkv, L, Dh, dtype);
}

// The fp32 values a row of the statistics buffer holds (the entry below
// takes the buffer since this symbol exists)
extern "C" int ccmh_attention_bwd_stats_width() { return 4; }

// qkv and dqkv [B, L, 3*H*Dh], g [B, L, H*Dh], all contiguous in `dtype`;
// qkv_b [3*H*Dh] in `dtype` or null; mask [L, L] fp32 or null; stats the
// bf16 long path's row statistics, [B, H, L, 4] fp32 scratch, 16-byte
// aligned (the wgmma families in bf16 refuse null; the others ignore it);
// scale is 1/sqrt(Dh) rounded to fp32 by the caller.  Launches on `stream`
// of card `device` and returns cudaGetLastError() (0 = launched).
extern "C" int ccmh_attention_bwd(int device, const void* qkv, const void* qkv_b,
                                  const float* mask, const void* g, void* dqkv, float* stats,
                                  int B, int L, int H, int Dh, float scale, int dtype,
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
      switch (long_family(qkv, qkv_b, g, dqkv, L, Dh, dtype)) {
        case ccmh::kFamilyShort:
          return (int)launch<float>(device, qkv, qkv_b, mask, g, dqkv, B, L, H, Dh, scale, s);
        case ccmh::kFamilyLongWgmma:
          return (int)launch_wgmma32(qkv, qkv_b, mask, g, dqkv, B, L, H, scale, s);
        default:
          return (int)launch_long<float>(qkv, qkv_b, mask, g, dqkv, B, L, H, Dh, scale, s);
      }
    case ccmh::kBFloat16:
      switch (const int family = long_family(qkv, qkv_b, g, dqkv, L, Dh, dtype)) {
        case ccmh::kFamilyShort:
          return (int)launch<__nv_bfloat16>(device, qkv, qkv_b, mask, g, dqkv, B, L, H, Dh,
                                            scale, s);
        case ccmh::kFamilyLongWgmma:
        case ccmh::kFamilyLongOnePass:
          if (stats == nullptr || !ccmh::aligned16_or_null(stats))
            return (int)cudaErrorInvalidValue;
          return (int)launch_wgmma(qkv, qkv_b, mask, g, dqkv, stats, B, L, H, scale,
                                   family == ccmh::kFamilyLongOnePass, s);
        default:
          return (int)launch_long<__nv_bfloat16>(qkv, qkv_b, mask, g, dqkv, B, L, H, Dh, scale,
                                                 s);
      }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
