// The long-sequence path of the attention kernels #1 (attention.cu) and #2
// (attention_bwd.cu): the building blocks both share.
//
// Past L = 128 one head's q, k and v no longer fit a block's shared memory
// beside a warp's [16, L] logits in registers (the short kernels' design):
// at L = 577, Dh = 64 fp32 k and v alone take 295 KB, and an SM offers 227.
// So the long kernels stream the sequence through shared memory in tiles of
// kTile = 64 rows (queries or keys), one warp per 16 rows of a tile, and
// take each warp's logits kChunk = 32 columns at a time, in registers.
// They compute ccmh's function with ccmh's rounding points:
//   * the softmax is normalised BEFORE the probabilities are rounded to T:
//     a stats pass streams the key tiles for each row's max and sum (the
//     sum rescaled as the max grows, in fp32), then p = exp(x - max) / sum
//     is formed in fp32, rounded to T, and multiplied (no online rescale of
//     an unnormalised, rounded p, which would depart from ccmh in bf16);
//   * every product accumulates in fp32 on the tensor cores (mma.sync:
//     bf16 m16n8k16, fp32 as 3xTF32 m16n8k8 split toward zero, FragTz);
//   * no atomics: every output element is summed by one warp in a fixed
//     order, so the gradients are the same bits from run to run.
// Tiles live in shared memory in T with the projection bias folded in, in
// the layout of mma_tiles.cuh; rows past the sequence's end are zero
// (load_tile pads to 16 rows; 16-row blocks past that are skipped).

#pragma once

#include "mma_tiles.cuh"

namespace ccmh {
namespace attn_long {

using namespace ccmh::mma;

constexpr int kTile = 64;       // rows of a streamed tile
constexpr int kWarps = 4;       // a block's warps, 16 rows of a tile each
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;      // logit columns a warp holds at a time
constexpr int kMaxL = 4096;     // the mask's i L + j fits an int

// Wait for the block's copies and make them visible.  (Double-buffering
// the streamed tiles, the next tile's copies in flight over the current
// one's products, measured no gain: PERF.md.)
__device__ __forceinline__ void land(bool vec) {
  if (vec) cp_async_wait_all();
  __syncthreads();
}

// The vec path's bias, added in T over `rows` rows of a landed tile (the
// caller syncs afterwards).
template <typename T>
__device__ __forceinline__ void fold_bias(T* dst, int ld, int rows, int Dh,
                                          const T* __restrict__ bias, bool vec) {
  if (vec && bias != nullptr) add_bias<T>(dst, ld, rows, Dh, bias);
}

// acc[0..3] = X[m0 + 0..15] . Y[n0 + 0..31]^T over the head dim (rows
// family of fragments): the warp's 16 rows against 32 rows of Y, of which
// the 16-row blocks below n_blk (1 or 2) are computed and the rest left 0.
template <typename T>
__device__ __forceinline__ void rows_chunk(float (&acc)[4][4], const T* X, const T* Y, int ld,
                                           int m0, int n0, int n_blk, int n_dk, int lane) {
  using F = FragTz<T>;
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int kb = 0; kb < n_dk; ++kb) {
    const typename F::A a = F::a_rows(X, ld, m0, kb * 16, lane);
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      if (jp < n_blk) {
        typename F::B b0, b1;
        F::b_rows(b0, b1, Y, ld, n0 + jp * 16, kb * 16, lane);
        F::mma(acc[2 * jp], a, b0);
        F::mma(acc[2 * jp + 1], a, b1);
      }
    }
  }
}

// acc[j] += A Y, A the [16][16] operand of two accumulator tiles (rounded
// to T on the way: bf16 as the probabilities and dS are rounded in ccmh)
// and Y rows k0 + 0..15 of a row-major [rows][Dh] tile (cols family).
template <typename T, int N>
__device__ __forceinline__ void acc_times(float (&acc)[N][4], const float (&c0)[4],
                                           const float (&c1)[4], const T* Y, int ld, int k0,
                                           int n_dk, int lane) {
  using F = FragTz<T>;
  const typename F::A a = F::a_acc(c0, c1);
#pragma unroll
  for (int np = 0; np < N / 2; ++np) {
    if (np < n_dk) {
      typename F::B b0, b1;
      F::b_cols(b0, b1, Y, ld, k0, np * 16, lane);
      F::mma(acc[2 * np], a, b0);
      F::mma(acc[2 * np + 1], a, b1);
    }
  }
}

// Blocks of 16 columns of chunk n0 that hold rows of a tile of `rows` rows.
__device__ __forceinline__ int chunk_blocks(int n0, int rows) {
  return min(2, (pad16(rows) - n0) / 16);
}

// Row statistics streamed over key chunks: the running max mx, and the
// sums l = sum_j exp(x_j - mx) and dn = sum_j exp(x_j - mx) dp_j (the
// backward's D numerator; pass dp = nullptr for none), rescaled as mx
// grows.  s holds the chunk's logits (keys past L at -inf), the 16-column
// blocks below n_blk.  Partial sums stay per lane; reduce with finish().
struct RowStats {
  float mx[2], l[2], dn[2];

  __device__ void init() {
    mx[0] = mx[1] = -CUDART_INF_F;
    l[0] = l[1] = dn[0] = dn[1] = 0.f;
  }

  __device__ void add(const float (&s)[4][4], const float (*dp)[4], int n_blk) {
    float cm[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j / 2 < n_blk) {
        cm[0] = fmaxf(cm[0], fmaxf(s[j][0], s[j][1]));
        cm[1] = fmaxf(cm[1], fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float nm = fmaxf(mx[r], quad_max(cm[r]));
      if (nm != mx[r]) {
        const float corr = mx[r] == -CUDART_INF_F ? 0.f : expf(mx[r] - nm);
        l[r] *= corr;
        dn[r] *= corr;
        mx[r] = nm;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j / 2 < n_blk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = mx[r] == -CUDART_INF_F ? 0.f : expf(s[j][e] - mx[r]);
          l[r] += p;
          if (dp != nullptr) dn[r] += p * dp[j][e];
        }
  }

  __device__ void finish() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      dn[r] = quad_sum(dn[r]);
    }
  }
};

// The chunk's logits in place: query rows i0 and i0 + 8 (a warp's rows g,
// g + 8), key columns j0 + 8 j + 2 t (+1); keys past L at -inf.
__device__ __forceinline__ void logits_rows(float (&s)[4][4], int n_blk, float scale,
                                            const float* __restrict__ mask, int i0, int j0,
                                            int L, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j / 2 < n_blk) {
      const int c = j0 + 8 * j + 2 * t;
      s[j][0] = logit(s[j][0], scale, mask, i0, c, L);
      s[j][1] = logit(s[j][1], scale, mask, i0, c + 1, L);
      s[j][2] = logit(s[j][2], scale, mask, i0 + 8, c, L);
      s[j][3] = logit(s[j][3], scale, mask, i0 + 8, c + 1, L);
    }
}

}  // namespace attn_long
}  // namespace ccmh
