// The attention-backward ablation kernels of tools/bench_attn_bwd.py, for
// the short sequences of the CLIP towers (vision L=50, text L=32; Dh=64).
//
// Replaces three Pallas TPU kernels of tools/bench_attn_bwd.py (#9,
// backward_merged, is attention_merged.cu, on the tensor cores):
//   #6  backward_x / _bwd_kernel_x      -> ccmh_attention_bwd_x (8 modes)
//   #8  backward_savedp                  -> ccmh_attention_bwd_savedp
//   #10 backward_headpair                -> ccmh_attention_bwd_headpair
// Each is kernel #2's function (attention_bwd.cu) with no projection bias:
// per (batch element, head), from qkv [B, L, 3D] and g [B, L, D] in T,
//   logits = (q . k) * scale + mask,   probs = softmax(logits) in fp32,
//   dprobs = g . v,                    dlogits = probs * (dprobs - sum_j dprobs * probs),
//   probs_c = probs -> T,              dlogits_c = (dlogits * scale) -> T,
//   dq = dlogits_c . k,  dk = dlogits_c^T . q,  dv = probs_c^T . g,
// each product summed in fp32 and stored in T into dqkv [B, L, 3D], except
// where an ablation changes one step (#6's `mode`):
//   full, pair     the function above;
//   stacked        the same function, every head's logits and dprobs first,
//                  then one softmax / VJP pass, then every output product;
//   nomax          probs = exp(logits) / sum, no max subtracted (overflows
//                  on large logits, as the TPU kernel does);
//   nosoftmax      probs = logits * 0.01;
//   novjp          dlogits = dprobs;
//   bf16vjp        the VJP chain in T: p = probs_c, d = dprobs -> T,
//                  dlogits = p * (d - (sum_j d * p -> T)), each step
//                  rounded to T, times scale -> T;
//   fewstores      only dq, written into the dk slot; dq's and dv's slots
//                  are left unwritten.
// #8 reads probs [B, H, L, L] in T from device memory instead of
// recomputing them (the mask is not read) and uses their fp32 value in the
// VJP.  #10 runs two heads a block on a (B / bb, H / 2) grid.
//
// What bounds them on an H100: bytes, as kernel #2.  The vision call at
// B=256 bf16 reads 59 MB of qkv and 20 MB of g and writes 59 MB of dqkv
// (41 us at 3.35 TB/s); #8 adds 15.4 MB of probs.  fewstores writes a
// third of dqkv.
//
// Design: kernel #2's two phases for one (rows, head) unit, bwd_unit
// below: A. query-major, k and v in shared memory, a warp carries 4 query
// rows and a lane keys j = lane + 32 t, writing dq; B. key-major, q and g
// in shared memory, dk and dv summed over the queries in order, from the
// [n, n] probs_c and dlogits_c tiles phase A left in shared memory where
// they fit, else recomputed.  A block walks its bb batch elements one unit
// after the other (the TPU grid's batch block): a grid of (B / bb, H), or
// (B / bb, H / 2) with two heads a block for `pair` and #10 (pair walks
// batch elements outer, #10 heads outer, as the two TPU kernels order
// them).  `stacked` is a kernel of its own, one block per bb
// elements: the two [hg, L, L] fp32 stacks of the largest head group hg
// that fits shared memory (8 of 12 heads at vision, all 8 at text), then
// the softmax / VJP pass over the group, then its output products.
// Simple first: no tensor cores, no TMA; fp32 FMAs.

#include "attention_rows.cuh"

namespace {

using namespace attn;

// #6's modes as the wrapper numbers them, then the other kernels' own
enum Mode : int {
  kFull = 0, kStacked = 1, kPair = 2, kNoMax = 3, kNoSoftmax = 4, kNoVjp = 5,
  kBf16Vjp = 6, kFewStores = 7, kSavedP = 8, kHeadPair = 9
};

constexpr int kSlots = 4;         // L <= 128 keys a unit
constexpr int kMaxL = 128;

struct Args {
  int device;
  const void* qkv;
  const float* mask;   // [L, L] fp32 or null
  const void* probs;   // #8: [B, H, L, L] in T
  const void* g;
  void* dqkv;
  int B, L, H, Dh, bb;
  float scale;
  cudaStream_t stream;
};

// k and v (then q and g) [n, ld], the warps' staging rows, the two [n, n]
// tiles when kept, and the three row statistics
size_t unit_floats(int n, int Dh, bool tiles) {
  return (size_t)(2 * n + kWarps * 2 * kRows) * row_stride(Dh) +
         (tiles ? 2 * (size_t)n * tile_stride(n) : 0) + 3 * (size_t)n;
}

// dlogits_c of one entry: p the fp32 probability, u = dprobs, dot the
// row's sum_j dprobs * probs (bf16vjp: of the rounded terms, rounded)
template <typename T, int MODE>
__device__ __forceinline__ float dlogit_c(float p, float u, float dot, float scale) {
  if (MODE == kNoVjp) return ccmh::round_to<T>(u * scale);
  if (MODE == kBf16Vjp) {
    const float p16 = ccmh::round_to<T>(p), d16 = ccmh::round_to<T>(u);
    const float dl = ccmh::round_to<T>(p16 * ccmh::round_to<T>(d16 - dot));
    return ccmh::round_to<T>(dl * ccmh::round_to<T>(scale));   // a T scalar, as in T math
  }
  return ccmh::round_to<T>(p * (u - dot) * scale);
}

// One unit: rows row0 .. row0 + n - 1 of qkv / g / dqkv (n = L), each
// attending to the same n rows, head h.  mask is [n, n] with rows
// mask_ld apart, or null; probs (#8) is the unit's [n, n] block in T.
template <typename T, int MODE, int S>
__device__ void bwd_unit(const T* __restrict__ qkv, const T* __restrict__ g,
                         const float* __restrict__ mask, int mask_ld,
                         const T* __restrict__ probs, T* __restrict__ dqkv, size_t row0,
                         int n, int h, int H, int Dh, float scale, bool tiles, float* smem) {
  const int dp = padded_dim(Dh);
  const int ld = row_stride(Dh);
  const int D = H * Dh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float* big0 = smem;                                   // [n, ld]: k in A, q in B
  float* big1 = smem + n * ld;                          // [n, ld]: v in A, g in B
  float* stage_a = smem + 2 * n * ld + warp * 2 * kRows * ld;   // the warp's rows
  float* stage_b = stage_a + kRows * ld;
  const float* a_rows[kRows] = {stage_a, stage_a + ld, stage_a + 2 * ld, stage_a + 3 * ld};
  const float* b_rows[kRows] = {stage_b, stage_b + ld, stage_b + 2 * ld, stage_b + 3 * ld};
  const int ldt = tile_stride(n);
  float* tile_p = smem + (2 * n + kWarps * 2 * kRows) * ld;     // [n, ldt]: probs_c
  float* tile_s = tile_p + n * ldt;                             // [n, ldt]: dlogits_c
  float* row_max = tiles ? tile_s + n * ldt : tile_p;           // [n] each
  float* row_sum = row_max + n;
  float* row_dot = row_sum + n;

  __syncthreads();   // the block's previous unit is done with shared memory
  // ---- phase A: k | v of head h into shared memory; a warp per row
  for (int pr = warp; pr < 2 * n; pr += kWarps) {
    const int which = pr / n, l = pr - which * n;
    load_row<T>((which ? big1 : big0) + l * ld, qkv, g, row0 + l, 1 + which, h, Dh, D, dp,
                lane);
  }
  __syncthreads();

  for (int i0 = warp * kRows; i0 < n; i0 += kWarps * kRows) {
    __syncwarp();
    // rows past n are clamped to n-1 for reading and never stored
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = min(i0 + r, n - 1);
      if (MODE != kSavedP)
        load_row<T>(stage_a + r * ld, qkv, g, row0 + i, 0, h, Dh, D, dp, lane);
      load_row<T>(stage_b + r * ld, qkv, g, row0 + i, 3, h, Dh, D, dp, lane);
    }
    __syncwarp();
    float s[kRows][S], u[kRows][S];   // q_i . k_j (then probs, then dlogits_c), g_i . v_j
    if (MODE != kSavedP) dot_rows<S>(a_rows, big0, n, dp, ld, lane, s);
    dot_rows<S>(b_rows, big1, n, dp, ld, lane, u);

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = min(i0 + r, n - 1);
      float m = 0.f, sum = 1.f;
      if (MODE == kSavedP) {
#pragma unroll
        for (int t = 0; t < S; ++t) {
          const int j = t * 32 + lane;
          s[r][t] = j < n ? ccmh::to_float(probs[(size_t)i * n + j]) : 0.f;
        }
      } else {
#pragma unroll
        for (int t = 0; t < S; ++t) {
          const int j = t * 32 + lane;
          float logit = -CUDART_INF_F;
          if (j < n) {
            logit = s[r][t] * scale;
            if (mask != nullptr) logit += mask[(size_t)i * mask_ld + j];
          }
          s[r][t] = logit;
        }
        if (MODE == kNoSoftmax) {
#pragma unroll
          for (int t = 0; t < S; ++t) s[r][t] = t * 32 + lane < n ? s[r][t] * 0.01f : 0.f;
        } else {
          if (MODE != kNoMax) {
            m = -CUDART_INF_F;
#pragma unroll
            for (int t = 0; t < S; ++t) m = fmaxf(m, s[r][t]);
            m = ccmh::warp_max(m);
          }
          sum = 0.f;
#pragma unroll
          for (int t = 0; t < S; ++t) {
            const float e = (t * 32 + lane < n) ? expf(s[r][t] - m) : 0.f;
            s[r][t] = e;
            sum += e;
          }
          sum = ccmh::warp_sum(sum);
#pragma unroll
          for (int t = 0; t < S; ++t) s[r][t] = s[r][t] / sum;
        }
      }
      // s[r] holds the fp32 probs, 0 past n
      float dot = 0.f;
      if (MODE == kBf16Vjp) {
#pragma unroll
        for (int t = 0; t < S; ++t)
          dot += ccmh::round_to<T>(ccmh::round_to<T>(u[r][t]) * ccmh::round_to<T>(s[r][t]));
        dot = ccmh::round_to<T>(ccmh::warp_sum(dot));
      } else if (MODE != kNoVjp) {
#pragma unroll
        for (int t = 0; t < S; ++t) dot = fmaf(u[r][t], s[r][t], dot);
        dot = ccmh::warp_sum(dot);
      }
#pragma unroll
      for (int t = 0; t < S; ++t) {
        const float p = s[r][t];
        s[r][t] = dlogit_c<T, MODE>(p, u[r][t], dot, scale);
        const int j = t * 32 + lane;
        if (tiles && i0 + r < n && j < n) {
          tile_p[i * ldt + j] = ccmh::round_to<T>(p);
          tile_s[i * ldt + j] = s[r][t];
        }
      }
      if (lane == 0 && i0 + r < n) {
        row_max[i] = m;
        row_sum[i] = sum;
        row_dot[i] = dot;
      }
    }

    // dq = dlogits_c . k over the keys in order (fewstores: into dk's slot)
    float2 acc[kRows][kDimPairs];
    zero(acc);
    weighted_rows<S>(s, big0, n, dp, ld, lane, acc);
    store_rows<T>(dqkv, acc, row0 + i0, n - i0, 3 * D, (MODE == kFewStores ? D : 0) + h * Dh,
                  Dh, lane);
  }
  if (MODE == kFewStores) return;
  __syncthreads();   // every warp is done with k, v and has written its statistics

  // ---- phase B: q | g of head h into shared memory
  for (int pr = warp; pr < 2 * n; pr += kWarps) {
    const int which = pr / n, l = pr - which * n;
    load_row<T>((which ? big1 : big0) + l * ld, qkv, g, row0 + l, which ? 3 : 0, h, Dh, D, dp,
                lane);
  }
  __syncthreads();

  if (tiles) {
    // the warp's 4 keys j0..j0+3 are 4 adjacent tile columns: one float4
    // broadcast per query brings their weights (columns past n are never
    // stored)
    for (int j0 = warp * kRows; j0 < n; j0 += kWarps * kRows) {
      float2 dk[kRows][kDimPairs], dv[kRows][kDimPairs];
      zero(dk);
      zero(dv);
      for (int i = 0; i < n; ++i) {
        const float4 ws4 = *reinterpret_cast<const float4*>(tile_s + i * ldt + j0);
        const float4 wp4 = *reinterpret_cast<const float4*>(tile_p + i * ldt + j0);
        const float ws[kRows] = {ws4.x, ws4.y, ws4.z, ws4.w};
        const float wp[kRows] = {wp4.x, wp4.y, wp4.z, wp4.w};
#pragma unroll
        for (int c = 0; c < kDimPairs; ++c) {
          const int d = c * 64 + 2 * lane;
          if (d < dp) {
            const float2 qv = *reinterpret_cast<const float2*>(big0 + i * ld + d);
            const float2 gv = *reinterpret_cast<const float2*>(big1 + i * ld + d);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              dk[r][c].x = fmaf(ws[r], qv.x, dk[r][c].x);
              dk[r][c].y = fmaf(ws[r], qv.y, dk[r][c].y);
              dv[r][c].x = fmaf(wp[r], gv.x, dv[r][c].x);
              dv[r][c].y = fmaf(wp[r], gv.y, dv[r][c].y);
            }
          }
        }
      }
      store_rows<T>(dqkv, dk, row0 + j0, n - j0, 3 * D, D + h * Dh, Dh, lane);
      store_rows<T>(dqkv, dv, row0 + j0, n - j0, 3 * D, 2 * D + h * Dh, Dh, lane);
    }
    return;
  }

  for (int j0 = warp * kRows; j0 < n; j0 += kWarps * kRows) {
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = min(j0 + r, n - 1);
      load_row<T>(stage_a + r * ld, qkv, g, row0 + j, 1, h, Dh, D, dp, lane);
      load_row<T>(stage_b + r * ld, qkv, g, row0 + j, 2, h, Dh, D, dp, lane);
    }
    __syncwarp();
    float s[kRows][S], u[kRows][S];   // k_j . q_i and v_j . g_i
    if (MODE != kSavedP) dot_rows<S>(a_rows, big0, n, dp, ld, lane, s);
    dot_rows<S>(b_rows, big1, n, dp, ld, lane, u);

    // lane's queries i = lane + 32 t: probs_c into u, dlogits_c into s, with
    // phase A's row statistics (the same fmaf chains, so the same bits)
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const int i = t * 32 + lane;
      const bool live = i < n;
      const float m = live ? row_max[i] : 0.f;
      const float sum = live ? row_sum[i] : 1.f;
      const float dot = live ? row_dot[i] : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int j = min(j0 + r, n - 1);
        float p = 0.f;
        if (live) {
          if (MODE == kSavedP) {
            p = ccmh::to_float(probs[(size_t)i * n + j]);
          } else {
            float logit = s[r][t] * scale;
            if (mask != nullptr) logit += mask[(size_t)i * mask_ld + j];
            p = MODE == kNoSoftmax ? logit * 0.01f : expf(logit - m) / sum;
          }
        }
        s[r][t] = live ? dlogit_c<T, MODE>(p, u[r][t], dot, scale) : 0.f;
        u[r][t] = ccmh::round_to<T>(p);
      }
    }

    // dk = dlogits_c^T . q and dv = probs_c^T . g over the queries in order
    float2 acc[kRows][kDimPairs];
    zero(acc);
    weighted_rows<S>(s, big0, n, dp, ld, lane, acc);
    store_rows<T>(dqkv, acc, row0 + j0, n - j0, 3 * D, D + h * Dh, Dh, lane);
    zero(acc);
    weighted_rows<S>(u, big1, n, dp, ld, lane, acc);
    store_rows<T>(dqkv, acc, row0 + j0, n - j0, 3 * D, 2 * D + h * Dh, Dh, lane);
  }
}

// #6 (but `stacked`), #8 and #10: the units (batch element, head) of the
// block's bb elements, one after the other
template <typename T, int MODE>
__global__ void __launch_bounds__(kWarps * 32, 3)
bwd_x_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
             const T* __restrict__ probs, const T* __restrict__ g, T* __restrict__ dqkv,
             int B, int L, int H, int Dh, int bb, float scale, int tiles) {
  extern __shared__ __align__(16) float smem[];
  const int b0 = blockIdx.x * bb, b1 = min(B, b0 + bb);
  auto unit = [&](int b, int h) {
    const T* pb = MODE == kSavedP ? probs + ((size_t)b * H + h) * L * L : nullptr;
    bwd_unit<T, MODE, kSlots>(qkv, g, MODE == kSavedP ? nullptr : mask, L, pb, dqkv,
                              (size_t)b * L, L, h, H, Dh, scale, tiles != 0, smem);
  };
  if (MODE == kPair) {
    for (int b = b0; b < b1; ++b)
      for (int hh = 0; hh < 2; ++hh) unit(b, 2 * blockIdx.y + hh);
  } else if (MODE == kHeadPair) {
    for (int hh = 0; hh < 2; ++hh)
      for (int b = b0; b < b1; ++b) unit(b, 2 * blockIdx.y + hh);
  } else {
    for (int b = b0; b < b1; ++b) unit(b, blockIdx.y);
  }
}

// `stacked`: three [L, ld] row buffers, the warps' staging rows and the two
// [hg, L, ldt] stacks
size_t stacked_floats(int L, int Dh, int hg) {
  return (size_t)(3 * L + kWarps * 2 * kRows) * row_stride(Dh) +
         2 * (size_t)hg * L * tile_stride(L);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32, 1)
bwd_stacked_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                   const T* __restrict__ g, T* __restrict__ dqkv, int B, int L, int H, int Dh,
                   int bb, float scale, int hg_max) {
  extern __shared__ __align__(16) float smem[];
  const int dp = padded_dim(Dh), ld = row_stride(Dh), ldt = tile_stride(L);
  const int D = H * Dh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* buf0 = smem;              // k (1), then q (3)
  float* buf1 = smem + L * ld;     // v (1), then g (3)
  float* buf2 = smem + 2 * L * ld; // k (3)
  float* stage_a = smem + 3 * L * ld + warp * 2 * kRows * ld;
  float* stage_b = stage_a + kRows * ld;
  const float* a_rows[kRows] = {stage_a, stage_a + ld, stage_a + 2 * ld, stage_a + 3 * ld};
  const float* b_rows[kRows] = {stage_b, stage_b + ld, stage_b + 2 * ld, stage_b + 3 * ld};
  float* stack_p = smem + (3 * L + kWarps * 2 * kRows) * ld;   // logits, then probs_c
  float* stack_s = stack_p + (size_t)hg_max * L * ldt;         // dprobs, then dlogits_c

  const int b0 = blockIdx.x * bb, b1 = min(B, b0 + bb);
  for (int b = b0; b < b1; ++b) {
    const size_t row0 = (size_t)b * L;
    for (int h0 = 0; h0 < H; h0 += hg_max) {
      const int hn = min(hg_max, H - h0);
      // 1. the group's logits and dprobs, head by head
      for (int hg = 0; hg < hn; ++hg) {
        const int h = h0 + hg;
        __syncthreads();
        for (int pr = warp; pr < 2 * L; pr += kWarps) {
          const int which = pr / L, l = pr - which * L;
          load_row<T>((which ? buf1 : buf0) + l * ld, qkv, g, row0 + l, 1 + which, h, Dh, D,
                      dp, lane);
        }
        __syncthreads();
        float* lp = stack_p + (size_t)hg * L * ldt;
        float* ls = stack_s + (size_t)hg * L * ldt;
        for (int i0 = warp * kRows; i0 < L; i0 += kWarps * kRows) {
          __syncwarp();
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int i = min(i0 + r, L - 1);
            load_row<T>(stage_a + r * ld, qkv, g, row0 + i, 0, h, Dh, D, dp, lane);
            load_row<T>(stage_b + r * ld, qkv, g, row0 + i, 3, h, Dh, D, dp, lane);
          }
          __syncwarp();
          float s[kRows][kSlots], u[kRows][kSlots];
          dot_rows<kSlots>(a_rows, buf0, L, dp, ld, lane, s);
          dot_rows<kSlots>(b_rows, buf1, L, dp, ld, lane, u);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (i0 + r >= L) break;   // warp-uniform
            const int i = i0 + r;
#pragma unroll
            for (int t = 0; t < kSlots; ++t) {
              const int j = t * 32 + lane;
              if (j < L) {
                float logit = s[r][t] * scale;
                if (mask != nullptr) logit += mask[i * L + j];
                lp[i * ldt + j] = logit;
                ls[i * ldt + j] = u[r][t];
              }
            }
          }
        }
      }
      __syncthreads();
      // 2. one softmax and softmax-VJP pass over the group: a warp per (head, row)
      for (int hr = warp; hr < hn * L; hr += kWarps) {
        float* lp = stack_p + (size_t)hr * ldt;
        float* ls = stack_s + (size_t)hr * ldt;
        float x[kSlots];
        float m = -CUDART_INF_F;
#pragma unroll
        for (int t = 0; t < kSlots; ++t) {
          const int j = t * 32 + lane;
          x[t] = j < L ? lp[j] : -CUDART_INF_F;
          m = fmaxf(m, x[t]);
        }
        m = ccmh::warp_max(m);
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < kSlots; ++t) {
          x[t] = (t * 32 + lane < L) ? expf(x[t] - m) : 0.f;
          sum += x[t];
        }
        sum = ccmh::warp_sum(sum);
        float dot = 0.f;
#pragma unroll
        for (int t = 0; t < kSlots; ++t) {
          const int j = t * 32 + lane;
          x[t] = x[t] / sum;
          dot = fmaf(j < L ? ls[j] : 0.f, x[t], dot);
        }
        dot = ccmh::warp_sum(dot);
#pragma unroll
        for (int t = 0; t < kSlots; ++t) {
          const int j = t * 32 + lane;
          if (j < L) {
            const float u = ls[j];
            lp[j] = ccmh::round_to<T>(x[t]);
            ls[j] = ccmh::round_to<T>(x[t] * (u - dot) * scale);
          }
        }
      }
      // 3. the group's output products, head by head
      for (int hg = 0; hg < hn; ++hg) {
        const int h = h0 + hg;
        __syncthreads();
        for (int pr = warp; pr < 3 * L; pr += kWarps) {
          const int part = pr / L, l = pr - part * L;   // q, g, k
          load_row<T>((part == 0 ? buf0 : part == 1 ? buf1 : buf2) + l * ld, qkv, g, row0 + l,
                      part == 0 ? 0 : part == 1 ? 3 : 1, h, Dh, D, dp, lane);
        }
        __syncthreads();
        const float* lp = stack_p + (size_t)hg * L * ldt;
        const float* ls = stack_s + (size_t)hg * L * ldt;
        // dq = dlogits_c . k, query-major
        for (int i0 = warp * kRows; i0 < L; i0 += kWarps * kRows) {
          float w[kRows][kSlots];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int t = 0; t < kSlots; ++t) {
              const int j = t * 32 + lane;
              w[r][t] = j < L ? ls[min(i0 + r, L - 1) * ldt + j] : 0.f;
            }
          float2 acc[kRows][kDimPairs];
          zero(acc);
          weighted_rows<kSlots>(w, buf2, L, dp, ld, lane, acc);
          store_rows<T>(dqkv, acc, row0 + i0, L - i0, 3 * D, h * Dh, Dh, lane);
        }
        // dk = dlogits_c^T . q and dv = probs_c^T . g, key-major
        for (int j0 = warp * kRows; j0 < L; j0 += kWarps * kRows) {
          float2 dk[kRows][kDimPairs], dv[kRows][kDimPairs];
          zero(dk);
          zero(dv);
          for (int i = 0; i < L; ++i) {
            const float4 ws4 = *reinterpret_cast<const float4*>(ls + i * ldt + j0);
            const float4 wp4 = *reinterpret_cast<const float4*>(lp + i * ldt + j0);
            const float ws[kRows] = {ws4.x, ws4.y, ws4.z, ws4.w};
            const float wp[kRows] = {wp4.x, wp4.y, wp4.z, wp4.w};
#pragma unroll
            for (int c = 0; c < kDimPairs; ++c) {
              const int d = c * 64 + 2 * lane;
              if (d < dp) {
                const float2 qv = *reinterpret_cast<const float2*>(buf0 + i * ld + d);
                const float2 gv = *reinterpret_cast<const float2*>(buf1 + i * ld + d);
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
                  dk[r][c].x = fmaf(ws[r], qv.x, dk[r][c].x);
                  dk[r][c].y = fmaf(ws[r], qv.y, dk[r][c].y);
                  dv[r][c].x = fmaf(wp[r], gv.x, dv[r][c].x);
                  dv[r][c].y = fmaf(wp[r], gv.y, dv[r][c].y);
                }
              }
            }
          }
          store_rows<T>(dqkv, dk, row0 + j0, L - j0, 3 * D, D + h * Dh, Dh, lane);
          store_rows<T>(dqkv, dv, row0 + j0, L - j0, 3 * D, 2 * D + h * Dh, Dh, lane);
        }
      }
      __syncthreads();   // the next group overwrites the stacks
    }
  }
}

unsigned blocks(const Args& a) { return (unsigned)((a.B + a.bb - 1) / a.bb); }

template <typename T, int MODE>
cudaError_t launch_x(const Args& a) {
  const int optin = smem_optin(a.device);
  // keep the [L, L] tiles of phase A for phase B where they fit
  const bool tiles = MODE != kFewStores && unit_floats(a.L, a.Dh, true) * sizeof(float) <=
                                               (size_t)optin;
  const size_t smem = unit_floats(a.L, a.Dh, tiles) * sizeof(float);
  cudaError_t err = set_smem(bwd_x_kernel<T, MODE>, smem, optin);
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks(a), (MODE == kPair || MODE == kHeadPair) ? a.H / 2 : a.H);
  bwd_x_kernel<T, MODE><<<grid, kWarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.qkv), a.mask, static_cast<const T*>(a.probs),
      static_cast<const T*>(a.g), static_cast<T*>(a.dqkv), a.B, a.L, a.H, a.Dh, a.bb, a.scale,
      tiles ? 1 : 0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stacked(const Args& a) {
  const int optin = smem_optin(a.device);
  int hg = a.H;   // the largest head group whose two stacks fit
  while (hg > 0 && stacked_floats(a.L, a.Dh, hg) * sizeof(float) > (size_t)optin) --hg;
  if (hg == 0) return cudaErrorInvalidValue;
  const size_t smem = stacked_floats(a.L, a.Dh, hg) * sizeof(float);
  cudaError_t err = set_smem(bwd_stacked_kernel<T>, smem, optin);
  if (err != cudaSuccess) return err;
  bwd_stacked_kernel<T><<<blocks(a), kWarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.qkv), a.mask, static_cast<const T*>(a.g),
      static_cast<T*>(a.dqkv), a.B, a.L, a.H, a.Dh, a.bb, a.scale, hg);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mode(int mode, const Args& a) {
  switch (mode) {
    case kFull: return launch_x<T, kFull>(a);
    case kStacked: return launch_stacked<T>(a);
    case kPair: return launch_x<T, kPair>(a);
    case kNoMax: return launch_x<T, kNoMax>(a);
    case kNoSoftmax: return launch_x<T, kNoSoftmax>(a);
    case kNoVjp: return launch_x<T, kNoVjp>(a);
    case kBf16Vjp: return launch_x<T, kBf16Vjp>(a);
    case kFewStores: return launch_x<T, kFewStores>(a);
    case kSavedP: return launch_x<T, kSavedP>(a);
    case kHeadPair: return launch_x<T, kHeadPair>(a);
    default: return cudaErrorInvalidValue;
  }
}

int run(int mode, int dtype, const Args& a) {
  const bool pairs = mode == kPair || mode == kHeadPair;
  if (a.B < 1 || a.bb < 1 || a.H < 1 || a.H > 65535 || (pairs && a.H % 2) || a.L < 1 ||
      a.Dh < 1 || a.Dh > kMaxDh || a.L > kMaxL)
    return (int)cudaErrorInvalidValue;
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: name the card of the tensors
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  switch (dtype) {
    case ccmh::kFloat32: return (int)launch_mode<float>(mode, a);
    case ccmh::kBFloat16: return (int)launch_mode<__nv_bfloat16>(mode, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv and dqkv [B, L, 3*H*Dh], g [B, L, H*Dh], all contiguous in `dtype`
// (0 fp32, 1 bf16); mask [L, L] fp32 or null; scale is 1/sqrt(Dh) rounded
// to fp32 by the caller; a block walks bb batch elements.  Each entry
// launches on `stream` of card `device` and returns cudaGetLastError()
// (0 = launched).

// #6; mode 0 full, 1 stacked, 2 pair (H even), 3 nomax, 4 nosoftmax,
// 5 novjp, 6 bf16vjp, 7 fewstores
extern "C" int ccmh_attention_bwd_x(int device, const void* qkv, const float* mask,
                                    const void* g, void* dqkv, int B, int L, int H, int Dh,
                                    int bb, int mode, float scale, int dtype, void* stream) {
  if (mode < kFull || mode > kFewStores) return (int)cudaErrorInvalidValue;
  return run(mode, dtype, Args{device, qkv, mask, nullptr, g, dqkv, B, L, H, Dh, bb, scale,
                               static_cast<cudaStream_t>(stream)});
}

// #8: probs [B, H, L, L] in `dtype` in place of a mask
extern "C" int ccmh_attention_bwd_savedp(int device, const void* qkv, const void* probs,
                                         const void* g, void* dqkv, int B, int L, int H,
                                         int Dh, int bb, float scale, int dtype, void* stream) {
  return run(kSavedP, dtype, Args{device, qkv, nullptr, probs, g, dqkv, B, L, H, Dh, bb, scale,
                                  static_cast<cudaStream_t>(stream)});
}

// #10: H even
extern "C" int ccmh_attention_bwd_headpair(int device, const void* qkv, const float* mask,
                                           const void* g, void* dqkv, int B, int L, int H,
                                           int Dh, int bb, float scale, int dtype,
                                           void* stream) {
  return run(kHeadPair, dtype, Args{device, qkv, mask, nullptr, g, dqkv, B, L, H, Dh, bb,
                                    scale, static_cast<cudaStream_t>(stream)});
}
