// The attention-backward ablation kernels #6 (eight modes) and #10 of
// tools/bench_attn_bwd.py, on the tensor cores.
//
// Replaces: tools/bench_attn_bwd.py `backward_x` (:202) / `_bwd_kernel_x`
// (:43) and `backward_headpair` (:470) / `_bwd_kernel_headpair` (:435),
// Pallas TPU kernels.  Each is kernel #2's function (attention_bwd.cu) with
// no projection bias: per (batch element, head), from qkv [B, L, 3D] and
// g [B, L, D] in T,
//   logits = (q . k) * scale + mask,   probs = softmax(logits) in fp32,
//   dprobs = g . v,                    dlogits = probs * (dprobs - sum_j dprobs * probs),
//   probs_c = probs -> T,              dlogits_c = (dlogits * scale) -> T,
//   dq = dlogits_c . k,  dk = dlogits_c^T . q,  dv = probs_c^T . g,
// each product summed in fp32 and stored in T into dqkv [B, L, 3D], except
// where an ablation mode of #6 changes one step:
//   full, pair, stacked, headpair (#10)  the function above;
//   nomax      probs = exp(logits) / sum, no max subtracted;
//   nosoftmax  probs = logits * 0.01;
//   novjp      dlogits = dprobs;
//   bf16vjp    the VJP chain in T: p = probs_c, d = dprobs -> T,
//              dlogits = p * (d - (sum_j d * p -> T)), each step rounded to
//              T, times scale -> T;
//   fewstores  only dq, written into the dk slot; dq's and dv's slots are
//              left unwritten.
//
// What bounds it on an H100: bytes, as kernel #2.  At B=256 the vision call
// (L=50, H=12, Dh=64) reads 59 MB of qkv and 20 MB of g and writes 59 MB of
// dqkv in bf16 (41 us at 3.35 TB/s; fp32 82 us); fewstores writes a third
// of dqkv.  The five products, 10 B H L^2 Dh = 4.9 GFLOP, take 5 us at the
// bf16 tensor-core peak and 30 us as 3xTF32 at 495/3 TFLOP/s.
//
// Design: kernel #2's tile design, with the bench's schedules.  A warp
// group of pad16(L) / 16 warps works on one (batch element, head) unit:
// q, k, v and g in four [pad16(L)][ld] tiles of shared memory in T (16-byte
// cp.async where aligned, scalar loads otherwise), and
//   1. query-major, a warp per 16 queries: S = q k^T and dP = g v^T in
//      registers on mma.sync (bf16 m16n8k16; fp32 as 3xTF32 m16n8k8 with
//      a split that rounds toward zero, no conversion instruction), the
//      mode's probabilities and VJP in registers, probs_c and dlogits_c
//      into two [L, L] tiles in T, dq = dS_c k from the registers;
//   2. key-major, a warp per 16 keys: dv = probs_c^T g and dk = dS_c^T q
//      from the tiles (ldmatrix.trans in bf16).
// Outputs go from the accumulators to device memory in pairs of columns.
// A block walks its bb batch elements, as the TPU grid's batch block: a
// grid of (B / bb, H) blocks of one unit at a time; `pair` and #10 take a
// head pair a block, (B / bb, H / 2), elements outer for `pair`, heads
// outer for #10, or (`groups` = 2) both heads at once as two warp groups;
// `stacked` takes one head a block, (B / bb, H), and works on a stack of
// E elements at once as warp groups, as the TPU kernel stacks its batch
// block's logits (E grows with bb, so that a block's steps do not), in
// three phases with block barriers between them: every unit's S and dP
// products, then the softmax / VJP over the stack, then the output
// products.  Otherwise the warp groups of
// a block never meet: each loads and reads its own unit's tiles and waits
// on its own named barrier.  The next unit's k and v (dead after dq) are
// copied during phase 2, its q and g after it (1-3% faster than copying
// all four after phase 2).  fp32 where the four operand tiles and the two
// [L, L] tiles do not fit (from L = 113 at Dh = 64, from L = 81 at
// Dh = 128) runs the recompute path: two operand tiles at a time, the other two
// operands' fragments read from device memory, the row statistics kept
// from phase A and the probabilities recomputed key-major in phase B.
// The plan (path, warp groups, shared-memory bytes) is made in
// Python (ccmh_torch/ops/attention_variants.py `_bwd_x_plan`) and checked
// here: the entry refuses a plan it does not compute the same way.
//
// Shared memory, a group: 4 pad16(L) ld + 2 pad16(L) ldt elements of T
// (ld = pad16(Dh) + 8 | 4, ldt = pad16(L) + 8 | 4, bf16 | fp32; fewstores
// keeps no [L, L] tiles): vision Dh=64 55,296 bytes bf16 / 104,448 fp32,
// text 23,552 / 44,032.  Recompute: 2 pad16(L) tile_ld(Dh) + 3 pad16(L)
// floats, 136,704 bytes at L = Dh = 128.

#include "bwd_tiles.cuh"

namespace {

using namespace ccmh::mma;
using namespace ccmh::bwd;

constexpr int kMaxL = 128;
constexpr int kMaxDh = 128;
constexpr int kMaxGroups = 4;

// #6's modes as the wrapper numbers them, then #10
enum Mode : int {
  kFull = 0, kStacked = 1, kPair = 2, kNoMax = 3, kNoSoftmax = 4, kNoVjp = 5,
  kBf16Vjp = 6, kFewStores = 7, kHeadPair = 8
};
// the plan's path (ccmh_torch/ops/attention_variants.py BWD_X_PATHS)
enum Path : int { kTiles = 0, kRecompute = 1 };

// dlogits_c of one entry: p the fp32 probability, u = dprobs, dot the row's
// sum_j dprobs * probs (bf16vjp: of the rounded terms, rounded)
template <typename T, int MATH>
__device__ __forceinline__ float dlogit_c(float p, float u, float dot, float scale) {
  if (MATH == kNoVjp) return ccmh::round_to<T>(u * scale);
  if (MATH == kBf16Vjp) {
    const float p16 = ccmh::round_to<T>(p), d16 = ccmh::round_to<T>(u);
    const float dl = ccmh::round_to<T>(p16 * ccmh::round_to<T>(d16 - dot));
    return ccmh::round_to<T>(dl * ccmh::round_to<T>(scale));   // a T scalar, as in T math
  }
  return ccmh::round_to<T>(p * (u - dot) * scale);
}

// The mode's probabilities of a warp's accumulator tiles s[j] (keys 8 j ..)
// of queries m0 + g and m0 + g + 8, in place, from q . k: the softmax
// (mma_tiles.cuh softmax_tile), exp(logit) / sum (nomax), or logit * 0.01
// (nosoftmax; 0 for a padded key).  The row max (0 where none is taken)
// and sum (1 in nosoftmax) go to mx, sum.
template <int MATH, int N>
__device__ __forceinline__ void probs_tile(float (&s)[N][4], int n_tiles, float scale,
                                           const float* __restrict__ mask, int m0, int L,
                                           int lane, float (&mx)[2], float (&sum)[2]) {
  if constexpr (MATH == kNoMax || MATH == kNoSoftmax) {
    const int g = lane >> 2, t = lane & 3;
    const int i0 = m0 + g, i1 = i0 + 8;
    mx[0] = mx[1] = 0.f;
    sum[0] = sum[1] = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j < n_tiles) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          const float x = logit(s[j][e], scale, mask, e < 2 ? i0 : i1, c, L);
          if (MATH == kNoSoftmax) {
            s[j][e] = c < L ? x * 0.01f : 0.f;
          } else {
            s[j][e] = expf(x);
            sum[e >> 1] += s[j][e];
          }
        }
      }
    }
    if (MATH == kNoSoftmax) {
      sum[0] = sum[1] = 1.f;
      return;
    }
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);
    const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= inv[e >> 1];
  } else {
    softmax_tile(s, n_tiles, scale, mask, m0, L, lane, mx, sum);
  }
}

// The mode's VJP on a warp's tiles, in place: s holds probs and becomes
// probs_c (0 for padded queries), dp holds dprobs and becomes dlogits_c;
// `dot` returns the rows' sum_j dprobs * probs (0 in novjp).
template <typename T, int MATH, int N>
__device__ __forceinline__ void vjp_tile(float (&s)[N][4], float (&dp)[N][4], int n_tiles,
                                         float scale, int m0, int L, int lane,
                                         float (&dot)[2]) {
  const int g = lane >> 2;
  dot[0] = dot[1] = 0.f;
  if (MATH != kNoVjp) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j < n_tiles) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (MATH == kBf16Vjp)
            dot[e >> 1] += ccmh::round_to<T>(ccmh::round_to<T>(dp[j][e]) *
                                             ccmh::round_to<T>(s[j][e]));
          else
            dot[e >> 1] = fmaf(dp[j][e], s[j][e], dot[e >> 1]);
        }
      }
    }
    dot[0] = quad_sum(dot[0]);
    dot[1] = quad_sum(dot[1]);
    if (MATH == kBf16Vjp) {
      dot[0] = ccmh::round_to<T>(dot[0]);
      dot[1] = ccmh::round_to<T>(dot[1]);
    }
  }
  const bool live0 = m0 + g < L, live1 = m0 + g + 8 < L;
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = s[j][e];
      dp[j][e] = dlogit_c<T, MATH>(p, dp[j][e], dot[e >> 1], scale);
      s[j][e] = (e < 2 ? live0 : live1) ? ccmh::round_to<T>(p) : 0.f;
    }
  }
}

// the threads of warp group gi meet (barrier 1 + gi; 0 is __syncthreads')
__device__ __forceinline__ void group_sync(int gi, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + gi), "r"(threads) : "memory");
}

struct Args {
  int B, L, H, Dh, bb;
  float scale;
  int groups;        // warp groups a block: units worked on at once
  int nh;            // heads a block covers: 2 for pair and #10, else 1
  int heads_outer;   // #10 one unit at a time: a head's elements, then the other's
  int stacked;       // block barriers between stacked's three phases
  int vec;           // 16-byte loads, pairs of columns stored
};

// The units of a block, (element, head), in its walk order; group gi takes
// unit s * groups + gi at step s.  A unit past the walk is computed on the
// last one and not stored.
struct Walker {
  int b0, h0, n_el, nh, ng, heads_outer;
  __device__ int steps() const { return (n_el * nh + ng - 1) / ng; }
  __device__ bool unit(int s, int gi, int& b, int& h) const {
    const int n = n_el * nh;
    int u = s * ng + gi;
    bool live = u < n;
    if (!live) u = n - 1;
    int e, k;
    if (heads_outer) {
      k = u / n_el;
      e = u - k * n_el;
    } else {
      e = u / nh;
      k = u - e * nh;
    }
    b = b0 + e;
    h = h0 + k;
    return live;
  }
};

template <typename T>
size_t tiles_smem(int L, int Dh, int groups, bool tiles) {
  const size_t Lp = pad16(L);
  return groups * (4 * Lp * tile_ld<T>(Dh) + (tiles ? 2 * Lp * tile_ld<T>(L) : 0)) * sizeof(T);
}

size_t recompute_smem(int L, int Dh) {
  const int Lp = pad16(L);
  return (2 * (size_t)Lp * tile_ld<float>(Dh) + 3 * (size_t)Lp) * sizeof(float);
}

// ---- the tile path: a block of `groups` warp groups, GMAX at most
template <typename T, int MATH, int LMAX, int DMAX, int GMAX>
__global__ void __launch_bounds__(GMAX * LMAX / 16 * 32)
tiles_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
             const T* __restrict__ gin, T* __restrict__ dqkv, Args a) {
  using F = FragTz<T>;
  constexpr bool TILES = MATH != kFewStores;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = a.L, H = a.H, Dh = a.Dh;
  const int Lp = pad16(L), ld = tile_ld<T>(Dh), ldt = tile_ld<T>(L);
  const int D = H * Dh, D3 = 3 * D;
  const int wpg = Lp / 16;   // warps a group
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = warp / wpg, m0 = (warp - gi * wpg) * 16;
  const size_t unit = 4 * (size_t)Lp * ld + (TILES ? 2 * (size_t)Lp * ldt : 0);
  T* const base = reinterpret_cast<T*>(smem_raw);
  T* const sq = base + gi * unit;
  T* const sk = sq + Lp * ld;
  T* const sv = sk + Lp * ld;
  T* const sg = sv + Lp * ld;
  T* const tp = sg + Lp * ld;     // probs_c [query][key]
  T* const ts = tp + Lp * ldt;    // dS_c [query][key]
  const Walker w{(int)blockIdx.x * a.bb, (int)blockIdx.y * a.nh, a.bb, a.nh, a.groups,
                 a.heads_outer};
  const int n_steps = w.steps();
  const int n_kt = Lp / 16, n_dk = pad16(Dh) / 16;
  const bool vec = a.vec != 0;

  // each warp group loads and reads only its own unit's tiles, so it meets
  // only itself (stacked's phase barriers aside) and the groups drift
  const int gthreads = wpg * 32, gtid = threadIdx.x - gi * gthreads;
  auto sync = [&]() {
    if (a.groups == 1)
      __syncthreads();
    else
      group_sync(gi, gthreads);
  };
  // part p of the group's unit at step s: q, k, v (p = 0, 1, 2), g (3)
  auto load = [&](int s, int parts) {
    int b, h;
    w.unit(s, gi, b, h);
    const T* src = qkv + (size_t)b * L * D3 + h * Dh;
    for (int p = 0; p < 4; ++p)
      if (parts >> p & 1)
        copy_rows<T>(sq + p * Lp * ld, ld, p < 3 ? src + p * D : gin + (size_t)b * L * D + h * Dh,
                     p < 3 ? D3 : D, L, Dh, vec, gtid, gthreads);
  };
  // the padding of every operand tile, once: the loads write rows < L and
  // columns < Dh only
  for (int t = 0; t < 4 * a.groups; ++t)
    zero_pad<T>(base + (t >> 2) * unit + (t & 3) * Lp * ld, ld, L, Dh);
  load(0, 0xF);
  if (vec) cp_async_wait_all();
  __syncthreads();
  // parts loaded once phase 1 is done (k and v, or fewstores all four) and after phase 2
  constexpr int early = TILES ? 0x6 : 0xF, late = 0xF & ~early;

  for (int s = 0; s < n_steps; ++s) {
    int b, h;
    const bool live = w.unit(s, gi, b, h);
    T* out = dqkv + (size_t)b * L * D3 + h * Dh;
    // ---- phase 1: the warp's 16 queries
    {
      float sc[LMAX / 8][4], dp[LMAX / 8][4];
      zero(sc);
      rows_by_rows<T>(sc, sq, sk, ld, m0, n_kt, n_dk, lane);
      zero(dp);
      rows_by_rows<T>(dp, sg, sv, ld, m0, n_kt, n_dk, lane);
      if (a.stacked) __syncthreads();   // every head's products, then the stack's softmax / VJP
      float mx[2], sum[2], dot[2];
      probs_tile<MATH>(sc, (L + 7) / 8, a.scale, mask, m0, L, lane, mx, sum);
      vjp_tile<T, MATH>(sc, dp, (L + 7) / 8, a.scale, m0, L, lane, dot);
      if constexpr (TILES) {
        stage_acc<T>(tp + m0 * ldt, ldt, sc, 2 * n_kt, lane);
        stage_acc<T>(ts + m0 * ldt, ldt, dp, 2 * n_kt, lane);
      }
      if (a.stacked) __syncthreads();   // then the output products
      float dq[DMAX / 8][4];
      zero(dq);
      times_rows<T, LMAX / 16>(dq, [&](int kb) { return F::a_acc(dp[2 * kb], dp[2 * kb + 1]); },
                               sk, ld, n_kt, n_dk, lane);
      if (live)
        store_acc<T>(out + (MATH == kFewStores ? D : 0), D3, dq, 2 * n_dk, m0, L, Dh, vec, lane);
    }
    sync();   // k and v are read no more; the tiles are complete
    const bool next = s + 1 < n_steps;
    if (next) load(s + 1, early);
    if constexpr (TILES) {
      // ---- phase 2: the warp's 16 keys (m0 .. m0 + 15)
      float acc[DMAX / 8][4];
      zero(acc);
      times_rows<T, LMAX / 16>(acc, [&](int kb) { return F::a_cols(tp, ldt, m0, kb * 16, lane); },
                               sg, ld, n_kt, n_dk, lane);
      if (live) store_acc<T>(out + 2 * D, D3, acc, 2 * n_dk, m0, L, Dh, vec, lane);
      zero(acc);
      times_rows<T, LMAX / 16>(acc, [&](int kb) { return F::a_cols(ts, ldt, m0, kb * 16, lane); },
                               sq, ld, n_kt, n_dk, lane);
      if (live) store_acc<T>(out + D, D3, acc, 2 * n_dk, m0, L, Dh, vec, lane);
      sync();   // q, g and the tiles are read no more
    }
    if (next) {
      if (late) load(s + 1, late);
      if (vec) cp_async_wait_all();
      sync();
    }
  }
}

// ---- the recompute path (fp32 only, one unit at a time)

template <int MATH, int LMAX, int DMAX>
__global__ void __launch_bounds__(LMAX / 16 * 32)
recompute_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                 const float* __restrict__ gin, float* __restrict__ dqkv, Args a) {
  using F = FragTz<float>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = a.L, H = a.H, Dh = a.Dh;
  const int Lp = pad16(L), ld = tile_ld<float>(Dh);
  const int D = H * Dh, D3 = 3 * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, m0 = warp * 16;
  float* x0 = reinterpret_cast<float*>(smem_raw);   // k in A, q in B
  float* x1 = x0 + Lp * ld;                         // v in A, g in B
  float* row_max = x1 + Lp * ld;
  float* row_sum = row_max + Lp;
  float* row_dot = row_sum + Lp;
  const Walker w{(int)blockIdx.x * a.bb, (int)blockIdx.y * a.nh, a.bb, a.nh, 1,
                 a.heads_outer};
  const int n_steps = w.steps();
  const int n_kt = Lp / 16, n_dk = pad16(Dh) / 16;
  const bool vec = a.vec != 0;
  zero_pad<float>(x0, ld, L, Dh);
  zero_pad<float>(x1, ld, L, Dh);

  for (int s = 0; s < n_steps; ++s) {
    int b, h;
    const bool live = w.unit(s, 0, b, h);
    const float* base = qkv + (size_t)b * L * D3 + h * Dh;
    const float* gbase = gin + (size_t)b * L * D + h * Dh;
    float* out = dqkv + (size_t)b * L * D3 + h * Dh;

    // ---- phase A: k | v in shared memory; the warp's 16 queries
    copy_rows<float>(x0, ld, base + D, D3, L, Dh, vec, threadIdx.x, blockDim.x);
    copy_rows<float>(x1, ld, base + 2 * D, D3, L, Dh, vec, threadIdx.x, blockDim.x);
    if (vec) cp_async_wait_all();
    __syncthreads();
    {
      float sc[LMAX / 8][4], dp[LMAX / 8][4];
      zero(sc);
      zero(dp);
#pragma unroll 1
      for (int kb = 0; kb < n_dk; ++kb) {
        const F::A aq = a_rows_gmem(base, D3, m0, kb * 16, L, Dh, lane);
        const F::A ag = a_rows_gmem(gbase, D, m0, kb * 16, L, Dh, lane);
#pragma unroll
        for (int jp = 0; jp < LMAX / 16; ++jp) {
          if (jp < n_kt) {
            F::B b0, b1;
            F::b_rows(b0, b1, x0, ld, jp * 16, kb * 16, lane);
            F::mma(sc[2 * jp], aq, b0);
            F::mma(sc[2 * jp + 1], aq, b1);
            F::b_rows(b0, b1, x1, ld, jp * 16, kb * 16, lane);
            F::mma(dp[2 * jp], ag, b0);
            F::mma(dp[2 * jp + 1], ag, b1);
          }
        }
      }
      float mx[2], sum[2], dot[2];
      probs_tile<MATH>(sc, (L + 7) / 8, a.scale, mask, m0, L, lane, mx, sum);
      vjp_tile<float, MATH>(sc, dp, (L + 7) / 8, a.scale, m0, L, lane, dot);
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
      times_rows<float, LMAX / 16>(
          dq, [&](int kb) { return F::a_acc(dp[2 * kb], dp[2 * kb + 1]); }, x0, ld, n_kt, n_dk,
          lane);
      if (live)
        store_acc<float>(out + (MATH == kFewStores ? D : 0), D3, dq, 2 * n_dk, m0, L, Dh, vec,
                         lane);
    }
    __syncthreads();   // k and v are read no more; the row statistics are in
    if (MATH == kFewStores) continue;

    // ---- phase B: q | g in shared memory; the warp's 16 keys, S^T and dP^T
    // recomputed against each 16-query tile
    copy_rows<float>(x0, ld, base, D3, L, Dh, vec, threadIdx.x, blockDim.x);
    copy_rows<float>(x1, ld, gbase, D, L, Dh, vec, threadIdx.x, blockDim.x);
    if (vec) cp_async_wait_all();
    __syncthreads();
    float dv[DMAX / 8][4], dk[DMAX / 8][4];
    zero(dv);
    zero(dk);
#pragma unroll 1
    for (int q0 = 0; q0 < Lp; q0 += 16) {
      float st[2][4], dpt[2][4];
      zero(st);
      zero(dpt);
#pragma unroll 1
      for (int kb = 0; kb < n_dk; ++kb) {
        const F::A ak = a_rows_gmem(base + D, D3, m0, kb * 16, L, Dh, lane);
        const F::A avv = a_rows_gmem(base + 2 * D, D3, m0, kb * 16, L, Dh, lane);
        F::B b0, b1;
        F::b_rows(b0, b1, x0, ld, q0, kb * 16, lane);
        F::mma(st[0], ak, b0);
        F::mma(st[1], ak, b1);
        F::b_rows(b0, b1, x1, ld, q0, kb * 16, lane);
        F::mma(dpt[0], avv, b0);
        F::mma(dpt[1], avv, b1);
      }
      // the weights of keys m0 + g (+8) and queries q0 + 8 jj + 2 t (+1)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = m0 + g + 8 * (e >> 1), i = q0 + 8 * jj + 2 * t + (e & 1);
          float p = 0.f, wt = 0.f;
          if (i < L && key < L) {
            const float x = logit(st[jj][e], a.scale, mask, i, key, L);
            p = MATH == kNoSoftmax ? x * 0.01f : expf(x - row_max[i]) * (1.f / row_sum[i]);
            wt = dlogit_c<float, MATH>(p, dpt[jj][e], row_dot[i], a.scale);
          }
          st[jj][e] = p;
          dpt[jj][e] = wt;
        }
      }
      times_rows_block<float>(dv, F::a_acc(st[0], st[1]), x1, ld, q0 / 16, n_dk, lane);
      times_rows_block<float>(dk, F::a_acc(dpt[0], dpt[1]), x0, ld, q0 / 16, n_dk, lane);
    }
    if (live) {
      store_acc<float>(out + 2 * D, D3, dv, 2 * n_dk, m0, L, Dh, vec, lane);
      store_acc<float>(out + D, D3, dk, 2 * n_dk, m0, L, Dh, vec, lane);
    }
    __syncthreads();   // q and g are read no more
  }
}

// ---- launches

template <typename T, int MATH>
cudaError_t launch_math(const void* qkv, const float* mask, const void* g, void* dqkv,
                        const Args& a, int path, size_t smem, cudaStream_t stream) {
  const T* q = static_cast<const T*>(qkv);
  const T* gg = static_cast<const T*>(g);
  T* out = static_cast<T*>(dqkv);
  auto go = [&](auto kernel) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.B / a.bb, a.H / a.nh);
    kernel<<<grid, a.groups * pad16(a.L) / 16 * 32, smem, stream>>>(q, mask, gg, out, a);
    return cudaGetLastError();
  };
  if (path == kRecompute) {
    if constexpr (sizeof(T) == 4) return go(recompute_kernel<MATH, 128, 128>);
    return cudaErrorInvalidValue;
  }
  if (pad16(a.L) > 64 || pad16(a.Dh) > 64) return go(tiles_kernel<T, MATH, 128, 128, 1>);
  if (a.groups == 1) return go(tiles_kernel<T, MATH, 64, 64, 1>);
  if constexpr (MATH == kFull) {
    if (a.groups == 2) return go(tiles_kernel<T, kFull, 64, 64, 2>);
    return go(tiles_kernel<T, kFull, 64, 64, kMaxGroups>);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(int device, int mode, const void* qkv, const float* mask, const void* g,
                   void* dqkv, int B, int L, int H, int Dh, int bb, int path, int groups,
                   int smem_bytes, float scale, cudaStream_t stream) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                           device);
  if (err != cudaSuccess) return err;
  const bool pairs = mode == kPair || mode == kHeadPair;
  const bool full_math = mode == kFull || mode == kStacked || pairs;
  const bool small = pad16(L) <= 64 && pad16(Dh) <= 64;
  // the plan must be one this entry computes the same way and can run
  if (groups < 1 || groups > kMaxGroups || (groups > 1 && (!full_math || !small)) ||
      (path != kTiles && path != kRecompute) ||
      (path == kRecompute && (sizeof(T) != 4 || groups != 1)))
    return cudaErrorInvalidValue;
  const size_t smem = path == kTiles ? tiles_smem<T>(L, Dh, groups, mode != kFewStores)
                                     : recompute_smem(L, Dh);
  if (smem_bytes < 0 || smem != (size_t)smem_bytes || smem > (size_t)optin)
    return cudaErrorInvalidValue;
  Args a;
  a.B = B;
  a.L = L;
  a.H = H;
  a.Dh = Dh;
  a.bb = bb;
  a.scale = scale;
  a.groups = groups;
  a.nh = pairs ? 2 : 1;
  a.heads_outer = mode == kHeadPair && groups == 1;
  a.stacked = mode == kStacked;
  a.vec = (Dh * sizeof(T)) % 16 == 0 && aligned16(qkv) && aligned16(g) && aligned16(dqkv);
  switch (mode) {
    case kNoMax: return launch_math<T, kNoMax>(qkv, mask, g, dqkv, a, path, smem, stream);
    case kNoSoftmax: return launch_math<T, kNoSoftmax>(qkv, mask, g, dqkv, a, path, smem, stream);
    case kNoVjp: return launch_math<T, kNoVjp>(qkv, mask, g, dqkv, a, path, smem, stream);
    case kBf16Vjp: return launch_math<T, kBf16Vjp>(qkv, mask, g, dqkv, a, path, smem, stream);
    case kFewStores: return launch_math<T, kFewStores>(qkv, mask, g, dqkv, a, path, smem, stream);
    default: return launch_math<T, kFull>(qkv, mask, g, dqkv, a, path, smem, stream);
  }
}

int run(int device, int mode, const void* qkv, const float* mask, const void* g, void* dqkv,
        int B, int L, int H, int Dh, int bb, int path, int groups, int smem_bytes, float scale,
        int dtype, void* stream) {
  const bool pairs = mode == kPair || mode == kHeadPair;
  if (B < 1 || bb < 1 || B % bb || H < 1 || H > 65535 || (pairs && H % 2) || L < 1 ||
      L > kMaxL || Dh < 1 || Dh > kMaxDh)
    return (int)cudaErrorInvalidValue;
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: name the card of the tensors
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ccmh::kFloat32:
      return (int)launch<float>(device, mode, qkv, mask, g, dqkv, B, L, H, Dh, bb, path, groups,
                                smem_bytes, scale, s);
    case ccmh::kBFloat16:
      return (int)launch<__nv_bfloat16>(device, mode, qkv, mask, g, dqkv, B, L, H, Dh, bb, path,
                                        groups, smem_bytes, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv and dqkv [B, L, 3*H*Dh], g [B, L, H*Dh], all contiguous in `dtype`
// (0 fp32, 1 bf16); mask [L, L] fp32 or null; L, Dh <= 128, bb dividing B;
// scale is 1/sqrt(Dh) rounded to fp32 by the caller.  The plan, as
// `_bwd_x_plan` makes it: path (0 tiles, 1 recompute: fp32 only), groups
// (warp groups a block, 1-4, units worked on at once; more than 1 only for
// full, stacked, pair and #10 at L, Dh <= 64) and smem_bytes.  A block
// covers two heads in pair and #10, one otherwise.
// Each entry launches on `stream` of card `device` and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a shape
// or plan it does not take.

// #6; mode 0 full, 1 stacked, 2 pair (H even), 3 nomax, 4 nosoftmax,
// 5 novjp, 6 bf16vjp, 7 fewstores
extern "C" int ccmh_attention_bwd_x(int device, const void* qkv, const float* mask,
                                    const void* g, void* dqkv, int B, int L, int H, int Dh,
                                    int bb, int mode, int path, int groups, int smem_bytes,
                                    float scale, int dtype, void* stream) {
  if (mode < kFull || mode > kFewStores) return (int)cudaErrorInvalidValue;
  return run(device, mode, qkv, mask, g, dqkv, B, L, H, Dh, bb, path, groups, smem_bytes, scale,
             dtype, stream);
}

// #10: H even
extern "C" int ccmh_attention_bwd_headpair(int device, const void* qkv, const float* mask,
                                           const void* g, void* dqkv, int B, int L, int H,
                                           int Dh, int bb, int path, int groups, int smem_bytes,
                                           float scale, int dtype, void* stream) {
  return run(device, kHeadPair, qkv, mask, g, dqkv, B, L, H, Dh, bb, path, groups, smem_bytes,
             scale, dtype, stream);
}
