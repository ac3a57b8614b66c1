// The merged-rows attention backward of tools/bench_attn_bwd.py (#9), on
// the tensor cores.
//
// Replaces: tools/bench_attn_bwd.py `backward_merged` (:404) /
// `_bwd_kernel_merged` (:361), a Pallas TPU kernel.  Kernel #2's function
// (attention_bwd.cu) with no projection bias over R = bb L merged rows: the
// bb batch elements of a group are one run of R rows that attend to each
// other under the [R, R] fp32 mask the caller passes (any mask of that
// shape; the bench's is block-diagonal with -1e9 between elements, so the
// off-block probabilities are exactly 0).  Per (group, head), with the
// softmax in fp32,
//   logits = (q . k) * scale + mask,   probs = softmax(logits),
//   dprobs = g . v,                    dlogits = probs * (dprobs - sum_j dprobs * probs),
//   probs_c = probs -> T,              dlogits_c = (dlogits * scale) -> T,
//   dq = dlogits_c . k,  dk = dlogits_c^T . q,  dv = probs_c^T . g,
// each product summed in fp32 and stored in T into dqkv [B, L, 3D].
//
// Why it keeps the bb-fold products: they are the ablation's question (the
// bench's "bb elements as merged rows, bb-fold operations").  All five
// products run over the full [R, R], and every mask element is read where
// it is used; a kernel that skipped the tiles a block-diagonal mask zeroes
// would be kernel #2 at another tiling and would measure nothing new.
//
// What bounds it on an H100: at vision (B=256, L=50, H=12, Dh=64) it reads
// 59 MB of qkv and 20 MB of g and writes 59 MB of dqkv in bf16 (41 us at
// 3.35 TB/s; fp32 82 us), and does 10 B H L R Dh operations: 9.8 GFLOP at
// bb=2, 19.7 at bb=4.  In bf16 bytes bound it (the products take 10 / 20
// us at 989 TFLOP/s); in fp32, as 3xTF32 at 495/3 TFLOP/s, bb=2 is bound by
// bytes (0.082 ms over 0.059) and bb=4 by operations, 19.7 GFLOP / 165
// TFLOP/s = 0.119 ms.
//
// Design: one block per (group, head), a grid of (B / bb, H), so dk and dv,
// which sum over the queries, reduce inside the block.  A group of G warps
// shares each 16-row tile (G = 2 up to 128 rows, 4 above), each warp a run
// of the tile's 16-key blocks (at most 64 keys), so no warp holds more than
// two [16, 64] fp32 strips: a block of min(pad16(R) / 16, 16 / G) groups,
// 14 warps at R = 100, 16 at R = 200, at most 128 registers a thread.  All
// products on mma.sync (bf16 m16n8k16; fp32 as 3xTF32 m16n8k8, its split
// rounding toward zero with no conversion instruction, mma_tiles.cuh
// FragTz).  Two [pad16(R)][ld] operand tiles live in shared memory at a
// time, loaded by
// 16-byte cp.async where Dh sizeof(T), the row stride and the pointers
// allow (scalar loads otherwise):
//   A. query-major, k and v in shared memory, each warp's q and g fragments
//      read from device memory (4-byte pairs in bf16).  S = q k^T and
//      dP = g v^T of the warp's keys stay in registers; each warp's row
//      max, sum e and sum e dP (e = exp(logit - max)) go through shared
//      memory to its group, which combines them in one order in every
//      warp; then the softmax and its VJP in registers, as kernel #2.
//      Kept: probs_c and dlogits_c into the two [R, R] tiles in T, and each
//      warp of the group takes its share of dq's 16-column blocks over all
//      keys from the dlogits_c tile.  Recomputed: dq = dS_c k over the
//      warp's keys from dS_c repacked in registers, the group's partial dq
//      summed in a tree through shared memory, and the row statistics kept.
//   B. key-major, q and g reloaded into the same two tiles.  Kept: each
//      warp sums dv = P_c^T g or dk = dS_c^T q of 16 keys over the queries
//      from the tiles (ldmatrix.trans in bf16).  Recomputed: each warp
//      recomputes S^T = k q^T and dP^T = v g^T of its 16 keys against each
//      16-query tile (the keys' k and v rows held in registers in bf16),
//      the probabilities from A's statistics, and repacks them in registers
//      as the A operands of dv and dk: no transposing scratch.
//   Stream (fp32 from 145 rows at a head dim over 80, where the two
//      operand tiles and the dq buffers do not fit): the same as
//      recomputing, the operands' fragments read from device memory.
// The plan (register class, path, shared-memory bytes) is made in Python
// (ccmh_torch/ops/attention_variants.py `_merged_plan`: kept where the
// tiles fit, else recomputed, else streamed) and checked here: the entry
// refuses a plan whose bytes it does not compute the same way, that does
// not fit, or whose register class is not R's.
//
// Shared memory, 2 pad16(R) ld elements of T (ld = pad16(Dh) + 8 | 4,
// bf16 | fp32), plus the two kept [pad16(R)][pad16(R) + 8 | 4] tiles in T
// or, recomputing, three fp32 row statistics and (warps / 2) fp32
// [16][pad16(Dh)] dq buffers, plus each warp's [16][4] fp32 statistics: at
// Dh=64, R = 100 kept 89,600 bytes bf16 / 168,448 fp32, R = 200 recomputed
// 99,264 / 152,512; fp32 R = 256, Dh = 128 streamed 72,704.

#include <type_traits>

#include "mma_tiles.cuh"

namespace {

using namespace ccmh::mma;

// fp32 products as 3xTF32 with the split toward zero (mma_tiles.cuh
// FragTz); bf16 is Frag's as it is
template <typename T>
using MFrag = FragTz<T>;

constexpr int kMaxR = 256;
constexpr int kMaxDh = 128;
constexpr int kMaxWarps = 16;   // two a 16-row tile: 8 tiles at a time

// the plan's path (ccmh_torch/ops/attention_variants.py MERGED_PATHS)
enum Path : int { kRecompute = 0, kKeep = 1, kStream = 2 };

// A 16-row tile's keys are shared by a group of G warps: 2 up to 8 tiles
// (128 rows), 4 above, so that no warp holds more than 64 keys; a block
// holds min(tiles, 16 / G) groups
__host__ __device__ __forceinline__ int group_size(int R) { return pad16(R) <= 128 ? 2 : 4; }
__host__ __device__ __forceinline__ int warps_of(int R) {
  const int n_t = pad16(R) / 16, G = group_size(R);
  return G * (n_t < kMaxWarps / G ? n_t : kMaxWarps / G);
}

// The plan's shared-memory bytes (`_merged_plan` computes the same): the two
// operand tiles but on the stream path; the two kept [R, R] tiles, or the
// three fp32 row statistics and the groups' fp32 [16][pad16(Dh)] dq
// exchange buffers (G / 2 a group); and each warp's [16][4] fp32 row
// statistics exchange
template <typename T>
size_t plan_smem(int R, int Dh, int path) {
  const int Rp = pad16(R), warps = warps_of(R);
  const size_t xch = (size_t)warps * 16 * 4 * sizeof(float);
  const size_t stats = (size_t)3 * Rp * sizeof(float) +
                       (size_t)warps / 2 * 16 * pad16(Dh) * sizeof(float);
  if (path == kStream) return stats + xch;
  const size_t operands = (size_t)2 * Rp * tile_ld<T>(Dh) * sizeof(T);
  return operands + xch +
         (path == kKeep ? (size_t)2 * Rp * tile_ld<T>(R) * sizeof(T) : stats);
}

// An operand of the products, [rows][Dh] row-major: a tile in shared memory
// (fragments through ldmatrix in bf16) ...
template <typename T>
struct SmemOp {
  using F = MFrag<T>;
  const T* p;
  int ld;
  __device__ void b_rows(typename F::B& b0, typename F::B& b1, int n0, int k0, int lane) const {
    F::b_rows(b0, b1, p, ld, n0, k0, lane);
  }
  __device__ void b_cols(typename F::B& b0, typename F::B& b1, int k0, int n0, int lane) const {
    F::b_cols(b0, b1, p, ld, k0, n0, lane);
  }
};

// ... or a head slice in device memory, element by element (the stream
// path), 0 past `rows` and Dh; the same fragments as MFrag<T>'s
template <typename T>
struct GmemOp {
  using F = MFrag<T>;
  const T* __restrict__ p;
  size_t ld;
  int rows, Dh;
  __device__ float x(int r, int c) const {
    return (r < rows && c < Dh) ? ccmh::to_float(p[r * ld + c]) : 0.f;
  }
  // B[k][n] = Y[n0 + n][k0 + k]
  __device__ void b_rows(typename F::B& b0, typename F::B& b1, int n0, int k0, int lane) const {
    const int g = lane >> 2, t = lane & 3;
    if constexpr (sizeof(T) == 2) {
      const int c = k0 + 2 * t;
      b0.r[0] = pack_bf16(x(n0 + g, c), x(n0 + g, c + 1));
      b0.r[1] = pack_bf16(x(n0 + g, c + 8), x(n0 + g, c + 9));
      b1.r[0] = pack_bf16(x(n0 + g + 8, c), x(n0 + g + 8, c + 1));
      b1.r[1] = pack_bf16(x(n0 + g + 8, c + 8), x(n0 + g + 8, c + 9));
    } else {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int c = k0 + 8 * s + t;
        F::set_b(b0, s, x(n0 + g, c), x(n0 + g, c + 4));
        F::set_b(b1, s, x(n0 + g + 8, c), x(n0 + g + 8, c + 4));
      }
    }
  }
  // B[k][n] = Y[k0 + k][n0 + n]
  __device__ void b_cols(typename F::B& b0, typename F::B& b1, int k0, int n0, int lane) const {
    const int g = lane >> 2, t = lane & 3;
    if constexpr (sizeof(T) == 2) {
      const int r = k0 + 2 * t;
      b0.r[0] = pack_bf16(x(r, n0 + g), x(r + 1, n0 + g));
      b0.r[1] = pack_bf16(x(r + 8, n0 + g), x(r + 9, n0 + g));
      b1.r[0] = pack_bf16(x(r, n0 + g + 8), x(r + 1, n0 + g + 8));
      b1.r[1] = pack_bf16(x(r + 8, n0 + g + 8), x(r + 9, n0 + g + 8));
    } else {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int r = k0 + 8 * s + 2 * t;
        F::set_b(b0, s, x(r, n0 + g), x(r + 1, n0 + g));
        F::set_b(b1, s, x(r, n0 + g + 8), x(r + 1, n0 + g + 8));
      }
    }
  }
};

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// A fragment ("rows" order) of rows m0 .. m0 + 15 of a head slice in device
// memory: X[r][c] = src[r * src_ld + c] for r < rows, c < Dh, else 0; bf16
// pairs as one 4-byte load where `pairs` (even Dh, aligned rows)
template <typename T>
__device__ __forceinline__ typename MFrag<T>::A a_rows_gmem(const T* __restrict__ src,
                                                           size_t src_ld, int m0, int k0,
                                                           int rows, int Dh, bool pairs,
                                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  auto x = [&](int r, int c) {
    return (r < rows && c < Dh) ? ccmh::to_float(src[r * src_ld + c]) : 0.f;
  };
  typename MFrag<T>::A a;
  const int r0 = m0 + g, r1 = r0 + 8;
  if constexpr (sizeof(T) == 2) {
    const int c = k0 + 2 * t;
    auto pair = [&](int r, int cc) -> uint32_t {
      if (pairs)
        return (r < rows && cc < Dh)
                   ? __ldg(reinterpret_cast<const unsigned int*>(src + r * src_ld + cc))
                   : 0u;
      return pack_bf16(x(r, cc), x(r, cc + 1));
    };
    a.r[0] = pair(r0, c);
    a.r[1] = pair(r1, c);
    a.r[2] = pair(r0, c + 8);
    a.r[3] = pair(r1, c + 8);
  } else {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int c = k0 + 8 * s + t;
      MFrag<T>::set_a(a, s, x(r0, c), x(r1, c), x(r0, c + 4), x(r1, c + 4));
    }
  }
  return a;
}

// A warp's 16 rows m0 .. of a head slice in device memory as the A
// operands of the 16-dim blocks: read at each use, or (bf16) held in
// registers as fragments
template <typename T, int DMAX, bool HOLD>
struct Rows;

template <typename T, int DMAX>
struct Rows<T, DMAX, false> {
  static constexpr bool kHeld = false;
  const T* __restrict__ src;
  size_t ld;
  int m0, rows, Dh;
  bool pairs;
  __device__ Rows(const T* s, size_t l, int m, int r, int d, int, bool p, int)
      : src(s), ld(l), m0(m), rows(r), Dh(d), pairs(p) {}
  __device__ typename MFrag<T>::A get(int kb, int lane) const {
    return a_rows_gmem<T>(src, ld, m0, kb * 16, rows, Dh, pairs, lane);
  }
};

template <int DMAX>
struct Rows<__nv_bfloat16, DMAX, true> {
  static constexpr bool kHeld = true;
  using T = __nv_bfloat16;
  typename MFrag<T>::A a[DMAX / 16];
  __device__ Rows(const T* s, size_t l, int m, int r, int d, int n_dk, bool p, int lane) {
#pragma unroll
    for (int kb = 0; kb < DMAX / 16; ++kb)
      if (kb < n_dk) a[kb] = a_rows_gmem<T>(s, l, m, kb * 16, r, d, p, lane);
  }
  __device__ typename MFrag<T>::A get(int kb, int) const { return a[kb]; }
};

// acc[j] (keys key0 + 8 j ..) += X Y^T over the head dim, for the n_kt
// 16-key tiles from key0: X the warp's 16 rows (Rows), Y an operand
template <typename T, int N, typename X, typename Op>
__device__ __forceinline__ void strip_block(float (&acc)[N][4], const typename MFrag<T>::A& a,
                                            const Op& Y, int key0, int n_kt, int kb, int lane) {
  using F = MFrag<T>;
#pragma unroll
  for (int jp = 0; jp < N / 2; ++jp) {
    if (jp < n_kt) {
      typename F::B b0, b1;
      Y.b_rows(b0, b1, key0 + jp * 16, kb * 16, lane);
      F::mma(acc[2 * jp], a, b0);
      F::mma(acc[2 * jp + 1], a, b1);
    }
  }
}

// (held rows index their registers, so their 16-dim blocks unroll; rows
// read at each use do not, which keeps the fp32 code small)
template <typename T, int KBMAX, int N, typename X, typename Op>
__device__ __forceinline__ void strip(float (&acc)[N][4], const X& x, const Op& Y, int key0,
                                      int n_kt, int n_dk, int lane) {
  if constexpr (X::kHeld) {
#pragma unroll
    for (int kb = 0; kb < KBMAX; ++kb)
      if (kb < n_dk) strip_block<T, N, X>(acc, x.get(kb, lane), Y, key0, n_kt, kb, lane);
  } else {
#pragma unroll 1
    for (int kb = 0; kb < n_dk; ++kb)
      strip_block<T, N, X>(acc, x.get(kb, lane), Y, key0, n_kt, kb, lane);
  }
}

// acc += A Y for one 16-row block k0 of the operand Y, output column
// blocks np0 .. np1 - 1 (16 columns each)
template <typename T, int N, typename Op>
__device__ __forceinline__ void times_block(float (&acc)[N][4], const typename MFrag<T>::A& a,
                                            const Op& Y, int k0, int np0, int np1, int lane) {
  using F = MFrag<T>;
#pragma unroll
  for (int np = 0; np < N / 2; ++np) {
    if (np >= np0 && np < np1) {
      typename F::B b0, b1;
      Y.b_cols(b0, b1, k0, np * 16, lane);
      F::mma(acc[2 * np], a, b0);
      F::mma(acc[2 * np + 1], a, b1);
    }
  }
}

// dq += dS_c K over the strip's n_kt 16-key blocks from key0 (dS_c the
// rounded accumulator tiles ds[j], keys key0 + 8 j ..)
template <typename T, int KB, int N, typename Op>
__device__ __forceinline__ void dq_strip(float (&dq)[N][4], const float (&ds)[KB / 8][4],
                                         const Op& K, int key0, int n_kt, int n_dk, int lane) {
#pragma unroll
  for (int kk = 0; kk < KB / 16; ++kk)
    if (kk < n_kt)
      times_block<T>(dq, MFrag<T>::a_acc(ds[2 * kk], ds[2 * kk + 1]), K, key0 + kk * 16, 0, n_dk,
                     lane);
}

// An accumulator tile set's rows r0 + g (+8) and columns 8 j + 2 t (+1) into
// device memory (row stride dst_ld) in T, where r < rows and c < Dh; pairs
// of columns as one 4- or 8-byte store where `pairs` (even Dh, aligned)
template <typename T, int N>
__device__ __forceinline__ void store_acc(T* __restrict__ dst, size_t dst_ld,
                                          const float (&acc)[N][4], int j0, int j1, int r0,
                                          int rows, int Dh, bool pairs, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j < j0 || j >= j1) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + g + 8 * hr, c = 8 * j + 2 * t;
      if (r >= rows || c >= Dh) continue;
      T* d = dst + r * dst_ld + c;
      const float x0 = acc[j][2 * hr], x1 = acc[j][2 * hr + 1];
      if (pairs) {
        if constexpr (sizeof(T) == 2)
          *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(x0, x1);
        else
          *reinterpret_cast<float2*>(d) = make_float2(x0, x1);
      } else {
        d[0] = ccmh::from_float<T>(x0);
        if (c + 1 < Dh) d[1] = ccmh::from_float<T>(x1);
      }
    }
  }
}

// The VJP of the softmax on a warp's strip, in place, as kernel #2: s holds
// probs and becomes probs_c (0 for rows past R), dp holds dprobs and
// becomes dlogits_c, given the rows' sum_j dprobs * probs
template <typename T, int N>
__device__ __forceinline__ void vjp(float (&s)[N][4], float (&dp)[N][4], const float (&dot)[2],
                                    float scale, bool live0, bool live1) {
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

// A[m][k] = X[m0 + m][k0 + k] of a row-major tile in shared memory, in the
// order a_acc gives (k = 2 t, 2 t + 1 of each fp32 sub-step), so that it
// pairs with b_cols: dq = dS_c K from the kept dS_c tile
template <typename T>
__device__ __forceinline__ typename MFrag<T>::A a_tile(const T* X, int ld, int m0, int k0,
                                                      int lane) {
  if constexpr (sizeof(T) == 2) {
    return MFrag<T>::a_rows(X, ld, m0, k0, lane);
  } else {
    const int g = lane >> 2, t = lane & 3;
    MFrag<float>::A a;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float* x = X + (m0 + g) * ld + k0 + 8 * s + 2 * t;
      MFrag<float>::set_a(a, s, x[0], x[8 * ld], x[1], x[8 * ld + 1]);
    }
    return a;
  }
}

// the G warps of group gi meet (barrier 1 + gi; 0 is __syncthreads')
__device__ __forceinline__ void group_sync(int gi, int G) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + gi), "r"(32 * G) : "memory");
}

// dq[j] += *x (or = where `set`): a [16][Dp] fp32 buffer in the accumulator layout
template <int N>
__device__ __forceinline__ void dq_buffer(float (&dq)[N][4], float* x, int Dp, int n_dk,
                                          bool write, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j < 2 * n_dk) {
      float2* p0 = reinterpret_cast<float2*>(x + g * Dp + 8 * j + 2 * t);
      float2* p1 = reinterpret_cast<float2*>(x + (g + 8) * Dp + 8 * j + 2 * t);
      if (write) {
        *p0 = make_float2(dq[j][0], dq[j][1]);
        *p1 = make_float2(dq[j][2], dq[j][3]);
      } else {
        const float2 a = *p0, b = *p1;
        dq[j][0] += a.x;
        dq[j][1] += a.y;
        dq[j][2] += b.x;
        dq[j][3] += b.y;
      }
    }
  }
}

// One block of at most 16 warps (128 registers a thread).  Phase A: warp
// G gi + part takes 16-row tile gi (then gi + 16 / G, ...) against its
// share of the keys, the tile's 16-key blocks dealt out in order; phase B:
// each warp a (16 keys, dv or dk) item, or (recomputing) a 16-key tile's
// dv and dk.
template <typename T, int KB, int DMAX, int PATH>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
merged_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
              const T* __restrict__ gin, T* __restrict__ dqkv, int R, int H, int Dh,
              float scale, int vec_in) {
  using F = MFrag<T>;
  using Op = std::conditional_t<PATH == kStream, GmemOp<T>, SmemOp<T>>;
  constexpr bool KEEP = PATH == kKeep;
  constexpr bool HOLD = sizeof(T) == 2;   // bf16 holds phase B's k and v rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const bool vec = vec_in != 0;
  const int Rp = pad16(R), Dp = pad16(Dh), ld = tile_ld<T>(Dh), ldt = tile_ld<T>(R);
  const int h = blockIdx.y;
  const int D = H * Dh, D3 = 3 * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int G = group_size(R), gi = warp / G, part = warp - gi * G, n_groups = nw / G;
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 = (size_t)blockIdx.x * R;
  const T* base = qkv + row0 * D3 + h * Dh;   // q; k at + D, v at + 2 D
  const T* gbase = gin + row0 * D + h * Dh;
  T* out = dqkv + row0 * D3 + h * Dh;
  const int n_t = Rp / 16, n_dk = Dp / 16;
  // shared memory: operand tiles x0 (k in A, q in B) and x1 (v, then g),
  // then the kept tiles or the statistics and dq buffers, then each warp's
  // statistics exchange
  T* x0 = reinterpret_cast<T*>(smem_raw);
  T* x1 = x0 + Rp * ld;
  T* tp = PATH == kStream ? x0 : x1 + Rp * ld;   // kept: probs_c [query][key]
  T* ts = tp + Rp * ldt;                         // kept: dlogits_c [query][key]
  float* row_max = reinterpret_cast<float*>(tp);    // otherwise: [Rp] each
  float* row_sum = row_max + Rp;
  float* row_dot = row_sum + Rp;
  float* dqx = row_dot + Rp;                        // [nw / 2][16][Dp]
  float* xch = KEEP ? reinterpret_cast<float*>(ts + Rp * ldt) : dqx + nw / 2 * 16 * Dp;
  // this warp's keys in phase A: 16-key blocks kt0 .. kt0 + n_kb - 1
  const int per = n_t / G, extra = n_t - per * G;
  const int n_kb = per + (part < extra), kt0 = part * per + min(part, extra);
  auto operand = [&](const T* tile, const T* src, size_t src_ld) {
    if constexpr (PATH == kStream)
      return Op{src, src_ld, R, Dh};
    else
      return Op{tile, ld};
  };

  if constexpr (PATH != kStream) {
    load_tile<T>(x0, ld, base + D, D3, R, Dh, nullptr, vec);
    load_tile<T>(x1, ld, base + 2 * D, D3, R, Dh, nullptr, vec);
    if (vec) cp_async_wait_all();
    __syncthreads();
  }
  const Op kop = operand(x0, base + D, D3), vop = operand(x1, base + 2 * D, D3);

  // ---- phase A: query tile m0 = 16 qt
  for (int qt = gi; qt < n_t; qt += n_groups) {
    const int m0 = qt * 16, key0 = kt0 * 16;
    const int i0 = m0 + g, i1 = i0 + 8;
    const bool live0 = i0 < R, live1 = i1 < R;
    const Rows<T, DMAX, false> qr(base, D3, m0, R, Dh, n_dk, vec, lane);
    const Rows<T, DMAX, false> gr(gbase, D, m0, R, Dh, n_dk, vec, lane);
    // S and dP against the warp's keys, the logits in s
    float s[KB / 8][4], dp[KB / 8][4];
    zero(s);
    zero(dp);
    strip<T, DMAX / 16>(s, qr, kop, key0, n_kb, n_dk, lane);
    strip<T, DMAX / 16>(dp, gr, vop, key0, n_kb, n_dk, lane);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < KB / 8; ++j) {
      const int c = key0 + 8 * j + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = j < 2 * n_kb ? logit(s[j][e], scale, mask, e < 2 ? i0 : i1, c + (e & 1), R)
                               : -CUDART_INF_F;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    // the warp's row max, sum e and sum e dP (e = exp(logit - max)); 0 for
    // a share with no finite logit
    float sum[2] = {0.f, 0.f}, u[2] = {0.f, 0.f}, ms[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = quad_max(mx[e]);
      ms[e] = mx[e] == -CUDART_INF_F ? 0.f : mx[e];
    }
#pragma unroll
    for (int j = 0; j < KB / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = expf(s[j][e] - ms[e >> 1]);
        sum[e >> 1] += x;
        u[e >> 1] = fmaf(x, dp[j][e], u[e >> 1]);
      }
    }
    float* mine = xch + warp * 64;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sum[e] = quad_sum(sum[e]);
      u[e] = quad_sum(u[e]);
      if (t == 0) {
        mine[(g + 8 * e) * 4 + 0] = mx[e];
        mine[(g + 8 * e) * 4 + 1] = sum[e];
        mine[(g + 8 * e) * 4 + 2] = u[e];
      }
    }
    group_sync(gi, G);
    // the group's shares combined, in the same order in every warp
    float dot[2], inv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float* st0 = xch + gi * G * 64 + (g + 8 * e) * 4;
      float m = -CUDART_INF_F;
      for (int p = 0; p < G; ++p) m = fmaxf(m, st0[p * 64]);   // finite: a row has a finite logit
      float l = 0.f, uu = 0.f;
      for (int p = 0; p < G; ++p) {
        const float c = expf(st0[p * 64] - m);
        l += st0[p * 64 + 1] * c;
        uu += st0[p * 64 + 2] * c;
      }
      mx[e] = m;
      sum[e] = l;
      dot[e] = uu / l;
      inv[e] = 1.f / l;
    }
    if (!KEEP && part == 0 && t == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        row_max[i0 + 8 * e] = mx[e];
        row_sum[i0 + 8 * e] = sum[e];
        row_dot[i0 + 8 * e] = dot[e];
      }
    }
    // probs_c and dlogits_c of the warp's keys
#pragma unroll
    for (int j = 0; j < KB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = expf(s[j][e] - mx[e >> 1]) * inv[e >> 1];
    vjp<T>(s, dp, dot, scale, live0, live1);
    float dq[DMAX / 8][4];
    zero(dq);
    if constexpr (KEEP) {
      stage_acc<T>(tp + m0 * ldt + key0, ldt, s, 2 * n_kb, lane);
      stage_acc<T>(ts + m0 * ldt + key0, ldt, dp, 2 * n_kb, lane);
      // the tile's dS_c is in: each warp of the group takes its share of
      // dq's 16-column blocks over all the keys
      group_sync(gi, G);
      const int dper = n_dk / G, dextra = n_dk - dper * G;
      const int np0 = part * dper + min(part, dextra), np1 = np0 + dper + (part < dextra);
      for (int kb = 0; kb < n_t; ++kb)
        times_block<T>(dq, a_tile<T>(ts, ldt, m0, kb * 16, lane), kop, kb * 16, np0, np1, lane);
      store_acc<T>(out, D3, dq, 2 * np0, 2 * np1, m0, R, Dh, vec, lane);
    } else {
      dq_strip<T, KB>(dq, dp, kop, key0, n_kb, n_dk, lane);
      // the group's partial dq summed in a tree through G / 2 buffers
      float* buf = dqx + gi * (G / 2) * 16 * Dp;
      if (part >= G / 2) dq_buffer(dq, buf + (part - G / 2) * 16 * Dp, Dp, n_dk, true, lane);
      group_sync(gi, G);
      if (part < G / 2) dq_buffer(dq, buf + part * 16 * Dp, Dp, n_dk, false, lane);
      if (G == 4) {
        if (part == 1) dq_buffer(dq, buf + 16 * Dp, Dp, n_dk, true, lane);
        group_sync(gi, G);
        if (part == 0) dq_buffer(dq, buf + 16 * Dp, Dp, n_dk, false, lane);
      }
      if (part == 0) store_acc<T>(out, D3, dq, 0, 2 * n_dk, m0, R, Dh, vec, lane);
    }
  }
  __syncthreads();   // k and v are read no more; the tiles or statistics are in

  // ---- phase B: q | g (into the same two tiles)
  if constexpr (PATH != kStream) {
    load_tile<T>(x0, ld, base, D3, R, Dh, nullptr, vec);
    load_tile<T>(x1, ld, gbase, D, R, Dh, nullptr, vec);
    if (vec) cp_async_wait_all();
    __syncthreads();
  }
  const Op qop = operand(x0, base, D3), gop = operand(x1, gbase, D);

  if constexpr (KEEP) {
    // item 2 kt + which: dv = probs_c^T g (which 0) or dk = dlogits_c^T q of
    // keys j0 = 16 kt
    for (int it = warp; it < 2 * n_t; it += nw) {
      const int j0 = (it >> 1) * 16, which = it & 1;
      float acc[DMAX / 8][4];
      zero(acc);
      const T* W = which == 0 ? tp : ts;
      const Op& yop = which == 0 ? gop : qop;
      for (int qb = 0; qb < n_t; ++qb)
        times_block<T>(acc, F::a_cols(W, ldt, j0, qb * 16, lane), yop, qb * 16, 0, n_dk, lane);
      store_acc<T>(out + (which == 0 ? 2 * D : D), D3, acc, 0, 2 * n_dk, j0, R, Dh, vec, lane);
    }
  } else {
    // keys j0 = 16 kt: S^T and dP^T recomputed query tile by query tile
    for (int kt = warp; kt < n_t; kt += nw) {
      const int j0 = kt * 16;
      const Rows<T, DMAX, HOLD> kr(base + D, D3, j0, R, Dh, n_dk, vec, lane);
      const Rows<T, DMAX, HOLD> vr(base + 2 * D, D3, j0, R, Dh, n_dk, vec, lane);
      float dv[DMAX / 8][4], dk[DMAX / 8][4];
      zero(dv);
      zero(dk);
      for (int q0 = 0; q0 < Rp; q0 += 16) {
        float st[2][4], dpt[2][4];
        zero(st);
        zero(dpt);
        strip<T, DMAX / 16>(st, kr, qop, q0, 1, n_dk, lane);
        strip<T, DMAX / 16>(dpt, vr, gop, q0, 1, n_dk, lane);
        // the weights of keys j0 + g (+8) and queries q0 + 8 jj + 2 t (+1)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j0 + g + 8 * (e >> 1), i = q0 + 8 * jj + 2 * t + (e & 1);
            float p = 0.f, w = 0.f;
            if (i < R && key < R) {
              const float x = __fadd_rn(__fmul_rn(st[jj][e], scale), __ldg(mask + i * R + key));
              const float pf = expf(x - row_max[i]) * (1.f / row_sum[i]);
              p = ccmh::round_to<T>(pf);
              w = ccmh::round_to<T>(pf * (dpt[jj][e] - row_dot[i]) * scale);
            }
            st[jj][e] = p;
            dpt[jj][e] = w;
          }
        }
        times_block<T>(dv, F::a_acc(st[0], st[1]), gop, q0, 0, n_dk, lane);
        times_block<T>(dk, F::a_acc(dpt[0], dpt[1]), qop, q0, 0, n_dk, lane);
      }
      store_acc<T>(out + 2 * D, D3, dv, 0, 2 * n_dk, j0, R, Dh, vec, lane);
      store_acc<T>(out + D, D3, dk, 0, 2 * n_dk, j0, R, Dh, vec, lane);
    }
  }
}

template <typename T, int KB, int DMAX, int PATH>
cudaError_t launch_plan(const void* qkv, const float* mask, const void* g, void* dqkv, int B,
                        int R, int H, int Dh, int bb, float scale, bool vec, size_t smem,
                        cudaStream_t stream) {
  auto kernel = merged_kernel<T, KB, DMAX, PATH>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B / bb, H);
  kernel<<<grid, warps_of(R) * 32, smem, stream>>>(static_cast<const T*>(qkv), mask,
                                                   static_cast<const T*>(g),
                                                   static_cast<T*>(dqkv), R, H, Dh, scale,
                                                   vec ? 1 : 0);
  return cudaGetLastError();
}

template <typename T, int KB, int PATH>
cudaError_t launch_dh(const void* qkv, const float* mask, const void* g, void* dqkv, int B,
                      int R, int H, int Dh, int bb, float scale, bool vec, size_t smem,
                      cudaStream_t stream) {
  if (pad16(Dh) <= 64)
    return launch_plan<T, KB, 64, PATH>(qkv, mask, g, dqkv, B, R, H, Dh, bb, scale, vec, smem,
                                        stream);
  return launch_plan<T, KB, 128, PATH>(qkv, mask, g, dqkv, B, R, H, Dh, bb, scale, vec, smem,
                                       stream);
}

template <typename T>
cudaError_t launch(int device, const void* qkv, const float* mask, const void* g, void* dqkv,
                   int B, int L, int H, int Dh, int bb, int key_block, int path, size_t smem,
                   float scale, cudaStream_t stream) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                           device);
  if (err != cudaSuccess) return err;
  const int R = bb * L;
  // the plan must be one this entry computes the same way and can run: the
  // register class R's (the most keys of a tile one warp holds: 32 up to
  // 64 rows, 64 above), and the stream path only in fp32 at Dh > 64 (the
  // only place it is needed)
  const int want_kb = pad16(R) <= 64 ? 32 : 64;
  if (path < kRecompute || path > kStream || smem != plan_smem<T>(R, Dh, path) ||
      smem > (size_t)optin || key_block != want_kb ||
      (path == kStream && (sizeof(T) != 4 || key_block != 64 || pad16(Dh) <= 64)))
    return cudaErrorInvalidValue;
  const bool vec = (Dh * sizeof(T)) % 16 == 0 && aligned16(qkv) && aligned16(g) &&
                   aligned16(dqkv);
  const auto args = [&](auto launcher) {
    return launcher(qkv, mask, g, dqkv, B, R, H, Dh, bb, scale, vec, smem, stream);
  };
  if constexpr (sizeof(T) == 4)
    if (path == kStream) return args(launch_plan<T, 64, 128, kStream>);
  if (key_block == 32)
    return path == kKeep ? args(launch_dh<T, 32, kKeep>) : args(launch_dh<T, 32, kRecompute>);
  return path == kKeep ? args(launch_dh<T, 64, kKeep>) : args(launch_dh<T, 64, kRecompute>);
}

}  // namespace

// qkv and dqkv [B, L, 3*H*Dh], g [B, L, H*Dh], all contiguous in `dtype`
// (0 fp32, 1 bf16); mask [R, R] fp32 with R = bb * L <= 256, bb dividing
// B; scale is 1/sqrt(Dh) rounded to fp32 by the caller.  The plan, as
// `_merged_plan` makes it: key_block (the register class: the most keys of
// a 16-row tile one warp holds, 32 or 64), path (0 recompute, 1 keep the [R, R] tiles, 2 stream the
// operands from device memory) and smem_bytes.  Launches on `stream` of
// card `device` and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a shape or plan it does not take.
extern "C" int ccmh_attention_bwd_merged(int device, const void* qkv, const float* mask,
                                         const void* g, void* dqkv, int B, int L, int H,
                                         int Dh, int bb, int key_block, int path,
                                         int smem_bytes, float scale, int dtype,
                                         void* stream) {
  if (mask == nullptr || B < 1 || bb < 1 || B % bb || L < 1 || bb * L > kMaxR || H < 1 ||
      H > 65535 || Dh < 1 || Dh > kMaxDh || smem_bytes < 0)
    return (int)cudaErrorInvalidValue;
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: name the card of the tensors
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ccmh::kFloat32:
      return (int)launch<float>(device, qkv, mask, g, dqkv, B, L, H, Dh, bb, key_block, path,
                                (size_t)smem_bytes, scale, s);
    case ccmh::kBFloat16:
      return (int)launch<__nv_bfloat16>(device, qkv, mask, g, dqkv, B, L, H, Dh, bb, key_block,
                                        path, (size_t)smem_bytes, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
