// Hopper building blocks of the long path of the attention kernels #1
// (attention.cu) and #2 (attention_bwd.cu): warpgroup wgmma products on
// 64-row tiles, tiles landed by TMA in shared memory with the 128-byte
// swizzle, mbarriers that count the bytes landed, and the tensor maps that
// describe the packed qkv, g and dqkv rows to the TMA unit; the row
// softmax's statistics and exponentials; in fp32 the 3xTF32 products on
// wgmma .tf32 and the splits they read (the section "fp32 as 3xTF32").
//
// In bf16:
// A tile is [64 rows][64 bf16] = 8 KB: one head's 64 head-dim values of 64
// sequence rows, row r at byte r * 128 with its 16-byte chunk c stored at
// chunk c ^ (r & 7) (CU_TENSOR_MAP_SWIZZLE_128B, which TMA writes and the
// wgmma descriptors below read; every tile starts 1024-byte aligned, the
// swizzle's period).  Rows past the sequence's end land as zeros (TMA's
// out-of-bounds fill), and a box never crosses into the next batch
// element: the tensor maps are 3-D, [B][L][row width].
//
// Products (PTX wgmma.mma_async m64n64k16, fp32 accumulators):
//   * ss: A and B both from shared memory, both K-major, i.e. rows of the
//     head dim: S = Q K^T, dP = dO V^T, S^T = K Q^T, dP^T = V dO^T;
//   * rs: A from registers, B from shared memory MN-major (the 16-bit
//     transpose bit): O += P V, dV += P^T dO, dK += dS^T Q, dQ += dS K,
//     with the sequence rows of the tile as the summed index.
// An accumulator of m64n64 is float d[32] a thread: warp w of the
// warpgroup holds rows 16 w + g and 16 w + g + 8 (g = lane / 4), and
// d[4 j + e] is column 8 j + 2 t + (e & 1) of row g + 8 (e >> 1), t = lane
// % 4: mma.sync's accumulator tile, eight of them side by side.  The A
// operand of an rs product takes the same rows, so an accumulator rounded
// to bf16 becomes the next product's A in registers (to_a), no shuffle.

#pragma once

#include <cuda.h>   // CUtensorMap and its enums only: the library links no -lcuda

#include "mma_tiles.cuh"

namespace ccmh {
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                    // rows of a tile, of a warpgroup's product
constexpr int kDh = 64;                      // the head dim the wgmma kernels take
constexpr int kRowBytes = kDh * 2;           // 128: one swizzle row
constexpr int kTileBytes = kRows * kRowBytes;  // 8 KB
constexpr int kWgThreads = 128;

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte aligned byte of dynamic shared memory at or after p
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = saddr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// ---- mbarriers (one arrival, the expect_tx of the thread that starts the
// copies, plus the bytes the copies land)

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)), "r"(count)
               : "memory");
}

// the barriers' initialisation visible to the TMA unit (async proxy)
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one arrival on a barrier (release: the arriving thread's accesses before it)
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(bar)) : "memory");
}

// a barrier of `threads` threads, whole warps, named `id` (0 is __syncthreads')
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// a warpgroup's registers a thread, lowered for a producer or raised for a
// consumer of a warp-specialised block (setmaxnreg, sm_90a)
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- TMA: one box of a 3-D tensor map into shared memory, its bytes
// counted on `bar`; the map is a __grid_constant__ kernel parameter
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// generic-proxy writes to shared memory (the bias fold) made visible to the
// async proxy (wgmma's operand reads, the next TMA write of the buffer);
// each writing thread fences, then the block syncs
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accesses of an accumulator across the
// asynchronous product's start and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle (layout type 1);
// offsets in bytes
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr(p) & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// a tile as a K-major operand (the head dim summed), k-step kk of 16
// columns: 32 bytes into each swizzled row; 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k(const void* tile, int kk) {
  return desc(static_cast<const unsigned char*>(tile) + 32 * kk, 16, 1024);
}

// a tile as an MN-major operand (its rows summed, the head dim the N
// columns), k-step kk of 16 rows: 2048 bytes on; 8-row groups 1024 bytes
// apart; the next 64 columns would follow the tile (unused at N = 64)
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int kk) {
  return desc(static_cast<const unsigned char*>(tile) + 2048 * kk, kTileBytes, 1024);
}

#define CCMH_WG_D32                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define CCMH_WG_D16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define CCMH_WG_OUT16(d)                                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15])
#define CCMH_WG_OUT32(d)                                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (+)= A B^T over 16 columns: A [64][16] and B [N][16] K-major in
// shared memory, N = 64 or 16 (a streamed tile's last <= 16 rows);
// accumulate = 0 starts the sum
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                       int accumulate) {
  static_assert(N == 64 || N == 16, "m64n64k16 or m64n16k16");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CCMH_WG_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : CCMH_WG_OUT32(d)
        : "l"(da), "l"(db), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(da), "l"(db), "r"(accumulate));
  }
}

// d += A B over 16 rows of B: A [64][16] in registers (to_a), B [16][64]
// MN-major in shared memory
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CCMH_WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : CCMH_WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same over 8 columns in tf32 (the fp32 kernels, 3xTF32 below): A
// [64][8] K-major from shared memory or from registers (a[q]: rows g + 8 (q
// & 1), column t + 4 (q >> 1) of the warp's 16, wgmma's tf32 A layout), B
// [N][8] K-major from shared memory, N = 64, 32 (the fp32 backward's
// 32-row stages) or 16.  tf32 has no transpose bit.
template <int N>
__device__ __forceinline__ void mma32_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  static_assert(N == 64 || N == 32 || N == 16, "m64n64k8, m64n32k8 or m64n16k8");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " CCMH_WG_D32
        ", %32, %33, p, 1, 1;\n}\n"
        : CCMH_WG_OUT32(d)
        : "l"(da), "l"(db), "r"(accumulate));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " CCMH_WG_D16
        ", %16, %17, p, 1, 1;\n}\n"
        : CCMH_WG_OUT16(d)
        : "l"(da), "l"(db), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(da), "l"(db), "r"(accumulate));
  }
}

template <int N>
__device__ __forceinline__ void mma32_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  static_assert(N == 64 || N == 32 || N == 16, "m64n64k8, m64n32k8 or m64n16k8");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " CCMH_WG_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : CCMH_WG_OUT32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " CCMH_WG_D16
        ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : CCMH_WG_OUT16(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
}

#undef CCMH_WG_D32
#undef CCMH_WG_OUT32
#undef CCMH_WG_D16
#undef CCMH_WG_OUT16

// d = X Y^T over the head dim: X (the warpgroup's 64 rows) and the first
// N rows of Y
template <int N>
__device__ __forceinline__ void rows_times(float (&d)[N / 2], const void* x, const void* y) {
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) mma_ss<N>(d, desc_k(x, kk), desc_k(y, kk), kk > 0);
}

// the accumulator p (N columns) rounded to bf16 as the A operand of the
// N / 16 16-column steps of an rs product (columns 16 kk .. in a[kk])
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4], const float (&p)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = ccmh::mma::pack_bf16(p[8 * kk + 0], p[8 * kk + 1]);
    a[kk][1] = ccmh::mma::pack_bf16(p[8 * kk + 2], p[8 * kk + 3]);
    a[kk][2] = ccmh::mma::pack_bf16(p[8 * kk + 4], p[8 * kk + 5]);
    a[kk][3] = ccmh::mma::pack_bf16(p[8 * kk + 6], p[8 * kk + 7]);
  }
}

// d += A Y with A = to_a(p) over the first 16 KK rows of the tile y
// (MN-major)
template <int KK>
__device__ __forceinline__ void acc_times(float (&d)[32], const uint32_t (&a)[KK][4], const void* y) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) mma_rs(d, a[kk], desc_mn(y, kk));
}

// one product group: fence the registers, start, commit, wait
template <typename F, int N>
__device__ __forceinline__ void run(float (&d)[N], F start) {
  fence_regs(d);
  wg_fence();
  start();
  wg_commit();
  wg_wait0();
  fence_regs(d);
}

// dst[r][c] = (dst[r][c] + bias[c]) rounded to bf16 over rows 0..rows-1 of
// a swizzled tile, by the warpgroup's threads (thread tid keeps the
// bias's 16-byte chunk c = tid % 8, `bias`).  add.rn.bf16x2 rounds the
// exact sum once: the bits of the fp32 sum rounded to bf16, as two bf16
// values' sum is exact in fp32 or far from a bf16 tie.
__device__ __forceinline__ void fold_tile(unsigned char* tile, int rows, const uint4& bias,
                                          int tid) {
  const int c = tid & 7;
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&bias);
  for (int r = tid >> 3; r < rows; r += kWgThreads / 8) {
    uint4* p = reinterpret_cast<uint4*>(tile + r * kRowBytes + ((c ^ (r & 7)) << 4));
    uint4 x = *p;
    __nv_bfloat162* x2 = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int e = 0; e < 4; ++e) x2[e] = __hadd2(x2[e], b2[e]);
    *p = x;
  }
}

// the thread's 16-byte chunk of a head's bias slice, or zeros
__device__ __forceinline__ uint4 bias_chunk(const bf16* __restrict__ b, int tid) {
  return b == nullptr ? make_uint4(0, 0, 0, 0)
                      : *reinterpret_cast<const uint4*>(b + 8 * (tid & 7));
}

// exp(x) for the softmax: 2^(x log2 e) on the SFU (ex2.approx, within 2
// ulp of fp32's exp over the softmax's range, x <= 0): one multiply-add and
// one SFU op where expf takes about six instructions
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a row max m as the exponents take it: 0 for m = -inf, whose row's x are
// all -inf (then 2^-inf = 0)
__device__ __forceinline__ float finite_max(float m) { return m == -CUDART_INF_F ? 0.f : m; }

// m log2 e for a row max m (0 for m = -inf)
__device__ __forceinline__ float max_log2e(float m) { return finite_max(m) * kLog2e; }

// A tile's logits x = (q . k) * scale + mask in fp32, -inf past L.  A full
// tile without a mask (every tile of a tower but the last) keeps the raw
// products s, x = s * scale, and its exponentials take the scale into
// their multiply-add: exp(x - m) = 2^(s c - m log2 e) with c = scale log2
// e (the same value up to fp32 rounding of the exponent, far under bf16's
// rounding of p).  Tile::c and Tile::cm are the multipliers of s in an
// exponent and in a max.  The exponent's form is the call's (a kernel's
// MASK parameter): without a mask every tile, the last one too (keys past
// L at -inf), takes that single multiply-add; with one, every tile forms
// it from x - m first, exact where x = m: a row that a large finite mask
// covers entirely (x = m = -1e9, say) has m log2 e rounded by up to 64
// there, which the multiply-add would carry into the exponent (a row
// summing to 2^+-64), where ccmh and the plain softmax give a uniform row.
struct Tile {
  bool plain;
  float c, cm;
  __device__ Tile(const float* mask, int j0, int L, float scale)
      : plain(mask == nullptr && j0 + kRows <= L), c(plain ? scale * kLog2e : kLog2e),
        cm(plain ? scale : 1.f) {}
};

// Off the plain path, the logits in place: rows i0 and i0 + 8, columns
// j0 + 8 j + 2 t (+1) (logit: each step rounded on its own).
template <int N>
__device__ __forceinline__ void logits(float (&s)[N / 2], const Tile& tile, float scale,
                                       const float* __restrict__ mask, int i0, int j0, int L,
                                       int t) {
  if (tile.plain) return;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * j + e] = ccmh::mma::logit(s[4 * j + e], scale, mask, i0 + 8 * (e >> 1),
                                      j0 + 8 * j + 2 * t + (e & 1), L);
}

// A row's softmax statistics after the stats pass, in the two forms the
// exponentials take (Tile): lse2 = m log2 e + log2 sum for the single
// multiply-add of a call without a mask, m and log2 sum apart for one with
// a mask.  m is the row max, 0 for a row with no key; log2 sum is then
// -inf and p NaN, as the plain softmax's.
struct RowLse {
  float lse2, m, l2;
};

// p = exp(x - m) / sum of one element of a tile: s the raw product on a
// plain tile, else the logit x
template <bool MASK>
__device__ __forceinline__ float prob(float s, const Tile& tile, const RowLse& r) {
  if constexpr (MASK)
    return ex2(fmaf(s - r.m, kLog2e, -r.l2));
  else
    return ex2(fmaf(s, tile.c, -r.lse2));
}

// p in place over a tile's N columns of the rows g and g + 8
template <bool MASK, int N>
__device__ __forceinline__ void probs(float (&s)[N / 2], const Tile& tile, const RowLse (&rl)[2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s[i] = prob<MASK>(s[i], tile, rl[(i >> 1) & 1]);
}

// Row statistics over the tiles of an accumulator (the rows g and g + 8 of
// a thread): the running max mx, l = sum_j exp(x_j - mx) and dn = sum_j
// exp(x_j - mx) dp_j (the backward's D numerator), rescaled as mx grows,
// once a tile, each exponential in the call's form (Tile).  Partial sums
// stay per lane until finish().
struct Stats64 {
  float mx[2], l[2], dn[2];

  __device__ void init() {
    mx[0] = mx[1] = -CUDART_INF_F;
    l[0] = l[1] = dn[0] = dn[1] = 0.f;
  }

  // s: a tile's N columns of logits, or its raw products on the plain
  // path (Tile); MASK: the call has a mask
  template <bool DP, bool MASK, int N>
  __device__ void add(const float (&s)[N / 2], const float (&dp)[N / 2], const Tile& tile) {
    float cm[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      cm[0] = fmaxf(cm[0], fmaxf(s[4 * j], s[4 * j + 1]));
      cm[1] = fmaxf(cm[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    float mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // round(max s * scale) = max round(s * scale): the multiply is monotone
      const float nm = fmaxf(mx[r], ccmh::mma::quad_max(cm[r]) * tile.cm);
      if (nm != mx[r]) {
        const float corr = mx[r] == -CUDART_INF_F ? 0.f : ex2((mx[r] - nm) * kLog2e);
        l[r] *= corr;
        dn[r] *= corr;
        mx[r] = nm;
      }
      mb[r] = MASK ? finite_max(mx[r]) : max_log2e(mx[r]);
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float p = MASK ? ex2((s[i] - mb[r]) * kLog2e) : ex2(fmaf(s[i], tile.c, -mb[r]));
      l[r] += p;
      if (DP) dn[r] += p * dp[i];
    }
  }

  // row r's statistics after finish() in the forms prob() takes
  __device__ RowLse row(int r) const {
    const float l2 = log2f(l[r]);
    return {max_log2e(mx[r]) + l2, finite_max(mx[r]), l2};
  }

  __device__ void finish() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = ccmh::mma::quad_sum(l[r]);
      dn[r] = ccmh::mma::quad_sum(dn[r]);
    }
  }
};

// The softmax of the one-pass kernels (#1's bf16 forward, #2's bf16 query
// side), which hold a query tile's whole row of logits in registers.
// tile_max: a tile's row maxima in logit units (raw products times scale on
// a plain tile: the multiply is monotone) folded into the thread's mx
template <int N>
__device__ __forceinline__ void tile_max(const float (&s)[N / 2], const Tile& tile,
                                         float (&mx)[2]) {
  float cm[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) cm[(i >> 1) & 1] = fmaxf(cm[(i >> 1) & 1], s[i]);
  mx[0] = fmaxf(mx[0], cm[0] * tile.cm);
  mx[1] = fmaxf(mx[1], cm[1] * tile.cm);
}

// e = exp(x - m) in place over a tile (the exponent in the call's form,
// Tile), summed into the thread's l; mb: m log2 e without a mask, m with one
template <bool MASK, int N>
__device__ __forceinline__ void tile_exp(float (&s)[N / 2], const Tile& tile,
                                         const float (&mb)[2], float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = MASK ? ex2((s[i] - mb[r]) * kLog2e) : ex2(fmaf(s[i], tile.c, -mb[r]));
    l[r] += s[i];
  }
}

// ---- fp32 as 3xTF32 (the fp32 kernels)
//
// wgmma's .tf32 products (m64nNk8: 8 fp32 columns a step) read their
// shared-memory operands only K-major.  An fp32 tile of [64 rows][64 fp32]
// = 16 KB is two 128-byte swizzle atoms: atom a holds columns 32 a .. 32 a
// + 31 of every row (8 KB; row r at byte r * 128, its 16-byte chunk c at
// chunk c ^ (r & 7)), which TMA lands as two boxes of [64][32] fp32 with
// the 128-byte swizzle; k-step kk reads 32 bytes of each row of atom kk /
// 4.  Every operand x is split into hi = x with its low 13 mantissa bits
// cleared and lo = x - hi the same way (toward zero, split_tz), and a
// product is lo.hi' + hi.lo' + hi.hi' summed in fp32, each k-step in that
// order.  The block's threads write the hi and lo tiles of a landed tile
// (split_tile), the projection bias added in fp32 first.  A product that
// sums over a tile's rows (P V, P^T dO, dS^T Q, dS K) reads it transposed,
// which split_tile_t writes, its rows in the order in which an
// accumulator's columns enter as the A operand from registers
// (acc_to_a32): no shuffle, and no transposed copy of P or dS.

constexpr int kAtomBytes = kRows * 128;     // 8 KB: [64 rows][32 fp32]
constexpr int kTile32 = 2 * kAtomBytes;     // 16 KB: [64 rows][64 fp32]

// byte offset of element (r, c) of an fp32 tile
__device__ __forceinline__ int off32(int r, int c) {
  return (c >> 5) * kAtomBytes + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// an fp32 tile as a K-major tf32 operand, k-step kk of 8 columns; R: the
// tile's rows (64, or 32 for the fp32 backward's streamed stages, whose
// atoms are [32 rows][32 fp32] = 4 KB)
template <int R = kRows>
__device__ __forceinline__ uint64_t desc_k32(const void* tile, int kk) {
  return desc(static_cast<const unsigned char*>(tile) + (kk >> 2) * (R * 128) + 32 * (kk & 3), 16,
              1024);
}

// byte offset of element (r, c) of an fp32 tile of R rows
template <int R>
__device__ __forceinline__ int off32r(int r, int c) {
  return (c >> 5) * (R * 128) + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

__device__ __forceinline__ void split4(const float4& x, float4& hi, float4& lo) {
  uint32_t h, l;
  ccmh::mma::split_tz(x.x, h, l);
  hi.x = __uint_as_float(h), lo.x = __uint_as_float(l);
  ccmh::mma::split_tz(x.y, h, l);
  hi.y = __uint_as_float(h), lo.y = __uint_as_float(l);
  ccmh::mma::split_tz(x.z, h, l);
  hi.z = __uint_as_float(h), lo.z = __uint_as_float(l);
  ccmh::mma::split_tz(x.w, h, l);
  hi.w = __uint_as_float(h), lo.w = __uint_as_float(l);
}

// lo = x - hi of the split toward zero, itself cut to tf32 (split_tz's lo)
__device__ __forceinline__ float lo_tz(float x) {
  const float hi = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  return __uint_as_float(__float_as_uint(x - hi) & 0xffffe000u);
}

__device__ __forceinline__ float4 lo4(const float4& x) {
  return make_float4(lo_tz(x.x), lo_tz(x.y), lo_tz(x.z), lo_tz(x.w));
}

// The fp32 backward past 128 tokens keeps each operand as the fp32 value
// itself and its lo: the tensor cores ignore the low 13 mantissa bits of a
// raw fp32 operand (chip_smoke.py checks it before the first fp32 long
// launch), so x is its own hi, bit for bit split_tz's in the product.
// These run in a producer warpgroup of few registers: their loops are not
// unrolled, which unrolled spilled.
// fold_lo: rows 0..NR-1 of a landed tile of TR rows, bias[c] (device
// memory, or null) added in place to the rows below nb (rows past the
// sequence landed as zeros and stay so), and lo written beside; by one
// warpgroup, 16-byte chunks in their swizzled places.
template <int TR, int NR>
__device__ __forceinline__ void fold_lo(unsigned char* x, unsigned char* lo, int nb,
                                        const float* __restrict__ bias, int tid) {
#pragma unroll 1
  for (int i = 0; i < 2 * NR * 8 / kWgThreads; ++i) {
    const int q = tid + i * kWgThreads;
    const int a = q / (NR * 8), r = (q >> 3) % NR, c = q & 7;
    const int off = a * (TR * 128) + r * 128 + c * 16;
    float4 v = *reinterpret_cast<const float4*>(x + off);
    if (bias != nullptr && r < nb) {
      const float4 b = __ldg(reinterpret_cast<const float4*>(bias + 32 * a + 4 * (c ^ (r & 7))));
      v.x += b.x;
      v.y += b.y;
      v.z += b.z;
      v.w += b.w;
      *reinterpret_cast<float4*>(x + off) = v;
    }
    *reinterpret_cast<float4*>(lo + off) = lo4(v);
  }
}

// The transpose of rows 0..NX-1 of a folded tile of TR rows into a [64][32]
// tile and its lo, in split_tile_t's order (row n holds column n; source
// row 8 j + 2 i + h at column 8 j + 4 h + i, acc_to_a32's k order), by one
// warpgroup: thread tid writes row tid % 64, a 16-byte chunk at a time.
template <int TR, int NX>
__device__ __forceinline__ void transpose_lo(unsigned char* xt, unsigned char* lo,
                                             const unsigned char* x, int tid) {
  const int n = tid & 63;
#pragma unroll 1
  for (int it = 0; it < NX / 8; ++it) {
    const int cc = 2 * it + (tid >> 6);
    const int x0 = 8 * (cc >> 1) + (cc & 1);
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = *reinterpret_cast<const float*>(x + off32r<TR>(x0 + 2 * i, n));
    const float4 f = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(xt + off32(n, 4 * cc)) = f;
    *reinterpret_cast<float4*>(lo + off32(n, 4 * cc)) = lo4(f);
  }
}

// The hi and lo tiles of rows 0..NR-1 of a landed fp32 tile (NR = 64, or
// 16 for a last tile of <= 16 rows), bias[c] (device memory, or null) added
// first to the rows below nb: rows past the sequence landed as zeros and
// stay so.  16-byte chunks, kept in their swizzled places.
template <int NR>
__device__ __forceinline__ void split_tile(unsigned char* hi, unsigned char* lo,
                                           const unsigned char* raw, int nb,
                                           const float* __restrict__ bias, int tid) {
#pragma unroll
  for (int i = 0; i < 2 * NR * 8 / kWgThreads; ++i) {
    const int q = tid + i * kWgThreads;
    const int a = q / (NR * 8), r = (q >> 3) % NR, c = q & 7;
    const int off = a * kAtomBytes + r * 128 + c * 16;
    float4 x = *reinterpret_cast<const float4*>(raw + off);
    if (bias != nullptr && r < nb) {
      const float4 b = __ldg(reinterpret_cast<const float4*>(bias + 32 * a + 4 * (c ^ (r & 7))));
      x.x += b.x;
      x.y += b.y;
      x.z += b.z;
      x.w += b.w;
    }
    float4 h, l;
    split4(x, h, l);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// The hi and lo tiles of the transpose of rows 0..NX-1 of a landed fp32
// tile, bias[n] added first to the rows below nb: row n of the result
// holds column n, row x = 8 j + 2 i + h of the source at column 8 j + 4 h
// + i (the k order of acc_to_a32).  Thread tid writes row n = tid % 64, a
// 16-byte chunk at a time; each warp reads 32 columns of a source row
// and writes 32 rows, without bank conflicts.
template <int NX>
__device__ __forceinline__ void split_tile_t(unsigned char* hi, unsigned char* lo,
                                             const unsigned char* raw, int nb,
                                             const float* __restrict__ bias, int tid) {
  const int n = tid & 63;
  const float b = bias != nullptr ? __ldg(bias + n) : 0.f;
#pragma unroll
  for (int it = 0; it < NX / 8; ++it) {
    const int cc = 2 * it + (tid >> 6);      // the 16-byte chunk of row n: columns 4 cc ..
    const int x0 = 8 * (cc >> 1) + (cc & 1);
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int x = x0 + 2 * i;
      v[i] = *reinterpret_cast<const float*>(raw + off32(x, n));
      if (x < nb) v[i] += b;
    }
    float4 h, l;
    split4(make_float4(v[0], v[1], v[2], v[3]), h, l);
    *reinterpret_cast<float4*>(hi + off32(n, 4 * cc)) = h;
    *reinterpret_cast<float4*>(lo + off32(n, 4 * cc)) = l;
  }
}

// The A fragments (hi, lo) of the warp's rows 16 w + g and + 8 of a landed
// fp32 tile, bias[c] added first to the rows below nb: k-step kk takes
// columns 8 kk + t and 8 kk + t + 4 (mma32_rs).
__device__ __forceinline__ void a_rows32(uint32_t (&hi)[8][4], uint32_t (&lo)[8][4],
                                         const unsigned char* raw, int nb,
                                         const float* __restrict__ bias, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 16 * warp + g + 8 * (q & 1), c = 8 * kk + t + 4 * (q >> 1);
      float x = *reinterpret_cast<const float*>(raw + off32(r, c));
      if (bias != nullptr && r < nb) x += __ldg(bias + c);
      ccmh::mma::split_tz(x, hi[kk][q], lo[kk][q]);
    }
}

// Columns 8 J0 .. 8 (J0 + KK) - 1 of an accumulator p as the A operand
// (hi, lo) of KK tf32 k-steps: columns 8 j + 2 t and 8 j + 2 t + 1 are k =
// t and t + 4 of step j, so the B tile lists its rows in that order
// (split_tile_t).
template <int J0, int KK, int M>
__device__ __forceinline__ void acc_to_a32_part(uint32_t (&hi)[KK][4], uint32_t (&lo)[KK][4],
                                                const float (&p)[M]) {
#pragma unroll
  for (int i = 0; i < KK; ++i) {
    const int j = J0 + i;
    ccmh::mma::split_tz(p[4 * j + 0], hi[i][0], lo[i][0]);
    ccmh::mma::split_tz(p[4 * j + 2], hi[i][1], lo[i][1]);
    ccmh::mma::split_tz(p[4 * j + 1], hi[i][2], lo[i][2]);
    ccmh::mma::split_tz(p[4 * j + 3], hi[i][3], lo[i][3]);
  }
}

// all N columns
template <int N>
__device__ __forceinline__ void acc_to_a32(uint32_t (&hi)[N / 8][4], uint32_t (&lo)[N / 8][4],
                                           const float (&p)[N / 2]) {
  acc_to_a32_part<0, N / 8>(hi, lo, p);
}

// d = X Y^T over the 64 columns, 3xTF32: X's 64 rows (hi, lo tiles) and
// the first N rows of Y's (hi, lo tiles of YR rows)
template <int N, int YR = kRows>
__device__ __forceinline__ void rows_times32(float (&d)[N / 2], const void* xh, const void* xl,
                                             const void* yh, const void* yl) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    mma32_ss<N>(d, desc_k32(xl, kk), desc_k32<YR>(yh, kk), kk > 0);
    mma32_ss<N>(d, desc_k32(xh, kk), desc_k32<YR>(yl, kk), 1);
    mma32_ss<N>(d, desc_k32(xh, kk), desc_k32<YR>(yh, kk), 1);
  }
}

// the same with X's A fragments in registers (a_rows32)
template <int N, int YR = kRows>
__device__ __forceinline__ void rows_times32(float (&d)[N / 2], const uint32_t (&xh)[8][4],
                                             const uint32_t (&xl)[8][4], const void* yh,
                                             const void* yl) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    mma32_rs<N>(d, xl[kk], desc_k32<YR>(yh, kk), kk > 0);
    mma32_rs<N>(d, xh[kk], desc_k32<YR>(yl, kk), 1);
    mma32_rs<N>(d, xh[kk], desc_k32<YR>(yh, kk), 1);
  }
}

// d += A Y over rows 8 J0 .. 8 (J0 + KK) - 1 of Y: A = acc_to_a32_part of
// an accumulator, Y transposed in the tiles th, tl (split_tile_t), 3xTF32
template <int KK, int J0 = 0>
__device__ __forceinline__ void acc_times32(float (&d)[32], const uint32_t (&ah)[KK][4],
                                            const uint32_t (&al)[KK][4], const void* th,
                                            const void* tl) {
#pragma unroll
  for (int i = 0; i < KK; ++i) {
    const int j = J0 + i;
    mma32_rs<64>(d, al[i], desc_k32(th, j), 1);
    mma32_rs<64>(d, ah[i], desc_k32(tl, j), 1);
    mma32_rs<64>(d, ah[i], desc_k32(th, j), 1);
  }
}

// The lo halves of an accumulator p's A fragments (acc_to_a32's order):
// p itself is their hi (fold_lo)
template <int N>
__device__ __forceinline__ void lo_a32(uint32_t (&lo)[N / 8][4], const float (&p)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    lo[j][0] = __float_as_uint(lo_tz(p[4 * j + 0]));
    lo[j][1] = __float_as_uint(lo_tz(p[4 * j + 2]));
    lo[j][2] = __float_as_uint(lo_tz(p[4 * j + 1]));
    lo[j][3] = __float_as_uint(lo_tz(p[4 * j + 3]));
  }
}

// d += A Y over the first 8 KK rows of Y: A = an accumulator p (its own
// hi) and lo_a32(p), Y transposed in xt and its lo (transpose_lo), 3xTF32
template <int KK, int M>
__device__ __forceinline__ void acc_times32_raw(float (&d)[32], const float (&p)[M],
                                                const uint32_t (&al)[KK][4], const void* xt,
                                                const void* lo) {
#pragma unroll
  for (int j = 0; j < KK; ++j) {
    const uint32_t ah[4] = {__float_as_uint(p[4 * j + 0]), __float_as_uint(p[4 * j + 2]),
                            __float_as_uint(p[4 * j + 1]), __float_as_uint(p[4 * j + 3])};
    mma32_rs<64>(d, al[j], desc_k32(xt, j), 1);
    mma32_rs<64>(d, ah, desc_k32(lo, j), 1);
    mma32_rs<64>(d, ah, desc_k32(xt, j), 1);
  }
}

// the two TMA boxes of an fp32 tile (64 rows from row c1, columns c0 ..
// c0 + 63), counted on bar
__device__ __forceinline__ void tma_tile32(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                           int c1, int c2) {
  tma_load(dst, map, bar, c0, c1, c2);
  tma_load(static_cast<unsigned char*>(dst) + kAtomBytes, map, bar, c0 + 32, c1, c2);
}

// the two TMA boxes of a streamed [32 rows][64 fp32] tile (a map of
// 32-row boxes), counted on bar
__device__ __forceinline__ void tma_half32(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                           int c1, int c2) {
  tma_load(dst, map, bar, c0, c1, c2);
  tma_load(static_cast<unsigned char*>(dst) + kAtomBytes / 2, map, bar, c0 + 32, c1, c2);
}

// ---- host: tensor maps through cuTensorMapEncodeTiled, its entry point
// fetched by the CUDA runtime (so the library links no -lcuda)

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// How a tensor map lands its boxes: bf16 with the 128-byte swizzle (box =
// 64 values, one swizzle row), fp32 with it (box = 32, one atom of an fp32
// tile), or fp32 unswizzled (the bf16 backward's row statistics, box = 4).
enum MapKind { kMapBf16 = 0, kMapF32 = 1, kMapF32Plain = 2 };

// A [batch][rows][width] tensor whose rows are `ld` elements apart, in boxes
// of [1][box_rows][box] elements from column c0 (the kernel's coordinate).
inline cudaError_t make_map(CUtensorMap* map, const void* base, MapKind kind, uint64_t width,
                            uint64_t rows, uint64_t batch, uint64_t ld, uint32_t box,
                            uint32_t box_rows = kRows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const uint64_t item = kind == kMapBf16 ? 2 : 4;
  const cuuint64_t dims[3] = {width, rows, batch};
  const cuuint64_t strides[2] = {ld * item, rows * ld * item};
  const cuuint32_t boxes[3] = {box, box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, kind == kMapBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        3, const_cast<void*>(base), dims, strides, boxes, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        kind == kMapF32Plain ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wg
}  // namespace ccmh
