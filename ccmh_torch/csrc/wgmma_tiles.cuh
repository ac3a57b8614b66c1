// Hopper building blocks of the long path of the attention kernels #1
// (attention.cu) and #2 (attention_bwd.cu) in bf16: warpgroup wgmma
// products on 64-row tiles, tiles landed by TMA in shared memory with the
// 128-byte swizzle, mbarriers that count the bytes landed, and the tensor
// maps that describe the packed qkv, g and dqkv rows to the TMA unit.
//
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

#undef CCMH_WG_D32
#undef CCMH_WG_OUT32

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

// m log2 e for a row max m (0 for m = -inf, whose row's x are all -inf:
// then 2^-inf = 0)
__device__ __forceinline__ float max_log2e(float m) {
  return m == -CUDART_INF_F ? 0.f : m * kLog2e;
}

// A tile's logits x = (q . k) * scale + mask in fp32, -inf past L.  A full
// tile without a mask (every tile of a tower but the last) keeps the raw
// products s, x = s * scale, and its exponentials take the scale into
// their multiply-add: exp(x - m) = 2^(s c - m log2 e) with c = scale log2
// e (the same value up to fp32 rounding of the exponent, far under bf16's
// rounding of p).  Tile::c and Tile::cm are the multipliers of s in an
// exponent and in a max.
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

// Row statistics over the tiles of an accumulator (the rows g and g + 8 of
// a thread): the running max mx, l = sum_j exp(x_j - mx) and dn = sum_j
// exp(x_j - mx) dp_j (the backward's D numerator), rescaled as mx grows,
// once a tile.  Partial sums stay per lane until finish().
struct Stats64 {
  float mx[2], l[2], dn[2];

  __device__ void init() {
    mx[0] = mx[1] = -CUDART_INF_F;
    l[0] = l[1] = dn[0] = dn[1] = 0.f;
  }

  // s: a tile's N columns of logits, or its raw products on the plain
  // path (Tile)
  template <bool DP, int N>
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
      mb[r] = max_log2e(mx[r]);
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float p = ex2(fmaf(s[i], tile.c, -mb[r]));
      l[r] += p;
      if (DP) dn[r] += p * dp[i];
    }
  }

  // row r's m log2 e + log2 sum after finish(): p = exp(x - m) / sum =
  // 2^(x log2 e - lse2), the normalisation inside the exponent (-inf for
  // a row with no key, whose p are then NaN, as the plain softmax's)
  __device__ float lse2(int r) const { return max_log2e(mx[r]) + log2f(l[r]); }

  __device__ void finish() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = ccmh::mma::quad_sum(l[r]);
      dn[r] = ccmh::mma::quad_sum(dn[r]);
    }
  }
};

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

// A [batch][rows][width] tensor whose rows are `ld` elements apart, in boxes
// of [1][64][box] elements from column c0 (the kernel's coordinate):
// bf16 with the 128-byte swizzle (box = 64), or fp32 unswizzled (the
// backward's row statistics, box = 4).
inline cudaError_t make_map(CUtensorMap* map, const void* base, bool is_bf16, uint64_t width,
                            uint64_t rows, uint64_t batch, uint64_t ld, uint32_t box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const uint64_t item = is_bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {width, rows, batch};
  const cuuint64_t strides[2] = {ld * item, rows * ld * item};
  const cuuint32_t boxes[3] = {box, static_cast<cuuint32_t>(kRows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        3, const_cast<void*>(base), dims, strides, boxes, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        is_bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wg
}  // namespace ccmh
