// The tensor cores' one-bit AND-popcount product as the packed Hamming
// kernel #3 (hamming.cu) runs it: the layout of its operand tiles in
// shared memory, the descriptor of one 256-bit k-step, and the warpgroup
// product wgmma .b1 m64n128k256 .and.popc with an s32 accumulator (SASS
// BGMMA).  ccmh_torch/tools/hamming_rate.cu times the same product alone.
//
// A tile is kTcRows rows of one operand; each row is held as up to two
// 128-byte atoms of 32 lanes (4 k-steps of 256 bits): atom a of a tile at
// a * kBitAtomBytes, row r at r * 128 in it, its 16-byte chunk c at chunk
// c ^ (r & 7) (CU_TENSOR_MAP_SWIZZLE_128B, which TMA writes and the wgmma
// descriptors read, as for the attention kernels' bf16 tiles: a k-step is
// 32 bytes of a row there too).

#pragma once

#include "common.cuh"
#include "wgmma_tiles.cuh"

namespace ccmh {
namespace ham {

constexpr int kTcThreads = 256;                     // two warpgroups
constexpr int kTcRows = 128;                        // query rows = gallery rows of a block
constexpr int kLanesPerAtom = 32;
constexpr int kBitAtomBytes = kTcRows * 128;        // 16 KB
constexpr int kStageRowBytes = kTcRows * 4;         // a row of 128 int32 distances
constexpr int kStageBytes = kTcRows * kStageRowBytes;  // 64 KB >= both tiles (<= 4 atoms)
constexpr int kTcSmem = 1024 + kStageBytes + 2 * kTcRows * 4 + 16;

static_assert(4 * kBitAtomBytes <= kStageBytes, "the staged tile overlays the operand tiles");

// byte offset of lane l of row r in a tile
__device__ __forceinline__ int lane_offset(int r, int l) {
  return (l >> 5) * kBitAtomBytes + r * 128 + ((((l & 31) >> 2) ^ (r & 7)) << 4) +
         ((l & 3) << 2);
}

// the descriptor of k-step ks (256 bits, 32 bytes of each row) of the 64
// or 128 rows of a tile from `rows`: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t kstep_desc(const unsigned char* rows, int ks) {
  return ccmh::wg::desc(rows + (ks >> 2) * kBitAtomBytes + 32 * (ks & 3), 16, 1024);
}

template <int N>
__device__ __forceinline__ void fence_acc(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= popc(A & B) over one k-step: A [64][256 bits] and B [128][256
// bits], both K-major in shared memory; accumulate = 0 starts the sum.  d
// is an m64n128 s32 accumulator: d[4 j + e] is row 16 w + g + 8 (e >> 1),
// column 8 j + 2 t + (e & 1) of the warpgroup's tile (w the warp of the
// warpgroup, g = lane / 4, t = lane % 4), as the fp32 ones.
__device__ __forceinline__ void and_popc(uint32_t (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

}  // namespace ham
}  // namespace ccmh
