// The shared-memory plan and the grid of #2's fp32 long backward past 128
// tokens (attention_bwd.cu, attention_bwd_wgmma32_ws: kernels 2 and 3 of the fp32
// wgmma family).  Plain C++ with no CUDA header, so the CPU tests compile
// this same plan with the host compiler and check that every kernel fits
// the 232,448 bytes a block may take on an H100 and that the blocks'
// resident rows cover each row of L exactly once.
//
// A block is three warpgroups: a producer that lands each streamed tile by
// TMA and writes its split, and two consumers, each with 64 resident rows
// (keys in kernel 2, queries in kernel 3), that share every split tile.  A
// block holds kBlockRows = 128 resident rows; its last consumer idles where
// the head's last block has 64 rows or fewer (L = 257: 128, 128, 1).
//
// Shared memory, fp32 tiles of [64 rows][64] = 16 KB, [32][64] and
// [64][32] = 8 KB:
//   * resident: the two consumers' folded tiles (x + bias, their own TF32 hi
//     operand) and their lo tiles: 4 x 16 KB.  The second resident tensor
//     (v in kernel 2, g in kernel 3) lands in the lo tiles first and is read
//     into register A operands before the lo tiles are written;
//   * a stage of kStreamRows = 32 streamed rows, landed in place and folded:
//     kernel 2 q, q lo, g, g lo, q^T, q^T lo, g^T, g^T lo (8 x 8 KB) and the
//     32 queries' row statistics (512 bytes, apart so each stage's tiles
//     start 1024-byte aligned); kernel 3 k, k lo, v, v lo, k^T, k^T lo
//     (6 x 8 KB);
//   * kDkDvStages = 2 and kDqStages = 3 stages, 1 KB of slack for the
//     1024-byte alignment of the swizzled tiles and 128 bytes of mbarriers.

#pragma once

namespace ccmh {
namespace bwd32 {

constexpr int kMaxSmem = 232448;     // bytes a block may take on an H100
constexpr int kConsumers = 2;        // consumer warpgroups a block
constexpr int kConsumerRows = 64;    // resident rows a consumer
constexpr int kBlockRows = kConsumers * kConsumerRows;
constexpr int kStreamRows = 32;      // streamed rows a stage
constexpr int kThreads = (1 + kConsumers) * 128;
constexpr int kTile = 64 * 64 * 4;            // [64][64] fp32
constexpr int kHalfTile = kStreamRows * 64 * 4;  // [32][64] or [64][32] fp32
constexpr int kStatsRow = 16;                 // a query's (lse2, D, m, log2 sum)
constexpr int kSlack = 1024;
constexpr int kBarBytes = 128;   // 3 x stages + 2 mbarriers

constexpr int kDkDvStages = 2;
constexpr int kDqStages = 3;
constexpr int kResidentBytes = 2 * kConsumers * kTile;
constexpr int kDkDvStageBytes = 8 * kHalfTile;
constexpr int kDqStageBytes = 6 * kHalfTile;
constexpr int kDkDvStatsBytes = kStreamRows * kStatsRow;   // a stage's queries' statistics

// dynamic shared memory of kernel 2 (dk dv) and kernel 3 (dq)
constexpr int kDkDvSmem =
    kSlack + kResidentBytes + kDkDvStages * (kDkDvStageBytes + kDkDvStatsBytes) + kBarBytes;
constexpr int kDqSmem = kSlack + kResidentBytes + kDqStages * kDqStageBytes + kBarBytes;

static_assert(kDkDvSmem <= kMaxSmem, "kernel 2 must fit one block's shared memory");
static_assert(kDqSmem <= kMaxSmem, "kernel 3 must fit one block's shared memory");

// blocks a (batch, head): ceil(L / kBlockRows)
inline int blocks_a_head(int L) { return (L + kBlockRows - 1) / kBlockRows; }

// the first resident row of consumer c of block blk, and its rows (0: idle)
inline int consumer_row0(int blk, int c) { return blk * kBlockRows + c * kConsumerRows; }
inline int consumer_rows(int L, int blk, int c) {
  const int n = L - consumer_row0(blk, c);
  return n <= 0 ? 0 : n < kConsumerRows ? n : kConsumerRows;
}

// stages over L streamed rows, and the rows of stage s
inline int stream_steps(int L) { return (L + kStreamRows - 1) / kStreamRows; }
inline int stream_rows(int L, int s) {
  const int n = L - s * kStreamRows;
  return n < kStreamRows ? n : kStreamRows;
}

}  // namespace bwd32
}  // namespace ccmh
