// The fixed rule by which the C entry of the packed Hamming kernel #3
// (hamming.cu) chooses a kernel family, which it reports for each launch
// so the wrapper counts launches by family.  Plain
// C++ with no CUDA header, so the CPU tests compile this same rule with the
// host compiler.  W = ceil(K / 32) lanes of 32 bits a code.  Both families
// are the tensor cores' one-bit AND-popcount product; they differ in how
// the tiles land in shared memory:
//   0 tma: codes past kHammingLanesMaxW lanes whose rows are a multiple of
//     16 bytes (W % 4 == 0), both operands 16-byte aligned: TMA boxes
//     (hamming_tc_kernel<true, KS>);
//   1 lanes: the rest, the short codes among them (rows of 4 to 32 bytes,
//     and of 36, 68, ... bytes, which no tensor map describes): the block's
//     threads, lane by lane, coalesced (hamming_tc_kernel<false, KS>).

#pragma once

#include <stdint.h>

namespace ccmh {

enum HammingFamily : int { kHammingTma = 0, kHammingLanes = 1 };

constexpr int kHammingMaxLanes = 64;   // K <= 2,048 bits: TwDH's longest centre code
// The cut-over: up to 8 lanes (256 bits) the lane loader, past it TMA where
// it can.  Measured by ccmh_torch/tools/time_hamming.py on an H100 80GB
// HBM3 at 700 W, Q = 512, N = 2^18: lanes / TMA 0.191 / 0.218 ms at K =
// 128, 0.200 / 0.204 at 256, 0.265 / 0.219 at 512.
constexpr int kHammingLanesMaxW = 8;

inline bool hamming_aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// whether TMA can land the tiles of q [Q, W] and r [N, W]
inline bool hamming_tma_ok(int W, const void* q, const void* r) {
  return W % 4 == 0 && hamming_aligned16(q) && hamming_aligned16(r);
}

inline int hamming_family(int W, const void* q, const void* r) {
  return W > kHammingLanesMaxW && hamming_tma_ok(W, q, r) ? kHammingTma : kHammingLanes;
}

}  // namespace ccmh
