// The fixed rule by which the C entries of the attention kernels #1
// (attention.cu) and #2 (attention_bwd.cu) choose a kernel family, which
// they also report (ccmh_attention_{fwd,bwd}_family) so the wrapper counts
// launches by family.  Plain C++ with no CUDA header, so the CPU tests
// compile this same rule with the host compiler.
//   0 short: L <= 128, a warp's [16, L] logits in registers;
//   2 long wgmma: past it, head dim 64 and every pointer 16-byte aligned
//     (TMA's boxes and the bias's 16-byte chunks; the packed rows, 3 H 64
//     and H 64 values, are multiples of 16 bytes), in bf16 or in fp32 (as
//     3xTF32): every CLIP tower past 128 tokens and MITH's concept
//     transformers past K = 128, in either compute type;
//   1 long mma.sync: the other shapes past 128 (other head dims, views at
//     odd offsets), attention_long.cuh;
//   3 long one-pass (#1's forward, attention_fwd_family; #2's below): of the
//     wgmma family, bf16 up to kOnePassMaxL keys, where a warpgroup's whole
//     [64, L] logit tile fits in its registers: one q k^T, one exponential
//     a logit (ViT-B/16's 197, ViT-L/14's 256 and 257).  Past it (@336's
//     577) and in fp32 the forward stays on the two-pass wgmma kernels;
//   4 long resident (#1's forward only): of the wgmma family, bf16 past
//     kOnePassMaxL up to kResidentMaxL keys, the two passes over the head's
//     k and v resident in shared memory (@336's 577).
// #2's backward (attention_bwd_family) takes family 3 too: of the wgmma
// family, bf16 up to kBwdOnePassMaxL keys, where a warpgroup's [64, L] fp32
// probabilities fit in its registers beside dq, one dP tile and one dS
// operand: the query side in one kernel (row statistics and dq), then the
// dk dv kernel (ViT-B/16, ViT-L/14).  Past it (@336) and in fp32 it stays
// on the three wgmma kernels.

#pragma once

#include <stdint.h>

namespace ccmh {

enum AttentionFamily : int {
  kFamilyShort = 0,
  kFamilyLongMma = 1,
  kFamilyLongWgmma = 2,
  kFamilyLongOnePass = 3,
  kFamilyLongResident = 4
};

constexpr int kShortMaxL = 128;      // the short kernels' L
constexpr int kWgmmaHeadDim = 64;    // the head dim of the wgmma kernels
constexpr int kOnePassMaxL = 336;    // 5 x 64 + 16 keys: the one-pass kernel's logit columns
constexpr int kResidentMaxL = 768;   // 12 key tiles: 2 x 96 KB of k and v, 4 q tiles
constexpr int kBwdOnePassMaxL = 272; // 4 x 64 + 16 keys: #2's one-pass query side

inline bool aligned16_or_null(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// p0..p3: the entry's tensors (#1: qkv, qkv_b, out; #2: qkv, qkv_b, g,
// dqkv), null where absent; dtype the entries' code (0 fp32, 1 bf16)
inline int attention_family(int L, int Dh, int dtype, const void* p0, const void* p1,
                            const void* p2, const void* p3) {
  if (L <= kShortMaxL) return kFamilyShort;
  const bool wgmma = (dtype == 0 || dtype == 1) && Dh == kWgmmaHeadDim && aligned16_or_null(p0) &&
                     aligned16_or_null(p1) && aligned16_or_null(p2) && aligned16_or_null(p3);
  return wgmma ? kFamilyLongWgmma : kFamilyLongMma;
}

// #1's forward: attention_family, with the bf16 wgmma shapes up to
// kOnePassMaxL keys on the one-pass kernel and past it up to kResidentMaxL
// on the resident one (p0..p2: qkv, qkv_b, out)
inline int attention_fwd_family(int L, int Dh, int dtype, const void* p0, const void* p1,
                                const void* p2) {
  const int family = attention_family(L, Dh, dtype, p0, p1, p2, nullptr);
  if (family != kFamilyLongWgmma || dtype != 1 || L > kResidentMaxL) return family;
  return L <= kOnePassMaxL ? kFamilyLongOnePass : kFamilyLongResident;
}

// #2's backward: attention_family, with the bf16 wgmma shapes up to
// kBwdOnePassMaxL keys on the one-pass query side (p0..p3: qkv, qkv_b, g,
// dqkv)
inline int attention_bwd_family(int L, int Dh, int dtype, const void* p0, const void* p1,
                                const void* p2, const void* p3) {
  const int family = attention_family(L, Dh, dtype, p0, p1, p2, p3);
  if (family != kFamilyLongWgmma || dtype != 1 || L > kBwdOnePassMaxL) return family;
  return kFamilyLongOnePass;
}

}  // namespace ccmh
