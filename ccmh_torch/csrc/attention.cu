// Fused multi-head self-attention forward for the short sequences of the
// CLIP towers (vision L=50, text L=32..77; head dim 64).
//
// Replaces: ccmh/ops/attention.py `_pallas_forward` / `_kernel` (the Pallas
// TPU kernel).  Same function: per (batch element, head), q, k, v are cut
// from the packed [B, L, 3D] rows with the [3D] projection bias added in the
// INPUT type; logits = (q . k) * 1/sqrt(Dh) in fp32, plus the fp32 [L, L]
// additive mask; fp32 row softmax; probabilities rounded to the input type;
// ctx = p . v accumulated in fp32 and stored in the input type, [B, L, D].
//
// What bounds it on an H100: bytes.  At B=256 the vision call (L=50, H=12)
// reads 59 MB of qkv and writes 20 MB of context in bf16 (23 us at 3.35
// TB/s; fp32 twice that, 47 us), the text call (L=32, H=8) 25 + 8 MB (10
// us; fp32 20 us).  Its 4 B H L^2 Dh = 2.0 GFLOP (vision) take 2 us at the
// bf16 tensor-core peak (989 TFLOP/s) and 12 us as 3xTF32 (three TF32
// products at 495); the padding of L to 16 below makes that 3 and 20 us.
//
// Design: one block per (batch element, head), L/16 warps rounded up (4 at
// L=50, 2 at L=32, 5 at L=77, 8 at L=128), each warp one 16-query tile.
// q, k and v of the head are read once from device memory into shared
// memory in the input type, 16 bytes at a time where the head rows allow
// (Dh sizeof(T), the row stride and the pointers all multiples of 16;
// scalar loads otherwise, e.g. Dh=30 or a view at an odd offset), with the
// bias added in T: in bf16 on the 16-byte registers on the way in, in fp32
// by cp.async copies and then one pass over shared memory (each measured
// the faster for its type, mma_tiles.cuh load_qkv).  Rows and columns are
// zero-padded to 16.  Both products run on the tensor cores with mma.sync
// (bf16 m16n8k16; fp32 as 3xTF32 m16n8k8, which holds fp32 accuracy):
// S = q k^T stays in registers, its row max and sum are shuffles over the 4
// lanes that share a row, padded keys are -inf and their v rows zero; the
// probabilities are rounded to T and repacked in registers as the A operand
// of p . v (FlashAttention-2's register reuse: no [L, L] tile in shared
// memory, no shuffle broadcasts); ldmatrix feeds k and (transposed) v.  Each
// mask element is read once, by the one lane that holds that logit,
// straight into registers.  The context tile is staged in T over the warp's
// own q rows and written with coalesced 16-byte stores where aligned.
// Register arrays are sized by a class: L and Dh up to 64, or up to 128.
// Blocks an SM: bf16 at L, Dh <= 64 is held to 64 registers, so 8 blocks fit
// (4% faster at vision, PERF.md); fp32 spills at 64 and takes what it
// needs (4 blocks at vision, set by the 53 KB of shared memory).
// A persistent block that prefetched the next head into a second buffer
// measured slower: the buffers halve the blocks an SM.
//
// Shared memory, 3 pad16(L) (pad16(Dh) + 8 | 4) + 3 pad16(Dh) elements of
// T (bf16 | fp32) at Dh=64: L=32 14.2 KB bf16 / 26.9 KB fp32; L=50 28.0 /
// 53.0 KB; L=77 34.9 / 66.0 KB; L=128 55.7 / 105.2 KB (Dh=128: 105.2 /
// 204.3 KB).  Above 48 KB it needs cudaFuncSetAttribute.

#include "mma_tiles.cuh"

namespace {

using namespace ccmh::mma;

constexpr int kMaxL = 128;
constexpr int kMaxDh = 128;

// bf16 at L, Dh <= 64: 8 blocks an SM (64 registers), which measured
// faster; fp32 and Dh = 128 spill there, so they take what they need
template <typename T, int LMAX, int DMAX>
__global__ void __launch_bounds__(LMAX / 16 * 32,
                                  LMAX == 64 && DMAX == 64 && sizeof(T) == 2 ? 8 : 1)
attention_fwd_kernel(const T* __restrict__ qkv, const T* __restrict__ qkv_b,
                     const float* __restrict__ mask, T* __restrict__ out,
                     int L, int H, int Dh, float scale, int vec) {
  using F = Frag<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int Lp = pad16(L), Dp = pad16(Dh), ld = tile_ld<T>(Dh);
  const int b = blockIdx.x, h = blockIdx.y;
  const int D = H * Dh, D3 = 3 * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* sq = smem;
  T* sk = sq + Lp * ld;
  T* sv = sk + Lp * ld;
  T* sb = sv + Lp * ld;     // fp32: the bias, [3][Dp]

  load_qkv<T>(sq, Lp, ld, sb, qkv + (size_t)b * L * D3 + h * Dh, D, D3, L, Dh,
              qkv_b ? qkv_b + h * Dh : nullptr, vec);
  finish_qkv<T>(sq, Lp, ld, sb, L, Dh, qkv_b != nullptr, vec);

  const int m0 = warp * 16;
  const int n_kt = Lp / 16;     // 16-key blocks
  const int n_dk = Dp / 16;     // 16-dim blocks

  // S = q k^T for the warp's 16 queries against every key
  float s[LMAX / 8][4];
#pragma unroll
  for (int j = 0; j < LMAX / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  for (int kb = 0; kb < n_dk; ++kb) {
    const typename F::A a = F::a_rows(sq, ld, m0, kb * 16, lane);
#pragma unroll
    for (int jp = 0; jp < LMAX / 16; ++jp) {
      if (jp < n_kt) {
        typename F::B b0, b1;
        F::b_rows(b0, b1, sk, ld, jp * 16, kb * 16, lane);
        F::mma(s[2 * jp], a, b0);
        F::mma(s[2 * jp + 1], a, b1);
      }
    }
  }

  // fp32 softmax of the warp's rows, in registers
  float mx[2], sum[2];
  softmax_tile(s, (L + 7) / 8, scale, mask, m0, L, lane, mx, sum);

  // ctx = p . v, p rounded to T as it becomes the A operand
  float o[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
  for (int kb = 0; kb < LMAX / 16; ++kb) {
    if (kb < n_kt) {
      const typename F::A a = F::a_acc(s[2 * kb], s[2 * kb + 1]);
#pragma unroll
      for (int np = 0; np < DMAX / 16; ++np) {
        if (np < n_dk) {
          typename F::B b0, b1;
          F::b_cols(b0, b1, sv, ld, kb * 16, np * 16, lane);
          F::mma(o[2 * np], a, b0);
          F::mma(o[2 * np + 1], a, b1);
        }
      }
    }
  }

  // stage over the warp's own q rows (only this warp read them), then store
  __syncwarp();
  stage_acc<T>(sq + m0 * ld, ld, o, 2 * n_dk, lane);
  __syncwarp();
  if (m0 < L)
    store_rows<T>(out + ((size_t)b * L + m0) * D + h * Dh, D, sq + m0 * ld, ld,
                  min(16, L - m0), Dh, vec, lane);
}

template <typename T, int LMAX, int DMAX>
cudaError_t launch_class(const void* qkv, const void* qkv_b, const float* mask, void* out,
                         int B, int L, int H, int Dh, float scale, bool vec,
                         cudaStream_t stream) {
  const size_t smem = (size_t)3 * (pad16(L) * tile_ld<T>(Dh) + pad16(Dh)) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T, LMAX, DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, H);
  attention_fwd_kernel<T, LMAX, DMAX><<<grid, pad16(L) / 16 * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(qkv_b), mask, static_cast<T*>(out),
      L, H, Dh, scale, vec ? 1 : 0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* qkv, const void* qkv_b, const float* mask, void* out,
                   int B, int L, int H, int Dh, float scale, cudaStream_t stream) {
  // 16-byte copies need 16-byte head rows, row strides and base pointers
  const bool vec = (Dh * sizeof(T)) % 16 == 0 && aligned16(qkv) && aligned16(out) &&
                   (qkv_b == nullptr || aligned16(qkv_b));
  const bool small_l = pad16(L) <= 64, small_d = pad16(Dh) <= 64;
  if (small_l && small_d)
    return launch_class<T, 64, 64>(qkv, qkv_b, mask, out, B, L, H, Dh, scale, vec, stream);
  if (small_l)
    return launch_class<T, 64, 128>(qkv, qkv_b, mask, out, B, L, H, Dh, scale, vec, stream);
  if (small_d)
    return launch_class<T, 128, 64>(qkv, qkv_b, mask, out, B, L, H, Dh, scale, vec, stream);
  return launch_class<T, 128, 128>(qkv, qkv_b, mask, out, B, L, H, Dh, scale, vec, stream);
}

}  // namespace

// qkv [B, L, 3*H*Dh] and out [B, L, H*Dh] contiguous in `dtype`; qkv_b
// [3*H*Dh] in `dtype` or null; mask [L, L] fp32 or null; scale is
// 1/sqrt(Dh) rounded to fp32 by the caller.  Launches on `stream` of card
// `device` and returns cudaGetLastError() (0 = launched).
extern "C" int ccmh_attention_fwd(int device, const void* qkv, const void* qkv_b,
                                  const float* mask, void* out, int B, int L, int H,
                                  int Dh, float scale, int dtype, void* stream) {
  if (B < 1 || H < 1 || H > 65535 || L < 1 || L > kMaxL ||
      Dh < 1 || Dh > kMaxDh)
    return (int)cudaErrorInvalidValue;
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: name the card of the tensors
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ccmh::kFloat32:
      return (int)launch<float>(qkv, qkv_b, mask, out, B, L, H, Dh, scale, s);
    case ccmh::kBFloat16:
      return (int)launch<__nv_bfloat16>(qkv, qkv_b, mask, out, B, L, H, Dh, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
