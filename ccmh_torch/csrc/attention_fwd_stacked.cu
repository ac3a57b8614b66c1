// The head-stacked attention forward of tools/bench_attn_bwd.py, for the
// short sequences of the CLIP towers (vision L=50, text L=32; Dh=64).
//
// Replaces: tools/bench_attn_bwd.py `forward_stacked` / `_fwd_kernel_stacked`
// (#7, a Pallas TPU kernel).  Kernel #1's function (attention.cu) with no
// projection bias: per batch element, every head's logits
// (q . k) * scale + mask in fp32 are stacked [H, L, L] before one fp32 row
// softmax over the stack; the probabilities are rounded to T and
// ctx = p . v, summed in fp32, is stored in T into out [B, L, D].
//
// What bounds it on an H100: bytes.  The vision call at B=256 bf16 reads
// 59 MB of qkv and writes 20 MB (24 us at 3.35 TB/s); its 2 GFLOP of dot
// products are far below that even on the fp32 CUDA cores.  The stacked
// schedule does not move fewer bytes; it is the TPU's way to run one long
// softmax chain, timed here against kernel #1's per-head one.
//
// Design: one block per bb batch elements (the TPU grid's batch block), a
// batch element at a time.  1. head by head, q and k into shared memory as
// fp32 and each head's [L, L] logits into a shared-memory stack: the
// stack [hg, L, ldt] of the largest head group that fits (all 12 heads at
// vision, 125 KB in fp32; at L=77 7 of 8); 2. one softmax pass over the
// group's rows, a warp a row; 3. head by head, v into shared memory and
// ctx = p . v, a warp carrying 4 query rows with the probabilities
// broadcast by shuffle.  The products sum in the order kernel #1 does,
// with the same fmaf chains.  Simple first: no tensor cores, no TMA.

#include "attention_rows.cuh"

namespace {

using namespace attn;

constexpr int kSlots = 4;   // L <= 128
constexpr int kMaxL = 128;

// q (then v) and k [L, ld], and the [hg, L, ldt] stack
size_t fwd_floats(int L, int Dh, int hg) {
  return 2 * (size_t)L * row_stride(Dh) + (size_t)hg * L * tile_stride(L);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32, 1)
fwd_stacked_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                   T* __restrict__ out, int B, int L, int H, int Dh, int bb, float scale,
                   int hg_max) {
  extern __shared__ __align__(16) float smem[];
  const int dp = padded_dim(Dh), ld = row_stride(Dh), ldt = tile_stride(L);
  const int D = H * Dh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* buf0 = smem;               // q, then v
  float* buf1 = smem + L * ld;      // k
  float* stack = smem + 2 * L * ld; // [hg, L, ldt]: logits, then probs rounded to T

  const int b0 = blockIdx.x * bb, b1 = min(B, b0 + bb);
  for (int b = b0; b < b1; ++b) {
    const size_t row0 = (size_t)b * L;
    for (int h0 = 0; h0 < H; h0 += hg_max) {
      const int hn = min(hg_max, H - h0);
      // 1. the group's logits, head by head
      for (int hg = 0; hg < hn; ++hg) {
        const int h = h0 + hg;
        __syncthreads();
        for (int pr = warp; pr < 2 * L; pr += kWarps) {
          const int part = pr / L, l = pr - part * L;   // q, k
          load_row<T>((part ? buf1 : buf0) + l * ld, qkv, static_cast<const T*>(nullptr),
                      row0 + l, part, h, Dh, D, dp, lane);
        }
        __syncthreads();
        float* st = stack + (size_t)hg * L * ldt;
        for (int i0 = warp * kRows; i0 < L; i0 += kWarps * kRows) {
          // rows past L are clamped to L-1 for reading and never stored
          const float* rows[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) rows[r] = buf0 + min(i0 + r, L - 1) * ld;
          float s[kRows][kSlots];
          dot_rows<kSlots>(rows, buf1, L, dp, ld, lane, s);
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
                st[i * ldt + j] = logit;
              }
            }
          }
        }
      }
      __syncthreads();
      // 2. one softmax pass over the group's rows, a warp a (head, row)
      for (int hr = warp; hr < hn * L; hr += kWarps) {
        float* row = stack + (size_t)hr * ldt;
        float x[kSlots];
        float m = -CUDART_INF_F;
#pragma unroll
        for (int t = 0; t < kSlots; ++t) {
          const int j = t * 32 + lane;
          x[t] = j < L ? row[j] : -CUDART_INF_F;
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
#pragma unroll
        for (int t = 0; t < kSlots; ++t) {
          const int j = t * 32 + lane;
          if (j < L) row[j] = ccmh::round_to<T>(x[t] / sum);
        }
      }
      // 3. ctx = p . v, head by head
      for (int hg = 0; hg < hn; ++hg) {
        const int h = h0 + hg;
        __syncthreads();
        for (int l = warp; l < L; l += kWarps)
          load_row<T>(buf0 + l * ld, qkv, static_cast<const T*>(nullptr), row0 + l, 2, h, Dh,
                      D, dp, lane);
        __syncthreads();
        const float* st = stack + (size_t)hg * L * ldt;
        for (int i0 = warp * kRows; i0 < L; i0 += kWarps * kRows) {
          float w[kRows][kSlots];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int t = 0; t < kSlots; ++t) {
              const int j = t * 32 + lane;
              w[r][t] = j < L ? st[min(i0 + r, L - 1) * ldt + j] : 0.f;
            }
          float2 acc[kRows][kDimPairs];
          zero(acc);
          weighted_rows<kSlots>(w, buf0, L, dp, ld, lane, acc);
          store_rows<T>(out, acc, row0 + i0, L - i0, D, h * Dh, Dh, lane);
        }
      }
      __syncthreads();   // the next group overwrites the stack
    }
  }
}

template <typename T>
cudaError_t launch(int device, const void* qkv, const float* mask, void* out, int B, int L,
                   int H, int Dh, int bb, float scale, cudaStream_t stream) {
  const int optin = smem_optin(device);
  int hg = H;   // the largest head group whose stack fits
  while (hg > 0 && fwd_floats(L, Dh, hg) * sizeof(float) > (size_t)optin) --hg;
  if (hg == 0) return cudaErrorInvalidValue;
  const size_t smem = fwd_floats(L, Dh, hg) * sizeof(float);
  cudaError_t err = set_smem(fwd_stacked_kernel<T>, smem, optin);
  if (err != cudaSuccess) return err;
  fwd_stacked_kernel<T><<<(B + bb - 1) / bb, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), mask, static_cast<T*>(out), B, L, H, Dh, bb, scale, hg);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, L, 3*H*Dh] and out [B, L, H*Dh] contiguous in `dtype` (0 fp32,
// 1 bf16); mask [L, L] fp32 or null; scale is 1/sqrt(Dh) rounded to fp32
// by the caller; a block walks bb batch elements.  Launches on `stream` of
// card `device` and returns cudaGetLastError() (0 = launched).
extern "C" int ccmh_attention_fwd_stacked(int device, const void* qkv, const float* mask,
                                          void* out, int B, int L, int H, int Dh, int bb,
                                          float scale, int dtype, void* stream) {
  if (B < 1 || bb < 1 || H < 1 || L < 1 || L > kMaxL || Dh < 1 || Dh > kMaxDh)
    return (int)cudaErrorInvalidValue;
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: name the card of the tensors
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ccmh::kFloat32:
      return (int)launch<float>(device, qkv, mask, out, B, L, H, Dh, bb, scale, s);
    case ccmh::kBFloat16:
      return (int)launch<__nv_bfloat16>(device, qkv, mask, out, B, L, H, Dh, bb, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
