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
// What bounds it on an H100: bytes.  The vision call at B=256 fp32 must
// read 118 MB of qkv and write 39 MB of context (~47 us at 3.35 TB/s); its
// 2 GFLOP of dot products are under 30 us even on the fp32 CUDA cores.
//
// Design: one block per (batch element, head).  The head's q, k and v are
// read once from device memory into shared memory as fp32; nothing of the
// [L, L] logits ever leaves the SM.  Rows are padded to a multiple of 4
// floats plus 4 (stride 68 at Dh=64): 16-byte aligned for float4 reads, and
// eight lanes reading eight different key rows hit eight different 16-byte
// bank groups.  Each warp carries 4 query rows at once, so every k (or v)
// value read from shared memory feeds 4 FMAs: a lane owns keys
// j = lane + 32 t (t < 4, so L <= 128) and keeps the 4 rows' logits in
// registers; the row max and sum are warp shuffles.  For ctx a lane owns the
// head-dim pair d = 64 c + 2 lane (+1) (c < 2, so Dh <= 128), the
// probabilities are broadcast by shuffle, and the stores are coalesced.
// Both products sum over their index in order, one FMA at a time.  Shared
// memory is 3 L (Dh + 4) * 4 bytes: 41 KB at L=50, 63 KB at L=77 (above the
// 48 KB default, hence cudaFuncSetAttribute), 203 KB at the L=Dh=128 limit.
// Simple first: no tensor cores, no TMA; the dot products run on fp32 FMAs.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 4;                 // query rows a warp carries at once
constexpr int kMaxL = 128;
constexpr int kMaxDh = 128;
constexpr int kKeySlots = kMaxL / 32;    // keys j = lane + 32 t
constexpr int kDimPairs = kMaxDh / 64;   // dims d = 64 c + 2 lane, +1

__host__ __device__ __forceinline__ int padded_dim(int Dh) { return (Dh + 3) & ~3; }
__host__ __device__ __forceinline__ int row_stride(int Dh) { return padded_dim(Dh) + 4; }

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_kernel(const T* __restrict__ qkv, const T* __restrict__ qkv_b,
                     const float* __restrict__ mask, T* __restrict__ out,
                     int L, int H, int Dh, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int dp = padded_dim(Dh);
  const int ld = row_stride(Dh);
  const int b = blockIdx.x, h = blockIdx.y;
  const int D = H * Dh, D3 = 3 * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // q | k | v of head h -> shared memory, bias added in the input type.  A
  // warp copies one (part, row) at a time with its lanes along the head dim:
  // coalesced reads, and the index arithmetic is per row, not per element.
  // The padding columns Dh..dp-1 are zero and add nothing to the dots.
  for (int pr = warp; pr < 3 * L; pr += kWarps) {
    const int part = pr / L;
    const int l = pr - part * L;
    const int col = part * D + h * Dh;
    const T* src = qkv + ((size_t)b * L + l) * D3 + col;
    float* dst = smem + (part * L + l) * ld;
    for (int d = lane; d < dp; d += 32) {
      float x = 0.f;
      if (d < Dh) {
        x = ccmh::to_float(src[d]);
        if (qkv_b != nullptr) x = ccmh::round_to<T>(x + ccmh::to_float(qkv_b[col + d]));
      }
      dst[d] = x;
    }
  }
  __syncthreads();

  const float* sq = smem;
  const float* sk = smem + L * ld;
  const float* sv = smem + 2 * L * ld;
  const int n_slots = (L + 31) >> 5;

  for (int i0 = warp * kRows; i0 < L; i0 += kWarps * kRows) {
    // rows past L are clamped to L-1 for reading and never stored
    int row[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) row[r] = min(i0 + r, L - 1);

    float s[kRows][kKeySlots];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int t = 0; t < kKeySlots; ++t) s[r][t] = 0.f;

    for (int d = 0; d < dp; d += 4) {
      float4 qv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        qv[r] = *reinterpret_cast<const float4*>(sq + row[r] * ld + d);
#pragma unroll
      for (int t = 0; t < kKeySlots; ++t) {
        if (t < n_slots) {   // warp-uniform
          const int j = min(t * 32 + lane, L - 1);
          const float4 kv = *reinterpret_cast<const float4*>(sk + j * ld + d);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            float a = s[r][t];
            a = fmaf(qv[r].x, kv.x, a);
            a = fmaf(qv[r].y, kv.y, a);
            a = fmaf(qv[r].z, kv.z, a);
            a = fmaf(qv[r].w, kv.w, a);
            s[r][t] = a;
          }
        }
      }
    }

    // fp32 softmax per row; probabilities rounded to the input type
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float row_max = -CUDART_INF_F;
#pragma unroll
      for (int t = 0; t < kKeySlots; ++t) {
        const int j = t * 32 + lane;
        float logit = -CUDART_INF_F;
        if (j < L) {
          logit = s[r][t] * scale;
          if (mask != nullptr) logit += mask[row[r] * L + j];
        }
        s[r][t] = logit;
        row_max = fmaxf(row_max, logit);
      }
      row_max = ccmh::warp_max(row_max);
      float row_sum = 0.f;
#pragma unroll
      for (int t = 0; t < kKeySlots; ++t) {
        const float e = (t * 32 + lane < L) ? expf(s[r][t] - row_max) : 0.f;
        s[r][t] = e;
        row_sum += e;
      }
      row_sum = ccmh::warp_sum(row_sum);
#pragma unroll
      for (int t = 0; t < kKeySlots; ++t) s[r][t] = ccmh::round_to<T>(s[r][t] / row_sum);
    }

    // ctx = p . v over the keys in order
    float2 acc[kRows][kDimPairs];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kDimPairs; ++c) acc[r][c] = make_float2(0.f, 0.f);
#pragma unroll
    for (int t = 0; t < kKeySlots; ++t) {
      if (t >= n_slots) break;   // warp-uniform
      const int n_keys = min(32, L - t * 32);
      for (int u = 0; u < n_keys; ++u) {
        float p[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) p[r] = __shfl_sync(0xffffffffu, s[r][t], u);
        const float* vj = sv + (t * 32 + u) * ld;
#pragma unroll
        for (int c = 0; c < kDimPairs; ++c) {
          const int d = c * 64 + 2 * lane;
          if (d < dp) {
            const float2 vv = *reinterpret_cast<const float2*>(vj + d);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              acc[r][c].x = fmaf(p[r], vv.x, acc[r][c].x);
              acc[r][c].y = fmaf(p[r], vv.y, acc[r][c].y);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (i0 + r >= L) break;   // warp-uniform
      T* o = out + ((size_t)b * L + i0 + r) * D + h * Dh;
#pragma unroll
      for (int c = 0; c < kDimPairs; ++c) {
        const int d = c * 64 + 2 * lane;
        if (d < Dh) o[d] = ccmh::from_float<T>(acc[r][c].x);
        if (d + 1 < Dh) o[d + 1] = ccmh::from_float<T>(acc[r][c].y);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* qkv, const void* qkv_b, const float* mask, void* out,
                   int B, int L, int H, int Dh, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)3 * L * row_stride(Dh) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, H);
  attention_fwd_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(qkv_b), mask,
      static_cast<T*>(out), L, H, Dh, scale);
  return cudaGetLastError();
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
