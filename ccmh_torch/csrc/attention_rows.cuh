// Row helpers of the FMA attention-variant kernel (attention_variants.cu:
// #8): the building blocks of kernel #2's two-phase design
// (attention_bwd.cu), generalised to any number of key slots a lane (S, so
// up to 32 S keys) and to global row indices, so that a block can walk
// several batch elements.  Tensors are row-major [rows, 3D] (qkv, dqkv) and
// [rows, D] (g, out); a head's row is fp32 in shared memory, padded to a
// multiple of 4 floats plus 4 (16-byte aligned float4 reads, and 8 lanes
// reading 8 different rows hit 8 different 16-byte bank groups).
#pragma once

#include "common.cuh"

namespace attn {

constexpr int kWarps = 8;
constexpr int kRows = 4;                 // rows a warp carries at once
constexpr int kMaxDh = 128;
constexpr int kDimPairs = kMaxDh / 64;   // dims d = 64 c + 2 lane, +1

__host__ __device__ __forceinline__ int padded_dim(int Dh) { return (Dh + 3) & ~3; }
__host__ __device__ __forceinline__ int row_stride(int Dh) { return padded_dim(Dh) + 4; }
__host__ __device__ __forceinline__ int tile_stride(int n) { return (n + 3) & ~3; }

// Global row `row` of head h as fp32 into dst[0..dp): q (part 0), k (1) or
// v (2) from qkv [rows, 3D], or g (part 3) from g [rows, D]; lanes along
// the head dim, the padding columns zero.
template <typename T>
__device__ __forceinline__ void load_row(float* dst, const T* __restrict__ qkv,
                                         const T* __restrict__ g, size_t row, int part,
                                         int h, int Dh, int D, int dp, int lane) {
  const T* src = part < 3 ? qkv + row * 3 * D + part * D + h * Dh : g + row * D + h * Dh;
  for (int d = lane; d < dp; d += 32) dst[d] = d < Dh ? ccmh::to_float(src[d]) : 0.f;
}

// s[r][t] = a[r] . A[c] for the warp's kRows rows a[r] and the lane's
// columns c = lane + 32 t (clamped to n - 1) of the shared-memory tensor A,
// summed over the head dim in order, one fmaf at a time.
template <int S>
__device__ __forceinline__ void dot_rows(const float* const (&a)[kRows], const float* A, int n,
                                         int dp, int ld, int lane, float (&s)[kRows][S]) {
  const int n_slots = (n + 31) >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int t = 0; t < S; ++t) s[r][t] = 0.f;
  for (int d = 0; d < dp; d += 4) {
    float4 av[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) av[r] = *reinterpret_cast<const float4*>(a[r] + d);
#pragma unroll
    for (int t = 0; t < S; ++t) {
      if (t < n_slots) {   // warp-uniform
        const int c = min(t * 32 + lane, n - 1);
        const float4 x = *reinterpret_cast<const float4*>(A + c * ld + d);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float acc = s[r][t];
          acc = fmaf(av[r].x, x.x, acc);
          acc = fmaf(av[r].y, x.y, acc);
          acc = fmaf(av[r].z, x.z, acc);
          acc = fmaf(av[r].w, x.w, acc);
          s[r][t] = acc;
        }
      }
    }
  }
}

// acc[r][c] += sum over columns j < n of w[r][j] * M[j][64 c + 2 lane (+1)],
// the weights w[r][j] held by lane j % 32 in slot j / 32 and broadcast by
// shuffle; the columns in order.
template <int S>
__device__ __forceinline__ void weighted_rows(const float (&w)[kRows][S], const float* M, int n,
                                              int dp, int ld, int lane,
                                              float2 (&acc)[kRows][kDimPairs]) {
  const int n_slots = (n + 31) >> 5;
#pragma unroll
  for (int t = 0; t < S; ++t) {
    if (t >= n_slots) break;   // warp-uniform
    const int n_cols = min(32, n - t * 32);
    for (int src = 0; src < n_cols; ++src) {
      float p[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) p[r] = __shfl_sync(0xffffffffu, w[r][t], src);
      const float* mj = M + (t * 32 + src) * ld;
#pragma unroll
      for (int c = 0; c < kDimPairs; ++c) {
        const int d = c * 64 + 2 * lane;
        if (d < dp) {
          const float2 mv = *reinterpret_cast<const float2*>(mj + d);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc[r][c].x = fmaf(p[r], mv.x, acc[r][c].x);
            acc[r][c].y = fmaf(p[r], mv.y, acc[r][c].y);
          }
        }
      }
    }
  }
}

__device__ __forceinline__ void zero(float2 (&acc)[kRows][kDimPairs]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kDimPairs; ++c) acc[r][c] = make_float2(0.f, 0.f);
}

// Rows row0 + r (r < n_left) of acc into out[row][col .. col + Dh) in T,
// out's rows `ld_out` elements apart; coalesced along the head dim.
template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ out,
                                           const float2 (&acc)[kRows][kDimPairs], size_t row0,
                                           int n_left, int ld_out, int col, int Dh, int lane) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= n_left) break;   // warp-uniform
    T* o = out + (row0 + r) * ld_out + col;
#pragma unroll
    for (int c = 0; c < kDimPairs; ++c) {
      const int d = c * 64 + 2 * lane;
      if (d < Dh) o[d] = ccmh::from_float<T>(acc[r][c].x);
      if (d + 1 < Dh) o[d + 1] = ccmh::from_float<T>(acc[r][c].y);
    }
  }
}

// The shared memory a block of card `device` may have (0 if unknown).
inline int smem_optin(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return 0;
  return optin;
}

// Set the dynamic shared memory of `kernel` to `bytes` (above 48 KB it
// must be asked for), refusing more than the block limit `optin`.
template <typename K>
cudaError_t set_smem(K kernel, size_t bytes, int optin) {
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace attn
