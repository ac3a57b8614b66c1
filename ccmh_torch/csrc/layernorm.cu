// Fused LayerNorm (kernel #4) and residual add + LayerNorm (kernel #5).
//
// Replaces: ccmh/ops/layernorm.py `_ln_forward` / `_ln_kernel` and
// `_add_ln_forward` / `_add_ln_kernel` (the Pallas TPU kernels).
//
//   ln_forward:      y = LN(x)                      (x read once, y written once)
//   add_ln_forward:  s = x + d;  y = LN(s)          (x, d read once; y, s written once)
//
// Numerics follow the TPU kernels: the residual add in the input type (a bf16
// s is rounded before the statistics, as `x + d` rounds it), the statistics in
// fp32 with the biased variance of jnp.var (the mean first, then the mean of
// the squared deviations), rsqrt(var + 1e-5), the affine step with scale and
// bias widened to fp32, and one rounding of y to the input type.
//
// What bounds it on an H100: bytes.  A row of W elements costs ~8 operations
// per element, far below the card's operations per byte.  At the towers'
// shapes (rows = B * L, W = 768 vision / 512 text) ln_forward moves 2 * rows *
// W elements and add_ln_forward 4 * rows * W: vision B=256 fp32 is 78.6 MB
// (23.5 us at 3.35 TB/s) and 157 MB (46.9 us).
//
// Design: one warp per row, the whole row held in registers.  Lane l keeps
// columns l, l + 32, l + 64, ..., so every load and store of the warp touches
// 32 neighbouring elements; the two reductions are warp shuffles, so nothing
// but x (and d) is read and nothing but y (and s) is written.  A block holds
// eight rows; the missing rows of a ragged last block exit before any
// shuffle.  The TPU kernel's row blocking (`_pick_rows`, a divisor of the row
// count) is not carried over: nothing here needs one.  The per-lane register
// count is a template bucket (8, 16 or 32 values: W <= 256, 512, 1024); wider
// rows are refused.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kMaxWidth = 1024;
constexpr float kEps = 1e-5f;

template <typename T, typename P, int kPerLane, bool kAdd>
__global__ void __launch_bounds__(kThreads)
layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ d,
                  const P* __restrict__ scale, const P* __restrict__ bias,
                  T* __restrict__ y, T* __restrict__ s, long long rows, int W) {
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const size_t base = (size_t)row * W;

  float v[kPerLane];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int c = i * 32 + lane;
    v[i] = 0.f;
    if (c < W) {
      if constexpr (kAdd) {
        // the residual add in the input type, rounded as `x + d` rounds it
        const T sv = ccmh::from_float<T>(ccmh::to_float(x[base + c]) +
                                         ccmh::to_float(d[base + c]));
        s[base + c] = sv;
        v[i] = ccmh::to_float(sv);
      } else {
        v[i] = ccmh::to_float(x[base + c]);
      }
      sum += v[i];
    }
  }
  const float mean = ccmh::warp_sum(sum) / (float)W;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int c = i * 32 + lane;
    if (c < W) {
      const float t = v[i] - mean;
      sq += t * t;
    }
  }
  const float rstd = rsqrtf(ccmh::warp_sum(sq) / (float)W + kEps);

#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int c = i * 32 + lane;
    if (c < W) {
      const float n = (v[i] - mean) * rstd;
      y[base + c] = ccmh::from_float<T>(n * ccmh::to_float(scale[c]) + ccmh::to_float(bias[c]));
    }
  }
}

template <typename T, typename P, bool kAdd>
cudaError_t launch(const void* x, const void* d, const void* scale, const void* bias,
                   void* y, void* s, long long rows, int W, cudaStream_t stream) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  const T* xp = static_cast<const T*>(x);
  const T* dp = static_cast<const T*>(d);
  const P* sc = static_cast<const P*>(scale);
  const P* bi = static_cast<const P*>(bias);
  T* yp = static_cast<T*>(y);
  T* sp = static_cast<T*>(s);
  if (W <= 256)
    layer_norm_kernel<T, P, 8, kAdd><<<grid, kThreads, 0, stream>>>(xp, dp, sc, bi, yp, sp, rows, W);
  else if (W <= 512)
    layer_norm_kernel<T, P, 16, kAdd><<<grid, kThreads, 0, stream>>>(xp, dp, sc, bi, yp, sp, rows, W);
  else
    layer_norm_kernel<T, P, 32, kAdd><<<grid, kThreads, 0, stream>>>(xp, dp, sc, bi, yp, sp, rows, W);
  return cudaGetLastError();
}

template <bool kAdd>
int dispatch(int device, const void* x, const void* d, const void* scale, const void* bias,
             void* y, void* s, long long rows, int W, int dtype, int param_dtype,
             void* stream) {
  if (rows < 1 || W < 1 || W > kMaxWidth) return (int)cudaErrorInvalidValue;
  const bool known = (dtype == ccmh::kFloat32 || dtype == ccmh::kBFloat16) &&
                     (param_dtype == ccmh::kFloat32 || param_dtype == ccmh::kBFloat16);
  if (!known) return (int)cudaErrorInvalidValue;
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: name the card of the tensors
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ccmh::kFloat32) {
    err = param_dtype == ccmh::kFloat32
              ? launch<float, float, kAdd>(x, d, scale, bias, y, s, rows, W, st)
              : launch<float, __nv_bfloat16, kAdd>(x, d, scale, bias, y, s, rows, W, st);
  } else {
    err = param_dtype == ccmh::kFloat32
              ? launch<__nv_bfloat16, float, kAdd>(x, d, scale, bias, y, s, rows, W, st)
              : launch<__nv_bfloat16, __nv_bfloat16, kAdd>(x, d, scale, bias, y, s, rows, W, st);
  }
  return (int)err;
}

}  // namespace

// x, y [rows, W] in the input type; scale, bias [W] in the parameter type;
// all contiguous on card `device`.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int ccmh_ln_forward(int device, const void* x, const void* scale, const void* bias,
                               void* y, long long rows, int W, int dtype, int param_dtype,
                               void* stream) {
  return dispatch<false>(device, x, nullptr, scale, bias, y, nullptr, rows, W, dtype,
                         param_dtype, stream);
}

// As ccmh_ln_forward, with the residual d [rows, W] added to x first; the sum
// is written to s [rows, W] in the input type.
extern "C" int ccmh_add_ln_forward(int device, const void* x, const void* d, const void* scale,
                                   const void* bias, void* y, void* s, long long rows, int W,
                                   int dtype, int param_dtype, void* stream) {
  return dispatch<true>(device, x, d, scale, bias, y, s, rows, W, dtype, param_dtype, stream);
}
