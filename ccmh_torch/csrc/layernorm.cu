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
// bias widened to fp32, and one rounding of y to the input type.  Every fp32
// operation is written with a round-to-nearest intrinsic, so nvcc contracts
// nothing into an FMA and the order below is the order the card sums in
// (tests/test_torch_layernorm_vec.py emulates it): each lane sums its values
// in the order it holds them, then a butterfly of xor shuffles sums the lanes.
//
// What bounds it on an H100: bytes.  A row of W elements costs ~8 fp32
// operations per element, far below the card's operations per byte.  At the
// towers' shapes (rows = B * L, W = 768 vision / 512 text, B = 256) ln_forward
// moves 2 * rows * W elements and add_ln_forward 4 * rows * W: vision fp32
// 78.6 MB (23.5 us at 3.35 TB/s) and 157 MB (46.9 us), vision bf16 half of
// that; text fp32 33.6 MB (10.0 us) and 67.1 MB (20.0 us), text bf16 16.8 MB
// (5.0 us) and 33.6 MB (10.0 us).
//
// Design, for bytes in flight and few instructions per byte:
// - 16-byte loads and stores.  A row is cut into 16-byte chunks (4 fp32 or 8
//   bf16 values) and lane l holds chunks l, l + 32, ...: every warp-wide load
//   reads 512 neighbouring bytes, and a lane's loads of x (and d), scale and
//   bias are all in flight before the first reduction.  The per-lane chunk
//   count is a template bucket (1-4, 6 or 8 chunks: up to 1024 columns).
// - The row, scale and bias stay in registers in their own types, packed in
//   32-bit words (two bf16 values a word) and widened to fp32 where used:
//   few registers a thread, so many warps an SM and many bytes in flight.
// - One row per warp, four warps a block, as many blocks as rows / 4 (a
//   grid-stride loop covers more rows than a grid holds).  Measured against
//   a persistent grid whose warps keep scale and bias across rows, and
//   against 2 or 4 rows in flight per warp, one row per warp wins in 7 of 8
//   cases: the extra registers cost more warps than the reuse saves, and a
//   persistent grid ends on a partial pass; 128 threads a block beat 256 in
//   8 of 8 (finer blocks leave fewer registers idle and a shorter last
//   wave; PERF.md, tools/time_torch_layernorm.py).
// - The same kernel has a scalar branch (kVector false) for rows whose width
//   in bytes is not a multiple of 16 or whose pointers are not 16-byte
//   aligned (W = 100 in bf16, a view that starts one element in): lane l then
//   holds columns l, l + 32, ..., loaded one at a time.  The wrapper decides
//   which (`_vector_path`) and passes a flag; the vector branch refuses data
//   it cannot read 16 bytes at a time.
// The TPU kernel's row blocking (`_pick_rows`, a divisor of the row count)
// is not carried over: nothing here needs one.

#include "common.cuh"

namespace {

constexpr int kMaxWidth = 1024;
constexpr int kThreads = 128;   // four warps, four rows a block
constexpr float kEps = 1e-5f;

// Values of T packed in 32-bit words: a row and the parameters stay in
// registers in their own type (two bf16 values a word) and are widened to
// fp32 where they are used.
template <typename T> struct Word;
template <> struct Word<float> {
  static constexpr int kPer = 1;
  __device__ static float get(uint32_t w, int) { return __uint_as_float(w); }
  __device__ static uint32_t put(const float* f) { return __float_as_uint(f[0]); }
};
template <> struct Word<__nv_bfloat16> {
  static constexpr int kPer = 2;
  __device__ static float get(uint32_t w, int k) {
    return __uint_as_float(k ? (w & 0xffff0000u) : (w << 16));   // bf16 -> fp32 is exact
  }
  __device__ static uint32_t put(const float* f) {   // two values rounded to bf16
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[0])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[1])) << 16);
  }
};

// value k of the T values packed in w, as fp32
template <typename T>
__device__ __forceinline__ float get(const uint32_t* w, int k) {
  return Word<T>::get(w[k / Word<T>::kPer], k % Word<T>::kPer);
}

// value k of w set to v, which T holds exactly
template <typename T>
__device__ __forceinline__ void set(uint32_t* w, int k, float v) {
  if constexpr (Word<T>::kPer == 1) {
    w[k] = __float_as_uint(v);
  } else {
    const uint32_t h = __float_as_uint(v) >> 16, old = w[k / 2];
    w[k / 2] = k % 2 ? (old & 0xffffu) | (h << 16) : (old & 0xffff0000u) | h;
  }
}

// N 32-bit words from p: one 8-byte load (N = 2, p 8-byte aligned) or N / 4
// 16-byte loads (p 16-byte aligned)
template <int N>
__device__ __forceinline__ void load_words(const void* __restrict__ p, uint32_t* w) {
  if constexpr (N == 2) {
    const uint2 u = __ldg(static_cast<const uint2*>(p));
    w[0] = u.x, w[1] = u.y;
  } else {
#pragma unroll
    for (int h = 0; h < N / 4; ++h) {
      const uint4 u = __ldg(static_cast<const uint4*>(p) + h);
      w[4 * h] = u.x, w[4 * h + 1] = u.y, w[4 * h + 2] = u.z, w[4 * h + 3] = u.w;
    }
  }
}

__device__ __forceinline__ void store_words(void* p, const uint32_t* w) {
  *static_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, typename P, int kChunks, bool kAdd, bool kVector>
__global__ void __launch_bounds__(kThreads)
layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ d,
                  const P* __restrict__ scale, const P* __restrict__ bias,
                  T* __restrict__ y, T* __restrict__ s, long long rows, int W) {
  constexpr int V = 16 / (int)sizeof(T);       // values in a 16-byte chunk
  constexpr int kPer = kChunks * V;            // values a lane holds of a row
  constexpr int kWords = kChunks * 4;          // ... as 32-bit words of T
  constexpr int kPChunk = V * (int)sizeof(P) / 4;   // words of P for a chunk's columns
  const int lane = threadIdx.x & 31;
  // column of this lane's k-th value: chunk-major on the vector branch,
  // lane-strided on the scalar one
  auto col = [lane](int k) { return kVector ? ((k / V) * 32 + lane) * V + k % V : k * 32 + lane; };

  const long long n_warps = (long long)gridDim.x * (kThreads / 32);
  for (long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); row < rows;
       row += n_warps) {
    const size_t base = (size_t)row * W;
    // the row, scale and bias of this lane's columns as words of T and P
    // (absent values 0): every load first, scale and bias ahead of the row
    // (behind it, they cost #5 a tenth at vision fp32: PERF.md)
    uint32_t w[kWords] = {}, gw[kChunks * kPChunk] = {}, bw[kChunks * kPChunk] = {};
    if constexpr (kVector) {
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int c = col(i * V);
        if (c < W) {
          load_words<kPChunk>(scale + c, gw + i * kPChunk);
          load_words<kPChunk>(bias + c, bw + i * kPChunk);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      if constexpr (kVector) {
        const int c = col(i * V);
        if (c >= W) continue;   // W is a multiple of V here: a chunk is whole or absent
        load_words<4>(x + base + c, w + 4 * i);
        if constexpr (kAdd) {
          // the residual add, rounded to T as `x + d` rounds it
          uint32_t dw[4];
          load_words<4>(d + base + c, dw);
          float sv[V];
#pragma unroll
          for (int j = 0; j < V; ++j) sv[j] = __fadd_rn(get<T>(w + 4 * i, j), get<T>(dw, j));
#pragma unroll
          for (int q = 0; q < 4; ++q) w[4 * i + q] = Word<T>::put(sv + q * Word<T>::kPer);
        }
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int k = i * V + j, c = col(k);
          if (c >= W) continue;
          float t = ccmh::to_float(x[base + c]);
          if constexpr (kAdd) t = ccmh::round_to<T>(__fadd_rn(t, ccmh::to_float(d[base + c])));
          set<T>(w, k, t);
          set<P>(gw, k, ccmh::to_float(scale[c]));
          set<P>(bw, k, ccmh::to_float(bias[c]));
        }
      }
    }

    if constexpr (kAdd) {   // s leaves while the statistics are summed
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        if constexpr (kVector) {
          const int c = col(i * V);
          if (c < W) store_words(s + base + c, w + 4 * i);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const int c = col(i * V + j);
            if (c < W) s[base + c] = ccmh::from_float<T>(get<T>(w, i * V + j));
          }
        }
      }
    }

    // the mean: lane partial sums (absent values are 0 and add nothing),
    // then the butterfly; the variance from the deviations the same way
    float mean = 0.f, sq = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) mean = __fadd_rn(mean, get<T>(w, k));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mean = __fadd_rn(mean, __shfl_xor_sync(0xffffffffu, mean, o));
    mean = __fdiv_rn(mean, (float)W);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (col(k) < W) {
        const float t = __fsub_rn(get<T>(w, k), mean);
        sq = __fadd_rn(sq, __fmul_rn(t, t));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, o));
    const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(sq, (float)W), kEps));

    // y, a chunk at a time
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      if (kVector && col(i * V) >= W) continue;
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int k = i * V + j;
        o[j] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(get<T>(w, k), mean), rstd), get<P>(gw, k)),
                         get<P>(bw, k));
      }
      if constexpr (kVector) {
        uint32_t ow[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) ow[q] = Word<T>::put(o + q * Word<T>::kPer);
        store_words(y + base + col(i * V), ow);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int c = col(i * V + j);
          if (c < W) y[base + c] = ccmh::from_float<T>(o[j]);
        }
      }
    }
  }
}

template <typename T, typename P, int kChunks, bool kAdd, bool kVector>
cudaError_t launch_one(const void* x, const void* d, const void* scale, const void* bias,
                       void* y, void* s, long long rows, int W, cudaStream_t stream) {
  constexpr long long kWarps = kThreads / 32;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  const dim3 grid((unsigned)(blocks < 2147483647LL ? blocks : 2147483647LL));
  layer_norm_kernel<T, P, kChunks, kAdd, kVector><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(d), static_cast<const P*>(scale),
      static_cast<const P*>(bias), static_cast<T*>(y), static_cast<T*>(s), rows, W);
  return cudaGetLastError();
}

template <typename T, typename P, bool kAdd>
cudaError_t launch(const void* x, const void* d, const void* scale, const void* bias, void* y,
                   void* s, long long rows, int W, bool vector, cudaStream_t st) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int kMaxChunks = kMaxWidth / (32 * V);   // 8 fp32, 4 bf16
  if (!vector) return launch_one<T, P, kMaxChunks, kAdd, false>(x, d, scale, bias, y, s, rows, W, st);
  switch ((W + 32 * V - 1) / (32 * V)) {
    case 1: return launch_one<T, P, 1, kAdd, true>(x, d, scale, bias, y, s, rows, W, st);
    case 2: return launch_one<T, P, 2, kAdd, true>(x, d, scale, bias, y, s, rows, W, st);
    case 3: return launch_one<T, P, 3, kAdd, true>(x, d, scale, bias, y, s, rows, W, st);
    case 4: return launch_one<T, P, 4, kAdd, true>(x, d, scale, bias, y, s, rows, W, st);
    default:
      if constexpr (kMaxChunks > 4) {
        if (W <= 6 * 32 * V)
          return launch_one<T, P, 6, kAdd, true>(x, d, scale, bias, y, s, rows, W, st);
        return launch_one<T, P, 8, kAdd, true>(x, d, scale, bias, y, s, rows, W, st);
      }
      return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <bool kAdd>
int dispatch(int device, const void* x, const void* d, const void* scale, const void* bias,
             void* y, void* s, long long rows, int W, int dtype, int param_dtype, int vector,
             void* stream) {
  if (rows < 1 || W < 1 || W > kMaxWidth) return (int)cudaErrorInvalidValue;
  const bool known = (dtype == ccmh::kFloat32 || dtype == ccmh::kBFloat16) &&
                     (param_dtype == ccmh::kFloat32 || param_dtype == ccmh::kBFloat16);
  if (!known) return (int)cudaErrorInvalidValue;
  if (vector) {
    // the wrapper's rule (`_vector_path`), checked again: 16-byte chunks of
    // every row and of scale and bias, at 16-byte aligned addresses
    const int t_size = dtype == ccmh::kFloat32 ? 4 : 2;
    const int p_size = param_dtype == ccmh::kFloat32 ? 4 : 2;
    const bool ok = (W * t_size) % 16 == 0 && (W * p_size) % 16 == 0 && aligned16(x) &&
                    aligned16(d) && aligned16(scale) && aligned16(bias) && aligned16(y) &&
                    aligned16(s);
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: name the card of the tensors
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = vector != 0;
  if (dtype == ccmh::kFloat32) {
    err = param_dtype == ccmh::kFloat32
              ? launch<float, float, kAdd>(x, d, scale, bias, y, s, rows, W, vec, st)
              : launch<float, __nv_bfloat16, kAdd>(x, d, scale, bias, y, s, rows, W, vec, st);
  } else {
    err = param_dtype == ccmh::kFloat32
              ? launch<__nv_bfloat16, float, kAdd>(x, d, scale, bias, y, s, rows, W, vec, st)
              : launch<__nv_bfloat16, __nv_bfloat16, kAdd>(x, d, scale, bias, y, s, rows, W,
                                                           vec, st);
  }
  return (int)err;
}

}  // namespace

// x, y [rows, W] in the input type; scale, bias [W] in the parameter type;
// all contiguous on card `device`.  `vector` (0 or 1) asks for the 16-byte
// branch, which needs W times each type's size to be a multiple of 16 and
// every pointer 16-byte aligned (else cudaErrorInvalidValue and no launch).
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int ccmh_ln_forward(int device, const void* x, const void* scale, const void* bias,
                               void* y, long long rows, int W, int dtype, int param_dtype,
                               int vector, void* stream) {
  return dispatch<false>(device, x, nullptr, scale, bias, y, nullptr, rows, W, dtype,
                         param_dtype, vector, stream);
}

// As ccmh_ln_forward, with the residual d [rows, W] added to x first; the sum
// is written to s [rows, W] in the input type.
extern "C" int ccmh_add_ln_forward(int device, const void* x, const void* d, const void* scale,
                                   const void* bias, void* y, void* s, long long rows, int W,
                                   int dtype, int param_dtype, int vector, void* stream) {
  return dispatch<true>(device, x, d, scale, bias, y, s, rows, W, dtype, param_dtype, vector,
                        stream);
}
