// Fused multi-head self-attention backward for the short sequences of the
// CLIP towers (vision L=50, text L=32..77; head dim 64).
//
// Replaces: ccmh/ops/attention.py `_pallas_backward` / `_bwd_kernel` (the
// Pallas TPU kernel).  Same function: per (batch element, head), q, k, v are
// cut from the RAW packed [B, L, 3D] rows with the [3D] projection bias added
// in the INPUT type (the forward's fold); g [B, L, D] arrives in the input
// type.  With the softmax recomputed in fp32,
//   logits = (q . k) * scale + mask,   probs = softmax(logits),
//   dprobs = g . v,                    dlogits = probs * (dprobs - sum_j dprobs * probs),
//   probs_c = probs -> T,              dlogits_c = (dlogits * scale) -> T,
//   dq = dlogits_c . k,  dk = dlogits_c^T . q,  dv = probs_c^T . g,
// each product accumulated in fp32 and stored in T into one packed
// [B, L, 3D] dqkv.  d(qkv_b) is the (B, L) sum of dqkv, a torch reduction
// outside the kernel as in ccmh; the mask gets no gradient.
//
// What bounds it on an H100: bytes.  The vision call at B=256 fp32 must read
// 118 MB of qkv and 39 MB of g and write 118 MB of dqkv (~82 us at 3.35
// TB/s); its 10 B H L^2 Dh = 5 GFLOP of dot products take ~75 us on the fp32
// CUDA cores, so the two bounds are close in fp32 and bytes win in bf16.
//
// Design: one block per (batch element, head), so dk and dv, which sum over
// the queries, reduce inside the block with no atomics, and no [L, L] tile
// ever touches device memory.  Holding q, k, v and g of one head in shared
// memory as fp32 would take 4 L (Dh + 4) 4 bytes: 54 KB at L=50, but 270 KB
// at L = Dh = 128, over the 227 KB a block can have.  So the kernel runs in
// two phases and holds only two of the four at a time:
//   A. query-major, with k and v in shared memory: each warp carries 4 query
//      rows (staged from device memory into a per-warp buffer), a lane owns
//      keys j = lane + 32 t, and the row's logits, dprobs, softmax and
//      dlogits stay in registers.  It writes dq (the dlogits broadcast by
//      shuffle), and keeps each row's max, sum and sum_j dprobs * probs;
//   B. key-major, with q and g in shared memory: each warp carries 4 keys
//      and sums dk and dv over the queries in order.
// Phase B takes its weights from one of two places.  Where the [L, L]
// probs_c and dlogits_c tiles fit beside the rest (every shape up to
// L = 128 at Dh = 64: 66 KB at L=50, 109 KB at L=77), phase A leaves them
// in shared memory and phase B reads the 4 keys' weights of a query as one
// float4 broadcast.  Otherwise (L = Dh = 128) phase B recomputes them: a
// lane owns queries i = lane + 32 t, recomputes the same logits (the same
// fmaf chain, so the same bits) and dprobs, turns them into probs and
// dlogits with phase A's row statistics, and broadcasts them by shuffle.
// Shared memory above 48 KB needs cudaFuncSetAttribute; the recompute path
// takes (2 L + 64) (Dh + 4) 4 + 12 L bytes, 170 KB at the limit.  Simple
// first: no tensor cores, no TMA; the products run on fp32 FMAs, three
// blocks of 8 warps an SM.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 4;                 // rows (queries in A, keys in B) a warp carries
constexpr int kMaxL = 128;
constexpr int kMaxDh = 128;
constexpr int kSlots = kMaxL / 32;       // columns c = lane + 32 t
constexpr int kDimPairs = kMaxDh / 64;   // dims d = 64 c + 2 lane, +1

__host__ __device__ __forceinline__ int padded_dim(int Dh) { return (Dh + 3) & ~3; }
__host__ __device__ __forceinline__ int row_stride(int Dh) { return padded_dim(Dh) + 4; }

__host__ __device__ __forceinline__ int tile_stride(int L) { return (L + 3) & ~3; }

// [L, ld] x 2, the warps' staging rows, the two [L, L] tiles when kept,
// and the three row statistics
size_t smem_floats(int L, int Dh, bool tiles) {
  return (size_t)(2 * L + kWarps * 2 * kRows) * row_stride(Dh) +
         (tiles ? 2 * (size_t)L * tile_stride(L) : 0) + 3 * (size_t)L;
}

// One head row of q (part 0), k (1) or v (2) with the bias added in T, or
// of g (part 3), as fp32 into dst[0..dp); lanes along the head dim, the
// padding columns zero.
template <typename T>
__device__ __forceinline__ void load_row(float* dst, const T* __restrict__ qkv,
                                         const T* __restrict__ qkv_b,
                                         const T* __restrict__ g, int b, int l,
                                         int part, int L, int h, int Dh, int D,
                                         int dp, int lane) {
  const T* src;
  const T* bias = nullptr;
  if (part < 3) {
    const int col = part * D + h * Dh;
    src = qkv + ((size_t)b * L + l) * 3 * D + col;
    if (qkv_b != nullptr) bias = qkv_b + col;
  } else {
    src = g + ((size_t)b * L + l) * D + h * Dh;
  }
  for (int d = lane; d < dp; d += 32) {
    float x = 0.f;
    if (d < Dh) {
      x = ccmh::to_float(src[d]);
      if (bias != nullptr) x = ccmh::round_to<T>(x + ccmh::to_float(bias[d]));
    }
    dst[d] = x;
  }
}

// For the warp's kRows staged rows a[r] and the lane's columns
// c = lane + 32 t of the shared-memory tensor A: s[r][t] = a[r] . A[c],
// summed over the head dim in order, one fmaf at a time.  Called once per
// product (not fused over two), so fewer values are live at once.
__device__ __forceinline__ void dot_rows(const float* sa, const float* A, int L, int dp,
                                         int ld, int lane, float (&s)[kRows][kSlots]) {
  const int n_slots = (L + 31) >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int t = 0; t < kSlots; ++t) s[r][t] = 0.f;
  for (int d = 0; d < dp; d += 4) {
    float4 av[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) av[r] = *reinterpret_cast<const float4*>(sa + r * ld + d);
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      if (t < n_slots) {   // warp-uniform
        const int c = min(t * 32 + lane, L - 1);
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

// acc[r][c] += sum over columns j < L of w[r][j] * M[j][64 c + 2 lane (+1)],
// the weights w[r][j] held by lane j % 32 in slot j / 32 and broadcast by
// shuffle; the columns in order.
__device__ __forceinline__ void weighted_rows(const float (&w)[kRows][kSlots], const float* M,
                                              int L, int dp, int ld, int lane,
                                              float2 (&acc)[kRows][kDimPairs]) {
  const int n_slots = (L + 31) >> 5;
#pragma unroll
  for (int t = 0; t < kSlots; ++t) {
    if (t >= n_slots) break;   // warp-uniform
    const int n_cols = min(32, L - t * 32);
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

template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ dqkv, const float2 (&acc)[kRows][kDimPairs],
                                           int b, int r0, int L, int part, int h, int Dh,
                                           int D, int lane) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r0 + r >= L) break;   // warp-uniform
    T* o = dqkv + ((size_t)b * L + r0 + r) * 3 * D + part * D + h * Dh;
#pragma unroll
    for (int c = 0; c < kDimPairs; ++c) {
      const int d = c * 64 + 2 * lane;
      if (d < Dh) o[d] = ccmh::from_float<T>(acc[r][c].x);
      if (d + 1 < Dh) o[d + 1] = ccmh::from_float<T>(acc[r][c].y);
    }
  }
}

// 3 blocks an SM: at L=50 three blocks' 66 KB fill the shared memory, and
// with the 80 registers this leaves a thread (a few spill) the kernel runs
// faster than as 2 blocks at 128 (tools/bench_attn_bwd_occupancy.py)
template <typename T>
__global__ void __launch_bounds__(kWarps * 32, 3)
attention_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ qkv_b,
                     const float* __restrict__ mask, const T* __restrict__ g,
                     T* __restrict__ dqkv, int L, int H, int Dh, float scale,
                     int tiles) {
  extern __shared__ __align__(16) float smem[];
  const int dp = padded_dim(Dh);
  const int ld = row_stride(Dh);
  const int b = blockIdx.x, h = blockIdx.y;
  const int D = H * Dh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_slots = (L + 31) >> 5;

  float* big0 = smem;                                   // [L, ld]: k in A, q in B
  float* big1 = smem + L * ld;                          // [L, ld]: v in A, g in B
  float* stage_a = smem + 2 * L * ld + warp * 2 * kRows * ld;   // the warp's rows
  float* stage_b = stage_a + kRows * ld;
  const int ldt = tile_stride(L);
  float* tile_p = smem + (2 * L + kWarps * 2 * kRows) * ld;     // [L, ldt]: probs_c
  float* tile_s = tile_p + L * ldt;                             // [L, ldt]: dlogits_c
  float* row_max = tiles ? tile_s + L * ldt : tile_p;           // [L] each
  float* row_sum = row_max + L;
  float* row_dot = row_sum + L;

  // ---- phase A: k | v of head h into shared memory; a warp per row
  for (int pr = warp; pr < 2 * L; pr += kWarps) {
    const int which = pr / L, l = pr - which * L;
    load_row<T>((which ? big1 : big0) + l * ld, qkv, qkv_b, g, b, l, 1 + which, L, h,
                Dh, D, dp, lane);
  }
  __syncthreads();

  for (int i0 = warp * kRows; i0 < L; i0 += kWarps * kRows) {
    __syncwarp();
    // rows past L are clamped to L-1 for reading and never stored
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = min(i0 + r, L - 1);
      load_row<T>(stage_a + r * ld, qkv, qkv_b, g, b, i, 0, L, h, Dh, D, dp, lane);
      load_row<T>(stage_b + r * ld, qkv, qkv_b, g, b, i, 3, L, h, Dh, D, dp, lane);
    }
    __syncwarp();
    float s[kRows][kSlots], u[kRows][kSlots];   // q_i . k_j and g_i . v_j
    dot_rows(stage_a, big0, L, dp, ld, lane, s);
    dot_rows(stage_b, big1, L, dp, ld, lane, u);

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = min(i0 + r, L - 1);
      float m = -CUDART_INF_F;
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        const int j = t * 32 + lane;
        float logit = -CUDART_INF_F;
        if (t < n_slots && j < L) {
          logit = s[r][t] * scale;
          if (mask != nullptr) logit += mask[i * L + j];
        }
        s[r][t] = logit;
        m = fmaxf(m, logit);
      }
      m = ccmh::warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        const float e = (t * 32 + lane < L) ? expf(s[r][t] - m) : 0.f;
        s[r][t] = e;
        sum += e;
      }
      sum = ccmh::warp_sum(sum);
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        s[r][t] = s[r][t] / sum;             // probs, fp32
        dot = fmaf(u[r][t], s[r][t], dot);   // 0 past L: probs are 0 there
      }
      dot = ccmh::warp_sum(dot);
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {     // dlogits_c, 0 past L
        const float p = s[r][t];
        s[r][t] = ccmh::round_to<T>(p * (u[r][t] - dot) * scale);
        const int j = t * 32 + lane;
        if (tiles && i0 + r < L && j < L) {
          tile_p[i * ldt + j] = ccmh::round_to<T>(p);
          tile_s[i * ldt + j] = s[r][t];
        }
      }
      if (lane == 0 && i0 + r < L) {
        row_max[i] = m;
        row_sum[i] = sum;
        row_dot[i] = dot;
      }
    }

    // dq = dlogits_c . k over the keys in order
    float2 acc[kRows][kDimPairs];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kDimPairs; ++c) acc[r][c] = make_float2(0.f, 0.f);
    weighted_rows(s, big0, L, dp, ld, lane, acc);
    store_rows<T>(dqkv, acc, b, i0, L, 0, h, Dh, D, lane);
  }
  __syncthreads();   // every warp is done with k, v and has written its statistics

  // ---- phase B: q | g of head h into shared memory
  for (int pr = warp; pr < 2 * L; pr += kWarps) {
    const int which = pr / L, l = pr - which * L;
    load_row<T>((which ? big1 : big0) + l * ld, qkv, qkv_b, g, b, l, which ? 3 : 0, L,
                h, Dh, D, dp, lane);
  }
  __syncthreads();

  if (tiles) {
    // the warp's 4 keys j0..j0+3 are 4 adjacent tile columns: one float4
    // broadcast per query brings their weights (j0 is a multiple of 4 and
    // ldt >= j0 + 4; columns past L are never stored)
    for (int j0 = warp * kRows; j0 < L; j0 += kWarps * kRows) {
      float2 dk[kRows][kDimPairs], dv[kRows][kDimPairs];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kDimPairs; ++c) dk[r][c] = dv[r][c] = make_float2(0.f, 0.f);
      for (int i = 0; i < L; ++i) {
        const float4 ws4 = *reinterpret_cast<const float4*>(tile_s + i * ldt + j0);
        const float4 wp4 = *reinterpret_cast<const float4*>(tile_p + i * ldt + j0);
        const float ws[kRows] = {ws4.x, ws4.y, ws4.z, ws4.w};
        const float wp[kRows] = {wp4.x, wp4.y, wp4.z, wp4.w};
#pragma unroll
        for (int c = 0; c < kDimPairs; ++c) {
          const int d = c * 64 + 2 * lane;
          if (d < dp) {
            const float2 qv = *reinterpret_cast<const float2*>(big0 + i * ld + d);
            const float2 gv = *reinterpret_cast<const float2*>(big1 + i * ld + d);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              dk[r][c].x = fmaf(ws[r], qv.x, dk[r][c].x);
              dk[r][c].y = fmaf(ws[r], qv.y, dk[r][c].y);
              dv[r][c].x = fmaf(wp[r], gv.x, dv[r][c].x);
              dv[r][c].y = fmaf(wp[r], gv.y, dv[r][c].y);
            }
          }
        }
      }
      store_rows<T>(dqkv, dk, b, j0, L, 1, h, Dh, D, lane);
      store_rows<T>(dqkv, dv, b, j0, L, 2, h, Dh, D, lane);
    }
    return;
  }

  for (int j0 = warp * kRows; j0 < L; j0 += kWarps * kRows) {
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = min(j0 + r, L - 1);
      load_row<T>(stage_a + r * ld, qkv, qkv_b, g, b, j, 1, L, h, Dh, D, dp, lane);
      load_row<T>(stage_b + r * ld, qkv, qkv_b, g, b, j, 2, L, h, Dh, D, dp, lane);
    }
    __syncwarp();
    float s[kRows][kSlots], u[kRows][kSlots];   // k_j . q_i and v_j . g_i
    dot_rows(stage_a, big0, L, dp, ld, lane, s);
    dot_rows(stage_b, big1, L, dp, ld, lane, u);

    // lane's queries i = lane + 32 t: probs_c into u, dlogits_c into s
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int i = t * 32 + lane;
      const bool live = t < n_slots && i < L;
      const float m = live ? row_max[i] : 0.f;
      const float sum = live ? row_sum[i] : 1.f;
      const float dot = live ? row_dot[i] : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int j = min(j0 + r, L - 1);
        float p = 0.f;
        if (live) {
          float logit = s[r][t] * scale;
          if (mask != nullptr) logit += mask[i * L + j];
          p = expf(logit - m) / sum;
        }
        s[r][t] = ccmh::round_to<T>(p * (u[r][t] - dot) * scale);
        u[r][t] = ccmh::round_to<T>(p);
      }
    }

    // dk = dlogits_c^T . q and dv = probs_c^T . g over the queries in order
    float2 acc[kRows][kDimPairs];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kDimPairs; ++c) acc[r][c] = make_float2(0.f, 0.f);
    weighted_rows(s, big0, L, dp, ld, lane, acc);
    store_rows<T>(dqkv, acc, b, j0, L, 1, h, Dh, D, lane);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kDimPairs; ++c) acc[r][c] = make_float2(0.f, 0.f);
    weighted_rows(u, big1, L, dp, ld, lane, acc);
    store_rows<T>(dqkv, acc, b, j0, L, 2, h, Dh, D, lane);
  }
}

template <typename T>
cudaError_t launch(int device, const void* qkv, const void* qkv_b, const float* mask,
                   const void* g, void* dqkv, int B, int L, int H, int Dh, float scale,
                   cudaStream_t stream) {
  // keep the [L, L] tiles of phase A for phase B when they fit the block's
  // shared memory (every path shape; not L = Dh = 128)
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                           device);
  if (err != cudaSuccess) return err;
  const bool tiles = smem_floats(L, Dh, true) * sizeof(float) <= (size_t)optin;
  const size_t smem = smem_floats(L, Dh, tiles) * sizeof(float);
  err = cudaFuncSetAttribute(attention_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, H);
  attention_bwd_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(qkv_b), mask,
      static_cast<const T*>(g), static_cast<T*>(dqkv), L, H, Dh, scale, tiles ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// qkv and dqkv [B, L, 3*H*Dh], g [B, L, H*Dh], all contiguous in `dtype`;
// qkv_b [3*H*Dh] in `dtype` or null; mask [L, L] fp32 or null; scale is
// 1/sqrt(Dh) rounded to fp32 by the caller.  Launches on `stream` of card
// `device` and returns cudaGetLastError() (0 = launched).
extern "C" int ccmh_attention_bwd(int device, const void* qkv, const void* qkv_b,
                                  const float* mask, const void* g, void* dqkv, int B,
                                  int L, int H, int Dh, float scale, int dtype,
                                  void* stream) {
  if (B < 1 || H < 1 || H > 65535 || L < 1 || L > kMaxL || Dh < 1 || Dh > kMaxDh)
    return (int)cudaErrorInvalidValue;
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: name the card of the tensors
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ccmh::kFloat32:
      return (int)launch<float>(device, qkv, qkv_b, mask, g, dqkv, B, L, H, Dh, scale, s);
    case ccmh::kBFloat16:
      return (int)launch<__nv_bfloat16>(device, qkv, qkv_b, mask, g, dqkv, B, L, H, Dh,
                                        scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
