// The saved-probabilities attention backward of tools/bench_attn_bwd.py
// (#8), for the short sequences of the CLIP towers (vision L=50, text L=32;
// Dh=64).
//
// Replaces: tools/bench_attn_bwd.py `backward_savedp` (:322) /
// `_bwd_kernel_savedp`, a Pallas TPU kernel.  Kernel #2's function
// (attention_bwd.cu) with no projection bias and no softmax recompute: per
// (batch element, head), from qkv [B, L, 3D], g [B, L, D] and the saved
// probs [B, H, L, L] in T (the mask is not read),
//   p = probs in fp32,                 dprobs = g . v,
//   dlogits = p * (dprobs - sum_j dprobs * p),
//   probs_c = p -> T,                  dlogits_c = (dlogits * scale) -> T,
//   dq = dlogits_c . k,  dk = dlogits_c^T . q,  dv = probs_c^T . g,
// each product summed in fp32 and stored in T into dqkv [B, L, 3D].  (#6
// and #10 are attention_bwd_x.cu, #9 attention_merged.cu, #7
// attention_fwd_stacked.cu, all on the tensor cores.)
//
// What bounds it on an H100: bytes.  The vision call at B=256 bf16 reads
// 59 MB of qkv, 20 MB of g and 15.4 MB of probs and writes 59 MB of dqkv
// (46 us at 3.35 TB/s).
//
// Design: kernel #2's two phases for one (rows, head) unit, bwd_unit
// below: A. query-major, k and v in shared memory, a warp carries 4 query
// rows and a lane keys j = lane + 32 t, writing dq; B. key-major, q and g
// in shared memory, dk and dv summed over the queries in order, from the
// [n, n] probs_c and dlogits_c tiles phase A left in shared memory where
// they fit, else recomputed from the saved probabilities.  A block walks
// its bb batch elements one unit after the other (the TPU grid's batch
// block), a grid of (B / bb, H).  Simple first: no tensor cores, no TMA;
// fp32 FMAs.

#include "attention_rows.cuh"

namespace {

using namespace attn;

constexpr int kSlots = 4;         // L <= 128 keys a unit
constexpr int kMaxL = 128;

struct Args {
  int device;
  const void* qkv;
  const void* probs;   // [B, H, L, L] in T
  const void* g;
  void* dqkv;
  int B, L, H, Dh, bb;
  float scale;
  cudaStream_t stream;
};

// k and v (then q and g) [n, ld], the warps' staging rows, the two [n, n]
// tiles when kept, and the rows' sum_j dprobs * probs
size_t unit_floats(int n, int Dh, bool tiles) {
  return (size_t)(2 * n + kWarps * 2 * kRows) * row_stride(Dh) +
         (tiles ? 2 * (size_t)n * tile_stride(n) : 0) + (size_t)n;
}

// dlogits_c of one entry: p the fp32 probability, u = dprobs, dot the
// row's sum_j dprobs * probs
template <typename T>
__device__ __forceinline__ float dlogit_c(float p, float u, float dot, float scale) {
  return ccmh::round_to<T>(p * (u - dot) * scale);
}

// One unit: rows row0 .. row0 + n - 1 of qkv / g / dqkv (n = L), each
// attending to the same n rows, head h; probs is the unit's [n, n] block
// in T.
template <typename T, int S>
__device__ void bwd_unit(const T* __restrict__ qkv, const T* __restrict__ g,
                         const T* __restrict__ probs, T* __restrict__ dqkv, size_t row0,
                         int n, int h, int H, int Dh, float scale, bool tiles, float* smem) {
  const int dp = padded_dim(Dh);
  const int ld = row_stride(Dh);
  const int D = H * Dh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float* big0 = smem;                                   // [n, ld]: k in A, q in B
  float* big1 = smem + n * ld;                          // [n, ld]: v in A, g in B
  float* stage_b = smem + 2 * n * ld + (warp * 2 + 1) * kRows * ld;   // the warp's rows
  const float* b_rows[kRows] = {stage_b, stage_b + ld, stage_b + 2 * ld, stage_b + 3 * ld};
  const int ldt = tile_stride(n);
  float* tile_p = smem + (2 * n + kWarps * 2 * kRows) * ld;     // [n, ldt]: probs_c
  float* tile_s = tile_p + n * ldt;                             // [n, ldt]: dlogits_c
  float* row_dot = tiles ? tile_s + n * ldt : tile_p;           // [n]

  __syncthreads();   // the block's previous unit is done with shared memory
  // ---- phase A: k | v of head h into shared memory; a warp per row
  for (int pr = warp; pr < 2 * n; pr += kWarps) {
    const int which = pr / n, l = pr - which * n;
    load_row<T>((which ? big1 : big0) + l * ld, qkv, g, row0 + l, 1 + which, h, Dh, D, dp,
                lane);
  }
  __syncthreads();

  for (int i0 = warp * kRows; i0 < n; i0 += kWarps * kRows) {
    __syncwarp();
    // rows past n are clamped to n-1 for reading and never stored
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      load_row<T>(stage_b + r * ld, qkv, g, row0 + min(i0 + r, n - 1), 3, h, Dh, D, dp, lane);
    __syncwarp();
    float s[kRows][S], u[kRows][S];   // probs (then dlogits_c), g_i . v_j
    dot_rows<S>(b_rows, big1, n, dp, ld, lane, u);

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = min(i0 + r, n - 1);
#pragma unroll
      for (int t = 0; t < S; ++t) {
        const int j = t * 32 + lane;
        s[r][t] = j < n ? ccmh::to_float(probs[(size_t)i * n + j]) : 0.f;
      }
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < S; ++t) dot = fmaf(u[r][t], s[r][t], dot);
      dot = ccmh::warp_sum(dot);
#pragma unroll
      for (int t = 0; t < S; ++t) {
        const float p = s[r][t];
        s[r][t] = dlogit_c<T>(p, u[r][t], dot, scale);
        const int j = t * 32 + lane;
        if (tiles && i0 + r < n && j < n) {
          tile_p[i * ldt + j] = ccmh::round_to<T>(p);
          tile_s[i * ldt + j] = s[r][t];
        }
      }
      if (lane == 0 && i0 + r < n) row_dot[i] = dot;
    }

    // dq = dlogits_c . k over the keys in order
    float2 acc[kRows][kDimPairs];
    zero(acc);
    weighted_rows<S>(s, big0, n, dp, ld, lane, acc);
    store_rows<T>(dqkv, acc, row0 + i0, n - i0, 3 * D, h * Dh, Dh, lane);
  }
  __syncthreads();   // every warp is done with k, v and has written its statistics

  // ---- phase B: q | g of head h into shared memory
  for (int pr = warp; pr < 2 * n; pr += kWarps) {
    const int which = pr / n, l = pr - which * n;
    load_row<T>((which ? big1 : big0) + l * ld, qkv, g, row0 + l, which ? 3 : 0, h, Dh, D, dp,
                lane);
  }
  __syncthreads();

  if (tiles) {
    // the warp's 4 keys j0..j0+3 are 4 adjacent tile columns: one float4
    // broadcast per query brings their weights (columns past n are never
    // stored)
    for (int j0 = warp * kRows; j0 < n; j0 += kWarps * kRows) {
      float2 dk[kRows][kDimPairs], dv[kRows][kDimPairs];
      zero(dk);
      zero(dv);
      for (int i = 0; i < n; ++i) {
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
      store_rows<T>(dqkv, dk, row0 + j0, n - j0, 3 * D, D + h * Dh, Dh, lane);
      store_rows<T>(dqkv, dv, row0 + j0, n - j0, 3 * D, 2 * D + h * Dh, Dh, lane);
    }
    return;
  }

  for (int j0 = warp * kRows; j0 < n; j0 += kWarps * kRows) {
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      load_row<T>(stage_b + r * ld, qkv, g, row0 + min(j0 + r, n - 1), 2, h, Dh, D, dp, lane);
    __syncwarp();
    float s[kRows][S], u[kRows][S];   // v_j . g_i
    dot_rows<S>(b_rows, big1, n, dp, ld, lane, u);

    // lane's queries i = lane + 32 t: probs_c into u, dlogits_c into s, with
    // phase A's row statistic (the same fmaf chains, so the same bits)
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const int i = t * 32 + lane;
      const bool live = i < n;
      const float dot = live ? row_dot[i] : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int j = min(j0 + r, n - 1);
        const float p = live ? ccmh::to_float(probs[(size_t)i * n + j]) : 0.f;
        s[r][t] = live ? dlogit_c<T>(p, u[r][t], dot, scale) : 0.f;
        u[r][t] = ccmh::round_to<T>(p);
      }
    }

    // dk = dlogits_c^T . q and dv = probs_c^T . g over the queries in order
    float2 acc[kRows][kDimPairs];
    zero(acc);
    weighted_rows<S>(s, big0, n, dp, ld, lane, acc);
    store_rows<T>(dqkv, acc, row0 + j0, n - j0, 3 * D, D + h * Dh, Dh, lane);
    zero(acc);
    weighted_rows<S>(u, big1, n, dp, ld, lane, acc);
    store_rows<T>(dqkv, acc, row0 + j0, n - j0, 3 * D, 2 * D + h * Dh, Dh, lane);
  }
}

// The units (batch element, head) of the block's bb elements, one after
// the other
template <typename T>
__global__ void __launch_bounds__(kWarps * 32, 3)
savedp_kernel(const T* __restrict__ qkv, const T* __restrict__ probs, const T* __restrict__ g,
              T* __restrict__ dqkv, int B, int L, int H, int Dh, int bb, float scale,
              int tiles) {
  extern __shared__ __align__(16) float smem[];
  const int b0 = blockIdx.x * bb, b1 = min(B, b0 + bb);
  const int h = blockIdx.y;
  for (int b = b0; b < b1; ++b)
    bwd_unit<T, kSlots>(qkv, g, probs + ((size_t)b * H + h) * L * L, dqkv, (size_t)b * L, L, h,
                        H, Dh, scale, tiles != 0, smem);
}

template <typename T>
cudaError_t launch(const Args& a) {
  const int optin = smem_optin(a.device);
  // keep the [L, L] tiles of phase A for phase B where they fit
  const bool tiles = unit_floats(a.L, a.Dh, true) * sizeof(float) <= (size_t)optin;
  const size_t smem = unit_floats(a.L, a.Dh, tiles) * sizeof(float);
  cudaError_t err = set_smem(savedp_kernel<T>, smem, optin);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.B + a.bb - 1) / a.bb), a.H);
  savedp_kernel<T><<<grid, kWarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.qkv), static_cast<const T*>(a.probs), static_cast<const T*>(a.g),
      static_cast<T*>(a.dqkv), a.B, a.L, a.H, a.Dh, a.bb, a.scale, tiles ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// #8: qkv and dqkv [B, L, 3*H*Dh], g [B, L, H*Dh], probs [B, H, L, L], all
// contiguous in `dtype` (0 fp32, 1 bf16); scale is 1/sqrt(Dh) rounded to
// fp32 by the caller; a block walks bb batch elements.  Launches on
// `stream` of card `device` and returns cudaGetLastError() (0 = launched).
extern "C" int ccmh_attention_bwd_savedp(int device, const void* qkv, const void* probs,
                                         const void* g, void* dqkv, int B, int L, int H,
                                         int Dh, int bb, float scale, int dtype, void* stream) {
  if (B < 1 || bb < 1 || H < 1 || H > 65535 || L < 1 || L > kMaxL || Dh < 1 || Dh > kMaxDh)
    return (int)cudaErrorInvalidValue;
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: name the card of the tensors
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{device, qkv, probs, g, dqkv, B, L, H, Dh, bb, scale,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case ccmh::kFloat32: return (int)launch<float>(a);
    case ccmh::kBFloat16: return (int)launch<__nv_bfloat16>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
