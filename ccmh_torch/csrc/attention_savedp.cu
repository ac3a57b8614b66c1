// The saved-probabilities attention backward of tools/bench_attn_bwd.py
// (#8), on the tensor cores.
//
// Replaces: tools/bench_attn_bwd.py `backward_savedp` (:322) /
// `_bwd_kernel_savedp` (:287), a Pallas TPU kernel.  Kernel #2's function
// (attention_bwd.cu) with no projection bias and no softmax recompute: per
// (batch element, head), from qkv [B, L, 3D], g [B, L, D] and the saved
// probs [B, H, L, L] in T (the mask is not read),
//   p = probs in fp32,                 dprobs = g . v,
//   dlogits = p * (dprobs - sum_j dprobs * p),
//   dlogits_c = (dlogits * scale) -> T,
//   dq = dlogits_c . k,  dk = dlogits_c^T . q,  dv = probs^T . g,
// each product summed in fp32 and stored in T into dqkv [B, L, 3D].
//
// What bounds it on an H100: bytes.  The vision call at B=256 bf16 reads
// 59 MB of qkv, 20 MB of g and 15.4 MB of probs and writes 59 MB of dqkv
// (46 us at 3.35 TB/s; fp32 91 us).  The four products, 8 B H L^2 Dh =
// 3.9 GFLOP, take 24 us as 3xTF32 at 495/3 TFLOP/s.
//
// Design: #6 `full`'s tile design and schedule (attention_bwd_x.cu) with
// the saved P tile in place of the S product and the softmax.  A block of
// pad16(L) / 16 warps walks its bb batch elements of one head, a grid of
// (B / bb, H), one (element, head) unit at a time:
//   0. k, v, g and the unit's [L, L] probabilities into [pad16(L)][ld]
//      tiles of shared memory in T (cp.async: 16-byte operand rows where
//      aligned, probability rows in the widest copy their alignment allows,
//      16, 8 or 4 bytes, bf16 rows of 2-byte alignment by scalar copies);
//      q, needed only in phase 2, lands during phase 1;
//   1. query-major, a warp per 16 queries: dP = g v^T in registers on
//      mma.sync (bf16 m16n8k16; fp32 as 3xTF32 m16n8k8 with the split toward
//      zero, FragTz), p read from the P tile at the accumulators' own
//      positions, the rows' sum_j dP p over the quad, dS_c into the dS tile
//      and dq = dS_c k from the registers;
//   2. key-major, a warp per 16 keys: dv = P^T g and dk = dS_c^T q from the
//      two [L, L] tiles (ldmatrix.trans in bf16).
// Outputs go from the accumulators to device memory in pairs of columns.
// The next unit's k and v (dead after phase 1) are copied during phase 2,
// its g and probabilities after it, its q during its phase 1.  The padding
// of every tile (rows and columns L .. pad16(L) - 1 of P) is zeroed once:
// the loads write rows < L and columns < L (or Dh) only, so a padded p is
// 0 and so is its dS.  fp32 where the four operand tiles and the two [L, L]
// tiles do not fit (from L = 113 at Dh = 64, from L = 81 at Dh = 128) runs
// the stream path: k and v in shared memory for phase 1, q and g for
// phase 2, the dS tile, and g's fragments in phase 1 and P's in both phases
// read from device memory.  The plan (path, probability copy width,
// shared-memory bytes) is made in Python (ccmh_torch/ops/attention_variants.py
// `_savedp_plan`) and checked here: the entry refuses a plan it does not
// compute the same way.
//
// Shared memory: 4 pad16(L) ld + 2 pad16(L) ldt elements of T (ld =
// pad16(Dh) + 8 | 4, ldt = pad16(L) + 8 | 4, bf16 | fp32): vision Dh=64
// 55,296 bytes bf16 / 104,448 fp32, text 23,552 / 44,032.  Stream (fp32):
// 2 pad16(L) ld + pad16(L) ldt floats, 202,752 bytes at L = Dh = 128.

#include "bwd_tiles.cuh"

namespace {

using namespace ccmh::mma;
using namespace ccmh::bwd;

constexpr int kMaxL = 128;
constexpr int kMaxDh = 128;

// the plan's path (ccmh_torch/ops/attention_variants.py SAVEDP_PATHS)
enum Path : int { kTiles = 0, kStream = 1 };

struct Args {
  int L, H, Dh, bb;
  float scale;
  int width;   // bytes a copy of probability rows: 16, 8, 4 or (bf16) 2
  int vec;     // 16-byte operand loads, pairs of columns stored
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for every committed group but the last
__device__ __forceinline__ void cp_async_wait_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The unit's [L, L] probabilities (row i at src + i L) into rows and
// columns 0 .. L - 1 of the tile dst (row stride ldt), its padding left as
// it is: cp.async copies of `width` bytes (16, 8 or 4), or scalar copies
// (width 2, bf16).  Every thread of the block takes part.
template <typename T>
__device__ __forceinline__ void copy_probs(T* dst, int ldt, const T* __restrict__ src, int L,
                                           int width) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (width < 4) {
    for (Walk w(tid, nt, L); w.r < L; w.next()) dst[w.r * ldt + w.c] = src[w.r * L + w.c];
    return;
  }
  const int E = width / (int)sizeof(T);
  for (Walk w(tid, nt, L / E); w.r < L; w.next()) {
    T* d = dst + w.r * ldt + w.c * E;
    const T* s = src + w.r * L + w.c * E;
    if (width == 16)
      cp_async16(d, s);
    else if (width == 8)
      cp_async8(d, s);
    else
      cp_async4(d, s);
  }
}

// (x[0], x[1]) of T as fp32
__device__ __forceinline__ float2 load2(const float* x) {
  return *reinterpret_cast<const float2*>(x);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x));
}

// A warp's accumulator tiles dp[j] (g v^T: queries m0 + g and m0 + g + 8,
// keys 8 j + 2 t (+1)) become dS_c = (p (dP - sum_j dP p) scale) -> T in
// place, p_at(i, j) giving (p[i][j], p[i][j + 1]) in fp32, 0 where padded;
// n_tiles counts the tiles up to pad16(L)
template <typename T, int N, typename PAt>
__device__ __forceinline__ void ds_tile(float (&dp)[N][4], PAt p_at, int n_tiles, float scale,
                                        int m0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int i0 = m0 + g, i1 = i0 + 8;
  float dot[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j < n_tiles) {
      const float2 p0 = p_at(i0, 8 * j + 2 * t), p1 = p_at(i1, 8 * j + 2 * t);
      dot[0] = fmaf(dp[j][0], p0.x, dot[0]);
      dot[0] = fmaf(dp[j][1], p0.y, dot[0]);
      dot[1] = fmaf(dp[j][2], p1.x, dot[1]);
      dot[1] = fmaf(dp[j][3], p1.y, dot[1]);
    }
  }
  dot[0] = quad_sum(dot[0]);
  dot[1] = quad_sum(dot[1]);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j < n_tiles) {
      const float2 p0 = p_at(i0, 8 * j + 2 * t), p1 = p_at(i1, 8 * j + 2 * t);
      dp[j][0] = ccmh::round_to<T>(p0.x * (dp[j][0] - dot[0]) * scale);
      dp[j][1] = ccmh::round_to<T>(p0.y * (dp[j][1] - dot[0]) * scale);
      dp[j][2] = ccmh::round_to<T>(p1.x * (dp[j][2] - dot[1]) * scale);
      dp[j][3] = ccmh::round_to<T>(p1.y * (dp[j][3] - dot[1]) * scale);
    }
  }
}

template <typename T>
size_t tiles_smem(int L, int Dh) {
  const size_t Lp = pad16(L);
  return (4 * Lp * tile_ld<T>(Dh) + 2 * Lp * tile_ld<T>(L)) * sizeof(T);
}

size_t stream_smem(int L, int Dh) {
  const size_t Lp = pad16(L);
  return (2 * Lp * tile_ld<float>(Dh) + Lp * tile_ld<float>(L)) * sizeof(float);
}

// ---- the tile path

template <typename T, int LMAX, int DMAX>
__global__ void __launch_bounds__(LMAX / 16 * 32)
tiles_kernel(const T* __restrict__ qkv, const T* __restrict__ probs, const T* __restrict__ gin,
             T* __restrict__ dqkv, Args a) {
  using F = FragTz<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = a.L, H = a.H, Dh = a.Dh;
  const int Lp = pad16(L), ld = tile_ld<T>(Dh), ldt = tile_ld<T>(L);
  const int D = H * Dh, D3 = 3 * D;
  const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16;
  T* const sq = reinterpret_cast<T*>(smem_raw);
  T* const sk = sq + Lp * ld;
  T* const sv = sk + Lp * ld;
  T* const sg = sv + Lp * ld;
  T* const ts = sg + Lp * ld;     // dS_c [query][key]
  T* const tp = ts + Lp * ldt;    // the saved probabilities [query][key]
  const int h = blockIdx.y, b0 = blockIdx.x * a.bb;
  const int n_kt = Lp / 16, n_dk = pad16(Dh) / 16;
  const bool vec = a.vec != 0;

  // parts of element b: q, k, v, g (bits 0-3) and the probabilities (bit 4)
  auto load = [&](int b, int parts) {
    const T* src = qkv + (size_t)b * L * D3 + h * Dh;
    for (int p = 0; p < 4; ++p)
      if (parts >> p & 1)
        copy_rows<T>(sq + p * Lp * ld, ld, p < 3 ? src + p * D : gin + (size_t)b * L * D + h * Dh,
                     p < 3 ? D3 : D, L, Dh, vec, threadIdx.x, blockDim.x);
    if (parts >> 4 & 1) copy_probs<T>(tp, ldt, probs + ((size_t)b * H + h) * L * L, L, a.width);
  };
  // the padding of every operand tile and of the P tile, once
  for (int p = 0; p < 4; ++p) zero_pad<T>(sq + p * Lp * ld, ld, L, Dh);
  zero_pad<T>(tp, ldt, L, L);
  load(b0, 0x1E);
  cp_async_commit();
  load(b0, 0x1);
  cp_async_commit();
  cp_async_wait_but_last();
  __syncthreads();

  for (int s = 0; s < a.bb; ++s) {
    const int b = b0 + s;
    T* out = dqkv + (size_t)b * L * D3 + h * Dh;
    // ---- phase 1: the warp's 16 queries
    {
      float dp[LMAX / 8][4];
      zero(dp);
      rows_by_rows<T>(dp, sg, sv, ld, m0, n_kt, n_dk, lane);
      ds_tile<T>(dp, [&](int i, int j) { return load2(tp + i * ldt + j); }, 2 * n_kt, a.scale,
                 m0, lane);
      stage_acc<T>(ts + m0 * ldt, ldt, dp, 2 * n_kt, lane);
      float dq[DMAX / 8][4];
      zero(dq);
      times_rows<T, LMAX / 16>(dq, [&](int kb) { return F::a_acc(dp[2 * kb], dp[2 * kb + 1]); },
                               sk, ld, n_kt, n_dk, lane);
      store_acc<T>(out, D3, dq, 2 * n_dk, m0, L, Dh, vec, lane);
    }
    cp_async_wait_all();   // this unit's q
    __syncthreads();       // k and v are read no more; the dS tile is complete
    const bool next = s + 1 < a.bb;
    if (next) {
      load(b + 1, 0x6);
      cp_async_commit();
    }
    // ---- phase 2: the warp's 16 keys (m0 .. m0 + 15)
    {
      float acc[DMAX / 8][4];
      zero(acc);
      times_rows<T, LMAX / 16>(acc, [&](int kb) { return F::a_cols(tp, ldt, m0, kb * 16, lane); },
                               sg, ld, n_kt, n_dk, lane);
      store_acc<T>(out + 2 * D, D3, acc, 2 * n_dk, m0, L, Dh, vec, lane);
      zero(acc);
      times_rows<T, LMAX / 16>(acc, [&](int kb) { return F::a_cols(ts, ldt, m0, kb * 16, lane); },
                               sq, ld, n_kt, n_dk, lane);
      store_acc<T>(out + D, D3, acc, 2 * n_dk, m0, L, Dh, vec, lane);
    }
    if (next) {
      __syncthreads();   // q, g and the two [L, L] tiles are read no more
      load(b + 1, 0x18);
      cp_async_commit();
      load(b + 1, 0x1);
      cp_async_commit();
      cp_async_wait_but_last();   // all but q
      __syncthreads();
    }
  }
}

// ---- the stream path (fp32 only)

// A fragment ("cols" order) of P^T for keys m0 .. m0 + 15 and queries
// k0 .. k0 + 15, read from the unit's [L, L] probabilities in device
// memory: A[m][k] = P[k0 + k][m0 + m], 0 past L
__device__ __forceinline__ FragTz<float>::A a_cols_gmem(const float* __restrict__ P, int L,
                                                       int m0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  auto x = [&](int r, int c) { return (r < L && c < L) ? __ldg(P + r * L + c) : 0.f; };
  FragTz<float>::A a;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int r = k0 + 8 * s + 2 * t, c = m0 + g;
    FragTz<float>::set_a(a, s, x(r, c), x(r, c + 8), x(r + 1, c), x(r + 1, c + 8));
  }
  return a;
}

template <int LMAX, int DMAX>
__global__ void __launch_bounds__(LMAX / 16 * 32)
stream_kernel(const float* __restrict__ qkv, const float* __restrict__ probs,
              const float* __restrict__ gin, float* __restrict__ dqkv, Args a) {
  using F = FragTz<float>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = a.L, H = a.H, Dh = a.Dh;
  const int Lp = pad16(L), ld = tile_ld<float>(Dh), ldt = tile_ld<float>(L);
  const int D = H * Dh, D3 = 3 * D;
  const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16;
  float* const x0 = reinterpret_cast<float*>(smem_raw);   // k in phase 1, q in phase 2
  float* const x1 = x0 + Lp * ld;                         // v in phase 1, g in phase 2
  float* const ts = x1 + Lp * ld;                         // dS_c [query][key]
  const int h = blockIdx.y;
  const int n_kt = Lp / 16, n_dk = pad16(Dh) / 16;
  const bool vec = a.vec != 0;
  zero_pad<float>(x0, ld, L, Dh);
  zero_pad<float>(x1, ld, L, Dh);

  const int e0 = blockIdx.x * a.bb;
  for (int b = e0; b < e0 + a.bb; ++b) {
    const float* base = qkv + (size_t)b * L * D3 + h * Dh;
    const float* gbase = gin + (size_t)b * L * D + h * Dh;
    const float* pb = probs + ((size_t)b * H + h) * L * L;
    float* out = dqkv + (size_t)b * L * D3 + h * Dh;

    // ---- phase 1: k | v in shared memory; the warp's 16 queries
    copy_rows<float>(x0, ld, base + D, D3, L, Dh, vec, threadIdx.x, blockDim.x);
    copy_rows<float>(x1, ld, base + 2 * D, D3, L, Dh, vec, threadIdx.x, blockDim.x);
    if (vec) cp_async_wait_all();
    __syncthreads();
    {
      float dp[LMAX / 8][4];
      zero(dp);
#pragma unroll 1
      for (int kb = 0; kb < n_dk; ++kb) {
        const F::A ag = a_rows_gmem(gbase, D, m0, kb * 16, L, Dh, lane);
#pragma unroll
        for (int jp = 0; jp < LMAX / 16; ++jp) {
          if (jp < n_kt) {
            F::B b0, b1;
            F::b_rows(b0, b1, x1, ld, jp * 16, kb * 16, lane);
            F::mma(dp[2 * jp], ag, b0);
            F::mma(dp[2 * jp + 1], ag, b1);
          }
        }
      }
      ds_tile<float>(
          dp,
          [&](int i, int j) {
            const bool row = i < L;
            return make_float2(row && j < L ? __ldg(pb + i * L + j) : 0.f,
                               row && j + 1 < L ? __ldg(pb + i * L + j + 1) : 0.f);
          },
          2 * n_kt, a.scale, m0, lane);
      stage_acc<float>(ts + m0 * ldt, ldt, dp, 2 * n_kt, lane);
      float dq[DMAX / 8][4];
      zero(dq);
      times_rows<float, LMAX / 16>(
          dq, [&](int kb) { return F::a_acc(dp[2 * kb], dp[2 * kb + 1]); }, x0, ld, n_kt, n_dk,
          lane);
      store_acc<float>(out, D3, dq, 2 * n_dk, m0, L, Dh, vec, lane);
    }
    __syncthreads();   // k and v are read no more; the dS tile is complete

    // ---- phase 2: q | g in shared memory; the warp's 16 keys
    copy_rows<float>(x0, ld, base, D3, L, Dh, vec, threadIdx.x, blockDim.x);
    copy_rows<float>(x1, ld, gbase, D, L, Dh, vec, threadIdx.x, blockDim.x);
    if (vec) cp_async_wait_all();
    __syncthreads();
    {
      float acc[DMAX / 8][4];
      zero(acc);
      times_rows<float, LMAX / 16>(
          acc, [&](int kb) { return a_cols_gmem(pb, L, m0, kb * 16, lane); }, x1, ld, n_kt,
          n_dk, lane);
      store_acc<float>(out + 2 * D, D3, acc, 2 * n_dk, m0, L, Dh, vec, lane);
      zero(acc);
      times_rows<float, LMAX / 16>(
          acc, [&](int kb) { return F::a_cols(ts, ldt, m0, kb * 16, lane); }, x0, ld, n_kt,
          n_dk, lane);
      store_acc<float>(out + D, D3, acc, 2 * n_dk, m0, L, Dh, vec, lane);
    }
    __syncthreads();   // q, g and the dS tile are read no more
  }
}

// ---- launches

// the widest copy (bytes) that both the probabilities' start and the
// length of a row of L values divide: 16, 8 or 4, else (bf16) 2; every
// unit's block starts a whole number of rows in
int probs_width(int L, int itemsize, const void* probs) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(probs);
  for (int w = 16; w >= 4; w >>= 1)
    if ((L * itemsize) % w == 0 && p % w == 0) return w;
  return itemsize;
}

template <typename T>
cudaError_t launch(int device, const void* qkv, const void* probs, const void* g, void* dqkv,
                   int B, int L, int H, int Dh, int bb, int path, int width, int smem_bytes,
                   float scale, cudaStream_t stream) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                           device);
  if (err != cudaSuccess) return err;
  // the plan must be one this entry computes the same way and can run
  if ((path != kTiles && path != kStream) || (path == kStream && sizeof(T) != 4) ||
      width != probs_width(L, sizeof(T), probs))
    return cudaErrorInvalidValue;
  const size_t smem = path == kTiles ? tiles_smem<T>(L, Dh) : stream_smem(L, Dh);
  if (smem_bytes < 0 || smem != (size_t)smem_bytes || smem > (size_t)optin)
    return cudaErrorInvalidValue;
  Args a;
  a.L = L;
  a.H = H;
  a.Dh = Dh;
  a.bb = bb;
  a.scale = scale;
  a.width = width;
  a.vec = (Dh * sizeof(T)) % 16 == 0 && aligned16(qkv) && aligned16(g) && aligned16(dqkv);
  const T* q = static_cast<const T*>(qkv);
  const T* p = static_cast<const T*>(probs);
  const T* gg = static_cast<const T*>(g);
  T* out = static_cast<T*>(dqkv);
  auto go = [&](auto kernel) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(B / bb, H), pad16(L) / 16 * 32, smem, stream>>>(q, p, gg, out, a);
    return cudaGetLastError();
  };
  if (path == kStream) {
    if constexpr (sizeof(T) == 4) return go(stream_kernel<128, 128>);
    return cudaErrorInvalidValue;
  }
  if (pad16(L) > 64 || pad16(Dh) > 64) return go(tiles_kernel<T, 128, 128>);
  return go(tiles_kernel<T, 64, 64>);
}

}  // namespace

// #8: qkv and dqkv [B, L, 3*H*Dh], g [B, L, H*Dh], probs [B, H, L, L], all
// contiguous in `dtype` (0 fp32, 1 bf16); L, Dh <= 128, bb dividing B;
// scale is 1/sqrt(Dh) rounded to fp32 by the caller; a block walks bb
// batch elements of one head.  The plan, as `_savedp_plan` makes it: path
// (0 tiles, 1 stream: fp32 only), width (bytes a copy of probability rows:
// 16, 8, 4, or 2 for bf16 rows of 2-byte alignment) and smem_bytes.
// Launches on `stream` of card `device` and returns cudaGetLastError()
// (0 = launched), or cudaErrorInvalidValue for a shape or plan it does not
// take.
extern "C" int ccmh_attention_bwd_savedp(int device, const void* qkv, const void* probs,
                                         const void* g, void* dqkv, int B, int L, int H,
                                         int Dh, int bb, int path, int width, int smem_bytes,
                                         float scale, int dtype, void* stream) {
  if (B < 1 || bb < 1 || B % bb || H < 1 || H > 65535 || L < 1 || L > kMaxL || Dh < 1 ||
      Dh > kMaxDh)
    return (int)cudaErrorInvalidValue;
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: name the card of the tensors
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ccmh::kFloat32:
      return (int)launch<float>(device, qkv, probs, g, dqkv, B, L, H, Dh, bb, path, width,
                                smem_bytes, scale, s);
    case ccmh::kBFloat16:
      return (int)launch<__nv_bfloat16>(device, qkv, probs, g, dqkv, B, L, H, Dh, bb, path,
                                        width, smem_bytes, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
