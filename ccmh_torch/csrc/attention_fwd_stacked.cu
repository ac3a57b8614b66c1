// The head-stacked attention forward of tools/bench_attn_bwd.py, for the
// short sequences of the CLIP towers (vision L=50, text L=32; Dh=64).
//
// Replaces: tools/bench_attn_bwd.py `forward_stacked` (:258) /
// `_fwd_kernel_stacked` (:235) (#7, a Pallas TPU kernel).  Kernel #1's
// function (attention.cu) with no projection bias: per batch element and
// head, logits = (q . k) * scale + mask in fp32 (the TPU kernel stacks the
// heads' logits [bb, H, L, L] before one softmax over the last axis, which
// changes the schedule only), an fp32 row softmax, the probabilities
// rounded to T, and ctx = p . v summed in fp32 and stored in T into out
// [B, L, D].
//
// What bounds it on an H100: bytes.  At B=256 the vision call (L=50, H=12)
// reads 59 MB of qkv and writes 20 MB of context in bf16, 79 MB in all (24
// us at 3.35 TB/s; fp32 47 us), the text call 25 + 8 MB (10 us; fp32 20
// us).  Its 4 B H L^2 Dh = 2.0 GFLOP (vision) take 2 us at the bf16
// tensor-core peak and 12 us as 3xTF32.
//
// Design.  The TPU's batch block bb (a sequential grid step on one core)
// would be a loop that starves the card here, so bb no longer shapes the
// grid: it stays in the C signature, and the wrapper still checks that it
// divides B.  One block per (batch element, head group of hg heads): a
// grid of (B, ceil(H / hg)), hg = kGroup* below (what measured fastest,
// PERF.md: one head a block, but two in bf16 at L <= 32; 1 where hg heads
// do not fit shared memory).  The block's q, k and v row segments are hg Dh contiguous
// elements of each row: all three are copied into shared memory by 16-byte
// cp.async, consecutive threads on consecutive addresses across the
// group's heads (the one thing the "stacked" schedule can mean on this
// card), into one [pad16(L)][ld] tile per (part, head), zero-padded; scalar
// loads where Dh sizeof(T), the row stride or a pointer is not a 16-byte
// multiple.  Each warp owns one (head, 16-query tile) and runs both products
// on the tensor cores with mma.sync (bf16 m16n8k16; fp32 as 3xTF32
// m16n8k8, mma_tiles.cuh): S = q k^T stays in registers, the row max and sum
// are shuffled over the 4 lanes of a row, each mask element is read once by
// the lane that holds it, P is rounded to T and repacked in registers as the
// A operand of P . V; no [L, L] stack in shared memory.  The context tile
// is staged in T over the warp's own q rows and stored with coalesced
// 16-byte stores where aligned.  Register arrays are sized by a class: L and
// Dh up to 64, or up to 128.  Shares mma_tiles.cuh with kernel #1, not its
// kernel.
//
// Shared memory, 3 hg pad16(L) (pad16(Dh) + 8 | 4) elements of T (bf16 |
// fp32): at L=50, Dh=64 and hg=1 13.8 KB bf16 / 26.1 KB fp32, twice that at
// hg=2, four times at hg=4.

#include "mma_tiles.cuh"

namespace {

using namespace ccmh::mma;

constexpr int kMaxL = 128;
constexpr int kMaxDh = 128;
// heads a block (PERF.md: hg in {1, 2, 4} measured): one, but two in bf16
// where a head has at most two 16-query tiles (L <= 32), whose one-head
// blocks of 2 warps measured slower
constexpr int kGroupBf16Short = 2;   // pad16(L) <= 32
constexpr int kGroupBf16 = 1;
constexpr int kGroupF32 = 1;

template <typename T>
size_t group_smem(int L, int Dh, int hg) {
  return (size_t)3 * hg * pad16(L) * tile_ld<T>(Dh) * sizeof(T);
}

// The q | k | v rows of heads h0 .. h0 + hn - 1 (hn <= HG) of one batch
// element into the [3][HG][pad16(L)][ld] tiles at smem, padding zeroed: src
// is the element's row 0 at head h0's q slice (part p at + p D, row l at
// + l D3).  Walked as rows r = l HG + head, so that consecutive threads
// copy consecutive addresses across the group's heads.
template <typename T, int HG>
__device__ __forceinline__ void load_group(T* smem, int Lp, int ld, const T* __restrict__ src,
                                           int D, size_t D3, int L, int Dh, int hn, bool vec) {
  constexpr int E = 16 / sizeof(T);
  for (int t = 0; t < 3 * HG; ++t) zero_pad<T>(smem + t * Lp * ld, ld, L, Dh);
  const int rows = L * HG;
  for (int part = 0; part < 3; ++part) {
    T* dst = smem + part * HG * Lp * ld;
    const T* s = src + part * D;
    if (vec) {
      for (Walk w(threadIdx.x, blockDim.x, Dh / E); w.r < rows; w.next()) {
        const int l = w.r / HG, hh = w.r % HG;
        if (hh < hn)
          cp_async16(dst + (hh * Lp + l) * ld + w.c * E, s + l * D3 + hh * Dh + w.c * E);
      }
    } else {
      for (Walk w(threadIdx.x, blockDim.x, Dh); w.r < rows; w.next()) {
        const int l = w.r / HG, hh = w.r % HG;
        if (hh < hn) dst[(hh * Lp + l) * ld + w.c] = s[l * D3 + hh * Dh + w.c];
      }
    }
  }
  if (vec) cp_async_wait_all();
  __syncthreads();
}

// bf16 at L, Dh <= 64: 8 / HG blocks an SM (64 registers), as kernel #1;
// fp32 and the larger classes take what they need
template <typename T, int LMAX, int DMAX, int HG>
__global__ void __launch_bounds__(HG * LMAX / 16 * 32,
                                  LMAX == 64 && DMAX == 64 && sizeof(T) == 2 ? 8 / HG : 1)
fwd_stacked_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                   T* __restrict__ out, int L, int H, int Dh, float scale, int vec) {
  using F = Frag<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int Lp = pad16(L), Dp = pad16(Dh), ld = tile_ld<T>(Dh);
  const int b = blockIdx.x, h0 = blockIdx.y * HG, hn = min(HG, H - h0);
  const int D = H * Dh, D3 = 3 * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_group<T, HG>(smem, Lp, ld, qkv + (size_t)b * L * D3 + h0 * Dh, D, D3, L, Dh, hn,
                    vec != 0);

  const int n_kt = Lp / 16;     // 16-key blocks (and query tiles a head)
  const int n_dk = Dp / 16;     // 16-dim blocks
  const int hh = warp / n_kt, m0 = (warp - hh * n_kt) * 16;
  if (hh >= hn) return;         // the last group's missing heads (no barrier follows)
  T* sq = smem + hh * Lp * ld;
  const T* sk = smem + (HG + hh) * Lp * ld;
  const T* sv = smem + (2 * HG + hh) * Lp * ld;

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
    store_rows<T>(out + ((size_t)b * L + m0) * D + (h0 + hh) * Dh, D, sq + m0 * ld, ld,
                  min(16, L - m0), Dh, vec != 0, lane);
}

template <typename T, int LMAX, int DMAX, int HG>
cudaError_t launch_class(const void* qkv, const float* mask, void* out, int B, int L, int H,
                         int Dh, float scale, bool vec, cudaStream_t stream) {
  auto kernel = fwd_stacked_kernel<T, LMAX, DMAX, HG>;
  const size_t smem = group_smem<T>(L, Dh, HG);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, (H + HG - 1) / HG);
  kernel<<<grid, HG * pad16(L) / 16 * 32, smem, stream>>>(
      static_cast<const T*>(qkv), mask, static_cast<T*>(out), L, H, Dh, scale, vec ? 1 : 0);
  return cudaGetLastError();
}

template <typename T, int HG>
cudaError_t launch_group(const void* qkv, const float* mask, void* out, int B, int L, int H,
                         int Dh, float scale, bool vec, cudaStream_t stream) {
  const bool small_l = pad16(L) <= 64, small_d = pad16(Dh) <= 64;
  if (small_l && small_d)
    return launch_class<T, 64, 64, HG>(qkv, mask, out, B, L, H, Dh, scale, vec, stream);
  if (small_l)
    return launch_class<T, 64, 128, HG>(qkv, mask, out, B, L, H, Dh, scale, vec, stream);
  if (small_d)
    return launch_class<T, 128, 64, HG>(qkv, mask, out, B, L, H, Dh, scale, vec, stream);
  return launch_class<T, 128, 128, HG>(qkv, mask, out, B, L, H, Dh, scale, vec, stream);
}

template <typename T, int HG>
cudaError_t launch_hg(int optin, const void* qkv, const float* mask, void* out, int B, int L,
                      int H, int Dh, float scale, bool vec, cudaStream_t stream) {
  if constexpr (HG > 1) {
    // a group of HG heads where H has them and they fit (HG 16-row warps
    // of the 128-row class stay within 1024 threads up to HG = 4)
    if (H >= HG && group_smem<T>(L, Dh, HG) <= (size_t)optin)
      return launch_group<T, HG>(qkv, mask, out, B, L, H, Dh, scale, vec, stream);
  }
  if (group_smem<T>(L, Dh, 1) > (size_t)optin) return cudaErrorInvalidValue;
  return launch_group<T, 1>(qkv, mask, out, B, L, H, Dh, scale, vec, stream);
}

template <typename T>
cudaError_t launch(int device, const void* qkv, const float* mask, void* out, int B, int L,
                   int H, int Dh, float scale, cudaStream_t stream) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                           device);
  if (err != cudaSuccess) return err;
  // 16-byte copies need 16-byte head rows, row strides and base pointers
  const bool vec = (Dh * sizeof(T)) % 16 == 0 && aligned16(qkv) && aligned16(out);
  if constexpr (sizeof(T) == 2) {
    if (pad16(L) <= 32)
      return launch_hg<T, kGroupBf16Short>(optin, qkv, mask, out, B, L, H, Dh, scale, vec,
                                           stream);
    return launch_hg<T, kGroupBf16>(optin, qkv, mask, out, B, L, H, Dh, scale, vec, stream);
  } else {
    return launch_hg<T, kGroupF32>(optin, qkv, mask, out, B, L, H, Dh, scale, vec, stream);
  }
}

}  // namespace

// qkv [B, L, 3*H*Dh] and out [B, L, H*Dh] contiguous in `dtype` (0 fp32,
// 1 bf16); mask [L, L] fp32 or null; scale is 1/sqrt(Dh) rounded to fp32
// by the caller; bb is the TPU kernel's batch block, checked here and no
// longer shaping the grid.  Launches on `stream` of card `device` and
// returns cudaGetLastError() (0 = launched).
extern "C" int ccmh_attention_fwd_stacked(int device, const void* qkv, const float* mask,
                                          void* out, int B, int L, int H, int Dh, int bb,
                                          float scale, int dtype, void* stream) {
  if (B < 1 || bb < 1 || H < 1 || H > 65535 || L < 1 || L > kMaxL ||
      Dh < 1 || Dh > kMaxDh)
    return (int)cudaErrorInvalidValue;
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: name the card of the tensors
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ccmh::kFloat32:
      return (int)launch<float>(device, qkv, mask, out, B, L, H, Dh, scale, s);
    case ccmh::kBFloat16:
      return (int)launch<__nv_bfloat16>(device, qkv, mask, out, B, L, H, Dh, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
