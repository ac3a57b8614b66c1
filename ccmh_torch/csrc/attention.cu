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

#include <type_traits>

#include "attention_family.cuh"
#include "attention_long.cuh"
#include "mma_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace {

using namespace ccmh::mma;

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

// ---------------------------------------------------------------------------
// The long path, L > 128, for the shapes the wgmma kernels below do not
// take (a head dim other than 64, a pointer not 16-byte aligned:
// long_family): attention_long.cuh, one block per (batch element,
// head, 64-query tile), 4 warps of 16 queries.  The block's q tile stays in
// shared memory; the k tiles stream through twice, first for each row's
// softmax max and sum (RowStats), then with the v tiles for
// p = exp(x - max) / sum, rounded to T, times v, accumulated in registers.
// Shared memory 3 x 64 ld elements of T: Dh = 64 27.6 KB bf16 / 52.2 KB
// fp32, Dh = 128 52.2 / 101.4 KB.
//
// What bounds it on an H100: at ViT-L/14 (B = 64, L = 257, H = 16) bf16
// bytes (101 MB of qkv, 34 MB of context: 40 us at 3.35 TB/s), fp32 the
// 3xTF32 products (the function's 17.3 GFLOP at a third of the 495 TF32
// peak: 105 us; the stats pass's extra q k^T adds half again).  The k and v
// tiles are re-read by every query tile of a head, from L2.

template <typename T, int DMAX>
__global__ void __launch_bounds__(ccmh::attn_long::kThreads)
attention_fwd_long_kernel(const T* __restrict__ qkv, const T* __restrict__ qkv_b,
                          const float* __restrict__ mask, T* __restrict__ out, int L, int H,
                          int Dh, float scale, int vec, int n_qt) {
  using namespace ccmh::attn_long;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = tile_ld<T>(Dh);
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sk = sq + kTile * ld;
  T* sv = sk + kTile * ld;
  const int qt = blockIdx.x % n_qt;
  const int h = (blockIdx.x / n_qt) % H, b = blockIdx.x / (n_qt * H);
  const int D = H * Dh, D3 = 3 * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* base = qkv + (size_t)b * L * D3 + h * Dh;
  const T* bq = qkv_b ? qkv_b + h * Dh : nullptr;
  const T* bk = qkv_b ? bq + D : nullptr;
  const T* bv = qkv_b ? bq + 2 * D : nullptr;
  const int q0 = qt * kTile, nq = min(kTile, L - q0);
  const int m0 = warp * 16;
  const bool active = m0 < nq;          // the warp holds a query below L
  const int i0 = q0 + m0 + (lane >> 2);
  const int n_dk = pad16(Dh) / 16;
  const int n_kt = (L + kTile - 1) / kTile;

  load_tile<T>(sq, ld, base + (size_t)q0 * D3, D3, nq, Dh, bq, vec);
  RowStats st;       // pass 1: each row's softmax max and sum over every key
  st.init();
  float inv[2] = {0.f, 0.f};
  float o[DMAX / 8][4];   // pass 2: ctx = p . v, p normalised in fp32 and rounded to T
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  for (int step = 0; step < 2 * n_kt; ++step) {
    const bool pass2 = step >= n_kt;
    const int k0 = (pass2 ? step - n_kt : step) * kTile, nk = min(kTile, L - k0);
    if (step > 0) __syncthreads();      // every warp is done with the last tiles
    load_tile<T>(sk, ld, base + D + (size_t)k0 * D3, D3, nk, Dh, bk, vec);
    if (pass2) load_tile<T>(sv, ld, base + 2 * D + (size_t)k0 * D3, D3, nk, Dh, bv, vec);
    land(vec);
    if (vec && qkv_b != nullptr) {
      if (step == 0) fold_bias<T>(sq, ld, nq, Dh, bq, vec);
      fold_bias<T>(sk, ld, nk, Dh, bk, vec);
      if (pass2) fold_bias<T>(sv, ld, nk, Dh, bv, vec);
      __syncthreads();
    }
    if (active) {
      for (int n0 = 0; n0 < nk; n0 += kChunk) {
        const int n_blk = chunk_blocks(n0, nk);
        float s[4][4];
        rows_chunk<T>(s, sq, sk, ld, m0, n0, n_blk, n_dk, lane);
        logits_rows(s, n_blk, scale, mask, i0, k0 + n0, L, lane);
        if (!pass2) {
          st.add(s, nullptr, n_blk);
          continue;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = expf(s[j][e] - st.mx[e >> 1]) * inv[e >> 1];
#pragma unroll
        for (int jb = 0; jb < 2; ++jb)
          if (jb < n_blk)
            acc_times<T>(o, s[2 * jb], s[2 * jb + 1], sv, ld, n0 + jb * 16, n_dk, lane);
      }
    }
    if (step == n_kt - 1) {
      st.finish();
      inv[0] = 1.f / st.l[0];
      inv[1] = 1.f / st.l[1];
    }
  }

  // stage over the warp's own q rows (only this warp reads them), then store
  if (active) {
    __syncwarp();
    stage_acc<T>(sq + m0 * ld, ld, o, 2 * n_dk, lane);
    __syncwarp();
    store_rows<T>(out + ((size_t)b * L + q0 + m0) * D + h * Dh, D, sq + m0 * ld, ld,
                  min(16, nq - m0), Dh, vec, lane);
  }
}

template <typename T, int DMAX>
cudaError_t launch_long_class(const void* qkv, const void* qkv_b, const float* mask,
                              void* out, int B, int L, int H, int Dh, float scale, bool vec,
                              cudaStream_t stream) {
  using namespace ccmh::attn_long;
  const size_t smem = (size_t)3 * kTile * tile_ld<T>(Dh) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_long_kernel<T, DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (L + kTile - 1) / kTile;
  const long long blocks = (long long)B * H * n_qt;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  attention_fwd_long_kernel<T, DMAX><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(qkv_b), mask, static_cast<T*>(out),
      L, H, Dh, scale, vec ? 1 : 0, n_qt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_long(const void* qkv, const void* qkv_b, const float* mask, void* out,
                        int B, int L, int H, int Dh, float scale, cudaStream_t stream) {
  const bool vec = (Dh * sizeof(T)) % 16 == 0 && aligned16(qkv) && aligned16(out) &&
                   (qkv_b == nullptr || aligned16(qkv_b));
  if (pad16(Dh) <= 64)
    return launch_long_class<T, 64>(qkv, qkv_b, mask, out, B, L, H, Dh, scale, vec, stream);
  return launch_long_class<T, 128>(qkv, qkv_b, mask, out, B, L, H, Dh, scale, vec, stream);
}

// ---------------------------------------------------------------------------
// The long path on Hopper's warpgroup products: L > 128 in bf16 with Dh = 64
// and 16-byte aligned pointers (long_family) past the one-pass kernel's
// kOnePassMaxL = 336 keys (below), which is ViT-L/14@336's 577 tokens and
// MITH's concept transformers past K = 336; up to it the one-pass kernel
// takes ViT-B/16's 197 and ViT-L/14's 257.  Replaces ccmh/ops/attention.py
// `_pallas_forward` / `_kernel` past 128 tokens, with its rounding points:
// q + b, k + b, v + b rounded to bf16; logits (q . k) * scale + mask in fp32;
// p = exp(x - max) / sum formed in fp32 from the row's final max and sum,
// then rounded to bf16; ctx = p . v summed in fp32, stored in bf16.
//
// What bounds it on an H100: at ViT-L/14 (B = 64, L = 257, H = 16) bytes,
// 101 MB of qkv and 34 MB of context, 40 us at 3.35 TB/s; the function's
// 4 B H L^2 Dh = 17.3 GFLOP take 17.5 us at the bf16 peak (989 TFLOP/s),
// and the stats pass's second q k^T 8.8 more.  At @336 (L = 577) the
// products lead: 87.3 GFLOP, 88 us, plus 44 us for the stats pass.  Beside
// them, what the two passes cost inside an SM: an exponential a logit in
// each pass at the SFU's 16 a clock (57 us at ViT-L/14 with the padding to
// 64-key tiles), and the bias fold's shared-memory traffic (without the
// bias the kernel ran 19-23% faster: PERF.md).  mma.sync on 16-row warp
// tiles (the kernel above) reached 10-19x the bound: its fragments
// were reloaded from shared memory for every 16 x 8 product.
//
// Design: a block per (batch element, head, 64-query tile), one warpgroup
// (128 threads).  Its q tile and a ring of kFwdStages k | v buffers are
// landed by TMA (one 3-D map over qkv, boxes of 64 rows x 64 head dims with
// the 128-byte swizzle; rows past L arrive as zeros), each buffer's bytes
// counted on its own mbarrier; thread 0 starts the next buffer's copies as
// soon as the block has left the buffer (the same __syncthreads that
// publishes the bias fold), so kFwdStages - 1 tiles are in flight over
// each tile's products.  The keys stream twice: pass 1 takes S = q k^T
// (wgmma m64n64k16 x 4, both operands K-major in shared memory) for each
// row's max and sum (Stats64: once a tile, the sum rescaled as the max
// grows), pass 2 takes S again, forms p = 2^(s scale log2 e - lse2) with
// the row's final max and sum inside the exponent (one FMA and one SFU op
// a logit on a full tile; a call with a mask takes 2^((x - m) log2 e -
// log2 sum), its own instance of the kernel: Tile), rounds it to bf16 in
// registers as the A operand, and sums ctx += p v with v as the MN-major
// B operand (the transpose bit).  So Q K^T runs twice (the stats pass),
// which keeps ccmh's rounding: an online softmax would round an
// unnormalised p.
// Logits kept in shared memory instead (64 x 640 fp32 = 160 KB at L = 577)
// would leave one block an SM; the stats pass keeps four, and occupancy
// decides here: a third buffer (3 blocks an SM), two warpgroups a block,
// 128 keys a step (3 blocks), the next tile's q k^T started before this
// tile's softmax (it spilled) and q as a register operand all measured
// slower (PERF.md).
//
// The fence: the bias is added in bf16 by the block's threads through the
// swizzle (generic-proxy writes) after a tile lands; wgmma reads its
// operands through the async proxy, so every writing thread runs
// fence.proxy.async.shared::cta after its writes and before the
// __syncthreads that releases the tile to the products.  Without it a
// product may read the tile without the bias, which shows only sometimes.
//
// Shared memory: 1 KB of alignment slack + the q tile (8 KB) + kFwdStages x
// 16 KB + the barriers: 41 KB at 2 stages; 4 blocks an SM (120 registers).
// The class-token tail (L = 257 = 4 x 64 + 1, 577 = 9 x 64 + 1; 197 = 3 x
// 64 + 5): L = 257 cost 49% more than L = 256 (tools/time_torch_attention.py
// --shapes long, PERF.md), a fifth key tile for every block and a fifth
// query tile.  A last key tile of <= 16 keys takes m64n16k16 products
// (a quarter of the columns, products and exponentials: 5-9% of the whole
// at the towers); the last query tile, one or five rows, still takes a
// whole block, as wgmma's M is 64.

constexpr int kFwdStages = 2;      // k | v buffers in the ring

template <int STAGES, bool MASK>
__global__ void __launch_bounds__(ccmh::wg::kWgThreads, 4)
attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qkv_map,
                           const __nv_bfloat16* __restrict__ qkv_b,
                           const float* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                           int L, int H, float scale, int n_qt) {
  using namespace ccmh::wg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align1024(smem_raw);
  unsigned char* ring = sq + kTileBytes;        // STAGES x (k, v)
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * 2 * kTileBytes);
  uint64_t* qbar = full + STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int qt = blockIdx.x % n_qt, h = (blockIdx.x / n_qt) % H, b = blockIdx.x / (n_qt * H);
  const int D = H * kDh;
  const int q0 = qt * kRows;
  const int n_kt = (L + kRows - 1) / kRows, n_steps = 2 * n_kt;
  const int i0 = q0 + 16 * warp + (lane >> 2);   // the thread's query rows i0, i0 + 8
  const bf16* bq = qkv_b ? qkv_b + h * kDh : nullptr;
  const CUtensorMap* map = &qkv_map;

  // step s < n_kt lands k tile s (pass 1), step n_kt + s k and v tile s
  auto fetch = [&](int step) {
    const int slot = step % STAGES, kt = step < n_kt ? step : step - n_kt;
    unsigned char* sk = ring + slot * 2 * kTileBytes;
    bar_expect_tx(&full[slot], step < n_kt ? kTileBytes : 2 * kTileBytes);
    tma_load(sk, map, &full[slot], D + h * kDh, kt * kRows, b);
    if (step >= n_kt) tma_load(sk + kTileBytes, map, &full[slot], 2 * D + h * kDh, kt * kRows, b);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) bar_init(&full[s], 1);
    bar_init(qbar, 1);
    bar_init_fence();
    bar_expect_tx(qbar, kTileBytes);
    tma_load(sq, map, qbar, h * kDh, q0, b);
    for (int s = 0; s < STAGES && s < n_steps; ++s) fetch(s);
  }
  __syncthreads();
  const uint4 cb_k = bias_chunk(bq ? bq + D : nullptr, tid);
  const uint4 cb_v = bias_chunk(bq ? bq + 2 * D : nullptr, tid);
  bar_wait(qbar, 0);
  if (bq != nullptr) fold_tile(sq, min(kRows, L - q0), bias_chunk(bq, tid), tid);

  Stats64 st;
  st.init();
  RowLse rl[2] = {};          // each row's statistics, after pass 1
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  for (int step = 0; step < n_steps; ++step) {
    const int slot = step % STAGES;
    const bool pass2 = step >= n_kt;
    const int k0 = (pass2 ? step - n_kt : step) * kRows, nk = min(kRows, L - k0);
    unsigned char* sk = ring + slot * 2 * kTileBytes;
    unsigned char* sv = sk + kTileBytes;
    bar_wait(&full[slot], (step / STAGES) & 1);
    if (bq != nullptr) {
      fold_tile(sk, nk, cb_k, tid);
      if (pass2) fold_tile(sv, nk, cb_v, tid);
    }
    // every writer's fold (and q's, before step 0) before the async proxy
    // reads it: fence, then the block syncs, which also says that every
    // warp is done with step - 1's buffer, whose next copies go out now
    fence_async_smem();
    __syncthreads();
    if (tid == 0 && step >= 1 && step - 1 + STAGES < n_steps) fetch(step - 1 + STAGES);
    // the step over N key columns: 64, or 16 for a last tile of <= 16 keys
    // (the class token of L = 64 n + 1), whose columns past 16 hold no key
    auto cols = [&](auto n) {
      constexpr int N = decltype(n)::value;
      float s[N / 2];
      run(s, [&] { rows_times<N>(s, sq, sk); });
      const Tile tile(mask, k0, L, scale);
      logits<N>(s, tile, scale, mask, i0, k0, L, t);
      if (!pass2) {
        st.add<false, MASK, N>(s, s, tile);
        return;
      }
      probs<MASK, N>(s, tile, rl);   // p
      uint32_t a[N / 16][4];
      to_a<N>(a, s);
      run(o, [&] { acc_times(o, a, sv); });
    };
    if (nk <= 16)
      cols(std::integral_constant<int, 16>());
    else
      cols(std::integral_constant<int, 64>());
    if (step == n_kt - 1) {
      st.finish();
      rl[0] = st.row(0);
      rl[1] = st.row(1);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    if (i < L) {
      bf16* dst = out + ((size_t)b * L + i) * D + h * kDh + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 long path up to kOnePassMaxL = 336 keys (attention_family.cuh),
// which holds ViT-B/16's 197 and ViT-L/14's 256 and 257 tokens: one pass
// over the keys, a warpgroup's whole [64, L] logit tile in registers, the
// head's k and v resident in shared memory.  The same function and
// rounding points as the two-pass kernel above: q + b, k + b, v + b rounded
// to bf16; logits (q . k) * scale + mask in fp32; p = exp(x - max) / sum
// formed in fp32 from the row's whole max and sum, then rounded to bf16;
// ctx = p . v summed in fp32, stored in bf16.
//
// What bounds it on an H100: bytes, as above (ViT-L/14 0.040 ms, ViT-B/16
// at B = 256 0.092 ms; the products 17.5 and 37 us at the bf16 peak).
// Inside an SM nothing leads alone: a block's time splits between the bias
// folds, the products of S and of p v, the softmax and the landing of a
// head's tiles (tools/tune_torch_attention.py's ablations, PERF.md), and
// registers hold it to two warpgroups an SM.
//
// Design: a block per (batch element, head), one warpgroup.  An m64nN fp32
// accumulator holds N / 2 floats a thread, so a query tile's logits fit in
// registers: NT products of 64 key columns, plus one of 16 for a last tile
// of <= 16 keys (the class token of L = 64 n + 1): ViT-L/14 4 x 64 + 16 =
// 272 columns, 136 registers a thread; ViT-B/16 3 x 64 + 16, 104.  Every k
// and v tile of the head lands at once by TMA (the tensor map and swizzle
// above) and is folded with its bias once a block (v while the first S
// runs), then the block walks over the head's query tiles.  A tile: S = q
// k^T over every key tile in one group of products; the next q tile lands
// meanwhile into the same buffer once every warp is done with it (a sync);
// the softmax in registers: logits where a tile has a mask or keys past L
// (Tile), each row's max by quad shuffles, one ex2 a logit (no mask: 2^(s
// scale log2 e - m log2 e), one FMA on a full tile; a mask: 2^((x - m) log2
// e), exact where x = m, so a row that a finite mask covers entirely is
// ccmh's uniform row), the row's sum from the same registers, p = e * (1 /
// sum) in fp32, rounded to bf16 as the register A operand of p v (v the
// MN-major operand, the transpose bit); ctx += p v over every value tile
// in one group, while the next q tile is folded.  So q k^T runs once, each
// logit takes one exponential, each k and v tile is landed and folded once
// a head (the two-pass kernel: k twice and v once a query tile), and a
// query tile waits on no copy.  The logit columns are NT tiles of 64
// keys and one of 16 for a last tile of <= 16 (TAIL), KT = NT + TAIL tiles
// of k and of v.  Shared memory 1 KB of slack + q + 2 KT tiles (ViT-L/14
// 89 KB, 105 KB at 336 keys) and 132-241 registers: two blocks an SM.  No atomics and a fixed order of sums: two calls give the
// same bits.
//
// Measured and lost on the way (PERF.md): the same kernel streaming k and v
// through a ring a query tile (a block per query tile, three an SM: the
// per-tile folds and syncs cost more than the occupancy bought; at 168
// registers the 4-tile instances spilled); q as the register A operand of
// S with its bias added in registers (slower at ViT-B/16, and its buffer's
// refill raced the generic loads); three blocks an SM where the tiles fit
// (ptxas serialised the products for want of registers); two or three
// query tiles a block instead of the head's all.  No producer warp and no
// setmaxnreg: with the logits of a whole row in registers, two consumer
// warpgroups of ~230 registers already take an SM's register file, and two
// blocks an SM overlap one's softmax with the other's products.

// p = e * (1 / sum) in fp32, rounded to bf16 as the A operand of p v
template <int N>
__device__ __forceinline__ void tile_probs(uint32_t (&a)[N / 16][4], float (&s)[N / 2],
                                           const float (&inv)[2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s[i] *= inv[(i >> 1) & 1];
  ccmh::wg::to_a<N>(a, s);
}

template <int NT, bool TAIL, bool MASK>
__global__ void __launch_bounds__(ccmh::wg::kWgThreads, 2)
attention_fwd_wgmma_onepass_kernel(const __grid_constant__ CUtensorMap qkv_map,
                                   const __nv_bfloat16* __restrict__ qkv_b,
                                   const float* __restrict__ mask,
                                   __nv_bfloat16* __restrict__ out, int L, int H, float scale) {
  using namespace ccmh::wg;
  constexpr int KT = NT + (TAIL ? 1 : 0);      // k tiles, and v tiles
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align1024(smem_raw);
  unsigned char* sk = sq + kTileBytes;            // KT k tiles
  unsigned char* sv = sk + KT * kTileBytes;       // KT v tiles
  uint64_t* kbar = reinterpret_cast<uint64_t*>(sv + KT * kTileBytes);
  uint64_t* vbar = kbar + 1;
  uint64_t* qbar = kbar + 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int n_qt = (L + kRows - 1) / kRows;     // the head's query tiles
  const int D = H * kDh;
  const bf16* bq = qkv_b ? qkv_b + h * kDh : nullptr;
  const CUtensorMap* map = &qkv_map;

  if (tid == 0) {
    bar_init(kbar, 1);
    bar_init(vbar, 1);
    bar_init(qbar, 1);
    bar_init_fence();
    bar_expect_tx(qbar, kTileBytes);
    tma_load(sq, map, qbar, h * kDh, 0, b);
    bar_expect_tx(kbar, KT * kTileBytes);
    for (int j = 0; j < KT; ++j) tma_load(sk + j * kTileBytes, map, kbar, D + h * kDh, j * kRows, b);
    bar_expect_tx(vbar, KT * kTileBytes);
    for (int j = 0; j < KT; ++j)
      tma_load(sv + j * kTileBytes, map, vbar, 2 * D + h * kDh, j * kRows, b);
  }
  __syncthreads();
  const uint4 cb_q = bias_chunk(bq, tid);
  bar_wait(kbar, 0);
  if (bq != nullptr) {
    const uint4 cb_k = bias_chunk(bq + D, tid);
#pragma unroll
    for (int j = 0; j < KT; ++j) fold_tile(sk + j * kTileBytes, min(kRows, L - j * kRows), cb_k, tid);
  }
  bar_wait(qbar, 0);
  if (bq != nullptr) fold_tile(sq, min(kRows, L), cb_q, tid);
  fence_async_smem();     // k's and the first q's folds, published by the loop's first sync

  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * kRows;
    const int i0 = q0 + 16 * warp + (lane >> 2);   // the thread's query rows i0, i0 + 8
    __syncthreads();      // q's fold (made while the last tile's p v ran) published

    float s[NT][32];
    float st[TAIL ? 8 : 1];
#pragma unroll
    for (int j = 0; j < NT; ++j) fence_regs(s[j]);
    fence_regs(st);
    wg_fence();
#pragma unroll
    for (int j = 0; j < NT; ++j) rows_times<64>(s[j], sq, sk + j * kTileBytes);
    if constexpr (TAIL) rows_times<16>(st, sq, sk + NT * kTileBytes);
    wg_commit();
    if (qt == 0) {
      // v lands and is folded while the first tile's S runs
      bar_wait(vbar, 0);
      if (bq != nullptr) {
        const uint4 cb_v = bias_chunk(bq + 2 * D, tid);
#pragma unroll
        for (int j = 0; j < KT; ++j)
          fold_tile(sv + j * kTileBytes, min(kRows, L - j * kRows), cb_v, tid);
      }
      fence_async_smem();
    }
    wg_wait0();
#pragma unroll
    for (int j = 0; j < NT; ++j) fence_regs(s[j]);
    fence_regs(st);
    // every warp's products are done with q: its buffer takes the next
    // tile, which lands during the softmax (the first tile: v's fold
    // published too)
    __syncthreads();
    if (tid == 0 && qt + 1 < n_qt) {
      bar_expect_tx(qbar, kTileBytes);
      tma_load(sq, map, qbar, h * kDh, (qt + 1) * kRows, b);
    }

    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const Tile tile(mask, j * kRows, L, scale);
      logits<64>(s[j], tile, scale, mask, i0, j * kRows, L, t);
      tile_max<64>(s[j], tile, mx);
    }
    if constexpr (TAIL) {
      const Tile tile(mask, NT * kRows, L, scale);
      logits<16>(st, tile, scale, mask, i0, NT * kRows, L, t);
      tile_max<16>(st, tile, mx);
    }
    float mb[2], l[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      mb[r] = MASK ? finite_max(mx[r]) : max_log2e(mx[r]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) tile_exp<MASK, 64>(s[j], Tile(mask, j * kRows, L, scale), mb, l);
    if constexpr (TAIL) tile_exp<MASK, 16>(st, Tile(mask, NT * kRows, L, scale), mb, l);
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) inv[r] = 1.f / quad_sum(l[r]);
    uint32_t a[NT][4][4];
    uint32_t at[1][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) tile_probs<64>(a[j], s[j], inv);
    if constexpr (TAIL) tile_probs<16>(at, st, inv);

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    fence_regs(o);
    wg_fence();
#pragma unroll
    for (int j = 0; j < NT; ++j) acc_times(o, a[j], sv + j * kTileBytes);
    if constexpr (TAIL) acc_times(o, at, sv + NT * kTileBytes);
    wg_commit();
    if (qt + 1 < n_qt) {
      // the next q tile folded while p v runs
      bar_wait(qbar, (qt + 1) & 1);
      if (bq != nullptr) fold_tile(sq, min(kRows, L - q0 - kRows), cb_q, tid);
      fence_async_smem();
    }
    wg_wait0();
    fence_regs(o);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 8 * r;
      if (i < L) {
        bf16* dst = out + ((size_t)b * L + i) * D + h * kDh + 2 * t;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              pack_bf16(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 long path past kOnePassMaxL up to kResidentMaxL keys
// (attention_family.cuh; ViT-L/14@336's 577): the two-pass kernel's
// arithmetic (above: the stats pass, then S again, p and p v), bit for bit,
// over the head's k and v resident in shared memory.  What bounds it on an
// H100: bytes for the function at @336 (B = 64, L = 577, H = 16: 0.090 ms;
// its 87.3 GFLOP take 88 us at the bf16 peak), and the kernel's own
// products, the stats pass's 44 GFLOP more: 133 us.
// Design: a block per (batch element, head) of kResidentGroups warpgroups;
// every k and v tile of the head lands at once and is folded once (each
// warpgroup folds every kResidentGroups-th tile), where the two-pass kernel
// lands and folds k twice and v once a query tile; then warpgroup w walks
// over query tiles w, w + kResidentGroups, ..., its own q tile landed,
// folded and published on a named barrier of the warpgroup.  Shared memory
// 1 KB + 2 KT + kResidentGroups tiles (@336: 193 KB at 4 warpgroups), one
// block an SM of four warpgroups of <= 128 registers; with a mask three
// (168 registers: the mask's addressing spilled 16 bytes at 128).  Two
// warpgroups a block measured slower (PERF.md).
constexpr int kResidentGroups = 4;
constexpr int kResidentGroupsMask = 3;

// the warpgroup's named barrier (ids 1.., 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

template <bool MASK, int W>
__global__ void __launch_bounds__(W * ccmh::wg::kWgThreads, 1)
attention_fwd_wgmma_resident_kernel(const __grid_constant__ CUtensorMap qkv_map,
                                    const __nv_bfloat16* __restrict__ qkv_b,
                                    const float* __restrict__ mask,
                                    __nv_bfloat16* __restrict__ out, int L, int H, float scale) {
  using namespace ccmh::wg;
  extern __shared__ unsigned char smem_raw[];
  const int n_kt = (L + kRows - 1) / kRows;      // key tiles, and query tiles
  unsigned char* sk = align1024(smem_raw);       // n_kt k tiles
  unsigned char* sv = sk + n_kt * kTileBytes;    // n_kt v tiles
  unsigned char* sqs = sv + n_kt * kTileBytes;   // a q tile a warpgroup
  uint64_t* kbar = reinterpret_cast<uint64_t*>(sqs + W * kTileBytes);
  uint64_t* qbars = kbar + 1;
  const int tid = threadIdx.x, w = tid / kWgThreads, wtid = tid % kWgThreads;
  const int warp = wtid >> 5, lane = tid & 31, t = lane & 3;
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int D = H * kDh;
  const bf16* bq = qkv_b ? qkv_b + h * kDh : nullptr;
  const CUtensorMap* map = &qkv_map;
  unsigned char* sq = sqs + w * kTileBytes;
  uint64_t* qbar = qbars + w;

  if (tid == 0) {
    bar_init(kbar, 1);
    for (int i = 0; i < W; ++i) bar_init(&qbars[i], 1);
    bar_init_fence();
    bar_expect_tx(kbar, 2 * n_kt * kTileBytes);
    for (int j = 0; j < n_kt; ++j) {
      tma_load(sk + j * kTileBytes, map, kbar, D + h * kDh, j * kRows, b);
      tma_load(sv + j * kTileBytes, map, kbar, 2 * D + h * kDh, j * kRows, b);
    }
    for (int i = 0; i < W && i < n_kt; ++i) {
      bar_expect_tx(&qbars[i], kTileBytes);
      tma_load(sqs + i * kTileBytes, map, &qbars[i], h * kDh, i * kRows, b);
    }
  }
  __syncthreads();
  const uint4 cb_q = bias_chunk(bq, wtid);
  bar_wait(kbar, 0);
  if (bq != nullptr) {
    const uint4 cb_k = bias_chunk(bq + D, wtid), cb_v = bias_chunk(bq + 2 * D, wtid);
    for (int j = w; j < n_kt; j += W) {
      fold_tile(sk + j * kTileBytes, min(kRows, L - j * kRows), cb_k, wtid);
      fold_tile(sv + j * kTileBytes, min(kRows, L - j * kRows), cb_v, wtid);
    }
  }
  fence_async_smem();
  __syncthreads();

  // the steps over 64 key columns, or 16 for a last tile of <= 16 keys
  const int n_full = L % kRows != 0 && L % kRows <= 16 ? n_kt - 1 : n_kt;
  for (int qt = w, it = 0; qt < n_kt; qt += W, ++it) {
    const int q0 = qt * kRows;
    const int i0 = q0 + 16 * warp + (lane >> 2);   // the thread's query rows i0, i0 + 8
    bar_wait(qbar, it & 1);
    if (bq != nullptr) fold_tile(sq, min(kRows, L - q0), cb_q, wtid);
    fence_async_smem();
    wg_sync(1 + w);

    Stats64 st;            // pass 1: each row's max and sum
    st.init();
    auto stats = [&](auto n, int j) {
      constexpr int N = decltype(n)::value;
      float s[N / 2];
      run(s, [&] { rows_times<N>(s, sq, sk + j * kTileBytes); });
      const Tile tile(mask, j * kRows, L, scale);
      logits<N>(s, tile, scale, mask, i0, j * kRows, L, t);
      st.add<false, MASK, N>(s, s, tile);
    };
    for (int j = 0; j < n_full; ++j) stats(std::integral_constant<int, 64>(), j);
    if (n_full < n_kt) stats(std::integral_constant<int, 16>(), n_full);
    st.finish();
    const RowLse rl[2] = {st.row(0), st.row(1)};

    float o[32];          // pass 2: ctx = p v
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    auto probs_v = [&](auto n, int j) {
      constexpr int N = decltype(n)::value;
      float s[N / 2];
      run(s, [&] { rows_times<N>(s, sq, sk + j * kTileBytes); });
      const Tile tile(mask, j * kRows, L, scale);
      logits<N>(s, tile, scale, mask, i0, j * kRows, L, t);
      probs<MASK, N>(s, tile, rl);
      uint32_t a[N / 16][4];
      to_a<N>(a, s);
      run(o, [&] { acc_times(o, a, sv + j * kTileBytes); });
    };
    for (int j = 0; j < n_full; ++j) probs_v(std::integral_constant<int, 64>(), j);
    if (n_full < n_kt) probs_v(std::integral_constant<int, 16>(), n_full);

    // every warp of the warpgroup is done with q: its next tile lands
    wg_sync(1 + w);
    if (wtid == 0 && qt + W < n_kt) {
      bar_expect_tx(qbar, kTileBytes);
      tma_load(sq, map, qbar, h * kDh, (qt + W) * kRows, b);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 8 * r;
      if (i < L) {
        bf16* dst = out + ((size_t)b * L + i) * D + h * kDh + 2 * t;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              pack_bf16(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The fp32 long path on the same warpgroup products: L > 128 in fp32 with
// Dh = 64 and 16-byte aligned pointers (long_family), every CLIP tower past
// 128 tokens in ccmh's default compute type.  Replaces ccmh/ops/attention.py
// `_pallas_forward` / `_kernel` past 128 tokens in fp32: q + b, k + b, v + b
// in fp32; logits (q . k) * scale + mask; p = exp(x - max) / sum from the
// row's final max and sum; ctx = p . v, all in fp32, the products as
// 3xTF32 on wgmma .tf32 (wgmma_tiles.cuh: hi and lo split toward zero,
// lo.hi' + hi.lo' + hi.hi', 8 columns a step).
//
// What bounds it on an H100: the products.  At ViT-L/14 (B = 64, L = 257,
// H = 16) the function's 17.3 GFLOP take 105 us at a third of the 495
// TFLOP/s TF32 peak, against 81 us for its 270 MB of qkv and context at
// 3.35 TB/s; the stats pass's second q k^T adds half of the products
// again.  Beside them, each landed k and v tile is split into hi and lo by
// the block's threads (v transposed as well), a pass over shared memory.
//
// Design: the bf16 kernel's dataflow (a block per (batch element, head,
// 64-query tile), one warpgroup, the stats pass, then S again and ctx += p
// v) with what .tf32 asks for:
//   * its shared-memory operands are K-major only, with no transpose bit.
//     S = q k^T reads k's rows as they land.  ctx += p v sums over the
//     keys, which v's rows hold: the block's threads write v transposed
//     (split_tile_t), hi and lo, once a tile -- FlashAttention-3's fp8
//     path transposes v the same way -- and p's accumulator enters as the
//     register A operand with no shuffle, since the transposed tile lists
//     its keys in the order the accumulator's columns give (design (a),
//     with (b)'s register order: acc_to_a32);
//   * q's hi and lo A fragments stay in registers for the whole block (64
//     registers), so q takes no shared memory;
//   * every tile is split after it lands, the bias added in fp32 first,
//     into hi and lo tiles of its own: k before S, v^T while S is taken.
//     A landing buffer is free once split, and the next tile's copies go
//     out then, over this tile's products and softmax.  The tensor cores
//     ignore the low 13 bits of a raw fp32 operand (ccmh_wgmma_selftest
//     mode 6 against 7, on the H100), but the split clears them all the
//     same: the bias fold rewrites every tile anyway.
// Shared memory: 1 KB of slack + k, v as landed + k's hi, lo + v^T's hi,
// lo, 16 KB each (q lands in v^T's before pass 2 needs it) = 97 KB, so two
// blocks an SM.  A last key tile of <= 16 keys takes m64n16k8 products and
// splits 16 rows.

template <bool MASK>
__global__ void __launch_bounds__(ccmh::wg::kWgThreads, 2)
attention_fwd_wgmma32_kernel(const __grid_constant__ CUtensorMap qkv_map,
                             const float* __restrict__ qkv_b, const float* __restrict__ mask,
                             float* __restrict__ out, int L, int H, float scale, int n_qt) {
  using namespace ccmh::wg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* rk = align1024(smem_raw);   // k as landed
  unsigned char* rv = rk + kTile32;          // v as landed
  unsigned char* kh = rv + kTile32;          // k's hi and lo
  unsigned char* kl = kh + kTile32;
  unsigned char* vh = kl + kTile32;          // v transposed, hi and lo (q lands here first)
  unsigned char* vl = vh + kTile32;
  uint64_t* kbar = reinterpret_cast<uint64_t*>(vl + kTile32);
  uint64_t* vbar = kbar + 1;
  uint64_t* qbar = kbar + 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int qt = blockIdx.x % n_qt, h = (blockIdx.x / n_qt) % H, b = blockIdx.x / (n_qt * H);
  const int D = H * kDh;
  const int q0 = qt * kRows;
  const int n_kt = (L + kRows - 1) / kRows, n_steps = 2 * n_kt;
  const int i0 = q0 + 16 * warp + (lane >> 2);   // the thread's query rows i0, i0 + 8
  const float* bq = qkv_b ? qkv_b + h * kDh : nullptr;
  const float* bk = qkv_b ? bq + D : nullptr;
  const float* bv = qkv_b ? bq + 2 * D : nullptr;
  const CUtensorMap* map = &qkv_map;

  // step s < n_kt lands k tile s (pass 1), step n_kt + s k tile s; v tile s
  // lands for step n_kt + s, the first one at the start
  if (tid == 0) {
    bar_init(kbar, 1);
    bar_init(vbar, 1);
    bar_init(qbar, 1);
    bar_init_fence();
    bar_expect_tx(qbar, kTile32);
    tma_tile32(vh, map, qbar, h * kDh, q0, b);
    bar_expect_tx(kbar, kTile32);
    tma_tile32(rk, map, kbar, D + h * kDh, 0, b);
    bar_expect_tx(vbar, kTile32);
    tma_tile32(rv, map, vbar, 2 * D + h * kDh, 0, b);
  }
  __syncthreads();
  uint32_t qh[8][4], ql[8][4];   // q + b, split: the A operand of S = q k^T
  bar_wait(qbar, 0);
  a_rows32(qh, ql, vh, L - q0, bq, warp, lane);

  Stats64 st;
  st.init();
  RowLse rl[2] = {};          // each row's statistics, after pass 1
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  for (int step = 0; step < n_steps; ++step) {
    const bool pass2 = step >= n_kt;
    const int kt = pass2 ? step - n_kt : step;
    const int k0 = kt * kRows, nk = min(kRows, L - k0);
    bar_wait(kbar, step & 1);
    if (pass2) bar_wait(vbar, kt & 1);
    __syncthreads();   // every warp is done with the last step's hi and lo tiles (and q)
    // the step over N key columns: 64, or 16 for a last tile of <= 16 keys
    auto cols = [&](auto n) {
      constexpr int N = decltype(n)::value;
      split_tile<N>(kh, kl, rk, nk, bk, tid);
      // the split's writes before the async proxy reads them, and its reads
      // of the landing buffer before the next copies overwrite it
      fence_async_smem();
      __syncthreads();
      if (tid == 0 && step + 1 < n_steps) {
        const int next = step + 1 < n_kt ? step + 1 : step + 1 - n_kt;
        bar_expect_tx(kbar, kTile32);
        tma_tile32(rk, map, kbar, D + h * kDh, next * kRows, b);
      }
      float s[N / 2];
      fence_regs(s);
      wg_fence();
      rows_times32<N>(s, qh, ql, kh, kl);
      wg_commit();
      if (pass2) split_tile_t<N>(vh, vl, rv, nk, bv, tid);   // v^T, while S is taken
      wg_wait0();
      fence_regs(s);
      if (pass2) {
        fence_async_smem();
        __syncthreads();
        if (tid == 0 && kt + 1 < n_kt) {
          bar_expect_tx(vbar, kTile32);
          tma_tile32(rv, map, vbar, 2 * D + h * kDh, (kt + 1) * kRows, b);
        }
      }
      const Tile tile(mask, k0, L, scale);
      logits<N>(s, tile, scale, mask, i0, k0, L, t);
      if (!pass2) {
        st.add<false, MASK, N>(s, s, tile);
        return;
      }
      probs<MASK, N>(s, tile, rl);   // p
      uint32_t ah[N / 8][4], al[N / 8][4];
      acc_to_a32<N>(ah, al, s);
      run(o, [&] { acc_times32<N / 8>(o, ah, al, vh, vl); });
    };
    if (nk <= 16)
      cols(std::integral_constant<int, 16>());
    else
      cols(std::integral_constant<int, 64>());
    if (step == n_kt - 1) {
      st.finish();
      rl[0] = st.row(0);
      rl[1] = st.row(1);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    if (i < L) {
      float* dst = out + ((size_t)b * L + i) * D + h * kDh + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
    }
  }
}

// Which kernel the C entry launches, by the rule of attention_family.cuh
int long_family(const void* qkv, const void* qkv_b, const void* out, int L, int Dh, int dtype) {
  return ccmh::attention_fwd_family(L, Dh, dtype, qkv, qkv_b, out);
}

cudaError_t launch_wgmma(const void* qkv, const void* qkv_b, const float* mask, void* out, int B,
                         int L, int H, float scale, cudaStream_t stream) {
  using namespace ccmh::wg;
  constexpr int S = kFwdStages;
  CUtensorMap map;
  const uint64_t row = (uint64_t)3 * H * kDh;
  cudaError_t err = make_map(&map, qkv, kMapBf16, row, L, B, row, kDh);
  if (err != cudaSuccess) return err;
  const size_t smem = 1024 + (size_t)(1 + 2 * S) * kTileBytes + 8 * (S + 1);
  auto kernel = mask ? attention_fwd_wgmma_kernel<S, true> : attention_fwd_wgmma_kernel<S, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (L + kRows - 1) / kRows;
  const long long blocks = (long long)B * H * n_qt;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kWgThreads, smem, stream>>>(
      map, static_cast<const bf16*>(qkv_b), mask, static_cast<bf16*>(out), L, H, scale, n_qt);
  return cudaGetLastError();
}

template <int NT, bool TAIL>
cudaError_t launch_onepass_tiles(const CUtensorMap& map, const void* qkv_b, const float* mask,
                                 void* out, int B, int L, int H, float scale,
                                 cudaStream_t stream) {
  using namespace ccmh::wg;
  constexpr int KT = NT + (TAIL ? 1 : 0);      // k tiles, and v tiles
  const size_t smem = 1024 + (size_t)(1 + 2 * KT) * kTileBytes + 24;
  auto kernel = mask ? attention_fwd_wgmma_onepass_kernel<NT, TAIL, true>
                     : attention_fwd_wgmma_onepass_kernel<NT, TAIL, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kWgThreads, smem, stream>>>(
      map, static_cast<const bf16*>(qkv_b), mask, static_cast<bf16*>(out), L, H, scale);
  return cudaGetLastError();
}

// the one-pass kernel for 128 < L <= kOnePassMaxL: NT tiles of 64 keys, and
// one of 16 where the last tile holds <= 16 keys
cudaError_t launch_onepass(const void* qkv, const void* qkv_b, const float* mask, void* out,
                           int B, int L, int H, float scale, cudaStream_t stream) {
  using namespace ccmh::wg;
  CUtensorMap map;
  const uint64_t row = (uint64_t)3 * H * kDh;
  cudaError_t err = make_map(&map, qkv, kMapBf16, row, L, B, row, kDh);
  if (err != cudaSuccess) return err;
  const int rem = L % kRows;
  const bool tail = rem != 0 && rem <= 16;
  const int nt = L / kRows + (rem > 16 ? 1 : 0);
  switch (2 * nt + (tail ? 1 : 0)) {
    case 5: return launch_onepass_tiles<2, true>(map, qkv_b, mask, out, B, L, H, scale, stream);
    case 6: return launch_onepass_tiles<3, false>(map, qkv_b, mask, out, B, L, H, scale, stream);
    case 7: return launch_onepass_tiles<3, true>(map, qkv_b, mask, out, B, L, H, scale, stream);
    case 8: return launch_onepass_tiles<4, false>(map, qkv_b, mask, out, B, L, H, scale, stream);
    case 9: return launch_onepass_tiles<4, true>(map, qkv_b, mask, out, B, L, H, scale, stream);
    case 10: return launch_onepass_tiles<5, false>(map, qkv_b, mask, out, B, L, H, scale, stream);
    case 11: return launch_onepass_tiles<5, true>(map, qkv_b, mask, out, B, L, H, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the resident two-pass kernel for kOnePassMaxL < L <= kResidentMaxL
cudaError_t launch_resident(const void* qkv, const void* qkv_b, const float* mask, void* out,
                            int B, int L, int H, float scale, cudaStream_t stream) {
  using namespace ccmh::wg;
  const int W = mask ? kResidentGroupsMask : kResidentGroups;
  CUtensorMap map;
  const uint64_t row = (uint64_t)3 * H * kDh;
  cudaError_t err = make_map(&map, qkv, kMapBf16, row, L, B, row, kDh);
  if (err != cudaSuccess) return err;
  const int n_kt = (L + kRows - 1) / kRows;
  const size_t smem = 1024 + (size_t)(2 * n_kt + W) * kTileBytes + 8 * (1 + W);
  auto kernel = mask ? attention_fwd_wgmma_resident_kernel<true, kResidentGroupsMask>
                     : attention_fwd_wgmma_resident_kernel<false, kResidentGroups>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, W * kWgThreads, smem, stream>>>(
      map, static_cast<const bf16*>(qkv_b), mask, static_cast<bf16*>(out), L, H, scale);
  return cudaGetLastError();
}

cudaError_t launch_wgmma32(const void* qkv, const void* qkv_b, const float* mask, void* out,
                           int B, int L, int H, float scale, cudaStream_t stream) {
  using namespace ccmh::wg;
  CUtensorMap map;
  const uint64_t row = (uint64_t)3 * H * kDh;
  cudaError_t err = make_map(&map, qkv, kMapF32, row, L, B, row, 32);
  if (err != cudaSuccess) return err;
  const size_t smem = 1024 + (size_t)6 * kTile32 + 8 * 3;
  auto kernel = mask ? attention_fwd_wgmma32_kernel<true> : attention_fwd_wgmma32_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (L + kRows - 1) / kRows;
  const long long blocks = (long long)B * H * n_qt;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kWgThreads, smem, stream>>>(
      map, static_cast<const float*>(qkv_b), mask, static_cast<float*>(out), L, H, scale, n_qt);
  return cudaGetLastError();
}

// A check of the wgmma building blocks on one [64][64] product (the tool
// check_attention_long.py holds it against torch.matmul): mode 0, c = a b^T
// with both tiles landed by TMA as K-major operands; 1, c = a b with a's
// fragments in registers and b the MN-major operand; 2, c = (a + bias)
// (b + bias)^T, the bias folded into both landed tiles through the swizzle.
__global__ void __launch_bounds__(ccmh::wg::kWgThreads)
wgmma_selftest_kernel(const __grid_constant__ CUtensorMap a_map,
                      const __grid_constant__ CUtensorMap b_map, const __nv_bfloat16* a,
                      const __nv_bfloat16* bias, float* c, int mode) {
  using namespace ccmh::wg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sa = align1024(smem_raw);
  unsigned char* sb = sa + kTileBytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sb + kTileBytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  if (tid == 0) {
    bar_init(bar, 1);
    bar_init_fence();
    bar_expect_tx(bar, 2 * kTileBytes);
    tma_load(sa, &a_map, bar, 0, 0, 0);
    tma_load(sb, &b_map, bar, 0, 0, 0);
  }
  __syncthreads();
  bar_wait(bar, 0);
  if (mode == 2) {
    fold_tile(sa, kRows, bias_chunk(bias, tid), tid);
    fold_tile(sb, kRows, bias_chunk(bias, tid), tid);
  }
  fence_async_smem();
  __syncthreads();
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  const int r0 = 16 * warp + g;
  if (mode == 1) {
    uint32_t af[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        af[kk][q] = *reinterpret_cast<const uint32_t*>(a + (r0 + 8 * (q & 1)) * kDh + 16 * kk +
                                                       8 * (q >> 1) + 2 * t);
    run(d, [&] { acc_times(d, af, sb); });
  } else {
    run(d, [&] { rows_times<64>(d, sa, sb); });
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[(r0 + 8 * (e >> 1)) * 64 + 8 * j + 2 * t + (e & 1)] = d[4 * j + e];
}

// The same check of the fp32 building blocks (3xTF32 on wgmma .tf32), a
// and b [64][64] fp32 landed by TMA as two swizzle atoms each: mode 3, c =
// (a + bias) (b + bias)^T with both tiles split in shared memory; 4, the
// same with a's fragments in registers (the forward's q); 5, c = a (b +
// bias) with a in an accumulator's registers and b transposed by
// split_tile_t (p v, and the backward's sums over rows); 6, one tf32 pass
// c = a b^T over the tiles as they landed; 7, one pass over their hi
// tiles (the low 13 mantissa bits cleared): 6 and 7 agree bit for bit
// iff the tensor cores ignore those bits.
__global__ void __launch_bounds__(ccmh::wg::kWgThreads)
wgmma32_selftest_kernel(const __grid_constant__ CUtensorMap a_map,
                        const __grid_constant__ CUtensorMap b_map, const float* a,
                        const float* bias, float* c, int mode) {
  using namespace ccmh::wg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sa = align1024(smem_raw);
  unsigned char* sb = sa + kTile32;
  unsigned char* ah = sb + kTile32;
  unsigned char* al = ah + kTile32;
  unsigned char* bh = al + kTile32;
  unsigned char* bl = bh + kTile32;
  uint64_t* bar = reinterpret_cast<uint64_t*>(bl + kTile32);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  if (tid == 0) {
    bar_init(bar, 1);
    bar_init_fence();
    bar_expect_tx(bar, 2 * kTile32);
    tma_tile32(sa, &a_map, bar, 0, 0, 0);
    tma_tile32(sb, &b_map, bar, 0, 0, 0);
  }
  __syncthreads();
  bar_wait(bar, 0);
  const float* fb = mode >= 6 ? nullptr : bias;
  split_tile<64>(ah, al, sa, kRows, fb, tid);
  if (mode == 5)
    split_tile_t<64>(bh, bl, sb, kRows, bias, tid);
  else
    split_tile<64>(bh, bl, sb, kRows, fb, tid);
  fence_async_smem();
  __syncthreads();
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  const int r0 = 16 * warp + g;
  if (mode == 4) {
    uint32_t xh[8][4], xl[8][4];
    a_rows32(xh, xl, sa, kRows, bias, warp, lane);
    run(d, [&] { rows_times32<64>(d, xh, xl, bh, bl); });
  } else if (mode == 5) {
    float p[32];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[4 * j + e] = a[(r0 + 8 * (e >> 1)) * 64 + 8 * j + 2 * t + (e & 1)];
    uint32_t xh[8][4], xl[8][4];
    acc_to_a32<64>(xh, xl, p);
    run(d, [&] { acc_times32<8>(d, xh, xl, bh, bl); });
  } else if (mode >= 6) {
    const unsigned char* x = mode == 6 ? sa : ah;
    const unsigned char* y = mode == 6 ? sb : bh;
    run(d, [&] {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) mma32_ss<64>(d, desc_k32(x, kk), desc_k32(y, kk), kk > 0);
    });
  } else {
    run(d, [&] { rows_times32<64>(d, ah, al, bh, bl); });
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[(r0 + 8 * (e >> 1)) * 64 + 8 * j + 2 * t + (e & 1)] = d[4 * j + e];
}

}  // namespace

// qkv [B, L, 3*H*Dh] and out [B, L, H*Dh] contiguous in `dtype`; qkv_b
// [3*H*Dh] in `dtype` or null; mask [L, L] fp32 or null; scale is
// 1/sqrt(Dh) rounded to fp32 by the caller.  Launches on `stream` of card
// `device` and returns cudaGetLastError() (0 = launched).
extern "C" int ccmh_attention_fwd(int device, const void* qkv, const void* qkv_b,
                                  const float* mask, void* out, int B, int L, int H,
                                  int Dh, float scale, int dtype, void* stream) {
  if (B < 1 || H < 1 || H > 65535 || L < 1 || L > ccmh::attn_long::kMaxL ||
      Dh < 1 || Dh > kMaxDh)
    return (int)cudaErrorInvalidValue;
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: name the card of the tensors
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ccmh::kFloat32:
      switch (long_family(qkv, qkv_b, out, L, Dh, dtype)) {
        case ccmh::kFamilyShort:
          return (int)launch<float>(qkv, qkv_b, mask, out, B, L, H, Dh, scale, s);
        case ccmh::kFamilyLongWgmma:
          return (int)launch_wgmma32(qkv, qkv_b, mask, out, B, L, H, scale, s);
        default:
          return (int)launch_long<float>(qkv, qkv_b, mask, out, B, L, H, Dh, scale, s);
      }
    case ccmh::kBFloat16:
      switch (long_family(qkv, qkv_b, out, L, Dh, dtype)) {
        case ccmh::kFamilyShort:
          return (int)launch<__nv_bfloat16>(qkv, qkv_b, mask, out, B, L, H, Dh, scale, s);
        case ccmh::kFamilyLongWgmma:
          return (int)launch_wgmma(qkv, qkv_b, mask, out, B, L, H, scale, s);
        case ccmh::kFamilyLongOnePass:
          return (int)launch_onepass(qkv, qkv_b, mask, out, B, L, H, scale, s);
        case ccmh::kFamilyLongResident:
          return (int)launch_resident(qkv, qkv_b, mask, out, B, L, H, scale, s);
        default:
          return (int)launch_long<__nv_bfloat16>(qkv, qkv_b, mask, out, B, L, H, Dh, scale, s);
      }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The kernel family ccmh_attention_fwd launches for these arguments: 0 the
// short kernel, 1 the long mma.sync kernel, 2 the long two-pass wgmma
// kernel (fp32's, or bf16's past kResidentMaxL), 3 the bf16 one-pass one, 4
// the bf16 resident one (the wrapper counts its launches by family).
extern "C" int ccmh_attention_fwd_family(const void* qkv, const void* qkv_b, const void* out,
                                         int L, int Dh, int dtype) {
  return long_family(qkv, qkv_b, out, L, Dh, dtype);
}

// a, b [64][64] bf16, bias [64] bf16 (modes 0-2), or fp32 (modes 3-7), c
// [64][64] fp32, all contiguous on card `device`: see wgmma_selftest_kernel
// and wgmma32_selftest_kernel.
extern "C" int ccmh_wgmma_selftest(int device, const void* a, const void* b, const void* bias,
                                   float* c, int mode, void* stream) {
  using namespace ccmh::wg;
  if (mode < 0 || mode > 7) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap am, bm;
  if (mode >= 3) {
    if ((err = make_map(&am, a, kMapF32, kDh, kRows, 1, kDh, 32)) != cudaSuccess) return (int)err;
    if ((err = make_map(&bm, b, kMapF32, kDh, kRows, 1, kDh, 32)) != cudaSuccess) return (int)err;
    const size_t smem = 1024 + 6 * kTile32 + 8;
    err = cudaFuncSetAttribute(wgmma32_selftest_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    wgmma32_selftest_kernel<<<1, kWgThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        am, bm, static_cast<const float*>(a), static_cast<const float*>(bias), c, mode);
    return (int)cudaGetLastError();
  }
  if ((err = make_map(&am, a, kMapBf16, kDh, kRows, 1, kDh, kDh)) != cudaSuccess) return (int)err;
  if ((err = make_map(&bm, b, kMapBf16, kDh, kRows, 1, kDh, kDh)) != cudaSuccess) return (int)err;
  const size_t smem = 1024 + 2 * kTileBytes + 8;
  err = cudaFuncSetAttribute(wgmma_selftest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  wgmma_selftest_kernel<<<1, kWgThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      am, bm, static_cast<const bf16*>(a), static_cast<const bf16*>(bias), c, mode);
  return (int)cudaGetLastError();
}
