// Packed Hamming distances: out[i, j] = sum_w popcount(q[i, w] ^ r[j, w]).
//
// Replaces: ccmh/ops/hamming.py `hamming_distance_packed` (:56) /
// `_popcount_kernel` (the Pallas TPU kernel).  Lanes are 32-bit patterns
// (int32 tensors on the PyTorch side, uint32 here); W = ceil(K/32) <= 64 is
// a runtime value.
//
// What bounds it on an H100: bytes, at every length it takes, and almost
// all of them are the int32 [Q, N] output (at Q = 512, N = 2^18 the kernel
// must write 537 MB, 0.16 ms at 3.35 TB/s).  The 2 Q N K one-bit
// operations take far less on the tensor cores: their one-bit product runs
// at 8x the int8 dense rate, 1.58e16 operations a second
// (ccmh_torch/tools/time_hamming.py --rate on an H100 80GB HBM3 at 700 W),
// 0.035 ms at K = 2,048.  A SIMT kernel cannot get near the byte bound
// past the shortest codes: __popc issues at a quarter of the rate of XOR
// and add on compute capability 9.0 (16 a clock an SM, 4.2e12/s on 132 SMs
// at 1.98 GHz), and each output costs W of them: 0.51 ms at K = 512, 2.05
// ms at K = 2,048.
//
// Design: the tensor cores' one-bit product.  popc(a ^ b) = popc(a) +
// popc(b) - 2 popc(a & b), and sum_w popc(q[i, w] & r[j, w]) is the
// product q r^T over K one-bit values with AND for the multiply and a
// population count for the sum: wgmma .b1 m64n128k256 .and.popc with an s32
// accumulator (SASS BGMMA), exact.  The packed rows are already its K-major
// operands (no unpacking; the bit order inside a lane does not matter, the
// sum runs over all bits).  A block computes a [128 queries][128 gallery
// rows] tile of distances with two warpgroups, 64 query rows each, over the
// same gallery tile: the whole K of both tiles (<= 256 bytes a row, 64 KB
// in all at K = 2,048) lands at once in shared memory, rows and lanes past
// Q, N or W zero-filled (zero bits add nothing to any popcount), so no
// padding is needed on the caller's side.  While the products run (after
// all of them are issued), each thread counts the set bits of one row of
// the landed tiles (pq, pr: 8 KS __popc a thread, once per tile, amortised
// over the 128 outputs of the row; none per output).  The epilogue forms
// d = pq + pr - 2 acc in int32, stages the tile through shared memory
// (reusing the operand tiles; 16-byte chunks swizzled so neither side
// conflicts) and stores whole 128-byte lines with 16-byte coalesced stores
// (scalar ones where N % 4 != 0 leaves the rows unaligned).  The product
// and its tile layout are in hamming_tc.cuh.
//
// Two kernel families, by the rule of hamming_family.cuh: TMA lands the
// tiles (one box of [128 rows][32 lanes] an atom, the 128-byte swizzle)
// where the rows are a multiple of 16 bytes and the codes past 256 bits;
// the block's threads land them lane by lane otherwise (rows of 4, 8, ...
// or 68 bytes, which no tensor map describes).  On an H100 80GB HBM3 at
// 700 W (ccmh_torch/tools/time_hamming.py, Q = 512, N = 2^18) the lane
// loader beat the TMA one up to 256 bits (0.191 against 0.218 ms at K =
// 128, 0.200 against 0.204 at 256) and lost past it (0.265 against 0.219
// at 512), and it beat the XOR + __popc kernel it replaces at every length
// (0.183-0.201 against 0.194-0.440 ms from K = 32 to 256), which is gone.

#include <cstring>

#include "hamming_family.cuh"
#include "hamming_tc.cuh"

namespace {

using namespace ccmh::ham;

// rows row0 .. row0 + 127 of src [rows][W] into a tile, lane by lane,
// zeros past W (up to the KS k-steps the products read) and past `rows`
__device__ __forceinline__ void land_lanes(unsigned char* tile, const uint32_t* __restrict__ src,
                                           long long row0, long long rows, int W, int KS,
                                           int tid) {
  const int lanes = 8 * KS;
  for (int idx = tid; idx < kTcRows * lanes; idx += kTcThreads) {
    const int rr = idx / lanes, l = idx - rr * lanes;
    const long long row = row0 + rr;
    const uint32_t v = (row < rows && l < W) ? __ldg(src + row * W + l) : 0u;
    *reinterpret_cast<uint32_t*>(tile + lane_offset(rr, l)) = v;
  }
}

// One block: distances of queries q0 .. q0 + 127 to gallery rows n0 .. n0 +
// 127; blockIdx.x = the gallery tile * n_qt + the query tile, so the query
// tiles of one gallery tile run side by side and read it once from memory.
// KS = ceil(W / 8) k-steps, a template parameter so that the products are
// issued as straight-line code (ptxas serialises wgmma under a branch).
template <bool kTma, int KS>
__global__ void __launch_bounds__(kTcThreads, 2)
hamming_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap r_map, const uint32_t* __restrict__ q,
                  const uint32_t* __restrict__ r, int32_t* __restrict__ out, int Q, long long N,
                  int W, int n_qt) {
  using namespace ccmh::wg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  constexpr int NA = (KS + 3) / 4;                  // atoms of 32 lanes a row
  unsigned char* qs = smem;
  unsigned char* rs = smem + NA * kBitAtomBytes;
  int* pq = reinterpret_cast<int*>(smem + kStageBytes);
  int* pr = pq + kTcRows;
  uint64_t* bar = reinterpret_cast<uint64_t*>(pr + kTcRows);
  const int tid = threadIdx.x;
  const int q0 = (blockIdx.x % n_qt) * kTcRows;
  const long long n0 = (long long)(blockIdx.x / n_qt) * kTcRows;

  if constexpr (kTma) {
    if (tid == 0) {
      bar_init(bar, 1);
      bar_init_fence();
      bar_expect_tx(bar, 2 * NA * kBitAtomBytes);   // whole boxes, the zero fill counted
      for (int a = 0; a < NA; ++a) {
        tma_load(qs + a * kBitAtomBytes, &q_map, bar, kLanesPerAtom * a, q0, 0);
        tma_load(rs + a * kBitAtomBytes, &r_map, bar, kLanesPerAtom * a, (int)n0, 0);
      }
    }
    __syncthreads();
    bar_wait(bar, 0);
  } else {
    land_lanes(qs, q, q0, Q, W, KS, tid);
    land_lanes(rs, r, n0, N, W, KS, tid);
    fence_async_smem();   // the threads' writes visible to wgmma's operand reads
    __syncthreads();
  }

  // the products: the warpgroup's 64 query rows against the 128 gallery rows
  const int wg = tid >> 7;
  uint32_t d[64];   // the first k-step starts the sum (scale-d 0): no zeros to set
  fence_acc(d);
  wg_fence();
  const unsigned char* qa = qs + wg * 64 * 128;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) and_popc(d, kstep_desc(qa, ks), kstep_desc(rs, ks), ks > 0);
  wg_commit();
  // every product issued before any row popcount: without this barrier
  // ptxas interleaves the popcounts' shared-memory loads and POPCs with the
  // products' issue
  __syncthreads();

  // meanwhile the row popcounts: thread tid counts query row tid (< 128)
  // or gallery row tid - 128 over the 16-byte chunks the k-steps read (the
  // swizzle permutes a row's chunks, so each is read at its place)
  {
    const int row = tid & (kTcRows - 1);
    const unsigned char* base = (tid < kTcRows ? qs : rs) + row * 128;
    int s = 0;
#pragma unroll
    for (int c = 0; c < 2 * KS; ++c) {
      const uint4 v = *reinterpret_cast<const uint4*>(base + (c >> 3) * kBitAtomBytes +
                                                      (((c & 7) ^ (row & 7)) << 4));
      s += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
    }
    (tid < kTcRows ? pq : pr)[row] = s;
  }
  wg_wait0();
  fence_acc(d);
  // pq and pr complete, and every product's reads of the tiles done: the
  // staged distances may overwrite them
  __syncthreads();

  // d = pq + pr - 2 acc into the warpgroup's [64][128] staging tile: row
  // rr at rr * 512, its 16-byte chunk c at chunk c ^ (rr & 7)
  const int lt = tid & 127, warp = lt >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  unsigned char* st = smem + wg * 64 * kStageRowBytes;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = 16 * warp + g + 8 * h;
    const int prow = pq[64 * wg + rr];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * t;
      const int2 pc = *reinterpret_cast<const int2*>(pr + col);
      int2 v;
      v.x = prow + pc.x - 2 * static_cast<int>(d[4 * j + 2 * h]);
      v.y = prow + pc.y - 2 * static_cast<int>(d[4 * j + 2 * h + 1]);
      *reinterpret_cast<int2*>(st + rr * kStageRowBytes + (((col >> 2) ^ (rr & 7)) << 4) +
                               ((col & 3) << 2)) = v;
    }
  }
  // the warpgroup's staging complete (named barriers 1 and 2, constants so
  // that ptxas reserves just those)
  if (wg == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");

  // whole rows out: a warp writes row rr's 512 bytes, a 16-byte chunk a lane
  const bool vec = (N & 3) == 0;
  for (int rr = warp; rr < 64; rr += 4) {
    const int gq = q0 + 64 * wg + rr;
    if (gq >= Q) break;
    int32_t* orow = out + (size_t)gq * N;
    const unsigned char* srow = st + rr * kStageRowBytes;
    if (vec) {
      const long long col = n0 + 4 * lane;
      if (col < N)
        *reinterpret_cast<int4*>(orow + col) =
            *reinterpret_cast<const int4*>(srow + ((lane ^ (rr & 7)) << 4));
    } else {
#pragma unroll
      for (int c = lane; c < kTcRows; c += 32) {
        const long long col = n0 + c;
        if (col < N)
          orow[col] = *reinterpret_cast<const int*>(srow + (((c >> 2) ^ (rr & 7)) << 4) +
                                                    ((c & 3) << 2));
      }
    }
  }
}

// a [rows][W] tensor of 32-bit lanes (W % 4 == 0) in boxes of [128 rows][32
// lanes] under the 128-byte swizzle, lanes past W and rows past `rows`
// filled with zeros
cudaError_t lane_map(CUtensorMap* map, const void* base, uint64_t W, uint64_t rows) {
  ccmh::wg::EncodeTiled fn = ccmh::wg::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {W, rows, 1};
  const cuuint64_t strides[2] = {W * 4, rows * W * 4};
  const cuuint32_t boxes[3] = {kLanesPerAtom, kTcRows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, const_cast<void*>(base), dims,
                          strides, boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool kTma, int KS>
cudaError_t launch_tc(const void* q, const void* r, void* out, int Q, long long N, int W,
                      cudaStream_t stream) {
  CUtensorMap q_map, r_map;
  memset(&q_map, 0, sizeof(q_map));
  memset(&r_map, 0, sizeof(r_map));
  cudaError_t err;
  if (kTma) {
    if ((err = lane_map(&q_map, q, W, Q)) != cudaSuccess) return err;
    if ((err = lane_map(&r_map, r, W, N)) != cudaSuccess) return err;
  }
  const long long n_qt = (Q + kTcRows - 1) / kTcRows;
  const long long blocks = n_qt * ((N + kTcRows - 1) / kTcRows);
  if (N > 2147483647LL || blocks > 2147483647LL) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(hamming_tc_kernel<kTma, KS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (err != cudaSuccess) return err;
  hamming_tc_kernel<kTma, KS><<<(unsigned)blocks, kTcThreads, kTcSmem, stream>>>(
      q_map, r_map, static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(r),
      static_cast<int32_t*>(out), Q, N, W, (int)n_qt);
  return cudaGetLastError();
}

template <bool kTma>
cudaError_t launch_tc(const void* q, const void* r, void* out, int Q, long long N, int W,
                      cudaStream_t stream) {
  switch ((W + 7) / 8) {
    case 1: return launch_tc<kTma, 1>(q, r, out, Q, N, W, stream);
    case 2: return launch_tc<kTma, 2>(q, r, out, Q, N, W, stream);
    case 3: return launch_tc<kTma, 3>(q, r, out, Q, N, W, stream);
    case 4: return launch_tc<kTma, 4>(q, r, out, Q, N, W, stream);
    case 5: return launch_tc<kTma, 5>(q, r, out, Q, N, W, stream);
    case 6: return launch_tc<kTma, 6>(q, r, out, Q, N, W, stream);
    case 7: return launch_tc<kTma, 7>(q, r, out, Q, N, W, stream);
    case 8: return launch_tc<kTma, 8>(q, r, out, Q, N, W, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [Q, W], r [N, W] 32-bit lanes, out [Q, N] int32, all contiguous, by
// kernel family `family`, a HammingFamily, or -1 for the fixed rule of
// hamming_family.cuh.  A family the operands do not admit (TMA takes rows
// of 16-byte multiples at 16-byte aligned starts) is refused with
// cudaErrorNotSupported before any launch.  Launches on `stream` of card
// `device`, writes the family it launched to *launched (where not null)
// and returns cudaGetLastError() (0 = launched).
extern "C" int ccmh_hamming_packed_as(int device, const void* q, const void* r, void* out,
                                      int Q, long long N, int W, int family, int* launched,
                                      void* stream) {
  if (Q < 1 || N < 1 || W < 1 || W > ccmh::kHammingMaxLanes) return (int)cudaErrorInvalidValue;
  if (family == -1) family = ccmh::hamming_family(W, q, r);
  if (family != ccmh::kHammingTma && family != ccmh::kHammingLanes)
    return (int)cudaErrorInvalidValue;
  if (family == ccmh::kHammingTma && !ccmh::hamming_tma_ok(W, q, r))
    return (int)cudaErrorNotSupported;
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: name the card of the tensors
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = family == ccmh::kHammingTma ? launch_tc<true>(q, r, out, Q, N, W, s)
                                    : launch_tc<false>(q, r, out, Q, N, W, s);
  if (err == cudaSuccess && launched != nullptr) *launched = family;
  return (int)err;
}

// The same by the fixed rule, with the arguments every version of this
// entry takes (ccmh_torch/tools/time_hamming.py times another checkout's
// through it).
extern "C" int ccmh_hamming_packed(int device, const void* q, const void* r, void* out, int Q,
                                   long long N, int W, void* stream) {
  return ccmh_hamming_packed_as(device, q, r, out, Q, N, W, -1, nullptr, stream);
}
