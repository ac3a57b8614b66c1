// Packed Hamming distances: out[i, j] = sum_w popcount(q[i, w] ^ r[j, w]).
//
// Replaces: ccmh/ops/hamming.py `hamming_distance_packed` / `_popcount_kernel`
// (the Pallas TPU kernel).  Lanes are 32-bit patterns (int32 tensors on the
// PyTorch side, uint32 here); W = ceil(K/32) <= 8 is a runtime value.
//
// What bounds it on an H100: bytes, and almost all of them are the int32
// [Q, N] output.  At Q=512, N=2^20 the kernel must write 2.1 GB (~0.64 ms at
// 3.35 TB/s); the gallery is 8 MB at K=64 and the XOR+popcount work is a few
// integer operations per output.
//
// Design: a block stages a tile of 32 query rows in shared memory; each
// thread owns one gallery row, holds its W lanes in registers and walks the
// tile, so a warp's gallery reads and its output writes are coalesced along
// N.  The kernel masks the ragged edges of Q and N itself: no padding to
// block multiples is needed (ccmh's Pallas kernel needed 256 | Q, 1024 | N).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQueryTile = 32;
constexpr int kMaxW = 8;

__global__ void __launch_bounds__(kThreads)
hamming_packed_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ r,
                      int32_t* __restrict__ out, int Q, long long N, int W) {
  __shared__ uint32_t tile[kQueryTile * kMaxW];
  const int q0 = blockIdx.y * kQueryTile;
  const int nq = min(kQueryTile, Q - q0);
  for (int idx = threadIdx.x; idx < nq * W; idx += blockDim.x)
    tile[idx] = q[(size_t)q0 * W + idx];
  __syncthreads();

  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= N) return;
  uint32_t lanes[kMaxW];
#pragma unroll
  for (int w = 0; w < kMaxW; ++w) lanes[w] = (w < W) ? r[j * W + w] : 0u;
  for (int i = 0; i < nq; ++i) {
    int dist = 0;
#pragma unroll
    for (int w = 0; w < kMaxW; ++w)
      if (w < W) dist += __popc(tile[i * W + w] ^ lanes[w]);
    out[(size_t)(q0 + i) * N + j] = dist;
  }
}

}  // namespace

// q [Q, W], r [N, W] 32-bit lanes, out [Q, N] int32, all contiguous.
// Launches on `stream` of card `device` and returns cudaGetLastError()
// (0 = launched).
extern "C" int ccmh_hamming_packed(int device, const void* q, const void* r, void* out,
                                   int Q, long long N, int W, void* stream) {
  if (Q < 1 || N < 1 || W < 1 || W > kMaxW) return (int)cudaErrorInvalidValue;
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: name the card of the tensors
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long gx = (N + kThreads - 1) / kThreads;
  const long long gy = (Q + kQueryTile - 1) / kQueryTile;
  if (gx > 2147483647LL || gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  hamming_packed_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(r),
      static_cast<int32_t*>(out), Q, N, W);
  return (int)cudaGetLastError();
}
