// The rate of the tensor cores' one-bit AND-popcount product alone, the
// product the packed Hamming kernel #3 runs (ccmh_torch/csrc/hamming.cu,
// hamming_tc.cuh), for the record beside that kernel's bound.  Not part of
// the port's kernels: ccmh_torch/tools/time_hamming.py --rate compiles it
// with -I ccmh_torch/csrc and calls hamming_tc_rate.
//
// Each block runs `reps` rounds of 8 k-steps of m64n128k256 on each of its
// two warpgroups over the bits its shared memory holds (no loads, no
// stores in the loop), and writes one sum a thread so that the products
// are kept.

#include "hamming_tc.cuh"

namespace {

using namespace ccmh::ham;

__global__ void __launch_bounds__(kTcThreads)
hamming_tc_rate_kernel(int32_t* __restrict__ out, int reps) {
  using namespace ccmh::wg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int wg = threadIdx.x >> 7;
  uint32_t d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0u;
  for (int i = 0; i < reps; ++i) {
    fence_acc(d);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      and_popc(d, kstep_desc(smem + wg * 64 * 128, ks), kstep_desc(smem + 2 * kBitAtomBytes, ks),
               1);
    wg_commit();
    wg_wait0();
    fence_acc(d);
  }
  int s = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) s += static_cast<int>(d[i]);
  out[(size_t)blockIdx.x * kTcThreads + threadIdx.x] = s;
}

}  // namespace

// out [blocks * 256] int32: `blocks` blocks of hamming_tc_rate_kernel, each
// 2 * reps * 8 products of m64n128k256, 2 * 64 * 128 * 256 one-bit
// operations each.  Returns cudaGetLastError() (0 = launched).
extern "C" int hamming_tc_rate(int device, void* out, int blocks, int reps, void* stream) {
  if (blocks < 1 || reps < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(hamming_tc_rate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTcSmem);
  if (err != cudaSuccess) return (int)err;
  hamming_tc_rate_kernel<<<blocks, kTcThreads, kTcSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out), reps);
  return (int)cudaGetLastError();
}
