// The tile products, loads and stores shared by the ablation backwards on
// the tensor cores: #6 and #10 (attention_bwd_x.cu) and #8
// (attention_savedp.cu).  Operand tiles are row-major [pad16(rows)][ld] in
// shared memory (mma_tiles.cuh's layout); accumulators are mma_tiles.cuh's
// [N][4] tile sets; fp32 products are 3xTF32 with the split toward zero
// (FragTz).

#pragma once

#include "mma_tiles.cuh"

namespace ccmh {
namespace bwd {

using namespace ccmh::mma;

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// acc[j] += X[m0 + 0..15] Y^T over the head dim (S = q k^T, dP = g v^T), X
// and Y row-major [rows][Dh] tiles in shared memory: every key tile below n_kt
template <typename T, int N>
__device__ __forceinline__ void rows_by_rows(float (&acc)[N][4], const T* X, const T* Y,
                                             int ld, int m0, int n_kt, int n_dk, int lane) {
  using F = FragTz<T>;
  for (int kb = 0; kb < n_dk; ++kb) {
    const typename F::A a = F::a_rows(X, ld, m0, kb * 16, lane);
#pragma unroll
    for (int jp = 0; jp < N / 2; ++jp) {
      if (jp < n_kt) {
        typename F::B b0, b1;
        F::b_rows(b0, b1, Y, ld, jp * 16, kb * 16, lane);
        F::mma(acc[2 * jp], a, b0);
        F::mma(acc[2 * jp + 1], a, b1);
      }
    }
  }
}

// acc += A Y[16 kb .. 16 kb + 15] for one 16-block kb, Y a row-major
// [rows][Dh] tile
template <typename T, int N>
__device__ __forceinline__ void times_rows_block(float (&acc)[N][4],
                                                 const typename FragTz<T>::A& a, const T* Y,
                                                 int ld, int kb, int n_dk, int lane) {
  using F = FragTz<T>;
#pragma unroll
  for (int np = 0; np < N / 2; ++np) {
    if (np < n_dk) {
      typename F::B b0, b1;
      F::b_cols(b0, b1, Y, ld, kb * 16, np * 16, lane);
      F::mma(acc[2 * np], a, b0);
      F::mma(acc[2 * np + 1], a, b1);
    }
  }
}

// acc += A Y over n_kb 16-blocks, A given block by block by a_of(kb) (bf16:
// unrolled to KB, so that a_of indexes register arrays; fp32: not, as
// kernel #2, whose 3xTF32 code ran slower unrolled)
template <typename T, int KB, int N, typename AOf>
__device__ __forceinline__ void times_rows(float (&acc)[N][4], AOf a_of, const T* Y, int ld,
                                           int n_kb, int n_dk, int lane) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
      if (kb < n_kb) times_rows_block<T, N>(acc, a_of(kb), Y, ld, kb, n_dk, lane);
  } else {
#pragma unroll 1
    for (int kb = 0; kb < n_kb; ++kb) times_rows_block<T, N>(acc, a_of(kb), Y, ld, kb, n_dk, lane);
  }
}

// An accumulator tile set's rows r0 + g (+8) and columns 8 j + 2 t (+1) into
// device memory (row stride dst_ld) in T, where r < rows and c < Dh; pairs
// of columns as one 4- or 8-byte store where `pairs` (even Dh, aligned)
template <typename T, int N>
__device__ __forceinline__ void store_acc(T* __restrict__ dst, size_t dst_ld,
                                          const float (&acc)[N][4], int n_tiles, int r0,
                                          int rows, int Dh, bool pairs, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j >= n_tiles) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + g + 8 * hr, c = 8 * j + 2 * t;
      if (r >= rows || c >= Dh) continue;
      T* d = dst + r * dst_ld + c;
      const float x0 = acc[j][2 * hr], x1 = acc[j][2 * hr + 1];
      if (pairs) {
        if constexpr (sizeof(T) == 2)
          *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(x0, x1);
        else
          *reinterpret_cast<float2*>(d) = make_float2(x0, x1);
      } else {
        d[0] = ccmh::from_float<T>(x0);
        if (c + 1 < Dh) d[1] = ccmh::from_float<T>(x1);
      }
    }
  }
}

// Rows 0 .. rows - 1 of Dh values (src row r at src + r * src_ld) into the
// tile dst, its padding left as it is: 16-byte cp.async where vec (the
// caller then waits), scalar copies otherwise.  Threads tid of nt take part.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* __restrict__ src,
                                          size_t src_ld, int rows, int Dh, bool vec, int tid,
                                          int nt) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    for (Walk w(tid, nt, Dh / E); w.r < rows; w.next())
      cp_async16(dst + w.r * ld + w.c * E, src + w.r * src_ld + w.c * E);
  } else {
    for (Walk w(tid, nt, Dh); w.r < rows; w.next())
      dst[w.r * ld + w.c] = src[w.r * src_ld + w.c];
  }
}

// A fragment ("rows" order) of rows m0 .. m0 + 15 of a head in device
// memory: X[r][c] = src[r * src_ld + c] for r < rows, c < Dh, else 0
__device__ __forceinline__ FragTz<float>::A a_rows_gmem(const float* __restrict__ src,
                                                       size_t src_ld, int m0, int k0, int rows,
                                                       int Dh, int lane) {
  const int g = lane >> 2, t = lane & 3;
  auto x = [&](int r, int c) { return (r < rows && c < Dh) ? __ldg(src + r * src_ld + c) : 0.f; };
  const int r0 = m0 + g, r1 = r0 + 8;
  FragTz<float>::A a;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int c = k0 + 8 * s + t;
    FragTz<float>::set_a(a, s, x(r0, c), x(r1, c), x(r0, c + 4), x(r1, c + 4));
  }
  return a;
}

}  // namespace bwd
}  // namespace ccmh
