// Tensor-core building blocks of the attention kernels (attention.cu,
// attention_bwd.cu and the ablation kernels): warp-level mma.sync products on 16-row tiles held in
// shared memory, for bf16 (m16n8k16, fp32 accumulators) and for fp32 as
// 3xTF32 (m16n8k8: x = hi + lo with hi = rna(x) and lo = rna(x - hi) in
// TF32, and a.b = hi.hi' + hi.lo' + lo.hi' summed in fp32, which keeps
// about fp32's accuracy where one TF32 pass keeps three decimal digits),
// and the 16-byte cp.async loads of head rows into shared memory.
//
// Layout conventions.  A tile in shared memory is row-major with a row
// stride `ld` (elements) of Dp + 8 in bf16 and Dp + 4 in fp32, Dp the head
// dim (or L) padded to 16: rows then start 16 bytes apart modulo 128 in
// bf16, so the eight row addresses of every ldmatrix hit eight different
// bank groups, and in fp32 the scalar fragment loads below hit 32 different
// banks.  Products are taken in blocks of 16 along the summed index (one
// m16n8k16, or two m16n8k8 sub-steps) and 8 along n.  An accumulator tile
// (16 rows x 8 columns) is c[4]: rows g = lane / 4 and g + 8, columns
// 2 t and 2 t + 1, t = lane % 4.
//
// fp32 only: within a 16-block the summed index is taken in one of two
// orders.  "rows" fragments (a_rows with b_rows: S = Q K^T, dP = dO V^T)
// read k = t and t + 4 of each sub-step; "cols" fragments (a_acc, a_cols
// with b_cols: P V, dS K, P^T dO, dS^T Q) read k = 2 t and 2 t + 1, which
// is where an accumulator tile keeps its columns, so a rounded accumulator
// becomes the next product's A operand in registers, with no shuffle.  The
// two orders give the same sum up to fp32 reassociation; an A and a B
// fragment always come from the same family.

#pragma once

#include "common.cuh"

namespace ccmh {
namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 (round to nearest, ties away from zero)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T> struct Frag;

// bf16: one m16n8k16 per 16-block; ldmatrix feeds every shared-memory operand
template <> struct Frag<__nv_bfloat16> {
  using T = __nv_bfloat16;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };

  __device__ static void mma(float (&c)[4], const A& a, const B& b) { mma_bf16(c, a.r, b.r); }

  // A = X[m0 + 0..15][k0 + 0..15] of a row-major [m][k] tile
  __device__ static A a_rows(const T* X, int ld, int m0, int k0, int lane) {
    A a;
    ldsm_x4(a.r, X + (m0 + (lane & 15)) * ld + k0 + ((lane >> 4) << 3));
    return a;
  }
  // A[m][k] = X[k0 + k][m0 + m] of a row-major [k][m] tile (A = X^T)
  __device__ static A a_cols(const T* X, int ld, int m0, int k0, int lane) {
    A a;
    ldsm_x4_trans(a.r, X + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 +
                           (((lane >> 3) & 1) << 3));
    return a;
  }
  // A from two accumulator tiles (columns 0-7 and 8-15), rounded to bf16
  __device__ static A a_acc(const float (&c0)[4], const float (&c1)[4]) {
    A a;
    a.r[0] = pack_bf16(c0[0], c0[1]);
    a.r[1] = pack_bf16(c0[2], c0[3]);
    a.r[2] = pack_bf16(c1[0], c1[1]);
    a.r[3] = pack_bf16(c1[2], c1[3]);
    return a;
  }
  // B tiles n0 + 0..7 and n0 + 8..15 with B[k][n] = Y[n0 + n][k0 + k] of a
  // row-major [n][k] tile (B = Y^T)
  __device__ static void b_rows(B& b0, B& b1, const T* Y, int ld, int n0, int k0, int lane) {
    uint32_t r[4];
    ldsm_x4(r, Y + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + (((lane >> 3) & 1) << 3));
    b0.r[0] = r[0]; b0.r[1] = r[1]; b1.r[0] = r[2]; b1.r[1] = r[3];
  }
  // B tiles n0 + 0..7 and n0 + 8..15 of a row-major [k][n] tile
  __device__ static void b_cols(B& b0, B& b1, const T* Y, int ld, int k0, int n0, int lane) {
    uint32_t r[4];
    ldsm_x4_trans(r, Y + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n0 +
                         ((lane >> 4) << 3));
    b0.r[0] = r[0]; b0.r[1] = r[1]; b1.r[0] = r[2]; b1.r[1] = r[3];
  }
};

// fp32 as 3xTF32: two m16n8k8 sub-steps per 16-block, three products each
template <> struct Frag<float> {
  using T = float;
  struct A { uint32_t hi[2][4], lo[2][4]; };
  struct B { uint32_t hi[2][2], lo[2][2]; };

  __device__ static void mma(float (&c)[4], const A& a, const B& b) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mma_tf32(c, a.lo[s], b.hi[s]);
      mma_tf32(c, a.hi[s], b.lo[s]);
      mma_tf32(c, a.hi[s], b.hi[s]);
    }
  }
  __device__ static void set_a(A& a, int s, float x0, float x1, float x2, float x3) {
    split(x0, a.hi[s][0], a.lo[s][0]);
    split(x1, a.hi[s][1], a.lo[s][1]);
    split(x2, a.hi[s][2], a.lo[s][2]);
    split(x3, a.hi[s][3], a.lo[s][3]);
  }
  __device__ static void set_b(B& b, int s, float x0, float x1) {
    split(x0, b.hi[s][0], b.lo[s][0]);
    split(x1, b.hi[s][1], b.lo[s][1]);
  }
  // "rows" order: k = t, t + 4 of each sub-step
  __device__ static A a_rows(const T* X, int ld, int m0, int k0, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const T* x0 = X + (m0 + g) * ld + k0 + t;
    const T* x1 = x0 + 8 * ld;
    A a;
#pragma unroll
    for (int s = 0; s < 2; ++s) set_a(a, s, x0[8 * s], x1[8 * s], x0[8 * s + 4], x1[8 * s + 4]);
    return a;
  }
  // "cols" order: k = 2 t, 2 t + 1 of each sub-step
  __device__ static A a_cols(const T* X, int ld, int m0, int k0, int lane) {
    const int g = lane >> 2, t = lane & 3;
    A a;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const T* x = X + (k0 + 8 * s + 2 * t) * ld + m0 + g;
      set_a(a, s, x[0], x[8], x[ld], x[ld + 8]);
    }
    return a;
  }
  __device__ static A a_acc(const float (&c0)[4], const float (&c1)[4]) {
    A a;
    set_a(a, 0, c0[0], c0[2], c0[1], c0[3]);
    set_a(a, 1, c1[0], c1[2], c1[1], c1[3]);
    return a;
  }
  __device__ static void b_rows(B& b0, B& b1, const T* Y, int ld, int n0, int k0, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const T* y0 = Y + (n0 + g) * ld + k0 + t;
    const T* y1 = y0 + 8 * ld;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      set_b(b0, s, y0[8 * s], y0[8 * s + 4]);
      set_b(b1, s, y1[8 * s], y1[8 * s + 4]);
    }
  }
  __device__ static void b_cols(B& b0, B& b1, const T* Y, int ld, int k0, int n0, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const T* y = Y + (k0 + 8 * s + 2 * t) * ld + n0 + g;
      set_b(b0, s, y[0], y[ld]);
      set_b(b1, s, y[8], y[ld + 8]);
    }
  }
};

// fp32 products as 3xTF32 with a split that takes no conversion
// instruction (attention_merged.cu, attention_bwd_x.cu): hi = x with its
// low 13 mantissa bits cleared (rounded toward zero) and lo = x - hi the
// same way, two integer ANDs and one add where split (cvt.rna, round to
// nearest) takes two conversions, which run at a quarter of the integer
// rate; a.b = hi.hi' + hi.lo' + lo.hi' then stays within about 2^-21 of a.b
// relative (2^-22 rounding to nearest), far under the 1e-4 gates.
__device__ __forceinline__ void split_tz(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// Frag<T> with split_tz in fp32; bf16 is Frag's as it is
template <typename T>
struct FragTz : Frag<T> {};

template <>
struct FragTz<float> {
  using T = float;
  using A = Frag<float>::A;
  using B = Frag<float>::B;
  __device__ static void mma(float (&c)[4], const A& a, const B& b) { Frag<float>::mma(c, a, b); }
  __device__ static void set_a(A& a, int s, float x0, float x1, float x2, float x3) {
    split_tz(x0, a.hi[s][0], a.lo[s][0]);
    split_tz(x1, a.hi[s][1], a.lo[s][1]);
    split_tz(x2, a.hi[s][2], a.lo[s][2]);
    split_tz(x3, a.hi[s][3], a.lo[s][3]);
  }
  __device__ static void set_b(B& b, int s, float x0, float x1) {
    split_tz(x0, b.hi[s][0], b.lo[s][0]);
    split_tz(x1, b.hi[s][1], b.lo[s][1]);
  }
  // the fragments of Frag<float>, in its "rows" and "cols" orders
  __device__ static A a_rows(const T* X, int ld, int m0, int k0, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const T* x0 = X + (m0 + g) * ld + k0 + t;
    const T* x1 = x0 + 8 * ld;
    A a;
#pragma unroll
    for (int s = 0; s < 2; ++s) set_a(a, s, x0[8 * s], x1[8 * s], x0[8 * s + 4], x1[8 * s + 4]);
    return a;
  }
  __device__ static A a_cols(const T* X, int ld, int m0, int k0, int lane) {
    const int g = lane >> 2, t = lane & 3;
    A a;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const T* x = X + (k0 + 8 * s + 2 * t) * ld + m0 + g;
      set_a(a, s, x[0], x[8], x[ld], x[ld + 8]);
    }
    return a;
  }
  __device__ static A a_acc(const float (&c0)[4], const float (&c1)[4]) {
    A a;
    set_a(a, 0, c0[0], c0[2], c0[1], c0[3]);
    set_a(a, 1, c1[0], c1[2], c1[1], c1[3]);
    return a;
  }
  __device__ static void b_rows(B& b0, B& b1, const T* Y, int ld, int n0, int k0, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const T* y0 = Y + (n0 + g) * ld + k0 + t;
    const T* y1 = y0 + 8 * ld;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      set_b(b0, s, y0[8 * s], y0[8 * s + 4]);
      set_b(b1, s, y1[8 * s], y1[8 * s + 4]);
    }
  }
  __device__ static void b_cols(B& b0, B& b1, const T* Y, int ld, int k0, int n0, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const T* y = Y + (k0 + 8 * s + 2 * t) * ld + n0 + g;
      set_b(b0, s, y[0], y[ld]);
      set_b(b1, s, y[8], y[ld + 8]);
    }
  }
};

__host__ __device__ __forceinline__ int pad16(int n) { return (n + 15) & ~15; }

// (r, c) = divmod(i, cols) for i = start, start + stride, ..., stepped
// without a division per step (a thread's walk over a [rows][cols] grid)
struct Walk {
  int r, c;
  const int dr, dc, cols;
  __device__ Walk(int start, int stride, int cols_)
      : r(start / cols_), c(start % cols_), dr(stride / cols_), dc(stride % cols_),
        cols(cols_) {}
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// row stride of a shared-memory tile whose rows hold `cols` (padded) values
template <typename T>
__host__ __device__ __forceinline__ int tile_ld(int cols) {
  return pad16(cols) + (sizeof(T) == 2 ? 8 : 4);
}

// Zero the padding of a [pad16(rows)][ld] tile holding `rows` rows of Dh
// values: columns Dh..pad16(Dh)-1 of the live rows, and the padding rows
// (16 bytes at a time: every row starts 16-byte aligned).
template <typename T>
__device__ __forceinline__ void zero_pad(T* dst, int ld, int rows, int Dh) {
  constexpr int E = 16 / sizeof(T);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int rp = pad16(rows), dp = pad16(Dh);
  if (dp > Dh)
    for (Walk w(tid, nt, dp - Dh); w.r < rows; w.next())
      dst[w.r * ld + Dh + w.c] = from_float<T>(0.f);
  for (Walk w(tid, nt, dp / E); w.r < rp - rows; w.next())
    *reinterpret_cast<uint4*>(dst + (rows + w.r) * ld + w.c * E) = make_uint4(0, 0, 0, 0);
}

// Copy `rows` head rows of Dh values (src row r at src + r * src_ld) into
// the [pad16(rows)][ld] tile dst, its padding zeroed.  vec: 16-byte
// cp.async copies (the caller has checked that src, src_ld and Dh are
// 16-byte multiples); the caller then waits (cp_async_wait_all,
// __syncthreads) and adds the bias with add_bias.  Otherwise scalar loads,
// with the bias added here in T.  Every thread of the block takes part.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* __restrict__ src,
                                          size_t src_ld, int rows, int Dh,
                                          const T* __restrict__ bias, bool vec) {
  constexpr int E = 16 / sizeof(T);
  const int tid = threadIdx.x, nt = blockDim.x;
  zero_pad<T>(dst, ld, rows, Dh);
  if (vec) {
    for (Walk w(tid, nt, Dh / E); w.r < rows; w.next())
      cp_async16(dst + w.r * ld + w.c * E, src + w.r * src_ld + w.c * E);
  } else {
    for (Walk w(tid, nt, Dh); w.r < rows; w.next()) {
      float x = to_float(src[w.r * src_ld + w.c]);
      if (bias != nullptr) x = round_to<T>(x + to_float(bias[w.c]));
      dst[w.r * ld + w.c] = from_float<T>(x);
    }
  }
}

// x = (x + b) rounded to T, on 16 bytes of T (in fp32, as the plain version)
template <typename T>
__device__ __forceinline__ void add16(uint4& xv, const uint4& bv) {
  if constexpr (sizeof(T) == 2) {
    __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&xv);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&bv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 xf = __bfloat1622float2(x[e]), bf = __bfloat1622float2(b[e]);
      x[e] = __floats2bfloat162_rn(xf.x + bf.x, xf.y + bf.y);
    }
  } else {
    float* x = reinterpret_cast<float*>(&xv);
    const float* b = reinterpret_cast<const float*>(&bv);
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] += b[e];
  }
}

// dst[r][c] = (dst[r][c] + bias[c]) rounded to T, 16 bytes at a time (the
// vec path of load_tile, after its copies have landed); bias is a 16-byte
// aligned row of shared or device memory
template <typename T>
__device__ __forceinline__ void add_bias(T* dst, int ld, int rows, int Dh, const T* bias) {
  constexpr int E = 16 / sizeof(T);
  for (Walk w(threadIdx.x, blockDim.x, Dh / E); w.r < rows; w.next()) {
    T* d = dst + w.r * ld + w.c * E;
    uint4 xv = *reinterpret_cast<const uint4*>(d);
    add16<T>(xv, *reinterpret_cast<const uint4*>(bias + w.c * E));
    *reinterpret_cast<uint4*>(d) = xv;
  }
}

// The q | k | v rows of one head into the three [pad16(L)][ld] tiles at
// dst (q, then k, then v), the bias added in T: src is the head's q slice
// of row 0 (part p at src + p D, row r at + r D3), bias its q slice of
// qkv_b (part p at + p D) or null.  With a bias on the vec path, bf16 rows
// come through registers, four 16-byte loads in flight a thread, and are
// stored once with the bias added; fp32 rows (twice the loads, which
// measured slower that way) are copied by cp.async and the bias, copied to
// sbias ([3][pad16(Dh)]), is added by finish_qkv.  Without a bias, or
// off the vec path, as load_tile does.  The caller then calls finish_qkv.
template <typename T>
__device__ __forceinline__ void load_qkv(T* dst, int Lp, int ld, T* sbias,
                                         const T* __restrict__ src, int D, size_t D3, int L,
                                         int Dh, const T* __restrict__ bias, bool vec) {
  if (!vec || bias == nullptr || sizeof(T) == 4) {
    for (int part = 0; part < 3; ++part)
      load_tile<T>(dst + part * Lp * ld, ld, src + part * D, D3, L, Dh,
                   bias ? bias + part * D : nullptr, vec);
    if (vec && bias != nullptr) {
      constexpr int E = 16 / sizeof(T);
      for (Walk w(threadIdx.x, blockDim.x, Dh / E); w.r < 3; w.next())
        cp_async16(sbias + w.r * pad16(Dh) + w.c * E, bias + w.r * D + w.c * E);
    }
    return;
  }
  constexpr int E = 16 / sizeof(T), U = 4;
  for (int part = 0; part < 3; ++part) zero_pad<T>(dst + part * Lp * ld, ld, L, Dh);
  const int rows = 3 * L;
  Walk w(threadIdx.x, blockDim.x, Dh / E);
  while (w.r < rows) {
    uint4 x[U], b[U];
    int off[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      off[u] = -1;
      if (w.r < rows) {
        const int part = w.r >= 2 * L ? 2 : (w.r >= L ? 1 : 0);
        const int r = w.r - part * L, c = w.c * E;
        x[u] = __ldg(reinterpret_cast<const uint4*>(src + part * D + r * D3 + c));
        b[u] = __ldg(reinterpret_cast<const uint4*>(bias + part * D + c));
        off[u] = (part * Lp + r) * ld + c;
        w.next();
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (off[u] >= 0) {
        add16<T>(x[u], b[u]);
        *reinterpret_cast<uint4*>(dst + off[u]) = x[u];
      }
    }
  }
}

// Wait for load_qkv's copies and make the tiles visible to the block; on
// the fp32 vec path with a bias, add it in a pass over the tiles.
template <typename T>
__device__ __forceinline__ void finish_qkv(T* dst, int Lp, int ld, const T* sbias, int L,
                                           int Dh, bool has_bias, bool vec) {
  if (vec) cp_async_wait_all();
  __syncthreads();
  if (sizeof(T) == 4 && vec && has_bias) {
    for (int part = 0; part < 3; ++part)
      add_bias<T>(dst + part * Lp * ld, ld, L, Dh, sbias + part * pad16(Dh));
    __syncthreads();
  }
}

// Accumulator tiles acc[j] (columns 8 j ..) of a warp's 16 rows, rounded
// to T, into rows 0..15 of the [16][ld] tile dst
template <typename T, int N>
__device__ __forceinline__ void stage_acc(T* dst, int ld, const float (&acc)[N][4], int n_tiles,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j < n_tiles) {
      T* d = dst + g * ld + 8 * j + 2 * t;
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<uint32_t*>(d) = pack_bf16(acc[j][0], acc[j][1]);
        *reinterpret_cast<uint32_t*>(d + 8 * ld) = pack_bf16(acc[j][2], acc[j][3]);
      } else {
        *reinterpret_cast<float2*>(d) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(d + 8 * ld) = make_float2(acc[j][2], acc[j][3]);
      }
    }
  }
}

// A warp copies `rows` (<= 16) rows of Dh values from the tile src to
// device memory (row r at dst + r * dst_ld): 16-byte stores, coalesced
// along each row, where vec; scalar stores otherwise.
template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, size_t dst_ld, const T* src,
                                           int ld, int rows, int Dh, bool vec, int lane) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    for (Walk w(lane, 32, Dh / E); w.r < rows; w.next())
      *reinterpret_cast<uint4*>(dst + w.r * dst_ld + w.c * E) =
          *reinterpret_cast<const uint4*>(src + w.r * ld + w.c * E);
  } else {
    for (Walk w(lane, 32, Dh); w.r < rows; w.next())
      dst[w.r * dst_ld + w.c] = src[w.r * ld + w.c];
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// logit of query i and key j: (q . k) * scale + mask in fp32, each step
// rounded on its own (no fused multiply-add), -inf for a padded key; a
// padded query (i >= L) reads no mask
__device__ __forceinline__ float logit(float s, float scale, const float* __restrict__ mask,
                                       int i, int j, int L) {
  if (j >= L) return -CUDART_INF_F;
  float x = __fmul_rn(s, scale);
  if (mask != nullptr && i < L) x = __fadd_rn(x, __ldg(mask + i * L + j));
  return x;
}

// The fp32 row softmax of a warp's accumulator tiles s[j] (keys 8 j ..) of
// queries i0 = m0 + g and i0 + 8, in place: logits, row max and sum over the
// 4 lanes of each row, p = exp(logit - max) * (1 / sum).  n_tiles counts the
// tiles that hold a key below L; the tiles past them hold q . 0 = 0 (the
// padded keys' rows are zero) and stay 0.  The row maxima and sums are left
// in mx[2], sum[2].
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N][4], int n_tiles, float scale,
                                             const float* __restrict__ mask, int m0, int L,
                                             int lane, float (&mx)[2], float (&sum)[2]) {
  const int g = lane >> 2, t = lane & 3;
  const int i0 = m0 + g, i1 = i0 + 8;
  mx[0] = mx[1] = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j < n_tiles) {
      const int c = 8 * j + 2 * t;
      s[j][0] = logit(s[j][0], scale, mask, i0, c, L);
      s[j][1] = logit(s[j][1], scale, mask, i0, c + 1, L);
      s[j][2] = logit(s[j][2], scale, mask, i1, c, L);
      s[j][3] = logit(s[j][3], scale, mask, i1, c + 1, L);
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  sum[0] = sum[1] = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j < n_tiles) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = expf(s[j][e] - mx[e >> 1]);
      sum[0] += s[j][0] + s[j][1];
      sum[1] += s[j][2] + s[j][3];
    }
  }
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);
  const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= inv[e >> 1];
}

// true iff p is 16-byte aligned
__host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace mma
}  // namespace ccmh
