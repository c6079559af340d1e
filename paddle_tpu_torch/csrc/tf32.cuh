// 3xTF32 building blocks shared by the port's fp32 flash-attention kernels
// (the forward in flash_attn_fwd.cu, dQ and dK/dV in flash_attn_bwd.cu):
// the hi/lo split of an fp32 operand, the m16n8k8 TF32 tensor-core
// product and its 3xTF32 form, cp.async copies of a tile of rows of a
// strided [S, D] head slice into padded shared memory, and the address of
// an element of an fp32 box that TMA wrote with 128-byte swizzle (the
// split-D kernels).
//
// Fragment layouts of mma.sync.m16n8k8 (TF32), lane l, g = l / 4,
// t4 = l % 4:
//   A (16 x 8, row-major): a0 (g, t4), a1 (g + 8, t4), a2 (g, t4 + 4),
//     a3 (g + 8, t4 + 4);
//   B (8 x 8, column-major): b0 (k = t4, n = g), b1 (k = t4 + 4, n = g);
//   C (16 x 8, fp32): c0 (g, 2 t4), c1 (g, 2 t4 + 1), c2 (g + 8, 2 t4),
//     c3 (g + 8, 2 t4 + 1).
// A C fragment is not an A fragment (columns 2 t4, +1 against t4, t4 + 4).
// A second product that sums over the C fragment's columns takes each
// 8-column tile in the order 0, 2, 4, 6, 1, 3, 5, 7: then A = (c0, c2, c1,
// c3) as they stand, and B reads rows 2 t4 (b0) and 2 t4 + 1 (b1).  A sum
// does not depend on the order of its terms.
//
// Raw PTX, no CUTLASS: a source that includes this header builds with
// nvcc alone in seconds.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace tf32x3 {

// x = hi + lo exactly: hi is x with the 13 low mantissa bits cleared (a
// TF32 value), lo = x - hi has at most 13 significant bits and is exact
// in fp32.  The tensor cores read only the top 19 bits of a .tf32
// operand, so lo enters its products truncated to TF32 (a relative
// error of 2^-21 of x), with no conversion instruction.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b: m16n8k8, A row-major (4 TF32 registers), B column-major (2),
// fp32 accumulator
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the two small cross terms first, then hi hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const uint32_t (&bhi)[2],
                                     const uint32_t (&blo)[2]) {
  mma(d, alo, bhi);
  mma(d, ahi, blo);
  mma(d, ahi, bhi);
}

// the A fragment of a row-major tile with a row stride of SD floats, p at
// the thread's own element (row g, column t4) of the 16 x 8 block, split
template <int SD>
__device__ __forceinline__ void split_a(const float* p, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split(p[0], hi[0], lo[0]);
  split(p[8 * SD], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * SD + 4], hi[3], lo[3]);
}

// the B fragment (b0, b1) = (x0, x1), split
__device__ __forceinline__ void split_b(float x0, float x1, uint32_t (&hi)[2],
                                        uint32_t (&lo)[2]) {
  split(x0, hi[0], lo[0]);
  split(x1, hi[1], lo[1]);
}

// a C fragment c[0..3] as the A fragment of a product over its columns
// (taken in the order 0, 2, 4, 6, 1, 3, 5, 7), split
__device__ __forceinline__ void split_c_as_a(const float (&c)[4],
                                             uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool vec16, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  // src-size 0 zero-fills the destination and reads nothing
  if (vec16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + ROWS) of a strided [S, D] head slice into [ROWS][D + PAD]
// shared memory by the block's THREADS threads; rows past S are
// zero-filled.  vec16: 16-byte copies (every row start 16-byte aligned),
// else 4-byte ones.
template <int ROWS, int D, int PAD, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t row_stride, int r0, int S,
                                          bool vec16) {
  constexpr int SD = D + PAD;
  const int width = vec16 ? 4 : 1;  // floats per copy
  const int per_row = D / width;
  for (int i = threadIdx.x; i < ROWS * per_row; i += THREADS) {
    const int r = i / per_row, c = (i % per_row) * width, gr = r0 + r;
    const bool valid = gr < S;
    cp_async(dst + r * SD + c, valid ? src + (int64_t)gr * row_stride + c
                                     : src,
             vec16, valid);
  }
}

// a warp's 16 rows as raw A fragments, 4 values per 8 columns of D (a0..a3
// of column block ks in slot (ks, 0..3)): in registers (D <= 64), or in
// the thread's own shared-memory slots (D = 128, where registers would
// spill); split into hi/lo per use
template <int D, int THREADS, bool kInRegs = (D <= 64)>
struct RowFrags;

template <int D, int THREADS>
struct RowFrags<D, THREADS, true> {
  float x[D / 8][4];
  __device__ __forceinline__ explicit RowFrags(float*) {}
  __device__ __forceinline__ void set(int ks, int i, float v) {
    x[ks][i] = v;
  }
  __device__ __forceinline__ void get(int ks, uint32_t (&h)[4],
                                      uint32_t (&l)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(x[ks][i], h[i], l[i]);
  }
};

template <int D, int THREADS>
struct RowFrags<D, THREADS, false> {
  float* x;  // slot (ks, i) of thread t at x[(4 ks + i) THREADS + t]
  __device__ __forceinline__ explicit RowFrags(float* smem)
      : x(smem + threadIdx.x) {}
  __device__ __forceinline__ void set(int ks, int i, float v) {
    x[(4 * ks + i) * THREADS] = v;
  }
  __device__ __forceinline__ void get(int ks, uint32_t (&h)[4],
                                      uint32_t (&l)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(x[(4 * ks + i) * THREADS], h[i], l[i]);
  }
};

// the float offset of element (r, c) of a [rows][32] fp32 box that TMA
// wrote with 128-byte swizzle: 16-byte chunk c / 4 of row r lands at chunk
// (c / 4) ^ (r % 8) of the row (the box starts on 1024 bytes)
__device__ __forceinline__ int swz128(int r, int c) {
  return r * 32 + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

// host: whether 16-byte cp.async copies may move the rows of these
// views, i.e. every row start is 16-byte aligned: each base address a
// multiple of 16 bytes and each stride (in floats) a multiple of 4
inline bool rows_16b_aligned(std::initializer_list<const void*> bases,
                             std::initializer_list<int64_t> strides) {
  for (const void* p : bases)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int64_t s : strides)
    if (s % 4) return false;
  return true;
}

}  // namespace tf32x3
