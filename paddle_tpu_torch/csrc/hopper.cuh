// Hopper (sm_90a) building blocks shared by the port's bf16 and fp16
// flash-attention kernels: mbarriers, TMA tile loads, wgmma shared-memory
// descriptors and the wgmma instructions themselves, register rebalancing,
// and a host helper that encodes a TMA tensor map for a strided
// [B, H, S, D] view.
//
// Everything is raw PTX (no CUTLASS/CuTe), so a source that includes this
// header builds with nvcc alone in seconds.  The tensor map is encoded
// through the entry point that the CUDA runtime hands out
// (cudaGetDriverEntryPoint*), so the shared library needs no -lcuda.
//
// Conventions used by the kernels:
//   * A tile of R rows x C columns of a 16-bit type, bf16 or fp16 (C * 2
//     bytes = 128 with 128-byte swizzle, 64 with 64-byte swizzle), is
//     loaded by one TMA box and lands row-major in shared memory, 16-byte
//     chunks XOR-swizzled by the row within each 8-row group.  A head dim
//     wider than one swizzle row (D = 128) is loaded as D / C boxes stored
//     one after the other.
//   * Every tile starts on a 1024-byte boundary, so the descriptors' base
//     offset is 0.
//   * K-major operand (the reduction dim contiguous, e.g. q or k rows read
//     for q k^T): descriptor at the tile's first row, SBO = 8 rows; the k16
//     slice kk of a box starts kk * 32 bytes into it.
//   * MN-major operand (the output dim contiguous, e.g. v rows read for
//     P v): descriptor at the slice's first row (16 rows per k16 step),
//     SBO = 8 rows, one swizzle row (C columns) per instruction, trans-b 1.
//   * Accumulator fragment of m64nN (f32), thread t of the warpgroup,
//     w = t / 32, l = t % 32, register i:
//       row = 16 w + l / 4 + 8 ((i / 2) % 2)
//       col = 8 (i / 4) + 2 (l % 4) + i % 2
//     and the register A fragment of m64k16 (pairs of T) has the same
//     (row, col) map for i = 0..7, so the accumulator of a product becomes
//     the A operand of the next one by packing neighbours (pack2<T>).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// the dynamic shared memory a block may opt in to on sm_90
constexpr size_t kMaxSmem = 232448;

// ---------------------------------------------------------------------------
// shared memory addresses
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// round a dynamic shared-memory pointer up to the 1024-byte boundary that
// 128-byte swizzle atoms need (the launch asks for 1024 spare bytes)
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA) and to
// the other threads; call once after the inits, before a __syncthreads
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` has completed (a fresh barrier
// is in phase 0: wait(0) returns after its first completion)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA: one box of a rank-4 tensor map into shared memory, completion
// reported to `bar` as transaction bytes (the whole box, zero-filled where
// it leaves the tensor)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma shared-memory matrix descriptor
// ---------------------------------------------------------------------------
// (no swizzle: the 8x16-byte core-matrix layout; the kernels use 128B/64B)
enum Swizzle : int { kSwizzleNone = 0, kSwizzle128B = 1, kSwizzle64B = 2 };

// start address, leading and stride byte offsets (16-byte units), base
// offset 0 (1024-byte aligned atoms), swizzle mode in bits 62-63
__device__ __forceinline__ uint64_t make_desc(const void* smem, uint32_t lbo,
                                              uint32_t sbo, int swizzle) {
  const uint64_t addr = smem_u32(smem);
  return ((addr & 0x3FFFFull) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) |
         ((uint64_t)(swizzle & 3) << 62);
}

// ---------------------------------------------------------------------------
// wgmma.mma_async m64nNk16, 16-bit inputs (T = __nv_bfloat16 or __half),
// f32 accumulator in registers.
//   Wgmma<N, TransB, T>::ss(d, desc_a, desc_b, scale_d): A and B in shared
//     memory, A K-major;
//   Wgmma<N, TransB, T>::rs(d, a, desc_b, scale_d): A from registers (four
//     pairs of T, the fragment layout above).
// TransB = 0: B K-major (stored N x K); 1: B MN-major (stored K x N).
// scale_d = 0 overwrites d, 1 accumulates into it.  The two element types
// differ only in the instruction's type suffix (.bf16.bf16 / .f16.f16),
// so each specialization is written once, as a macro over (T, suffix).
// ---------------------------------------------------------------------------
template <int N, int TransB, typename T>
struct Wgmma;

#define HOPPER_WGMMA_N32(CT, TY)                                              \
  template <int TransB>                                                       \
  struct Wgmma<32, TransB, CT> {                                              \
    __device__ static __forceinline__ void ss(float (&d)[16], uint64_t da,    \
                                              uint64_t db, int scale_d) {     \
      asm volatile(                                                           \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                        \
          "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"        \
          "%0, %1, %2, %3, %4, %5, %6, %7, "                                  \
          "%8, %9, %10, %11, %12, %13, %14, %15"                              \
          "}, %16, %17, "                                                     \
          "p, 1, 1, 0, %19;\n}\n"                                             \
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                   \
            "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                   \
            "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                 \
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                \
          : "l"(da), "l"(db), "r"(scale_d), "n"(TransB));                     \
    }                                                                         \
    __device__ static __forceinline__ void rs(float (&d)[16],                 \
                                              const uint32_t (&a)[4],         \
                                              uint64_t db, int scale_d) {     \
      asm volatile(                                                           \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                        \
          "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"        \
          "%0, %1, %2, %3, %4, %5, %6, %7, "                                  \
          "%8, %9, %10, %11, %12, %13, %14, %15"                              \
          "}, {%16, %17, %18, %19}, %20, "                                    \
          "p, 1, 1, %22;\n}\n"                                                \
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                   \
            "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                   \
            "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                 \
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),              \
            "r"(scale_d), "n"(TransB));                                       \
    }                                                                         \
  };

#define HOPPER_WGMMA_N64(CT, TY)                                              \
  template <int TransB>                                                       \
  struct Wgmma<64, TransB, CT> {                                              \
    __device__ static __forceinline__ void ss(float (&d)[32], uint64_t da,    \
                                              uint64_t db, int scale_d) {     \
      asm volatile(                                                           \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                        \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"        \
          "%0, %1, %2, %3, %4, %5, %6, %7, "                                  \
          "%8, %9, %10, %11, %12, %13, %14, %15, "                            \
          "%16, %17, %18, %19, %20, %21, %22, %23, "                          \
          "%24, %25, %26, %27, %28, %29, %30, %31"                            \
          "}, %32, %33, "                                                     \
          "p, 1, 1, 0, %35;\n}\n"                                             \
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                   \
            "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                   \
            "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                 \
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),               \
            "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),               \
            "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),               \
            "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),               \
            "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                \
          : "l"(da), "l"(db), "r"(scale_d), "n"(TransB));                     \
    }                                                                         \
    __device__ static __forceinline__ void rs(float (&d)[32],                 \
                                              const uint32_t (&a)[4],         \
                                              uint64_t db, int scale_d) {     \
      asm volatile(                                                           \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                        \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"        \
          "%0, %1, %2, %3, %4, %5, %6, %7, "                                  \
          "%8, %9, %10, %11, %12, %13, %14, %15, "                            \
          "%16, %17, %18, %19, %20, %21, %22, %23, "                          \
          "%24, %25, %26, %27, %28, %29, %30, %31"                            \
          "}, {%32, %33, %34, %35}, %36, "                                    \
          "p, 1, 1, %38;\n}\n"                                                \
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                   \
            "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                   \
            "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                 \
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),               \
            "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),               \
            "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),               \
            "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),               \
            "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),              \
            "r"(scale_d), "n"(TransB));                                       \
    }                                                                         \
  };

#define HOPPER_WGMMA_N128(CT, TY)                                             \
  template <int TransB>                                                       \
  struct Wgmma<128, TransB, CT> {                                             \
    __device__ static __forceinline__ void ss(float (&d)[64], uint64_t da,    \
                                              uint64_t db, int scale_d) {     \
      asm volatile(                                                           \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                        \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"       \
          "%0, %1, %2, %3, %4, %5, %6, %7, "                                  \
          "%8, %9, %10, %11, %12, %13, %14, %15, "                            \
          "%16, %17, %18, %19, %20, %21, %22, %23, "                          \
          "%24, %25, %26, %27, %28, %29, %30, %31, "                          \
          "%32, %33, %34, %35, %36, %37, %38, %39, "                          \
          "%40, %41, %42, %43, %44, %45, %46, %47, "                          \
          "%48, %49, %50, %51, %52, %53, %54, %55, "                          \
          "%56, %57, %58, %59, %60, %61, %62, %63"                            \
          "}, %64, %65, "                                                     \
          "p, 1, 1, 0, %67;\n}\n"                                             \
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                   \
            "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                   \
            "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                 \
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),               \
            "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),               \
            "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),               \
            "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),               \
            "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),               \
            "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),               \
            "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),               \
            "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),               \
            "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),               \
            "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),               \
            "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),               \
            "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),               \
            "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                \
          : "l"(da), "l"(db), "r"(scale_d), "n"(TransB));                     \
    }                                                                         \
    __device__ static __forceinline__ void rs(float (&d)[64],                 \
                                              const uint32_t (&a)[4],         \
                                              uint64_t db, int scale_d) {     \
      asm volatile(                                                           \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                        \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"       \
          "%0, %1, %2, %3, %4, %5, %6, %7, "                                  \
          "%8, %9, %10, %11, %12, %13, %14, %15, "                            \
          "%16, %17, %18, %19, %20, %21, %22, %23, "                          \
          "%24, %25, %26, %27, %28, %29, %30, %31, "                          \
          "%32, %33, %34, %35, %36, %37, %38, %39, "                          \
          "%40, %41, %42, %43, %44, %45, %46, %47, "                          \
          "%48, %49, %50, %51, %52, %53, %54, %55, "                          \
          "%56, %57, %58, %59, %60, %61, %62, %63"                            \
          "}, {%64, %65, %66, %67}, %68, "                                    \
          "p, 1, 1, %70;\n}\n"                                                \
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                   \
            "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                   \
            "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                 \
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),               \
            "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),               \
            "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),               \
            "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),               \
            "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),               \
            "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),               \
            "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),               \
            "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),               \
            "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),               \
            "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),               \
            "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),               \
            "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),               \
            "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),              \
            "r"(scale_d), "n"(TransB));                                       \
    }                                                                         \
  };

HOPPER_WGMMA_N32(__nv_bfloat16, "bf16")
HOPPER_WGMMA_N64(__nv_bfloat16, "bf16")
HOPPER_WGMMA_N128(__nv_bfloat16, "bf16")
HOPPER_WGMMA_N32(__half, "f16")
HOPPER_WGMMA_N64(__half, "f16")
HOPPER_WGMMA_N128(__half, "f16")

#undef HOPPER_WGMMA_N32
#undef HOPPER_WGMMA_N64
#undef HOPPER_WGMMA_N128

// order the accumulator registers against the asynchronous wgmma: the
// compiler must neither read them before wgmma_wait nor move writes past
// the wgmma (an empty asm that "modifies" each register)
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// make register and shared-memory writes visible to the next wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending)
               : "memory");
}

// a barrier of `count` threads (a multiple of 32) on hardware barrier `id`
// (1-15; 0 is __syncthreads): the consumer warpgroups of a kernel whose
// producer warp does not take part, ordering their shared-memory accesses
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------------------
// register rebalancing between warpgroups (all 128 threads execute it)
// ---------------------------------------------------------------------------
template <int Regs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Regs));
}

template <int Regs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Regs));
}

// two floats rounded to a pair of T (lo in the low half), the register A
// operand format; T = __nv_bfloat16 or __half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the tensor-map element type of T
template <typename T>
struct TmaType;
template <>
struct TmaType<float> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct TmaType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType value =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct TmaType<__half> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

// ---------------------------------------------------------------------------
// host: TMA tensor map of a strided [B, H, S, D] view of T (16-bit, or
// fp32 for the 3xTF32 split-D kernels of flash_attn_fwd.cu and
// flash_attn_bwd.cu)
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the libcuda the runtime already loaded
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// columns of one TMA box for head dim D: one 128-byte swizzle row (64
// 16-bit elements), or the whole 64-byte row at D = 32
__host__ __device__ constexpr int box_cols(int D) { return D < 64 ? D : 64; }

// Encode `map` for the [B, H, S, D] tensor of T at `base` with element
// strides sb, sh, ss (D contiguous), boxes of one swizzle row (the bytes
// of box_cols(D) 16-bit columns: 32 columns in fp32) x `box_rows`, rows
// past S zero-filled.  A stride of a size-1 dim is never used for an
// address, so it is replaced by a valid one.  Returns cudaSuccess, or
// cudaErrorInvalidValue where TMA refuses the view (base address not
// 16-byte aligned, a byte stride not a multiple of 16).
template <typename T>
inline cudaError_t encode_bhsd(CUtensorMap* map, const void* base, int B,
                               int H, int S, int D, long long sb, long long sh,
                               long long ss, int box_rows) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (S <= 1) ss = D;
  if (H <= 1) sh = (long long)S * ss;
  if (B <= 1) sb = (long long)H * sh;
  constexpr int es = (int)sizeof(T);
  const int cols = box_cols(D) * 2 / es;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)ss * es, (cuuint64_t)sh * es,
                           (cuuint64_t)sb * es};
  cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)box_rows, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, TmaType<T>::value, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cols * es == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
