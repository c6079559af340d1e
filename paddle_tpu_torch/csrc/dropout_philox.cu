// Dropout forward for NVIDIA Hopper (sm_90a), written by hand: one pass
// that reads X, draws a counter-based uniform per element, and writes Out
// and the uint8 Mask.
//
// There is no TPU kernel to replace: the JAX package draws the keep mask
// with `jax.random.bernoulli` under XLA (paddle_tpu/ops/kernels/nn.py:490).
// The port needs a kernel because no library call draws from a seed held
// in device memory: a torch.Generator is seeded from the host, so a CUDA
// graph of the training step would replay one mask forever.  Here the seed
// is read through a device pointer, so the step that Executor.run_steps
// captures draws a new mask on each replay once the executor refills the
// seed buffer, and eager run(), the replayed step and the gradient (which
// reads Mask) all see the same mask for one (step seed, op uid).
//
// The generator is Philox-4x32-10 (Salmon et al., SC'11; cuRAND's and
// PyTorch's), written out here:
//   key     = (seed mod 2^32, uid mod 2^32)
//   counter = (g mod 2^32, g / 2^32, 0, 0) for the group g = e / 4 of the
//             element e (elements in row-major order);
//   draw(e) = word e mod 4 of philox(counter, key);
//   keep(e) = draw(e) < threshold, threshold = ceil((1 - p) 2^32) (a
//             64-bit integer, so p = 0 keeps every element).
// paddle_tpu_torch/ops/dropout.py::dropout_plain computes the same bits in
// PyTorch integer arithmetic; the tests hold the two equal bit for bit.
//
// Out, for both of Paddle's modes:
//   upscale_in_train:   keep ? x / q : 0, q = (1 - p) rounded to X's dtype,
//                       the quotient taken in fp32 (IEEE division) and
//                       rounded to X's dtype;
//   downgrade_in_infer: keep ? x : 0 (training leaves X unscaled).
//
// What bounds it on an H100: 5 bytes an element in 16 bits (read 2, write
// 2 and 1 of mask), 9 in fp32, against ~25 integer operations an element
// for the generator (10 rounds of two 32x32 multiplies and xors per 4
// elements).  At [8, 12, 512, 512] bf16 that is 126 MB, 0.038 ms at
// 3.35 TB/s.  Design: grid-stride over 16-byte vectors (4 fp32 or 8
// bf16/fp16 elements: one or two Philox calls per vector), so loads and
// stores are 16 bytes a thread and coalesced; the mask of a vector is one
// 4- or 8-byte store.  A tail that is not a whole vector, or a tensor not
// 16-byte aligned, takes a scalar loop (one Philox call per element).
//
// Built by paddle_tpu_torch/core/kernel_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// (no fast math: the division is IEEE) and called through the plain C
// interface at the end of this file.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;

constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i > 0) {
      k.x += PHILOX_W0;
      k.y += PHILOX_W1;
    }
    const uint32_t hi0 = __umulhi(PHILOX_M0, c.x), lo0 = PHILOX_M0 * c.x;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c.z), lo1 = PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ uint4 draw_group(unsigned long long g, uint2 k) {
  return philox4x32_10(
      make_uint4((uint32_t)g, (uint32_t)(g >> 32), 0u, 0u), k);
}

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

template <typename T>
__device__ __forceinline__ T apply(T x, bool keep, float q, bool upscale) {
  if (!keep) return from_f32<T>(0.f);
  return upscale ? from_f32<T>(to_f32(x) / q) : x;
}

// one element, for the tail and for tensors that are not 16-byte aligned
template <typename T>
__device__ __forceinline__ void dropout_one(const T* x, T* out, uint8_t* mask,
                                            long long e, uint2 key,
                                            unsigned long long thr, float q,
                                            bool upscale) {
  const uint4 r = draw_group((unsigned long long)e >> 2, key);
  const bool keep = (unsigned long long)word(r, (int)(e & 3)) < thr;
  out[e] = apply(x[e], keep, q, upscale);
  mask[e] = keep ? 1 : 0;
}

// V elements (16 bytes) a vector; `nvec` whole vectors, then the scalar
// tail up to n.  nvec = 0 runs every element through the scalar loop.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    dropout_philox_kernel(const T* __restrict__ x, T* __restrict__ out,
                          uint8_t* __restrict__ mask, long long nvec,
                          long long n, const long long* __restrict__ seed_ptr,
                          long long seed_value, uint32_t uid,
                          unsigned long long thr, float q, int upscale) {
  constexpr int V = 16 / sizeof(T);
  const long long seed = seed_ptr != nullptr ? *seed_ptr : seed_value;
  const uint2 key = make_uint2((uint32_t)(unsigned long long)seed, uid);
  const bool up = upscale != 0;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  for (long long v = tid; v < nvec; v += stride) {
    uint4 in = reinterpret_cast<const uint4*>(x)[v];
    const T* xe = reinterpret_cast<const T*>(&in);
    uint4 res;
    T* oe = reinterpret_cast<T*>(&res);
    uint32_t m[V / 4];  // the mask bytes of 4 elements, little-endian
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      const uint4 r = draw_group((unsigned long long)v * (V / 4) + j, key);
      m[j] = 0u;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const bool keep = (unsigned long long)word(r, t) < thr;
        oe[4 * j + t] = apply(xe[4 * j + t], keep, q, up);
        m[j] |= (keep ? 1u : 0u) << (8 * t);
      }
    }
    reinterpret_cast<uint4*>(out)[v] = res;
    if constexpr (V == 4) {
      reinterpret_cast<uint32_t*>(mask)[v] = m[0];
    } else {
      reinterpret_cast<uint2*>(mask)[v] = make_uint2(m[0], m[V / 4 - 1]);
    }
  }
  for (long long e = nvec * V + tid; e < n; e += stride)
    dropout_one(x, out, mask, e, key, thr, q, up);
}

template <typename T>
int launch(const void* x, void* out, void* mask, long long n,
           const void* seed_ptr, long long seed_value, long long uid,
           unsigned long long thr, float q, int upscale, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0)
                       && ((uintptr_t)mask % V == 0);
  const long long nvec = aligned ? n / V : 0;
  const long long work = nvec > 0 ? nvec : n;
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  dropout_philox_kernel<T><<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<uint8_t*>(mask), nvec, n,
      static_cast<const long long*>(seed_ptr), seed_value,
      (uint32_t)(unsigned long long)uid, thr, q, upscale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  x and out [n] contiguous,
// mask [n] uint8.  The seed is read from `seed_ptr` (one int64 in device
// memory) when it is not null, else it is `seed_value`.  threshold is
// ceil((1 - p) 2^32); q the divisor of upscale_in_train (ignored when
// upscale is 0).  Returns the CUDA error code of the launch (0 on
// success); the kernel is asynchronous on `stream`.  The caller makes the
// tensors' device current.
int dropout_philox_fwd(const void* x, void* out, void* mask, long long n,
                       int dtype, const void* seed_ptr, long long seed_value,
                       long long uid, unsigned long long threshold, float q,
                       int upscale, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, out, mask, n, seed_ptr, seed_value, uid,
                         threshold, q, upscale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, out, mask, n, seed_ptr, seed_value, uid,
                                 threshold, q, upscale, s);
  if (dtype == 2)
    return launch<__half>(x, out, mask, n, seed_ptr, seed_value, uid,
                          threshold, q, upscale, s);
  return (int)cudaErrorInvalidValue;
}

const char* dropout_philox_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
