// Uniform, normal, truncated-normal, integer and Bernoulli draws for
// NVIDIA Hopper (sm_90a), written by hand: one pass that writes a tensor
// of counter-based random numbers keyed by a seed read from device memory.
//
// There is no TPU kernel to replace: the JAX package's uniform_random,
// gaussian_random, truncated_gaussian_random, bernoulli and randint ops
// draw with jax.random under XLA
// (paddle_tpu/ops/kernels/random.py:20,40,48,58,64).  The port needs a kernel for
// the reason csrc/dropout_philox.cu gives: no library call draws from a
// seed held in device memory, so a CUDA graph of a step that draws (an
// initializer op, dpsgd's noise) would replay one draw forever.  Here the
// seed is read through a pointer (the executor's step seed buffer), so a
// replayed step draws anew once the executor refills the buffer, and an
// eager run() of the same step draws the same numbers.
//
// The generator is dropout_philox.cu's Philox-4x32-10, with its keying:
//   key     = (seed mod 2^32, uid mod 2^32)
//   counter = (g mod 2^32, g / 2^32, 0, 0) for the group g = e / 4 of the
//             element e (row-major);
//   w(e)    = word e mod 4 of philox(counter, key).
// uniform (dist 0): u = (w >> 8) 2^-24 in [0, 1), exact in fp32, and the
//   output u * span + lo with each step rounded on its own (__fmul_rn,
//   __fadd_rn: no contraction into an FMA);
// normal (dist 1): Box-Muller over the word pairs (w0, w1) and (w2, w3)
//   of a group: u1 = ((w0 >> 8) + 1) 2^-24 in (0, 1], u2 = (w1 >> 8) 2^-24,
//   r = sqrtf(-2 logf(u1)), sincosf(2 pi u2) -> (s, c), the even element
//   r c and the odd one r s, then mean + std z, all fp32.
// truncated normal (dist 2): u = (w >> 8) 2^-24, t = A (2u - 1) with
//   A = erf(sqrt 2) rounded to fp32 (2u - 1 is exact, the product rounded
//   once), z = sqrt(2) erfinvf(t) clipped to [-2, 2]: the inverse CDF of
//   the standard normal over (Phi(-2), Phi(2)); then mean + std z.
// The output is rounded to its dtype (round to nearest even).
// philox_randint_fill: an integer in [low, low + span) from each word by
//   multiply-shift, (w span) >> 32, for span <= 2^32; above that from a
//   second word h of the counter (g mod 2^32, g / 2^32, 1, 0):
//   ((h mod 2^31) 2^32 + w) mod span (bias below span / 2^63).
// philox_bernoulli_fill: 1 where u = (w >> 8) 2^-24 < p (X read as
//   fp32), else 0, in X's dtype.
// paddle_tpu_torch/ops/random.py::random_plain computes the same function
// in PyTorch: the uniform bit for bit; the normal within a few ulps,
// because this file's logf / sincosf and the CPU's log / cos / sin round
// differently (sqrtf is IEEE here: no fast math).
//
// What bounds it on an H100: the write alone, 4 bytes an element in fp32
// and 2 in 16 bits (nothing is read; the Bernoulli draw reads X too, the
// integers write 4 or 8 bytes); about 25 integer operations an element
// for the generator, plus a logf, a sqrtf and a sincosf for two elements
// of a normal, an erfinvf an element of a truncated normal.  At [30522, 768] fp32 (the word embedding) that
// is 94 MB, 0.028 ms at 3.35 TB/s.  Design: a grid-stride loop over
// groups, one Philox call and four outputs a thread a step; a group whose
// four elements are in the tensor and whose destination is aligned stores
// them with one 16-byte (fp32) or 8-byte (16-bit) store, the tail
// element by element.
//
// Built by paddle_tpu_torch/core/kernel_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// (no --use_fast_math) and called through the plain C interface at the end
// of this file.

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
constexpr float U24 = 5.9604644775390625e-08f;  // 2^-24
constexpr float TWO_PI = 6.28318548202514648f;  // 2 pi rounded to fp32
constexpr float TRUNC_A = 0.95449972152709961f;  // erf(sqrt 2) in fp32
constexpr float SQRT2 = 1.4142135381698608f;     // sqrt 2 in fp32

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

__device__ __forceinline__ float uniform_of(uint32_t w, float lo,
                                            float span) {
  const float u = (float)(w >> 8) * U24;
  return __fadd_rn(__fmul_rn(u, span), lo);
}

// the two normals of the word pair (a, b): r cos, r sin
__device__ __forceinline__ float2 normal_pair(uint32_t a, uint32_t b,
                                              float mean, float std) {
  const float u1 = (float)((a >> 8) + 1u) * U24;
  const float u2 = (float)(b >> 8) * U24;
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincosf(__fmul_rn(u2, TWO_PI), &s, &c);
  return make_float2(__fadd_rn(__fmul_rn(__fmul_rn(r, c), std), mean),
                     __fadd_rn(__fmul_rn(__fmul_rn(r, s), std), mean));
}

// a standard normal truncated to [-2, 2] by the inverse CDF, scaled
__device__ __forceinline__ float trunc_normal_of(uint32_t w, float mean,
                                                 float std) {
  const float u = (float)(w >> 8) * U24;
  const float t = __fmul_rn(__fsub_rn(__fmul_rn(2.0f, u), 1.0f), TRUNC_A);
  const float z = fminf(fmaxf(__fmul_rn(erfinvf(t), SQRT2), -2.0f), 2.0f);
  return __fadd_rn(__fmul_rn(z, std), mean);
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half x) {
  return __half2float(x);
}

template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

// c0, c1: (lo, span) of a uniform, (mean, std) of a normal
template <typename T>
__global__ void __launch_bounds__(THREADS)
    philox_random_kernel(T* __restrict__ out, long long n, int dist,
                         const long long* __restrict__ seed_ptr,
                         long long seed_value, uint32_t uid, float c0,
                         float c1, int aligned) {
  const long long seed = seed_ptr != nullptr ? *seed_ptr : seed_value;
  const uint2 key = make_uint2((uint32_t)(unsigned long long)seed, uid);
  const long long groups = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
       g < groups; g += stride) {
    const uint4 r = philox4x32_10(
        make_uint4((uint32_t)(unsigned long long)g,
                   (uint32_t)((unsigned long long)g >> 32), 0u, 0u),
        key);
    float f[4];
    if (dist == 0) {
      f[0] = uniform_of(r.x, c0, c1);
      f[1] = uniform_of(r.y, c0, c1);
      f[2] = uniform_of(r.z, c0, c1);
      f[3] = uniform_of(r.w, c0, c1);
    } else if (dist == 2) {
      f[0] = trunc_normal_of(r.x, c0, c1);
      f[1] = trunc_normal_of(r.y, c0, c1);
      f[2] = trunc_normal_of(r.z, c0, c1);
      f[3] = trunc_normal_of(r.w, c0, c1);
    } else {
      const float2 p0 = normal_pair(r.x, r.y, c0, c1);
      const float2 p1 = normal_pair(r.z, r.w, c0, c1);
      f[0] = p0.x;
      f[1] = p0.y;
      f[2] = p1.x;
      f[3] = p1.y;
    }
    const long long e = 4 * g;
    if (aligned && e + 4 <= n) {
      Vec4<T> v;
#pragma unroll
      for (int t = 0; t < 4; ++t) v.v[t] = from_f32<T>(f[t]);
      *reinterpret_cast<Vec4<T>*>(out + e) = v;
    } else {
      for (int t = 0; t < 4 && e + t < n; ++t) out[e + t] = from_f32<T>(f[t]);
    }
  }
}

template <typename T>
int launch(void* out, long long n, int dist, const void* seed_ptr,
           long long seed_value, long long uid, float c0, float c1,
           cudaStream_t s) {
  const int aligned = ((uintptr_t)out % (4 * sizeof(T))) == 0;
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  philox_random_kernel<T><<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<T*>(out), n, dist,
      static_cast<const long long*>(seed_ptr), seed_value,
      (uint32_t)(unsigned long long)uid, c0, c1, aligned);
  return (int)cudaGetLastError();
}

// the integer draws: low + (w span) >> 32, or for span > 2^32
// low + ((h mod 2^31) 2^32 + w) mod span with h from counter word 2 = 1
template <typename T>
__global__ void __launch_bounds__(THREADS)
    philox_randint_kernel(T* __restrict__ out, long long n,
                          const long long* __restrict__ seed_ptr,
                          long long seed_value, uint32_t uid, long long low,
                          unsigned long long span, int aligned) {
  const long long seed = seed_ptr != nullptr ? *seed_ptr : seed_value;
  const uint2 key = make_uint2((uint32_t)(unsigned long long)seed, uid);
  const bool wide = span > (1ull << 32);
  const long long groups = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
       g < groups; g += stride) {
    const uint32_t glo = (uint32_t)(unsigned long long)g;
    const uint32_t ghi = (uint32_t)((unsigned long long)g >> 32);
    const uint4 r = philox4x32_10(make_uint4(glo, ghi, 0u, 0u), key);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
    uint32_t h[4] = {0u, 0u, 0u, 0u};
    if (wide) {
      const uint4 q = philox4x32_10(make_uint4(glo, ghi, 1u, 0u), key);
      h[0] = q.x;
      h[1] = q.y;
      h[2] = q.z;
      h[3] = q.w;
    }
    Vec4<T> v;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const unsigned long long off =
          wide ? ((((unsigned long long)(h[t] & 0x7FFFFFFFu)) << 32) |
                  (unsigned long long)w[t]) %
                     span
               : ((unsigned long long)w[t] * span) >> 32;
      v.v[t] = (T)(low + (long long)off);
    }
    const long long e = 4 * g;
    if (aligned && e + 4 <= n) {
      *reinterpret_cast<Vec4<T>*>(out + e) = v;
    } else {
      for (int t = 0; t < 4 && e + t < n; ++t) out[e + t] = v.v[t];
    }
  }
}

// Bernoulli draws: out = (u < x) in x's dtype
template <typename T>
__global__ void __launch_bounds__(THREADS)
    philox_bernoulli_kernel(T* __restrict__ out, const T* __restrict__ x,
                            long long n,
                            const long long* __restrict__ seed_ptr,
                            long long seed_value, uint32_t uid, int aligned) {
  const long long seed = seed_ptr != nullptr ? *seed_ptr : seed_value;
  const uint2 key = make_uint2((uint32_t)(unsigned long long)seed, uid);
  const long long groups = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
       g < groups; g += stride) {
    const uint4 r = philox4x32_10(
        make_uint4((uint32_t)(unsigned long long)g,
                   (uint32_t)((unsigned long long)g >> 32), 0u, 0u),
        key);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
    const long long e = 4 * g;
    if (aligned && e + 4 <= n) {
      const Vec4<T> p = *reinterpret_cast<const Vec4<T>*>(x + e);
      Vec4<T> v;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float u = (float)(w[t] >> 8) * U24;
        v.v[t] = from_f32<T>(u < to_f32<T>(p.v[t]) ? 1.0f : 0.0f);
      }
      *reinterpret_cast<Vec4<T>*>(out + e) = v;
    } else {
      for (int t = 0; t < 4 && e + t < n; ++t) {
        const float u = (float)(w[t] >> 8) * U24;
        out[e + t] = from_f32<T>(u < to_f32<T>(x[e + t]) ? 1.0f : 0.0f);
      }
    }
  }
}

long long grid_of(long long n) {
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  return blocks < 1 ? 1 : blocks;
}

template <typename T>
int launch_randint(void* out, long long n, const void* seed_ptr,
                   long long seed_value, long long uid, long long low,
                   unsigned long long span, cudaStream_t s) {
  const int aligned = ((uintptr_t)out % (4 * sizeof(T))) == 0;
  philox_randint_kernel<T><<<(unsigned)grid_of(n), THREADS, 0, s>>>(
      static_cast<T*>(out), n, static_cast<const long long*>(seed_ptr),
      seed_value, (uint32_t)(unsigned long long)uid, low, span, aligned);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bernoulli(void* out, const void* x, long long n,
                     const void* seed_ptr, long long seed_value,
                     long long uid, cudaStream_t s) {
  const int aligned = ((uintptr_t)out % (4 * sizeof(T))) == 0 &&
                      ((uintptr_t)x % (4 * sizeof(T))) == 0;
  philox_bernoulli_kernel<T><<<(unsigned)grid_of(n), THREADS, 0, s>>>(
      static_cast<T*>(out), static_cast<const T*>(x), n,
      static_cast<const long long*>(seed_ptr), seed_value,
      (uint32_t)(unsigned long long)uid, aligned);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; dist: 0 = uniform
// (c0 = lo, c1 = span), 1 = normal (c0 = mean, c1 = std), 2 = normal
// truncated to 2 std (c0 = mean, c1 = std).  out [n]
// contiguous.  The seed is read from `seed_ptr` (one int64 in device
// memory) when it is not null, else it is `seed_value`.  Returns the CUDA
// error code of the launch (0 on success); the kernel is asynchronous on
// `stream`.  The caller makes the tensor's device current.
int philox_random_fill(void* out, long long n, int dtype, int dist,
                       const void* seed_ptr, long long seed_value,
                       long long uid, float c0, float c1, void* stream) {
  if (n <= 0 || dist < 0 || dist > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(out, n, dist, seed_ptr, seed_value, uid, c0, c1, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(out, n, dist, seed_ptr, seed_value, uid, c0,
                                 c1, s);
  if (dtype == 2)
    return launch<__half>(out, n, dist, seed_ptr, seed_value, uid, c0, c1, s);
  return (int)cudaErrorInvalidValue;
}

// out [n] contiguous int32 (dtype 0) or int64 (dtype 1): integers in
// [low, low + span), 1 <= span < 2^63.  Seed as philox_random_fill.
int philox_randint_fill(void* out, long long n, int dtype,
                        const void* seed_ptr, long long seed_value,
                        long long uid, long long low, long long span,
                        void* stream) {
  if (n <= 0 || span < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned long long sp = (unsigned long long)span;
  if (dtype == 0)
    return launch_randint<int>(out, n, seed_ptr, seed_value, uid, low, sp,
                               s);
  if (dtype == 1)
    return launch_randint<long long>(out, n, seed_ptr, seed_value, uid, low,
                                     sp, s);
  return (int)cudaErrorInvalidValue;
}

// out, x [n] contiguous, both of `dtype` (0 = float32, 1 = bfloat16,
// 2 = float16): out = 1 where the draw's u < x, else 0.
int philox_bernoulli_fill(void* out, const void* x, long long n, int dtype,
                          const void* seed_ptr, long long seed_value,
                          long long uid, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bernoulli<float>(out, x, n, seed_ptr, seed_value, uid, s);
  if (dtype == 1)
    return launch_bernoulli<__nv_bfloat16>(out, x, n, seed_ptr, seed_value,
                                           uid, s);
  if (dtype == 2)
    return launch_bernoulli<__half>(out, x, n, seed_ptr, seed_value, uid, s);
  return (int)cudaErrorInvalidValue;
}

const char* philox_random_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
