// Uniform and normal draws for NVIDIA Hopper (sm_90a), written by hand:
// one pass that writes a tensor of counter-based random numbers keyed by a
// seed read from device memory.
//
// There is no TPU kernel to replace: the JAX package's uniform_random and
// gaussian_random ops draw with jax.random under XLA
// (paddle_tpu/ops/kernels/random.py:20,40).  The port needs a kernel for
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
// The output is rounded to its dtype (round to nearest even).
// paddle_tpu_torch/ops/random.py::random_plain computes the same function
// in PyTorch: the uniform bit for bit; the normal within a few ulps,
// because this file's logf / sincosf and the CPU's log / cos / sin round
// differently (sqrtf is IEEE here: no fast math).
//
// What bounds it on an H100: the write alone, 4 bytes an element in fp32
// and 2 in 16 bits (nothing is read); about 25 integer operations an
// element for the generator, plus a logf, a sqrtf and a sincosf for two
// elements of a normal.  At [30522, 768] fp32 (the word embedding) that
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; dist: 0 = uniform
// (c0 = lo, c1 = span), 1 = normal (c0 = mean, c1 = std).  out [n]
// contiguous.  The seed is read from `seed_ptr` (one int64 in device
// memory) when it is not null, else it is `seed_value`.  Returns the CUDA
// error code of the launch (0 on success); the kernel is asynchronous on
// `stream`.  The caller makes the tensor's device current.
int philox_random_fill(void* out, long long n, int dtype, int dist,
                       const void* seed_ptr, long long seed_value,
                       long long uid, float c0, float c1, void* stream) {
  if (n <= 0 || (dist != 0 && dist != 1)) return (int)cudaErrorInvalidValue;
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

const char* philox_random_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
