// Fused softmax-cross-entropy forward for NVIDIA Hopper (sm_90a), written
// by hand.
//
// Replaces paddle_tpu/ops/fused_xent.py::_fused_xent_kernel, the Pallas TPU
// kernel behind the `fused_xent` flag of softmax_with_cross_entropy.  It
// computes the same function over logits [T, V] and hard labels [T]:
//   lse_t  = log sum_v exp(logits[t, v])
//   loss_t = lse_t - logits[t, label_t]
// in one pass over each row, keeping a running max and sum of exponentials
// (the online softmax), so the [T, V] softmax never reaches device memory.
//
// Semantics held equal to the TPU kernel:
//   * statistics and outputs are fp32 whatever the logits dtype (fp32,
//     bf16 or fp16);
//   * loss = 0 where label == ignore_index, whatever the index's sign;
//     lse is written for every row, ignored ones included;
//   * a label outside [0, V) that is not ignore_index picks nothing, so
//     loss = lse.
//
// Design:
//   * one CTA of 256 threads per row.  Each thread walks its share of the
//     row with 16-byte vector loads (4 fp32, or 8 bf16 or fp16), keeping
//     its own running max m and sum s; on each vector it takes the
//     vector's max first, so it rescales s at most once per vector and
//     spends one exp per element.  The (m, s) pairs are then merged across the warp with
//     xor-shuffles and across the 8 warps through shared memory.
//   * rows need not be 16-byte aligned (at V = 30522 an fp32 row is 122,088
//     bytes, a bf16 row 61,044): a scalar head runs up to the first aligned
//     element, a scalar tail after the last whole vector.  The row stride is
//     an argument, so a view with padded rows needs no copy.
//   * the picked logit is one scalar load by thread 0.
//
// What bounds it on an H100: each logit is read once and nothing of size V
// is written, so at [4096, 30522] the kernel moves 500 MB in fp32 (250 MB in
// bf16) for ~4 operations per element: it is bounded by the 3.35 TB/s of
// device memory (~0.15 ms fp32, ~0.075 ms bf16).  The design keeps loads
// vectorised and coalesced; 4096 rows give ~31 CTAs per SM to hide latency.
//
// Built by paddle_tpu_torch/core/kernel_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through the plain C interface at the end of this file.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// one 16-byte vector of logits, widened to fp32
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Vec<__half> {
  static constexpr int N = 8;
  __device__ static void load(const __half* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// add `n` values to the running (m, s): rescale once to the new max
template <int N>
__device__ __forceinline__ void accumulate(const float* x, float& m,
                                           float& s) {
  float vmax = x[0];
#pragma unroll
  for (int i = 1; i < N; ++i) vmax = fmaxf(vmax, x[i]);
  if (vmax > m) {
    s = (m == -INFINITY) ? 0.f : s * expf(m - vmax);
    m = vmax;
  }
  if (m == -INFINITY) return;  // every value so far is -inf
#pragma unroll
  for (int i = 0; i < N; ++i) s += expf(x[i] - m);
}

// merge (m2, s2) into (m, s)
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) return;
  s = (m == -INFINITY ? 0.f : s * expf(m - mm)) +
      (m2 == -INFINITY ? 0.f : s2 * expf(m2 - mm));
  m = mm;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_xent_kernel(const T* __restrict__ logits,
                  const long long* __restrict__ label,
                  float* __restrict__ loss, float* __restrict__ lse, int V,
                  int64_t row_stride, long long ignore_index) {
  constexpr int N = Vec<T>::N;
  __shared__ float sm_m[WARPS], sm_s[WARPS];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const T* x = logits + (int64_t)row * row_stride;

  // scalar head up to the first 16-byte-aligned element, vector body,
  // scalar tail
  const int mis = (int)((reinterpret_cast<uintptr_t>(x) % 16) / sizeof(T));
  const int head = mis == 0 ? 0 : min(V, N - mis);
  const int n_vec = (V - head) / N;
  const int tail0 = head + n_vec * N;

  float m = -INFINITY, s = 0.f;
  for (int i = tid; i < head; i += THREADS) {
    const float v = to_f32(x[i]);
    accumulate<1>(&v, m, s);
  }
  const T* body = x + head;
  for (int i = tid; i < n_vec; i += THREADS) {
    float v[N];
    Vec<T>::load(body + (int64_t)i * N, v);
    accumulate<N>(v, m, s);
  }
  for (int i = tail0 + tid; i < V; i += THREADS) {
    const float v = to_f32(x[i]);
    accumulate<1>(&v, m, s);
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  if (tid % 32 == 0) {
    sm_m[tid / 32] = m;
    sm_s[tid / 32] = s;
  }
  __syncthreads();
  if (tid == 0) {
    m = sm_m[0];
    s = sm_s[0];
    for (int w = 1; w < WARPS; ++w) merge(m, s, sm_m[w], sm_s[w]);
    const float l = m == -INFINITY ? -INFINITY : m + logf(fmaxf(s, 1e-30f));
    const long long lbl = label[row];
    const float picked = (lbl >= 0 && lbl < V) ? to_f32(x[lbl]) : 0.f;
    lse[row] = l;
    loss[row] = lbl == ignore_index ? 0.f : l - picked;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  logits [T, V] with a contiguous vocab
// dim and `row_stride` elements between rows; label [T] int64; loss and
// lse [T] fp32, contiguous.  Returns the CUDA error code of the launch
// (0 on success); the kernel is asynchronous on `stream`.  The caller
// makes the tensors' device current.
int fused_xent_fwd(const void* logits, const void* label, void* loss,
                   void* lse, int dtype, int T, int V, long long row_stride,
                   long long ignore_index, void* stream) {
  if (T <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* lbl = static_cast<const long long*>(label);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  if (dtype == 0)
    fused_xent_kernel<float><<<T, THREADS, 0, s>>>(
        static_cast<const float*>(logits), lbl, lo, ls, V, row_stride,
        ignore_index);
  else if (dtype == 1)
    fused_xent_kernel<__nv_bfloat16><<<T, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), lbl, lo, ls, V,
        row_stride, ignore_index);
  else if (dtype == 2)
    fused_xent_kernel<__half><<<T, THREADS, 0, s>>>(
        static_cast<const __half*>(logits), lbl, lo, ls, V, row_stride,
        ignore_index);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* fused_xent_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
