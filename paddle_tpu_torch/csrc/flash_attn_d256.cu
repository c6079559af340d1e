// Flash attention at head dim 256 (and the 16-bit dQ at 256 n, n >= 2) for
// NVIDIA Hopper (sm_90a), written by hand on fp32 FMAs from shared memory,
// for what no tensor-core kernel runs yet.
//
// Replaces, for wide head dims, the same three Pallas TPU kernels that
// flash_attn_fwd.cu and flash_attn_bwd.cu replace up to 128:
// paddle_tpu/ops/attention.py::_flash_fwd_kernel, ::_flash_bwd_dq_kernel
// and ::_flash_bwd_dkv_kernel (the reference takes any head dim).  The
// wrapper (paddle_tpu_torch/ops/attention.py) zero-pads a head dim up to
// 256 (129-255) or to the next multiple of 256 (above 256), which leaves
// q k^T, lse and rowsum(dO * O) unchanged.  What runs here:
//   * D = 256: the fp32 forward, dQ and dK/dV (the 16-bit forward, dQ and
//     dK/dV are the wgmma kernels of flash_attn_fwd.cu and
//     flash_attn_bwd.cu at D = 256);
//   * D = 256 n, n >= 2 (the split-D route): the bf16 and fp16 dQ.  Every
//     other split-D kernel runs on the tensor cores: the 16-bit forward
//     and dK/dV on wgmma, the fp32 forward, dQ and dK/dV on 3xTF32
//     (flash_attn_fwd.cu, flash_attn_bwd.cu).
// No other instance is compiled: the C entries return
// cudaErrorInvalidValue for every forward but the fp32 one at D = 256,
// for the 16-bit dQ at n = 1 and the fp32 dQ at n >= 2, and for every
// dK/dV but the fp32 one at n = 1, so a wrong route raises and never runs
// a replaced kernel.
//
// The functions, held equal to the TPU kernels and to the D <= 128
// kernels:
//   forward   out = softmax(scale * q k^T [causal]) v, lse per row, with an
//             online softmax over key tiles (the [Sq, Sk] scores never
//             reach device memory);
//   dQ        dQ = scale * dS k,  dS = P * (dP - D), P = exp(S - lse);
//   dK/dV     dK = scale * dS^T q, dV = P^T dO.
//   * statistics and accumulators are fp32; P (and dS) are rounded to the
//     input dtype before the second product, where the TPU kernels cast
//     (`p.astype(vs.dtype)`, `ds.astype(ks.dtype)`); the row sum is taken
//     on the fp32 P;
//   * the causal mask is aligned bottom-right (query i sees keys
//     <= i + Sk - Sq), and tiles wholly above the diagonal are skipped;
//   * a fully-masked row writes out = 0, lse = -inf, and its P is 0 in the
//     backward (dq = 0, nothing added to dk and dv).
//
// Design: the SIMT design of the port's first kernels, with the tile sizes
// cut to a 256-column chunk of the head dim.  Here:
//   * 128 threads a block; thread t owns ROWS rows of the block's own tile
//     (row group t/8) and, of every tile streamed past it, the rows
//     t%8 + 8j; the 8 threads of a row group are adjacent lanes and combine
//     row max and row sum with xor-shuffles.  For the second product the
//     same thread owns the output columns t%8 + 8j (32 of them).
//   * Tiles are staged in shared memory as fp32 with rows padded to 257
//     floats (the lanes of a warp hit distinct banks); products are fp32
//     FMAs from shared memory, for every input dtype.
//   * Shared memory (dynamic, opted in once per device and instance):
//       forward  q tile 64, k/v tiles 64, P 64 x 66:           214,272 B
//       dQ       q, dO tiles 64, k/v tiles 32, dS 64 x 34:     206,080 B
//       dK/dV    k, v tiles 32, q, dO tiles 32, P, dS 32 x 34: 140,544 B
//     under the 232,448 B a block may opt in to.  dK/dV keeps 32 own rows
//     (2 a thread) because each thread accumulates both dK and dV: 2 x 2 x
//     32 fp32 registers; 64 rows would hold 256 and spill.
//   * The 16-bit split-D dQ (n >= 2): a grid dimension over dQ's
//     256-column chunks, folded into blockIdx.x.  The reductions over D
//     (S = q k^T and dP = dO v^T) stream q and k (dO and v) through the
//     same shared-memory tiles, one 256-column chunk at a time, into the
//     same fp32 registers; then the block stages its own chunk of k for
//     the second product.  Shared memory does not grow with D.  The price:
//     each of the n blocks of a tile recomputes the scores over all of D
//     (1.67x the FMA work of a D = 256 block at n = 2), and q and dO,
//     resident at n = 1, are reloaded per key tile.  The dQ kernel has an
//     instance per case (template flag SPLIT): at n = 1 the chunk loop is
//     compiled away and the kernel is the D = 256 kernel it was (with the
//     loop left to run time, the 16-bit D = 256 dQ this file ran before
//     the wgmma dQ took it over was 16% slower on an H100).
//   * Any Sq and Sk (ragged tiles masked; rows past the end load as zero
//     with lse = -inf and are never stored); q, k, v and dO are read
//     through batch/head/sequence strides with a contiguous head dim; out,
//     lse, dq, dk and dv are written contiguous.  No atomics: every output
//     element is summed by one thread in a fixed order.
//
// What bounds it on an H100 at [8, 8, 512, 256]: the forward does
// 4 B H S^2 D = 17.2 GFLOP against 134 MB of fp32 inputs and outputs; on
// fp32 FMAs (67 TFLOP/s) that is 256 us against 40 us of bytes, so the
// bound is operations; on the tensor cores it is 104 us of 3xTF32
// products.  These kernels run on fp32 FMAs from shared memory (about one
// shared load per FMA) with one block per SM: they are right first, and
// slow; PERF.md records their times beside every bound.
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

constexpr int HEAD_DIM = 256;
constexpr int THREADS = 128;
constexpr int GROUP = 8;                      // threads sharing a row group
constexpr int ROW_GROUPS = THREADS / GROUP;   // 16
constexpr int kMaxDevices = 64;
constexpr size_t kMaxSmem = 232448;           // the per-block opt-in limit

// tile rows: forward (q, k/v), dQ (q, k/v), dK/dV (k/v, q)
constexpr int FWD_BQ = 64, FWD_BK = 64;
constexpr int DQ_BQ = 64, DQ_BK = 32;
constexpr int DKV_BK = 32, DKV_BQ = 32;

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
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// x rounded to the input dtype and widened again (the identity in fp32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// stage rows [r0, r0 + BR) of a strided [S, D] head slice into shared
// memory as fp32 ([BR][D + 1]); rows past S are zero
template <typename T, int D, int BR>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int r0, int S) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < BR * D; i += THREADS) {
    const int r = i / D, c = i % D, gr = r0 + r;
    dst[r * DP + c] = gr < S ? to_f32(src[(int64_t)gr * row_stride + c]) : 0.f;
  }
}

struct Strides {
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
      o_ss;
};

template <int D, int BQ, int BK>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 2));
}

template <int D, int BQ, int BK>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) *
         (size_t)(2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 2));
}

template <int D, int BK, int BQ>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t)(2 * BK * (D + 1) + 2 * BQ * (D + 1) +
                                  2 * BK * (BQ + 2) + 2 * BQ);
}

static_assert(fwd_smem_bytes<HEAD_DIM, FWD_BQ, FWD_BK>() <= kMaxSmem,
              "forward tiles exceed the shared-memory opt-in");
static_assert(dq_smem_bytes<HEAD_DIM, DQ_BQ, DQ_BK>() <= kMaxSmem,
              "dQ tiles exceed the shared-memory opt-in");
static_assert(dkv_smem_bytes<HEAD_DIM, DKV_BK, DKV_BQ>() <= kMaxSmem,
              "dK/dV tiles exceed the shared-memory opt-in");

// ---------------------------------------------------------------------------
// forward: one block per (q tile, head, batch), a loop over key tiles
// ---------------------------------------------------------------------------
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
flash_fwd_d256_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int H, int Sq, int Sk,
                      Strides st, int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = BK + 2;
  constexpr int ROWS = BQ / ROW_GROUPS;  // query rows per thread
  constexpr int KCOLS = BK / GROUP;      // keys per thread per tile
  constexpr int DCOLS = D / GROUP;       // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;           // [BQ][DP]
  float* sK = sQ + BQ * DP;   // [BK][DP]
  float* sV = sK + BK * DP;   // [BK][DP]
  float* sP = sV + BK * DP;   // [BQ][PP]

  const int tid = threadIdx.x;
  const int rg = tid / GROUP;
  const int cg = tid % GROUP;
  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const T* qb = q + bb * st.q_sb + hh * st.q_sh;
  const T* kb = k + bb * st.k_sb + hh * st.k_sh;
  const T* vb = v + bb * st.v_sb + hh * st.v_sh;
  load_tile<T, D, BQ>(sQ, qb, st.q_ss, q0, Sq);  // resident

  float m[ROWS], l[ROWS], acc[ROWS][DCOLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DCOLS; ++j) acc[i][j] = 0.f;
  }

  const int shift = Sk - Sq;  // bottom-right causal alignment
  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {
    const int hi = q0 + BQ + shift;  // keys visible to the tile's last row
    n_tiles = min(n_tiles, hi <= 0 ? 0 : (hi + BK - 1) / BK);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    float s[ROWS][KCOLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) s[i][j] = 0.f;
    // S = q k^T over the head dim
    __syncthreads();  // Q is staged / the previous reads are done
    load_tile<T, D, BK>(sK, kb, st.k_ss, k0, Sk);
    load_tile<T, D, BK>(sV, vb, st.v_ss, k0, Sk);
    __syncthreads();
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[ROWS], kv[KCOLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = sQ[(rg * ROWS + i) * DP + d];
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) kv[j] = sK[(cg + GROUP * j) * DP + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < KCOLS; ++j)
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qpos = q0 + rg * ROWS + i;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const int kpos = k0 + cg + GROUP * j;
        const bool valid = kpos < Sk && (!causal || kpos <= qpos + shift);
        const float x = valid ? s[i][j] * scale : -INFINITY;
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 4));
      const float m_new = fmaxf(m[i], rmax);
      // fully masked so far: keep everything at zero (exp(-inf - -inf)
      // would be nan)
      const bool live = m_new != -INFINITY;
      const float safe = live ? m_new : 0.f;
      const float alpha = m[i] != -INFINITY ? expf(m[i] - safe) : 0.f;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const float p = live ? expf(s[i][j] - safe) : 0.f;
        sP[(rg * ROWS + i) * PP + cg + GROUP * j] = round_to<T>(p);
        psum += p;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      psum += __shfl_xor_sync(0xffffffffu, psum, 4);
      l[i] = alpha * l[i] + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DCOLS; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // P tile complete

#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float pv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = sP[(rg * ROWS + i) * PP + c];
#pragma unroll
      for (int j = 0; j < DCOLS; ++j) {
        const float vv = sV[c * DP + cg + GROUP * j];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  const int64_t row0 = ((int64_t)bb * H + hh) * Sq;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qpos = q0 + rg * ROWS + i;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + (row0 + qpos) * D;
#pragma unroll
    for (int j = 0; j < DCOLS; ++j)
      orow[cg + GROUP * j] = from_f32<T>(acc[i][j] / denom);
    if (cg == 0)
      lse[row0 + qpos] = m[i] != -INFINITY ? m[i] + logf(denom) : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (q tile, head, batch), a loop over key tiles
// ---------------------------------------------------------------------------
template <typename T, int D, int BQ, int BK, bool SPLIT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_d256_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dd, T* __restrict__ dq,
                         int H, int Sq, int Sk, int n_chunks, Strides st,
                         int causal, float scale) {
  const int nchunk = SPLIT ? n_chunks : 1;
  constexpr int DP = D + 1;
  constexpr int PP = BK + 2;
  constexpr int ROWS = BQ / ROW_GROUPS;
  constexpr int COLS = BK / GROUP;
  constexpr int DCOLS = D / GROUP;
  extern __shared__ float smem[];
  float* sQ = smem;             // [BQ][DP]
  float* sDO = sQ + BQ * DP;    // [BQ][DP]
  float* sK = sDO + BQ * DP;    // [BK][DP]
  float* sV = sK + BK * DP;     // [BK][DP]
  float* sDS = sV + BK * DP;    // [BQ][PP]

  const int tid = threadIdx.x;
  const int rg = tid / GROUP;
  const int cg = tid % GROUP;
  const int chunk = blockIdx.x % nchunk;  // the block's dQ columns
  const int q0 = blockIdx.x / nchunk * BQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int64_t row0 = ((int64_t)bb * H + hh) * Sq;

  const T* qb = q + bb * st.q_sb + hh * st.q_sh;
  const T* ob = dout + bb * st.o_sb + hh * st.o_sh;
  const T* kb = k + bb * st.k_sb + hh * st.k_sh;
  const T* vb = v + bb * st.v_sb + hh * st.v_sh;
  if (nchunk == 1) {  // q and dO resident
    load_tile<T, D, BQ>(sQ, qb, st.q_ss, q0, Sq);
    load_tile<T, D, BQ>(sDO, ob, st.o_ss, q0, Sq);
  }

  float row_lse[ROWS], row_dd[ROWS], acc[ROWS][DCOLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qpos = q0 + rg * ROWS + i;
    row_lse[i] = qpos < Sq ? lse[row0 + qpos] : -INFINITY;
    row_dd[i] = qpos < Sq ? dd[row0 + qpos] : 0.f;
#pragma unroll
    for (int j = 0; j < DCOLS; ++j) acc[i][j] = 0.f;
  }

  const int shift = Sk - Sq;
  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {
    const int hi = q0 + BQ + shift;
    n_tiles = min(n_tiles, hi <= 0 ? 0 : (hi + BK - 1) / BK);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    float s[ROWS][COLS], dp[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = dp[i][j] = 0.f;
    // S = q k^T and dP = dO v^T over the head dim, one chunk at a time
    for (int c = 0; c < nchunk; ++c) {
      __syncthreads();  // the previous reads of the tiles / sDS are done
      if (nchunk > 1) {
        load_tile<T, D, BQ>(sQ, qb + c * D, st.q_ss, q0, Sq);
        load_tile<T, D, BQ>(sDO, ob + c * D, st.o_ss, q0, Sq);
      }
      load_tile<T, D, BK>(sK, kb + c * D, st.k_ss, k0, Sk);
      load_tile<T, D, BK>(sV, vb + c * D, st.v_ss, k0, Sk);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[ROWS], ov[ROWS], kv[COLS], vv[COLS];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          qv[i] = sQ[(rg * ROWS + i) * DP + d];
          ov[i] = sDO[(rg * ROWS + i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          kv[j] = sK[(cg + GROUP * j) * DP + d];
          vv[j] = sV[(cg + GROUP * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
          for (int j = 0; j < COLS; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
          }
      }
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qpos = q0 + rg * ROWS + i;
      const bool live = row_lse[i] != -INFINITY;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int kpos = k0 + cg + GROUP * j;
        const bool valid =
            live && kpos < Sk && (!causal || kpos <= qpos + shift);
        const float p = valid ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        sDS[(rg * ROWS + i) * PP + cg + GROUP * j] =
            round_to<T>(p * (dp[i][j] - row_dd[i]));
      }
    }
    __syncthreads();  // dS tile complete, every read of sK done
    if (chunk != nchunk - 1) {  // sK holds the last chunk: stage the own
      load_tile<T, D, BK>(sK, kb + chunk * D, st.k_ss, k0, Sk);
      __syncthreads();
    }

#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float dsv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) dsv[i] = sDS[(rg * ROWS + i) * PP + c];
#pragma unroll
      for (int j = 0; j < DCOLS; ++j) {
        const float kv = sK[c * DP + cg + GROUP * j];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qpos = q0 + rg * ROWS + i;
    if (qpos >= Sq) continue;
    T* out = dq + (row0 + qpos) * D * nchunk + chunk * D;
#pragma unroll
    for (int j = 0; j < DCOLS; ++j)
      out[cg + GROUP * j] = from_f32<T>(acc[i][j] * scale);
  }
}

// ---------------------------------------------------------------------------
// dK / dV: one block per (key tile, head, batch), a loop over q tiles; the
// tile is computed transposed (rows = keys), so the thread that accumulates
// a key row of dK and dV owns that row of P^T and dS^T
// ---------------------------------------------------------------------------
template <typename T, int D, int BK, int BQ>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_d256_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dd, T* __restrict__ dk,
                          T* __restrict__ dv, int H, int Sq, int Sk,
                          Strides st, int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = BQ + 2;
  constexpr int ROWS = BK / ROW_GROUPS;  // key rows per thread
  constexpr int COLS = BQ / GROUP;       // q rows per thread per tile
  constexpr int DCOLS = D / GROUP;
  extern __shared__ float smem[];
  float* sK = smem;             // [BK][DP]   resident
  float* sV = sK + BK * DP;     // [BK][DP]   resident
  float* sQ = sV + BK * DP;     // [BQ][DP]   streamed
  float* sDO = sQ + BQ * DP;    // [BQ][DP]   streamed
  float* sP = sDO + BQ * DP;    // [BK][PP]   P^T
  float* sDS = sP + BK * PP;    // [BK][PP]   dS^T
  float* sL = sDS + BK * PP;    // [BQ]       lse of the q tile
  float* sD = sL + BQ;          // [BQ]       D of the q tile

  const int tid = threadIdx.x;
  const int rg = tid / GROUP;
  const int cg = tid % GROUP;
  const int k0 = blockIdx.x * BK;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int64_t qrow0 = ((int64_t)bb * H + hh) * Sq;
  const int64_t krow0 = ((int64_t)bb * H + hh) * Sk;

  const T* kb = k + bb * st.k_sb + hh * st.k_sh;
  const T* vb = v + bb * st.v_sb + hh * st.v_sh;
  const T* qb = q + bb * st.q_sb + hh * st.q_sh;
  const T* ob = dout + bb * st.o_sb + hh * st.o_sh;
  load_tile<T, D, BK>(sK, kb, st.k_ss, k0, Sk);  // resident
  load_tile<T, D, BK>(sV, vb, st.v_ss, k0, Sk);

  float acc_k[ROWS][DCOLS], acc_v[ROWS][DCOLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < DCOLS; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int shift = Sk - Sq;
  const int n_tiles = (Sq + BQ - 1) / BQ;
  int first = 0;
  if (causal) {
    const int lo = k0 - shift;  // the first query that sees key k0
    first = lo <= 0 ? 0 : lo / BQ;
  }

  for (int t = first; t < n_tiles; ++t) {
    const int q0 = t * BQ;
    float s[ROWS][COLS], dp[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = dp[i][j] = 0.f;
    // S^T = k q^T and dP^T = v dO^T over the head dim
    __syncthreads();  // the previous reads of the q and dO tiles are done
    load_tile<T, D, BQ>(sQ, qb, st.q_ss, q0, Sq);
    load_tile<T, D, BQ>(sDO, ob, st.o_ss, q0, Sq);
    for (int r = tid; r < BQ; r += THREADS) {
      const int qpos = q0 + r;
      sL[r] = qpos < Sq ? lse[qrow0 + qpos] : -INFINITY;
      sD[r] = qpos < Sq ? dd[qrow0 + qpos] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[ROWS], vv[ROWS], qv[COLS], ov[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        kv[i] = sK[(rg * ROWS + i) * DP + d];
        vv[i] = sV[(rg * ROWS + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        qv[j] = sQ[(cg + GROUP * j) * DP + d];
        ov[j] = sDO[(cg + GROUP * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int kr = rg * ROWS + i;
      const int kpos = k0 + kr;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int qc = cg + GROUP * j;
        const int qpos = q0 + qc;
        const float l = sL[qc];
        const bool valid = l != -INFINITY && kpos < Sk &&
                           (!causal || kpos <= qpos + shift);
        const float p = valid ? expf(s[i][j] * scale - l) : 0.f;
        sP[kr * PP + qc] = round_to<T>(p);
        sDS[kr * PP + qc] = round_to<T>(p * (dp[i][j] - sD[qc]));
      }
    }
    __syncthreads();  // P^T and dS^T tiles complete

#pragma unroll 2
    for (int c = 0; c < BQ; ++c) {
      float pv[ROWS], dsv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        pv[i] = sP[(rg * ROWS + i) * PP + c];
        dsv[i] = sDS[(rg * ROWS + i) * PP + c];
      }
#pragma unroll
      for (int j = 0; j < DCOLS; ++j) {
        const float ov = sDO[c * DP + cg + GROUP * j];
        const float qv = sQ[c * DP + cg + GROUP * j];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          acc_v[i][j] = fmaf(pv[i], ov, acc_v[i][j]);
          acc_k[i][j] = fmaf(dsv[i], qv, acc_k[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int kpos = k0 + rg * ROWS + i;
    if (kpos >= Sk) continue;
    T* ko = dk + (krow0 + kpos) * D;
    T* vo = dv + (krow0 + kpos) * D;
#pragma unroll
    for (int j = 0; j < DCOLS; ++j) {
      ko[cg + GROUP * j] = from_f32<T>(acc_k[i][j] * scale);
      vo[cg + GROUP * j] = from_f32<T>(acc_v[i][j]);
    }
  }
}

// the shared-memory opt-in is a per-device attribute of each instance:
// set it on the first launch on each device only (a race between two
// first launches just sets the same value twice)
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t smem, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

// the forward and dK/dV run D = 256 only; dQ has one launcher per
// (T, SPLIT) instance: SPLIT = false runs D = 256 (nchunk 1), SPLIT = true
// D = 256 n, n >= 2
template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Sq, int Sk,
                       const Strides& st, int causal, float scale,
                       cudaStream_t stream) {
  constexpr int D = HEAD_DIM;
  static bool smem_set[kMaxDevices] = {};
  const size_t smem = fwd_smem_bytes<D, FWD_BQ, FWD_BK>();
  auto kernel = flash_fwd_d256_kernel<T, D, FWD_BQ, FWD_BK>;
  cudaError_t err = opt_in_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + FWD_BQ - 1) / FWD_BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), H, Sq, Sk, st, causal, scale);
  return cudaGetLastError();
}

template <typename T, bool SPLIT>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dd,
                      void* dq, int B, int H, int Sq, int Sk, int nchunk,
                      const Strides& st, int causal, float scale,
                      cudaStream_t stream) {
  constexpr int D = HEAD_DIM;
  static bool smem_set[kMaxDevices] = {};
  const size_t smem = dq_smem_bytes<D, DQ_BQ, DQ_BK>();
  auto kernel = flash_bwd_dq_d256_kernel<T, D, DQ_BQ, DQ_BK, SPLIT>;
  cudaError_t err = opt_in_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + DQ_BQ - 1) / DQ_BQ * nchunk, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<T*>(dq), H, Sq, Sk, nchunk, st, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dd,
                       void* dk, void* dv, int B, int H, int Sq, int Sk,
                       const Strides& st, int causal, float scale,
                       cudaStream_t stream) {
  constexpr int D = HEAD_DIM;
  static bool smem_set[kMaxDevices] = {};
  const size_t smem = dkv_smem_bytes<D, DKV_BK, DKV_BQ>();
  auto kernel = flash_bwd_dkv_d256_kernel<T, D, DKV_BK, DKV_BQ>;
  cudaError_t err = opt_in_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + DKV_BK - 1) / DKV_BK, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, st, causal,
      scale);
  return cudaGetLastError();
}

Strides make_strides(long long q_sb, long long q_sh, long long q_ss,
                     long long k_sb, long long k_sh, long long k_ss,
                     long long v_sb, long long v_sh, long long v_ss,
                     long long o_sb, long long o_sh, long long o_ss) {
  return Strides{q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                 v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; D must be a multiple of
// 256 (256 n: n blocks per tile, one per 256-column chunk of the output).
// What each entry runs, by dtype (anything else returns
// cudaErrorInvalidValue, so a wrong route raises in the wrapper and runs
// no replaced kernel):
//   forward  fp32, D = 256 (bf16 and fp16, and fp32 above 256:
//            flash_attn_fwd.cu);
//   dQ       fp32, n = 1; bf16 and fp16, n >= 2 (at D = 256 the wgmma dQ
//            of flash_attn_bwd.cu, fp32 above 256 its 3xTF32 split-D dQ);
//   dK/dV    fp32, n = 1 (at D = 256 the 16-bit wgmma dK/dV of
//            flash_attn_bwd.cu, above 256 its wgmma and 3xTF32 split-D
//            dK/dV).
// Strides (in elements) of q, k, v (and dO): batch, head, sequence; the
// head dim must be contiguous.  out [B, H, Sq, D] and lse [B, H, Sq] are
// written contiguous.  Each entry returns the CUDA error code of its
// launch (0 on success); the kernels are asynchronous on `stream`.  The
// caller makes the tensors' device current.
int flash_attn_d256_fwd(const void* q, const void* k, const void* v, void* o,
                        void* lse, int dtype, int B, int H, int Sq, int Sk,
                        int D, long long q_sb, long long q_sh,
                        long long q_ss, long long k_sb, long long k_sh,
                        long long k_ss, long long v_sb, long long v_sh,
                        long long v_ss, int causal, float scale,
                        void* stream) {
  if (D != HEAD_DIM || dtype != 0) return (int)cudaErrorInvalidValue;
  const Strides st = make_strides(q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,
                                  v_sh, v_ss, 0, 0, 0);
  return (int)launch_fwd<float>(q, k, v, o, lse, B, H, Sq, Sk, st, causal,
                                scale, static_cast<cudaStream_t>(stream));
}

// lse and D are contiguous fp32 [B, H, Sq]; dq [B, H, Sq, D] (and dk, dv
// [B, H, Sk, D]) are written contiguous in the input dtype.
int flash_attn_d256_bwd_dq(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* dd,
                           void* dq, int dtype, int B, int H, int Sq, int Sk,
                           int D, long long q_sb, long long q_sh,
                           long long q_ss, long long k_sb, long long k_sh,
                           long long k_ss, long long v_sb, long long v_sh,
                           long long v_ss, long long o_sb, long long o_sh,
                           long long o_ss, int causal, float scale,
                           void* stream) {
  if (D <= 0 || D % HEAD_DIM) return (int)cudaErrorInvalidValue;
  const int n = D / HEAD_DIM;
  const Strides st = make_strides(q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,
                                  v_sh, v_ss, o_sb, o_sh, o_ss);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && n == 1)
    err = launch_dq<float, false>(q, k, v, dout, lse, dd, dq, B, H, Sq, Sk,
                                  n, st, causal, scale, s);
  else if (dtype == 0 || n == 1)
    err = cudaErrorInvalidValue;
  else if (dtype == 1)
    err = launch_dq<__nv_bfloat16, true>(q, k, v, dout, lse, dd, dq, B, H,
                                         Sq, Sk, n, st, causal, scale, s);
  else if (dtype == 2)
    err = launch_dq<__half, true>(q, k, v, dout, lse, dd, dq, B, H, Sq, Sk,
                                  n, st, causal, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

int flash_attn_d256_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* dd, void* dk, void* dv, int dtype,
                            int B, int H, int Sq, int Sk, int D,
                            long long q_sb, long long q_sh, long long q_ss,
                            long long k_sb, long long k_sh, long long k_ss,
                            long long v_sb, long long v_sh, long long v_ss,
                            long long o_sb, long long o_sh, long long o_ss,
                            int causal, float scale, void* stream) {
  if (D != HEAD_DIM || dtype != 0) return (int)cudaErrorInvalidValue;
  const Strides st = make_strides(q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,
                                  v_sh, v_ss, o_sb, o_sh, o_ss);
  return (int)launch_dkv<float>(q, k, v, dout, lse, dd, dk, dv, B, H, Sq, Sk,
                                st, causal, scale,
                                static_cast<cudaStream_t>(stream));
}

const char* flash_attn_d256_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
