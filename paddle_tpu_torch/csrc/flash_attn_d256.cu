// The fp32 flash dQ and dK/dV at head dim 256 for NVIDIA Hopper (sm_90a),
// written by hand on fp32 FMAs from shared memory: the last two kernels
// of the port that do not run on the tensor cores.
//
// Replace, at D = 256 in fp32, the Pallas TPU kernels
// paddle_tpu/ops/attention.py::_flash_bwd_dq_kernel and
// ::_flash_bwd_dkv_kernel (the reference takes any head dim).  The wrapper
// (paddle_tpu_torch/ops/attention.py) zero-pads a head dim of 129-255 to
// 256, which leaves q k^T, lse and rowsum(dO * O) unchanged.  Everything
// else at D >= 256 runs on the tensor cores in flash_attn_fwd.cu and
// flash_attn_bwd.cu: the fp32 forward (D = 256 n, n >= 1) and the fp32 dQ
// and dK/dV above 256 on 3xTF32, every 16-bit kernel on wgmma.  No other
// instance is compiled here: the C entries return cudaErrorInvalidValue for
// any dtype but fp32 and any head dim but 256, so a wrong route raises and
// never runs a replaced kernel.
//
// The functions, held equal to the TPU kernels and to the D <= 128
// kernels:
//   dQ        dQ = scale * dS k,  dS = P * (dP - D), P = exp(S - lse);
//   dK/dV     dK = scale * dS^T q, dV = P^T dO.
//   * P, dP, dS and the accumulators are fp32 (in fp32 the TPU kernels'
//     `p.astype(...)`, `ds.astype(...)` are the identity);
//   * the causal mask is aligned bottom-right (query i sees keys
//     <= i + Sk - Sq), and tiles wholly above the diagonal are skipped;
//   * a fully-masked row (lse = -inf) has P = 0 (dq = 0, nothing added to
//     dk and dv).
//
// Design: the SIMT design of the port's first kernels, with the tile sizes
// cut to a 256-column head dim.  Here:
//   * 128 threads a block; thread t owns ROWS rows of the block's own tile
//     (row group t/8) and, of every tile streamed past it, the rows
//     t%8 + 8j; the 8 threads of a row group are adjacent lanes.  For the
//     second product the same thread owns the output columns t%8 + 8j (32
//     of them).
//   * Tiles are staged in shared memory as fp32 with rows padded to 257
//     floats (the lanes of a warp hit distinct banks); products are fp32
//     FMAs from shared memory.
//   * Shared memory (dynamic, opted in once per device and instance):
//       dQ       q, dO tiles 64, k/v tiles 32, dS 64 x 34:     206,080 B
//       dK/dV    k, v tiles 32, q, dO tiles 32, P, dS 32 x 34: 140,544 B
//     under the 232,448 B a block may opt in to.  dK/dV keeps 32 own rows
//     (2 a thread) because each thread accumulates both dK and dV: 2 x 2 x
//     32 fp32 registers; 64 rows would hold 256 and spill.
//   * Any Sq and Sk (ragged tiles masked; rows past the end load as zero
//     with lse = -inf and are never stored); q, k, v and dO are read
//     through batch/head/sequence strides with a contiguous head dim; dq,
//     dk and dv are written contiguous.  No atomics: every output element
//     is summed by one thread in a fixed order.
//
// What bounds them on an H100 at [8, 8, 512, 256]: dQ does
// 6 B H S^2 D = 25.8 GFLOP and dK/dV 34.4 against ~170 MB of fp32 inputs
// and outputs; on fp32 FMAs (67 TFLOP/s) that is 385 and 513 us against
// ~50 us of bytes, so the operations bound them; on the tensor cores they
// would be 156 and 208 us of 3xTF32 products.  These kernels run on fp32
// FMAs from shared memory (about one shared load per FMA) with one block
// per SM: they are right first, and slow; PERF.md records their times
// beside every bound.
//
// Built by paddle_tpu_torch/core/kernel_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through the plain C interface at the end of this file.

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

// tile rows: dQ (q, k/v), dK/dV (k/v, q)
constexpr int DQ_BQ = 64, DQ_BK = 32;
constexpr int DKV_BK = 32, DKV_BQ = 32;

// the kernels keep the input type T of the port's other kernels; only
// T = float is instantiated
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

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
constexpr size_t dq_smem_bytes() {
  return sizeof(float) *
         (size_t)(2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 2));
}

template <int D, int BK, int BQ>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t)(2 * BK * (D + 1) + 2 * BQ * (D + 1) +
                                  2 * BK * (BQ + 2) + 2 * BQ);
}

static_assert(dq_smem_bytes<HEAD_DIM, DQ_BQ, DQ_BK>() <= kMaxSmem,
              "dQ tiles exceed the shared-memory opt-in");
static_assert(dkv_smem_bytes<HEAD_DIM, DKV_BK, DKV_BQ>() <= kMaxSmem,
              "dK/dV tiles exceed the shared-memory opt-in");

// ---------------------------------------------------------------------------
// dQ: one block per (q tile, head, batch), a loop over key tiles
// ---------------------------------------------------------------------------
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_d256_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dd, T* __restrict__ dq,
                         int H, int Sq, int Sk, Strides st, int causal,
                         float scale) {
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
  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int64_t row0 = ((int64_t)bb * H + hh) * Sq;

  const T* qb = q + bb * st.q_sb + hh * st.q_sh;
  const T* ob = dout + bb * st.o_sb + hh * st.o_sh;
  const T* kb = k + bb * st.k_sb + hh * st.k_sh;
  const T* vb = v + bb * st.v_sb + hh * st.v_sh;
  load_tile<T, D, BQ>(sQ, qb, st.q_ss, q0, Sq);  // q and dO resident
  load_tile<T, D, BQ>(sDO, ob, st.o_ss, q0, Sq);

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
    // S = q k^T and dP = dO v^T over the head dim
    __syncthreads();  // the previous reads of the tiles / sDS are done
    load_tile<T, D, BK>(sK, kb, st.k_ss, k0, Sk);
    load_tile<T, D, BK>(sV, vb, st.v_ss, k0, Sk);
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
    __syncthreads();  // dS tile complete

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
    T* out = dq + (row0 + qpos) * D;
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

// both kernels run D = 256 only
template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dd,
                      void* dq, int B, int H, int Sq, int Sk,
                      const Strides& st, int causal, float scale,
                      cudaStream_t stream) {
  constexpr int D = HEAD_DIM;
  static bool smem_set[kMaxDevices] = {};
  const size_t smem = dq_smem_bytes<D, DQ_BQ, DQ_BK>();
  auto kernel = flash_bwd_dq_d256_kernel<T, D, DQ_BQ, DQ_BK>;
  cudaError_t err = opt_in_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + DQ_BQ - 1) / DQ_BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<T*>(dq), H, Sq, Sk, st, causal, scale);
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

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Both entries run fp32 at
// D = 256 only and return cudaErrorInvalidValue for anything else, so a
// wrong route raises in the wrapper and runs no replaced kernel (the
// forward, and every 16-bit kernel or head dim above 256, run
// flash_attn_fwd.cu and flash_attn_bwd.cu).  Strides (in elements) of q,
// k, v and dO: batch, head, sequence; the head dim must be contiguous.
// lse and D are contiguous fp32 [B, H, Sq]; dq [B, H, Sq, D] (and dk, dv
// [B, H, Sk, D]) are written contiguous.  Each entry returns the CUDA
// error code of its launch (0 on success); the kernels are asynchronous on
// `stream`.  The caller makes the tensors' device current.
int flash_attn_d256_bwd_dq(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* dd,
                           void* dq, int dtype, int B, int H, int Sq, int Sk,
                           int D, long long q_sb, long long q_sh,
                           long long q_ss, long long k_sb, long long k_sh,
                           long long k_ss, long long v_sb, long long v_sh,
                           long long v_ss, long long o_sb, long long o_sh,
                           long long o_ss, int causal, float scale,
                           void* stream) {
  if (D != HEAD_DIM || dtype != 0) return (int)cudaErrorInvalidValue;
  const Strides st = make_strides(q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,
                                  v_sh, v_ss, o_sb, o_sh, o_ss);
  return (int)launch_dq<float>(q, k, v, dout, lse, dd, dq, B, H, Sq, Sk, st,
                               causal, scale,
                               static_cast<cudaStream_t>(stream));
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
