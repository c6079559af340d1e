// Flash-attention backward for NVIDIA Hopper (sm_90a), written by hand:
// two kernels, dQ and dK/dV.
//
// Replaces paddle_tpu/ops/attention.py::_flash_bwd_dq_kernel and
// ::_flash_bwd_dkv_kernel, the Pallas TPU kernels of the flash backward.
// They compute the same functions.  With S = scale * q k^T (causal mask
// applied), P = exp(S - lse) recomputed per tile from the forward's
// logsumexp, dP = dO v^T and D = rowsum(dO * O) (computed by the caller as
// a torch op, as the JAX package leaves it to XLA):
//   dS = P * (dP - D)
//   dQ = scale * dS k          (kernel 1: one CTA per q tile, loop over k)
//   dK = scale * dS^T q        (kernel 2: one CTA per k tile, loop over q)
//   dV = P^T dO
// Two kernels, as on the TPU, keep dQ deterministic: no atomics, every
// output element is summed by one thread in a fixed order.
//
// Semantics held equal to the TPU kernels:
//   * P, dP, dS and the accumulators are fp32; outputs are written in the
//     input dtype (fp32 or bf16);
//   * the causal mask is aligned bottom-right (query i sees keys
//     <= i + Sk - Sq), and tiles wholly above the diagonal are skipped
//     (dQ: key tiles past the q tile's last visible key; dK/dV: q tiles
//     before the first query that sees the k tile);
//   * a row whose lse is -inf (fully masked) has P = 0: its dq is 0 and it
//     adds nothing to dk or dv (the Pallas `where(isfinite(lse), ...)`).
//
// Design:
//   * 128 threads per CTA, 64-row tiles on both sides, the thread layout of
//     flash_attn_fwd.cu: thread t owns 4 rows of the CTA's own tile (row
//     group t/8) and, of every 64-row tile streamed past it, the 8 rows
//     t%8 + 8j; the 8 threads of a row group are adjacent lanes.  Both
//     score products (S and dP) share one loop over the head dim, so each
//     shared load feeds two FMAs.
//   * dQ kernel: q and dO tiles, lse and D rows stay resident; K/V tiles
//     stream; dS goes to shared memory for the dS.k product.
//   * dK/dV kernel: the tile is computed transposed (rows = keys), so the
//     thread that accumulates a key row of dK and dV owns that row of P^T
//     and dS^T.  K and V tiles stay resident; q, dO, lse and D tiles
//     stream.  At D = 128 that is 4 x 64 x 129 floats of tiles plus two
//     64 x 66 P/dS tiles: ~166 KB of dynamic shared memory, set once per
//     device with cudaFuncSetAttribute.
//   * Any Sq and Sk: rows past the end are loaded as zeros with lse = -inf
//     (so P = 0) and never stored; keys past Sk are masked.
//   * q, k, v and dO are read through batch/head/sequence strides (the
//     [B, H, S, D] views transpose2 produces need no copy); the head dim is
//     contiguous.  lse and D are contiguous [B, H, Sq]; dq, dk, dv are
//     written contiguous [B, H, S, D].
//
// What bounds it on an H100 at the training shape B = 8, H = 12, S = 512,
// D = 64: dQ does 3 products of 2*S*S*D FLOPs per head (S, dP, dS.k) and
// dK/dV 4 (S, dP, P^T.dO, dS^T.q).  In fp32 that is several times the time
// of moving the inputs and outputs once, so both kernels are bounded by
// fp32 FMA throughput (67 TFLOP/s); in bf16 the tensor cores would make
// the bytes the bound.  These first kernels multiply in fp32 FMAs from
// shared memory, for fp32 and bf16 inputs alike (~1 shared load per FMA);
// register tiling, then wgmma fed by TMA, are the later redesigns.
//
// Built by paddle_tpu_torch/core/kernel_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through the plain C interface at the end of this file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;        // rows per tile, both sides
constexpr int THREADS = 128;
constexpr int ROWS = 4;       // own-tile rows per thread (16 row groups)
constexpr int GROUP = 8;      // threads sharing a row group
constexpr int COLS = BT / GROUP;  // streamed rows per thread per tile
constexpr int PP = BT + 2;    // padded P / dS row
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// stage rows [r0, r0 + BT) of a strided [S, D] head slice into shared
// memory as fp32 ([BT][D + 1]); rows past S are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int r0, int S) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < BT * D; i += THREADS) {
    const int r = i / D, c = i % D, gr = r0 + r;
    dst[r * DP + c] = gr < S ? to_f32(src[(int64_t)gr * row_stride + c]) : 0.f;
  }
}

struct Strides {
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
      o_ss;
};

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(4 * BT * (D + 1) + BT * PP);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t)(4 * BT * (D + 1) + 2 * BT * PP + 2 * BT);
}

// ---------------------------------------------------------------------------
// dQ: one CTA per (q tile, head, batch)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd, T* __restrict__ dq, int H,
                    int Sq, int Sk, Strides st, int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int DCOLS = D / GROUP;
  extern __shared__ float smem[];
  float* sQ = smem;              // [BT][DP]
  float* sDO = sQ + BT * DP;     // [BT][DP]
  float* sK = sDO + BT * DP;     // [BT][DP]
  float* sV = sK + BT * DP;      // [BT][DP]
  float* sDS = sV + BT * DP;     // [BT][PP]

  const int tid = threadIdx.x;
  const int rg = tid / GROUP;
  const int cg = tid % GROUP;
  const int q0 = blockIdx.x * BT;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int64_t row0 = ((int64_t)bb * H + hh) * Sq;

  load_tile<T, D>(sQ, q + bb * st.q_sb + hh * st.q_sh, st.q_ss, q0, Sq);
  load_tile<T, D>(sDO, dout + bb * st.o_sb + hh * st.o_sh, st.o_ss, q0, Sq);
  const T* kb = k + bb * st.k_sb + hh * st.k_sh;
  const T* vb = v + bb * st.v_sb + hh * st.v_sh;

  float row_lse[ROWS], row_dd[ROWS], acc[ROWS][DCOLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qpos = q0 + rg * ROWS + i;
    row_lse[i] = qpos < Sq ? lse[row0 + qpos] : -INFINITY;
    row_dd[i] = qpos < Sq ? dd[row0 + qpos] : 0.f;
#pragma unroll
    for (int j = 0; j < DCOLS; ++j) acc[i][j] = 0.f;
  }

  const int shift = Sk - Sq;  // bottom-right causal alignment
  int n_tiles = (Sk + BT - 1) / BT;
  if (causal) {
    const int hi = q0 + BT + shift;  // keys visible to the tile's last row
    n_tiles = min(n_tiles, hi <= 0 ? 0 : (hi + BT - 1) / BT);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BT;
    __syncthreads();  // previous tile's reads of sK / sV / sDS are done
    load_tile<T, D>(sK, kb, st.k_ss, k0, Sk);
    load_tile<T, D>(sV, vb, st.v_ss, k0, Sk);
    __syncthreads();

    float s[ROWS][COLS], dp[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = dp[i][j] = 0.f;
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
        sDS[(rg * ROWS + i) * PP + cg + GROUP * j] = p * (dp[i][j] - row_dd[i]);
      }
    }
    __syncthreads();  // dS tile complete

    // acc[row][col] += sum_c dS[row][c] * k[c][col], col = cg + 8j
#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
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
// dK / dV: one CTA per (k tile, head, batch)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Sq, int Sk, Strides st,
                     int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int DCOLS = D / GROUP;
  extern __shared__ float smem[];
  float* sK = smem;              // [BT][DP]   resident
  float* sV = sK + BT * DP;      // [BT][DP]   resident
  float* sQ = sV + BT * DP;      // [BT][DP]   streamed
  float* sDO = sQ + BT * DP;     // [BT][DP]   streamed
  float* sP = sDO + BT * DP;     // [BT keys][PP]  P^T
  float* sDS = sP + BT * PP;     // [BT keys][PP]  dS^T
  float* sL = sDS + BT * PP;     // [BT]  lse of the q tile
  float* sD = sL + BT;           // [BT]  D of the q tile

  const int tid = threadIdx.x;
  const int rg = tid / GROUP;
  const int cg = tid % GROUP;
  const int k0 = blockIdx.x * BT;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int64_t qrow0 = ((int64_t)bb * H + hh) * Sq;
  const int64_t krow0 = ((int64_t)bb * H + hh) * Sk;

  load_tile<T, D>(sK, k + bb * st.k_sb + hh * st.k_sh, st.k_ss, k0, Sk);
  load_tile<T, D>(sV, v + bb * st.v_sb + hh * st.v_sh, st.v_ss, k0, Sk);
  const T* qb = q + bb * st.q_sb + hh * st.q_sh;
  const T* ob = dout + bb * st.o_sb + hh * st.o_sh;

  float acc_k[ROWS][DCOLS], acc_v[ROWS][DCOLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < DCOLS; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int shift = Sk - Sq;  // bottom-right causal alignment
  const int n_tiles = (Sq + BT - 1) / BT;
  int first = 0;
  if (causal) {
    // the first query that sees key k0 is k0 - shift
    const int lo = k0 - shift;
    first = lo <= 0 ? 0 : lo / BT;
  }

  for (int t = first; t < n_tiles; ++t) {
    const int q0 = t * BT;
    __syncthreads();  // previous tile's reads are done
    load_tile<T, D>(sQ, qb, st.q_ss, q0, Sq);
    load_tile<T, D>(sDO, ob, st.o_ss, q0, Sq);
    for (int r = tid; r < BT; r += THREADS) {
      const int qpos = q0 + r;
      sL[r] = qpos < Sq ? lse[qrow0 + qpos] : -INFINITY;
      sD[r] = qpos < Sq ? dd[qrow0 + qpos] : 0.f;
    }
    __syncthreads();

    // transposed tile: rows = this CTA's keys, columns = the q tile
    float s[ROWS][COLS], dp[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = dp[i][j] = 0.f;
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
        sP[kr * PP + qc] = p;
        sDS[kr * PP + qc] = p * (dp[i][j] - sD[qc]);
      }
    }
    __syncthreads();  // P^T and dS^T tiles complete

    // acc_v[key][col] += sum_c P^T[key][c] dO[c][col];
    // acc_k[key][col] += sum_c dS^T[key][c] q[c][col]
#pragma unroll 2
    for (int c = 0; c < BT; ++c) {
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

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dd,
                      void* dq, int B, int H, int Sq, int Sk,
                      const Strides& st, int causal, float scale,
                      cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {};
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = opt_in_smem(flash_bwd_dq_kernel<T, D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BT - 1) / BT, H, B);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<T*>(dq), H, Sq, Sk, st, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dd,
                       void* dk, void* dv, int B, int H, int Sq, int Sk,
                       const Strides& st, int causal, float scale,
                       cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {};
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = opt_in_smem(flash_bwd_dkv_kernel<T, D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + BT - 1) / BT, H, B);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, st, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dq_dispatch(int D, const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* dd,
                        void* dq, int B, int H, int Sq, int Sk,
                        const Strides& st, int causal, float scale,
                        cudaStream_t s) {
  switch (D) {
    case 32:
      return launch_dq<T, 32>(q, k, v, dout, lse, dd, dq, B, H, Sq, Sk, st,
                              causal, scale, s);
    case 64:
      return launch_dq<T, 64>(q, k, v, dout, lse, dd, dq, B, H, Sq, Sk, st,
                              causal, scale, s);
    case 128:
      return launch_dq<T, 128>(q, k, v, dout, lse, dd, dq, B, H, Sq, Sk, st,
                               causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dkv_dispatch(int D, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* dd,
                         void* dk, void* dv, int B, int H, int Sq, int Sk,
                         const Strides& st, int causal, float scale,
                         cudaStream_t s) {
  switch (D) {
    case 32:
      return launch_dkv<T, 32>(q, k, v, dout, lse, dd, dk, dv, B, H, Sq, Sk,
                               st, causal, scale, s);
    case 64:
      return launch_dkv<T, 64>(q, k, v, dout, lse, dd, dk, dv, B, H, Sq, Sk,
                               st, causal, scale, s);
    case 128:
      return launch_dkv<T, 128>(q, k, v, dout, lse, dd, dk, dv, B, H, Sq, Sk,
                                st, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
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

// dtype: 0 = float32, 1 = bfloat16.  Strides (in elements) of q, k, v and
// dO: batch, head, sequence; the head dim must be contiguous.  lse and D
// are contiguous fp32 [B, H, Sq]; dq [B, H, Sq, D] (and dk, dv
// [B, H, Sk, D]) are written contiguous in the input dtype.  Each returns
// the CUDA error code of its launch (0 on success); the kernels are
// asynchronous on `stream`.  The caller makes the tensors' device current.
int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dd,
                      void* dq, int dtype, int B, int H, int Sq, int Sk,
                      int D, long long q_sb, long long q_sh, long long q_ss,
                      long long k_sb, long long k_sh, long long k_ss,
                      long long v_sb, long long v_sh, long long v_ss,
                      long long o_sb, long long o_sh, long long o_ss,
                      int causal, float scale, void* stream) {
  const Strides st = make_strides(q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,
                                  v_sh, v_ss, o_sb, o_sh, o_ss);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dq_dispatch<float>(D, q, k, v, dout, lse, dd, dq, B, H, Sq, Sk, st,
                             causal, scale, s);
  else if (dtype == 1)
    err = dq_dispatch<__nv_bfloat16>(D, q, k, v, dout, lse, dd, dq, B, H, Sq,
                                     Sk, st, causal, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dd,
                       void* dk, void* dv, int dtype, int B, int H, int Sq,
                       int Sk, int D, long long q_sb, long long q_sh,
                       long long q_ss, long long k_sb, long long k_sh,
                       long long k_ss, long long v_sb, long long v_sh,
                       long long v_ss, long long o_sb, long long o_sh,
                       long long o_ss, int causal, float scale,
                       void* stream) {
  const Strides st = make_strides(q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,
                                  v_sh, v_ss, o_sb, o_sh, o_ss);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dkv_dispatch<float>(D, q, k, v, dout, lse, dd, dk, dv, B, H, Sq,
                              Sk, st, causal, scale, s);
  else if (dtype == 1)
    err = dkv_dispatch<__nv_bfloat16>(D, q, k, v, dout, lse, dd, dk, dv, B,
                                      H, Sq, Sk, st, causal, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* flash_attn_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
