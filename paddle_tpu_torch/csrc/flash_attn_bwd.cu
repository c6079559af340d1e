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
// Two kernels, as on the TPU, keep the results deterministic: no atomics,
// every output element is summed by one thread in a fixed order.
//
// Semantics held equal to the TPU kernels:
//   * P, dP, dS and the accumulators are fp32; outputs are written in the
//     input dtype (fp32 or bf16);
//   * in bf16, P and dS are rounded to bf16 before the second products:
//     dS before dS k in dQ (the TPU kernel's `ds.astype(ks.dtype)`), P
//     and dS before P^T dO and dS^T q in dK/dV (`p.astype(do.dtype)`,
//     `.astype(q.dtype)`);
//   * the causal mask is aligned bottom-right (query i sees keys
//     <= i + Sk - Sq), and tiles wholly above the diagonal are skipped
//     (dQ: key tiles past the q tile's last visible key; dK/dV: q tiles
//     before the first query that sees the k tile);
//   * a row whose lse is -inf (fully masked) has P = 0: its dq is 0 and it
//     adds nothing to dk or dv (the Pallas `where(isfinite(lse), ...)`).
// Any Sq and Sk; q, k, v and dO are read through batch/head/sequence
// strides (the [B, H, S, D] views transpose2 produces need no copy) with
// the head dim contiguous; lse and D are contiguous [B, H, Sq]; dq, dk, dv
// are written contiguous [B, H, S, D].
//
// The kernels, dispatched by dtype in the C entries at the end:
//
// bf16 (the AMP training path): two warp-specialized wgmma kernels fed
// by TMA, `flash_bwd_dq_wgmma_kernel` and `flash_bwd_dkv_wgmma_kernel`.
//   Bound on an H100 at the training shape B = 8, H = 12, S = 512,
//   D = 64: dQ does 3 products of 2 S^2 D FLOPs per head (9.7 GFLOP,
//   9.8 us on the 989 TFLOP/s tensor cores) against 32 MB of inputs and
//   outputs (9.5 us); dK/dV 4 products (12.9 GFLOP, 13 us) against 38 MB
//   (11 us).  The operations bound both, and only wgmma reaches them.
//   Both kernels: three warpgroups, warpgroups 0 and 1 each own 64 rows
//   (consumers), one warp of warpgroup 2 is the producer; `setmaxnreg`
//   moves registers from the producer (24) to the consumers (240).
//   Tiles are TMA boxes in 128-byte swizzle (64-byte at D = 32; D = 128
//   as two 64-column boxes), each operand read by the wgmma descriptors
//   K-major for the score products and MN-major for the second product.
//
//   dQ: one CTA per (128 query rows, head, batch).
//   * q and dO are loaded once by TMA and stay resident; each consumer
//     thread keeps the lse (log2 units, +inf for rows past Sq or fully
//     masked, so P = 0 there without a test) and D of its two rows in
//     registers.  K/V tiles of BK = 64 keys stream through a 2-stage ring
//     (full and empty mbarriers; K and V have separate full barriers, so
//     S starts before V lands).  BK = 64 keeps S and dP at 32 fp32
//     registers each beside the dQ accumulator (32 or 64).
//   * S = q k^T and dP = dO v^T by wgmma m64n64k16 (both operands
//     K-major); P = exp2(S scale log2e - lse log2e) is computed while dP
//     is still in flight (wgmma wait 1); dS = P (dP - D) on the fragment,
//     packed to bf16 (the TPU kernel's `ds.astype(ks.dtype)`) as the
//     register A operand of dQ += dS k, B = the same k tile read MN-major.
//   * keys past Sk are masked in registers (TMA zero-fills them, and a
//     zero score is not -inf), as are keys above the causal diagonal;
//     key tiles wholly above it are skipped (`attention.py:273`).
//   * dQ stays in registers until the epilogue (x scale, bf16, rows past
//     Sq not stored).  Each dQ element is summed by one thread in a fixed
//     order: no atomics, bitwise reproducible.
//   At the training shape the grid is 4 x 12 x 8 = 384 CTAs, one per SM.
//
//   dK/dV: one CTA per (128 keys, head, batch).
//   * K and V are loaded once by TMA and stay resident.  q and dO tiles of
//     BQ = 64 rows stream through a 2-stage TMA ring; the producer warp
//     also stages the tile's lse (log2 units, +inf as above) and D rows
//     into shared memory with guarded loads, so nothing reads past the
//     end of [B, H, Sq].
//   * Scores are transposed, so each consumer owns its 64 keys as rows:
//     S^T = k q^T and dP^T = v dO^T (A = the warpgroup's k or v rows, B =
//     the q or dO tile, both K-major); P^T and dS^T = P^T (dP^T - D) on
//     the fragments, lse and D broadcast along the fragment's columns
//     (the q index), packed to bf16 as the register A operands of
//     dV += P^T dO and dK += dS^T q (B = the same dO / q tile read
//     MN-major).  dK and dV stay in registers until the epilogue.
//   * The causal start tile follows `attention.py:321`: the first q tile
//     that sees the CTA's first key.  Keys past Sk are computed on
//     zero-filled k and v and not stored (a key row of dK/dV depends only
//     on its own row of P^T and dS^T).
//
// fp32 (the fp32 check step): FMA kernels, `flash_bwd_dq_kernel` and
//   `flash_bwd_dkv_kernel`.  128 threads per CTA, 64-row tiles on both
//   sides: thread t owns 4 rows of the CTA's own tile (row group t/8)
//   and, of every 64-row tile streamed past it, the 8 rows t%8 + 8j.
//   Both score products (S and dP) share one loop over the head dim, so
//   each shared load feeds two FMAs.  dQ: q and dO tiles, lse and D rows
//   stay resident; K/V tiles stream.  dK/dV: the tile is computed
//   transposed (rows = keys); K and V tiles stay resident, q, dO, lse and
//   D tiles stream (~166 KB of shared memory at D = 128).  Rows past the
//   end are loaded as zeros with lse = -inf and never stored.  Bounded
//   by fp32 FMA throughput (67 TFLOP/s); register tiling is their next
//   step.
//
// Built by paddle_tpu_torch/core/kernel_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through the plain C interface at the end of this file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BT = 64;        // rows per tile, both sides
constexpr int THREADS = 128;
constexpr int ROWS = 4;       // own-tile rows per thread (16 row groups)
constexpr int GROUP = 8;      // threads sharing a row group
constexpr int COLS = BT / GROUP;  // streamed rows per thread per tile
constexpr int PP = BT + 2;    // padded P / dS row
constexpr int kMaxDevices = 64;

// stage rows [r0, r0 + BT) of a strided [S, D] head slice into shared
// memory ([BT][D + 1]); rows past S are zero
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t row_stride, int r0, int S) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < BT * D; i += THREADS) {
    const int r = i / D, c = i % D, gr = r0 + r;
    dst[r * DP + c] = gr < S ? src[(int64_t)gr * row_stride + c] : 0.f;
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
// dQ in fp32: one CTA per (q tile, head, batch)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd, float* __restrict__ dq, int H,
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

  load_tile<D>(sQ, q + bb * st.q_sb + hh * st.q_sh, st.q_ss, q0, Sq);
  load_tile<D>(sDO, dout + bb * st.o_sb + hh * st.o_sh, st.o_ss, q0, Sq);
  const float* kb = k + bb * st.k_sb + hh * st.k_sh;
  const float* vb = v + bb * st.v_sb + hh * st.v_sh;

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
    load_tile<D>(sK, kb, st.k_ss, k0, Sk);
    load_tile<D>(sV, vb, st.v_ss, k0, Sk);
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
    float* out = dq + (row0 + qpos) * D;
#pragma unroll
    for (int j = 0; j < DCOLS; ++j) out[cg + GROUP * j] = acc[i][j] * scale;
  }
}

// ---------------------------------------------------------------------------
// dK / dV in fp32: one CTA per (k tile, head, batch)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Sq, int Sk, Strides st,
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

  load_tile<D>(sK, k + bb * st.k_sb + hh * st.k_sh, st.k_ss, k0, Sk);
  load_tile<D>(sV, v + bb * st.v_sb + hh * st.v_sh, st.v_ss, k0, Sk);
  const float* qb = q + bb * st.q_sb + hh * st.q_sh;
  const float* ob = dout + bb * st.o_sb + hh * st.o_sh;

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
    load_tile<D>(sQ, qb, st.q_ss, q0, Sq);
    load_tile<D>(sDO, ob, st.o_ss, q0, Sq);
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
    float* ko = dk + (krow0 + kpos) * D;
    float* vo = dv + (krow0 + kpos) * D;
#pragma unroll
    for (int j = 0; j < DCOLS; ++j) {
      ko[cg + GROUP * j] = acc_k[i][j] * scale;
      vo[cg + GROUP * j] = acc_v[i][j];
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

template <int D>
cudaError_t launch_dq_fp32(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* dd,
                           void* dq, int B, int H, int Sq, int Sk,
                           const Strides& st, int causal, float scale,
                           cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {};
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = opt_in_smem(flash_bwd_dq_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BT - 1) / BT, H, B);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<float*>(dq), H, Sq, Sk, st, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_fp32(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* dd, void* dk, void* dv, int B, int H,
                            int Sq, int Sk, const Strides& st, int causal,
                            float scale, cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {};
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = opt_in_smem(flash_bwd_dkv_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + BT - 1) / BT, H, B);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Sq, Sk, st,
      causal, scale);
  return cudaGetLastError();
}

cudaError_t dq_dispatch_fp32(int D, const void* q, const void* k,
                             const void* v, const void* dout,
                             const void* lse, const void* dd, void* dq,
                             int B, int H, int Sq, int Sk, const Strides& st,
                             int causal, float scale, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch_dq_fp32<32>(q, k, v, dout, lse, dd, dq, B, H, Sq, Sk,
                                st, causal, scale, s);
    case 64:
      return launch_dq_fp32<64>(q, k, v, dout, lse, dd, dq, B, H, Sq, Sk,
                                st, causal, scale, s);
    case 128:
      return launch_dq_fp32<128>(q, k, v, dout, lse, dd, dq, B, H, Sq, Sk,
                                 st, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dkv_dispatch_fp32(int D, const void* q, const void* k,
                              const void* v, const void* dout,
                              const void* lse, const void* dd, void* dk,
                              void* dv, int B, int H, int Sq, int Sk,
                              const Strides& st, int causal, float scale,
                              cudaStream_t s) {
  switch (D) {
    case 32:
      return launch_dkv_fp32<32>(q, k, v, dout, lse, dd, dk, dv, B, H, Sq,
                                 Sk, st, causal, scale, s);
    case 64:
      return launch_dkv_fp32<64>(q, k, v, dout, lse, dd, dk, dv, B, H, Sq,
                                 Sk, st, causal, scale, s);
    case 128:
      return launch_dkv_fp32<128>(q, k, v, dout, lse, dd, dk, dv, B, H, Sq,
                                  Sk, st, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: warp-specialized wgmma kernels (dK/dV, then dQ)
// ---------------------------------------------------------------------------
namespace wg {

using hopper::Wgmma;

constexpr int BKV = 128;        // dK/dV: keys per CTA (two consumers)
constexpr int BQ = 64;          // dK/dV: query rows per streamed tile
constexpr int DQ_BQ = 128;      // dQ: query rows per CTA (two consumers)
constexpr int DQ_BK = 64;       // dQ: keys per streamed K/V tile
constexpr int THREADS = 384;    // warpgroups 0, 1 consume; 2 produces
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float kLog2e = 1.4426950408889634f;

// shared memory: K and V (resident), two stages of q and of dO, each as
// D / COLS boxes of [rows][COLS] bf16; two stages of the q tile's lse
// (log2 units) and D rows; then the mbarriers
template <int D>
struct Layout {
  static constexpr int COLS = hopper::box_cols(D);
  static constexpr int NBOX = D / COLS;
  static constexpr int SWIZZLE =
      COLS == 64 ? hopper::kSwizzle128B : hopper::kSwizzle64B;
  static constexpr uint32_t ROW = COLS * 2;        // bytes of a box row
  static constexpr uint32_t SBO = 8 * ROW;         // next 8-row group
  static constexpr uint32_t KV_BOX = BKV * ROW;
  static constexpr uint32_t Q_BOX = BQ * ROW;
  static constexpr uint32_t KV_BYTES = NBOX * KV_BOX;
  static constexpr uint32_t Q_BYTES = NBOX * Q_BOX;
  static constexpr uint32_t K_OFF = 0;
  static constexpr uint32_t V_OFF = KV_BYTES;
  static constexpr uint32_t Q_OFF = 2 * KV_BYTES;
  static constexpr uint32_t DO_OFF = Q_OFF + 2 * Q_BYTES;
  static constexpr uint32_t ROWS_OFF = DO_OFF + 2 * Q_BYTES;
  static constexpr uint32_t BAR_OFF = ROWS_OFF + 2 * 2 * BQ * 4;
  static constexpr size_t SMEM = BAR_OFF + 5 * 8 + 1024;  // + align slack
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ dd,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int H, int Sq,
                           int Sk, int causal, float scale) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  float* rows_all = reinterpret_cast<float*>(smem + L::ROWS_OFF);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* kv_full = bars;      // K and V landed
  uint64_t* q_full = bars + 1;   // [2] the stage's q, dO, lse and D landed
  uint64_t* q_empty = bars + 3;  // [2] both consumers are done with it

  const int k0 = blockIdx.x * BKV;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int shift = Sk - Sq;  // bottom-right causal alignment
  const int n_qt = (Sq + BQ - 1) / BQ;
  int first = 0;
  if (causal) {
    // the first q tile that can see key k0 (attention.py:321)
    const int lo = k0 - shift;
    first = lo <= 0 ? 0 : lo / BQ;
  }
  const int n_tiles = n_qt - first;  // <= 0: no query sees these keys

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(q_full + s, 32);
      hopper::mbar_init(q_empty + s, 2 * 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int64_t qrow_base = ((int64_t)bb * H + hh) * Sq;
  if (wg == 2) {
    // ---- producer warp: TMA loads (lane 0) and the lse / D rows (all)
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x < 256 + 32 && n_tiles > 0) {
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(kv_full, 2 * L::KV_BYTES);
        for (int b = 0; b < L::NBOX; ++b) {
          hopper::tma_load_4d(smem + L::K_OFF + b * L::KV_BOX, &tk, kv_full,
                              b * L::COLS, k0, hh, bb);
          hopper::tma_load_4d(smem + L::V_OFF + b * L::KV_BOX, &tv, kv_full,
                              b * L::COLS, k0, hh, bb);
        }
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it & 1;
        const int q0 = (first + it) * BQ;
        // stage s last held tile it - 2: wait for its release
        if (it >= 2) hopper::mbar_wait(q_empty + s, ((it >> 1) + 1) & 1);
        float* rows = rows_all + s * 2 * BQ;
        for (int r = lane; r < BQ; r += 32) {
          const int qpos = q0 + r;
          const float lv = qpos < Sq ? lse[qrow_base + qpos] : -INFINITY;
          rows[r] = lv == -INFINITY ? INFINITY : lv * kLog2e;
          rows[BQ + r] = qpos < Sq ? dd[qrow_base + qpos] : 0.f;
        }
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(q_full + s, 2 * L::Q_BYTES);
          for (int b = 0; b < L::NBOX; ++b) {
            const uint32_t off = s * L::Q_BYTES + b * L::Q_BOX;
            hopper::tma_load_4d(smem + L::Q_OFF + off, &tq, q_full + s,
                                b * L::COLS, q0, hh, bb);
            hopper::tma_load_4d(smem + L::DO_OFF + off, &tdo, q_full + s,
                                b * L::COLS, q0, hh, bb);
          }
        } else {
          hopper::mbar_arrive(q_full + s);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys k0 + 64 wg .. + 63 as rows
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    constexpr int SN = BQ / 2;        // S^T / dP^T fragment: 32 fp32
    constexpr int ON = L::COLS / 2;   // dK / dV fragment per box
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int kw0 = k0 + 64 * wg;                      // first key
    const int key = kw0 + 16 * (tid / 32) + lane / 4;  // keys key, key + 8
    const uint8_t* sk = smem + L::K_OFF + 64 * wg * L::ROW;
    const uint8_t* sv = smem + L::V_OFF + 64 * wg * L::ROW;
    const float scale_log2 = scale * kLog2e;

    float dk_acc[L::NBOX][ON], dv_acc[L::NBOX][ON];
#pragma unroll
    for (int b = 0; b < L::NBOX; ++b)
#pragma unroll
      for (int i = 0; i < ON; ++i) dk_acc[b][i] = dv_acc[b][i] = 0.f;
    float st[SN], dpt[SN];
#pragma unroll
    for (int i = 0; i < SN; ++i) st[i] = dpt[i] = 0.f;

    if (n_tiles > 0) hopper::mbar_wait(kv_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it & 1;
      const int q0 = (first + it) * BQ;
      const uint8_t* sq = smem + L::Q_OFF + s * L::Q_BYTES;
      const uint8_t* sdo = smem + L::DO_OFF + s * L::Q_BYTES;
      const float* rows = rows_all + s * 2 * BQ;

      // S^T = k q^T and dP^T = v dO^T: A = the warpgroup's k / v rows,
      // B = the q / dO tile, both K-major
      hopper::mbar_wait(q_full + s, (it >> 1) & 1);
      hopper::fence_regs(st);
      hopper::fence_regs(dpt);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int b = kk * 16 / L::COLS, c = kk * 16 % L::COLS;
        Wgmma<BQ, 0>::ss(
            st,
            hopper::make_desc(sk + b * L::KV_BOX + c * 2, 16, L::SBO,
                              L::SWIZZLE),
            hopper::make_desc(sq + b * L::Q_BOX + c * 2, 16, L::SBO,
                              L::SWIZZLE),
            kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int b = kk * 16 / L::COLS, c = kk * 16 % L::COLS;
        Wgmma<BQ, 0>::ss(
            dpt,
            hopper::make_desc(sv + b * L::KV_BOX + c * 2, 16, L::SBO,
                              L::SWIZZLE),
            hopper::make_desc(sdo + b * L::Q_BOX + c * 2, 16, L::SBO,
                              L::SWIZZLE),
            kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(st);
      hopper::fence_regs(dpt);

      // P^T = exp2(S^T scale log2e - lse log2e) (0 past Sq and on
      // fully-masked rows: their staged lse is +inf), 0 above the causal
      // diagonal; dS^T = P^T (dP^T - D).  The fragment's column is the q
      // row, so lse and D are read per column pair.
      const bool need_mask = causal && kw0 + 63 > q0 + shift;
      uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r;
          const int col = 8 * (i / 4) + 2 * (lane % 4);
          const float2 lr = *reinterpret_cast<const float2*>(rows + col);
          const float2 dr = *reinterpret_cast<const float2*>(rows + BQ + col);
          float p0 = exp2f(st[i] * scale_log2 - lr.x);
          float p1 = exp2f(st[i + 1] * scale_log2 - lr.y);
          if (need_mask) {
            const int kpos = key + 8 * (r % 2);
            if (kpos > q0 + col + shift) p0 = 0.f;
            if (kpos > q0 + col + 1 + shift) p1 = 0.f;
          }
          pa[kk][r] = hopper::pack_bf16(p0, p1);
          dsa[kk][r] = hopper::pack_bf16(p0 * (dpt[i] - dr.x),
                                         p1 * (dpt[i + 1] - dr.y));
        }

      // dV += P^T dO and dK += dS^T q: A from registers, B = the same
      // dO / q tile MN-major, one 16-row slice and one box per instruction
#pragma unroll
      for (int b = 0; b < L::NBOX; ++b) {
        hopper::fence_regs(dv_acc[b]);
        hopper::fence_regs(dk_acc[b]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int b = 0; b < L::NBOX; ++b) {
          const uint32_t off = b * L::Q_BOX + kk * 16 * L::ROW;
          Wgmma<L::COLS, 1>::rs(
              dv_acc[b], pa[kk],
              hopper::make_desc(sdo + off, L::Q_BOX, L::SBO, L::SWIZZLE), 1);
          Wgmma<L::COLS, 1>::rs(
              dk_acc[b], dsa[kk],
              hopper::make_desc(sq + off, L::Q_BOX, L::SBO, L::SWIZZLE), 1);
        }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < L::NBOX; ++b) {
        hopper::fence_regs(dv_acc[b]);
        hopper::fence_regs(dk_acc[b]);
      }
      hopper::mbar_arrive(q_empty + s);
    }

    // epilogue: dK scale and dV to bf16; keys past Sk are not stored
    const int64_t krow_base = ((int64_t)bb * H + hh) * Sk;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kpos = key + 8 * h;
      if (kpos >= Sk) continue;
      const int64_t off = (krow_base + kpos) * D + 2 * (lane % 4);
#pragma unroll
      for (int b = 0; b < L::NBOX; ++b)
#pragma unroll
        for (int j = 0; j < L::COLS / 8; ++j) {
          const int i = 4 * j + 2 * h;
          const int64_t at = off + b * L::COLS + 8 * j;
          *reinterpret_cast<uint32_t*>(dk + at) = hopper::pack_bf16(
              dk_acc[b][i] * scale, dk_acc[b][i + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + at) =
              hopper::pack_bf16(dv_acc[b][i], dv_acc[b][i + 1]);
        }
    }
  }
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dd,
                       void* dk, void* dv, int B, int H, int Sq, int Sk,
                       const Strides& st, int causal, float scale,
                       cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = hopper::encode_bhsd(&tq, q, B, H, Sq, D, st.q_sb,
                                        st.q_sh, st.q_ss, BQ);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd(&tk, k, B, H, Sk, D, st.k_sb, st.k_sh, st.k_ss,
                              BKV);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd(&tv, v, B, H, Sk, D, st.v_sb, st.v_sh, st.v_ss,
                              BKV);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd(&tdo, dout, B, H, Sq, D, st.o_sb, st.o_sh,
                              st.o_ss, BQ);
  if (err != cudaSuccess) return err;
  static bool smem_set[kMaxDevices] = {};
  err = opt_in_smem(flash_bwd_dkv_wgmma_kernel<D>, Layout<D>::SMEM,
                    smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + BKV - 1) / BKV, H, B);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, THREADS, Layout<D>::SMEM, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Sq, Sk, causal, scale);
  return cudaGetLastError();
}

cudaError_t dkv_dispatch(int D, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* dd,
                         void* dk, void* dv, int B, int H, int Sq, int Sk,
                         const Strides& st, int causal, float scale,
                         cudaStream_t s) {
  switch (D) {
    case 32:
      return launch_dkv<32>(q, k, v, dout, lse, dd, dk, dv, B, H, Sq, Sk, st,
                            causal, scale, s);
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, dd, dk, dv, B, H, Sq, Sk, st,
                            causal, scale, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, dd, dk, dv, B, H, Sq, Sk, st,
                             causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// dQ shared memory: q and dO (resident), two stages of K and two of V,
// each as D / COLS boxes of [rows][COLS] bf16; then the mbarriers
template <int D>
struct DqLayout {
  static constexpr int COLS = hopper::box_cols(D);
  static constexpr int NBOX = D / COLS;
  static constexpr int SWIZZLE =
      COLS == 64 ? hopper::kSwizzle128B : hopper::kSwizzle64B;
  static constexpr uint32_t ROW = COLS * 2;        // bytes of a box row
  static constexpr uint32_t SBO = 8 * ROW;         // next 8-row group
  static constexpr uint32_t Q_BOX = DQ_BQ * ROW;
  static constexpr uint32_t KV_BOX = DQ_BK * ROW;
  static constexpr uint32_t Q_BYTES = NBOX * Q_BOX;
  static constexpr uint32_t KV_BYTES = NBOX * KV_BOX;
  static constexpr uint32_t Q_OFF = 0;
  static constexpr uint32_t DO_OFF = Q_BYTES;
  static constexpr uint32_t K_OFF = 2 * Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + 2 * KV_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + 2 * KV_BYTES;
  static constexpr size_t SMEM = BAR_OFF + 7 * 8 + 1024;  // + align slack
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ dd,
                          __nv_bfloat16* __restrict__ dq, int H, int Sq,
                          int Sk, int causal, float scale) {
  using L = DqLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_full = bars;        // q and dO landed
  uint64_t* k_full = bars + 1;    // [2] the stage's K tile landed
  uint64_t* v_full = bars + 3;    // [2] the stage's V tile landed
  uint64_t* kv_empty = bars + 5;  // [2] both consumers are done with it

  const int q0 = blockIdx.x * DQ_BQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int shift = Sk - Sq;  // bottom-right causal alignment
  int n_tiles = (Sk + DQ_BK - 1) / DQ_BK;
  if (causal) {
    // keys visible to the CTA's last row (attention.py:273)
    const int hi = q0 + DQ_BQ + shift;
    n_tiles = min(n_tiles, hi <= 0 ? 0 : (hi + DQ_BK - 1) / DQ_BK);
  }

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(k_full + s, 1);
      hopper::mbar_init(v_full + s, 1);
      hopper::mbar_init(kv_empty + s, 2 * 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread starts every TMA load
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256 && n_tiles > 0) {
      hopper::mbar_arrive_expect_tx(q_full, 2 * L::Q_BYTES);
      for (int b = 0; b < L::NBOX; ++b) {
        hopper::tma_load_4d(smem + L::Q_OFF + b * L::Q_BOX, &tq, q_full,
                            b * L::COLS, q0, hh, bb);
        hopper::tma_load_4d(smem + L::DO_OFF + b * L::Q_BOX, &tdo, q_full,
                            b * L::COLS, q0, hh, bb);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t & 1;
        // stage s last held tile t - 2: wait for its release
        if (t >= 2) hopper::mbar_wait(kv_empty + s, ((t >> 1) + 1) & 1);
        uint8_t* sk = smem + L::K_OFF + s * L::KV_BYTES;
        uint8_t* sv = smem + L::V_OFF + s * L::KV_BYTES;
        hopper::mbar_arrive_expect_tx(k_full + s, L::KV_BYTES);
        for (int b = 0; b < L::NBOX; ++b)
          hopper::tma_load_4d(sk + b * L::KV_BOX, &tk, k_full + s,
                              b * L::COLS, t * DQ_BK, hh, bb);
        hopper::mbar_arrive_expect_tx(v_full + s, L::KV_BYTES);
        for (int b = 0; b < L::NBOX; ++b)
          hopper::tma_load_4d(sv + b * L::KV_BOX, &tv, v_full + s,
                              b * L::COLS, t * DQ_BK, hh, bb);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    constexpr int SN = DQ_BK / 2;     // S / dP fragment: 32 fp32
    constexpr int ON = L::COLS / 2;   // dQ fragment per box
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int qw0 = q0 + 64 * wg;                      // first row
    const int row = qw0 + 16 * (tid / 32) + lane / 4;  // rows row, row + 8
    const uint8_t* sq = smem + L::Q_OFF + 64 * wg * L::ROW;
    const uint8_t* sdo = smem + L::DO_OFF + 64 * wg * L::ROW;
    const float scale_log2 = scale * kLog2e;
    const int64_t row_base = ((int64_t)bb * H + hh) * Sq;

    // lse in log2 units (+inf past Sq and on fully-masked rows: P = 0
    // there) and D of the thread's two rows
    float lse2[2], drow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = row + 8 * h;
      const float lv = qpos < Sq ? lse[row_base + qpos] : -INFINITY;
      lse2[h] = lv == -INFINITY ? INFINITY : lv * kLog2e;
      drow[h] = qpos < Sq ? dd[row_base + qpos] : 0.f;
    }

    float dq_acc[L::NBOX][ON];
#pragma unroll
    for (int b = 0; b < L::NBOX; ++b)
#pragma unroll
      for (int i = 0; i < ON; ++i) dq_acc[b][i] = 0.f;
    float sacc[SN], dpacc[SN];
#pragma unroll
    for (int i = 0; i < SN; ++i) sacc[i] = dpacc[i] = 0.f;

    if (n_tiles > 0) hopper::mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t & 1;
      const uint32_t phase = (t >> 1) & 1;
      const int k0 = t * DQ_BK;
      const uint8_t* sk = smem + L::K_OFF + s * L::KV_BYTES;
      const uint8_t* sv = smem + L::V_OFF + s * L::KV_BYTES;

      // S = q k^T, then dP = dO v^T: A = the warpgroup's q / dO rows,
      // B = the k / v tile, all K-major
      hopper::mbar_wait(k_full + s, phase);
      hopper::fence_regs(sacc);
      hopper::fence_regs(dpacc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int b = kk * 16 / L::COLS, c = kk * 16 % L::COLS;
        Wgmma<DQ_BK, 0>::ss(
            sacc,
            hopper::make_desc(sq + b * L::Q_BOX + c * 2, 16, L::SBO,
                              L::SWIZZLE),
            hopper::make_desc(sk + b * L::KV_BOX + c * 2, 16, L::SBO,
                              L::SWIZZLE),
            kk > 0);
      }
      hopper::wgmma_commit();
      hopper::mbar_wait(v_full + s, phase);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int b = kk * 16 / L::COLS, c = kk * 16 % L::COLS;
        Wgmma<DQ_BK, 0>::ss(
            dpacc,
            hopper::make_desc(sdo + b * L::Q_BOX + c * 2, 16, L::SBO,
                              L::SWIZZLE),
            hopper::make_desc(sv + b * L::KV_BOX + c * 2, 16, L::SBO,
                              L::SWIZZLE),
            kk > 0);
      }
      hopper::wgmma_commit();

      // P = exp2(S scale log2e - lse log2e) while dP is in flight; keys
      // past Sk (zero-filled by TMA) and above the causal diagonal -> 0
      hopper::wgmma_wait<1>();
      hopper::fence_regs(sacc);
      const bool need_mask =
          k0 + DQ_BK > Sk || (causal && k0 + DQ_BK - 1 > qw0 + shift);
#pragma unroll
      for (int i = 0; i < SN; ++i) {
        const int h = (i / 2) % 2;
        float p = exp2f(sacc[i] * scale_log2 - lse2[h]);
        if (need_mask) {
          const int kpos = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
          if (kpos >= Sk || (causal && kpos > row + 8 * h + shift)) p = 0.f;
        }
        sacc[i] = p;
      }

      // dS = P (dP - D), rounded to bf16 as the register A operand of
      // dQ += dS k (the TPU kernel's `ds.astype(ks.dtype)`)
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dpacc);
      uint32_t dsa[DQ_BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < DQ_BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r, h = r % 2;
          dsa[kk][r] = hopper::pack_bf16(sacc[i] * (dpacc[i] - drow[h]),
                                         sacc[i + 1] * (dpacc[i + 1] - drow[h]));
        }

      // dQ += dS k: A from registers, B = the same k tile MN-major, one
      // 16-key slice and one box per instruction
#pragma unroll
      for (int b = 0; b < L::NBOX; ++b) hopper::fence_regs(dq_acc[b]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_BK / 16; ++kk)
#pragma unroll
        for (int b = 0; b < L::NBOX; ++b)
          Wgmma<L::COLS, 1>::rs(
              dq_acc[b], dsa[kk],
              hopper::make_desc(sk + b * L::KV_BOX + kk * 16 * L::ROW,
                                L::KV_BOX, L::SBO, L::SWIZZLE),
              1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < L::NBOX; ++b) hopper::fence_regs(dq_acc[b]);
      hopper::mbar_arrive(kv_empty + s);
    }

    // epilogue: dQ scale to bf16; rows past Sq are not stored
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = row + 8 * h;
      if (qpos >= Sq) continue;
      const int64_t off = (row_base + qpos) * D + 2 * (lane % 4);
#pragma unroll
      for (int b = 0; b < L::NBOX; ++b)
#pragma unroll
        for (int j = 0; j < L::COLS / 8; ++j) {
          const int i = 4 * j + 2 * h;
          *reinterpret_cast<uint32_t*>(dq + off + b * L::COLS + 8 * j) =
              hopper::pack_bf16(dq_acc[b][i] * scale,
                                dq_acc[b][i + 1] * scale);
        }
    }
  }
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dd,
                      void* dq, int B, int H, int Sq, int Sk,
                      const Strides& st, int causal, float scale,
                      cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = hopper::encode_bhsd(&tq, q, B, H, Sq, D, st.q_sb,
                                        st.q_sh, st.q_ss, DQ_BQ);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd(&tk, k, B, H, Sk, D, st.k_sb, st.k_sh, st.k_ss,
                              DQ_BK);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd(&tv, v, B, H, Sk, D, st.v_sb, st.v_sh, st.v_ss,
                              DQ_BK);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd(&tdo, dout, B, H, Sq, D, st.o_sb, st.o_sh,
                              st.o_ss, DQ_BQ);
  if (err != cudaSuccess) return err;
  static bool smem_set[kMaxDevices] = {};
  err = opt_in_smem(flash_bwd_dq_wgmma_kernel<D>, DqLayout<D>::SMEM,
                    smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + DQ_BQ - 1) / DQ_BQ, H, B);
  flash_bwd_dq_wgmma_kernel<D><<<grid, THREADS, DqLayout<D>::SMEM, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<__nv_bfloat16*>(dq), H, Sq,
      Sk, causal, scale);
  return cudaGetLastError();
}

cudaError_t dq_dispatch(int D, const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* dd,
                        void* dq, int B, int H, int Sq, int Sk,
                        const Strides& st, int causal, float scale,
                        cudaStream_t s) {
  switch (D) {
    case 32:
      return launch_dq<32>(q, k, v, dout, lse, dd, dq, B, H, Sq, Sk, st,
                           causal, scale, s);
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, dd, dq, B, H, Sq, Sk, st,
                           causal, scale, s);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, dd, dq, B, H, Sq, Sk, st,
                            causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace wg

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
// dO: batch, head, sequence; the head dim must be contiguous (bf16: the
// base addresses 16-byte aligned and the byte strides multiples of 16, as
// TMA needs).  lse and D
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
    err = dq_dispatch_fp32(D, q, k, v, dout, lse, dd, dq, B, H, Sq, Sk, st,
                           causal, scale, s);
  else if (dtype == 1)
    err = wg::dq_dispatch(D, q, k, v, dout, lse, dd, dq, B, H, Sq, Sk, st,
                          causal, scale, s);
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
    err = dkv_dispatch_fp32(D, q, k, v, dout, lse, dd, dk, dv, B, H, Sq, Sk,
                            st, causal, scale, s);
  else if (dtype == 1)
    err = wg::dkv_dispatch(D, q, k, v, dout, lse, dd, dk, dv, B, H, Sq, Sk,
                           st, causal, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* flash_attn_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
