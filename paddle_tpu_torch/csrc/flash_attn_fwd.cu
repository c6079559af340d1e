// Flash-attention forward for NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces paddle_tpu/ops/attention.py::_flash_fwd_kernel, the Pallas TPU
// kernel that paddle_tpu's `flash_attention` op launches.  It computes the
// same function: out = softmax(scale * q k^T [causal mask]) v over
// [B, H, S, D] tensors, with an online (streaming) softmax so the [Sq, Sk]
// score matrix never reaches device memory, plus the per-row logsumexp
// `lse` [B, H, Sq] (fp32) that a blockwise backward needs.
//
// Semantics held equal to the TPU kernel:
//   * the running max, running sum and output accumulator are fp32; the
//     scale is folded into the fp32 scores;
//   * the causal mask is aligned bottom-right (query i sees keys
//     <= i + Sk - Sq, as `_causal_mask_block`), and key tiles wholly above
//     the diagonal are skipped;
//   * a fully-masked row (causal with Sq > Sk) is written as 0 with
//     lse = -inf, like the TPU flash kernel (not like the score-matrix
//     reference, which averages V there);
//   * in bf16 and fp16, P is rounded to the input dtype before the P.v
//     product (the TPU kernel's `p.astype(vs.dtype)`) while the row sum
//     stays on the fp32 P;
//   * `out` is written in the input dtype (fp32, bf16 or fp16).
// Both kernels take any Sq and Sk (ragged tiles are masked, so the port
// needs no counterpart of the TPU tiling fallback `_fit_block`) and read
// q, k, v through batch/head/sequence strides, so the [B, H, S, D] view
// that transpose2 produces needs no copy; D is contiguous.  out and lse
// are written contiguous.
//
// The kernels, dispatched by dtype and head dim in the C entry at the end:
//
// bf16 (the AMP training path) and fp16: `flash_fwd_wgmma_kernel<D, T>`,
//   one source for both 16-bit types (they differ in the wgmma type
//   suffix, the tensor-map element type and the packing of P and O).
//   Bound on an H100 at the training shape B = 8, H = 12, S = 512,
//   D = 64: 6.4 GFLOP on the 989 TFLOP/s tensor cores (6.5 us) against
//   25 MB of q, k, v, out and lse at 3.35 TB/s (7.6 us), so the bytes
//   bound it.  The tensor cores are reached only through wgmma, and wgmma
//   wants its operands in shared memory in the swizzled layout that TMA
//   writes, so:
//   * one CTA per (128 query rows, head, batch) with three warpgroups:
//     warpgroups 0 and 1 each own 64 query rows (consumers), one warp of
//     warpgroup 2 starts every TMA load (producer).  `setmaxnreg` moves
//     registers from the producer (24) to the consumers (240);
//   * the producer loads the q tile once, then streams K/V tiles of
//     BK = 128 keys through a 2-stage ring of shared-memory buffers, each
//     stage guarded by "full" mbarriers (TMA transaction bytes; K and V
//     separately, so Q K^T starts before V has landed) and an "empty"
//     mbarrier (all 256 consumer threads arrive when their wgmma reads of
//     the stage are done).  A tile's load overlaps the previous tile's
//     math.  BK = 128 halves the barrier round trips and the O rescales
//     per key against BK = 64, and the 64-register S fragment plus O (32
//     or 64) and P (32) stay inside the consumers' 240 registers; two
//     stages of K and V are 128 KB at D = 128;
//   * S = Q K^T is one wgmma m64n128k16 per 16 columns of D (A = the
//     warpgroup's q rows, B = the k tile, both K-major in shared memory);
//     the online softmax runs on the accumulator fragment in registers,
//     a row's 32 values spread over a quad of 4 lanes and reduced with
//     xor-shuffles 1 and 2; scores are kept in log2 units (exp2f);
//   * P is packed to T in registers and is the register A operand of
//     O += P v (B = the v tile read MN-major through the descriptor, one
//     64-column swizzle row per wgmma); O stays in registers;
//   * keys past Sk are masked in registers (TMA zero-fills them, and a
//     zero score is not -inf), as are keys above the causal diagonal;
//     rows past Sq are computed on zero-filled q and not stored;
//   * D = 128 rows (256 bytes) are loaded as two 64-column boxes; D = 32
//     uses 64-byte swizzle.
//   At the training shape the grid is 4 x 12 x 8 = 384 CTAs of 384
//   threads, one CTA per SM (registers), 2.9 waves on 132 SMs.
//   D = 256 (and 129-255, zero-padded by the wrapper): the same kernel
//   with BK = 64.  The D = 128 layout (BK = 128, two K/V stages) would
//   need 64 KB of q and 4 x 64 KB of K/V, more than the 232,448 bytes a
//   block may opt in to; with BK = 64 the q tile (4 boxes, 65,536 B) and
//   two stages of K and of V (32,768 B each) take 197,688 B with the
//   barriers and the alignment slack, one CTA per SM.  Per consumer
//   thread: O 64 x 256 fp32 over 128 threads = 128 registers, S 32, P
//   packed 16, inside the 240 of `setmaxnreg`.  S = q k^T is m64n64k16
//   over 16 k-steps (K-major, from the 4 boxes); O += P v is four n64
//   products per k16 slice, one per 64-column box of v read MN-major, as
//   D = 128 issues two.  Bound at [8, 8, 512, 256]: 17.2 GFLOP take
//   17.4 us on the tensor cores, 67 MB of 16-bit inputs and outputs take
//   20.1 us, so the bytes bound it; the grid is 4 x 8 x 8 = 256 CTAs, two
//   waves on 132 SMs.  A view TMA refuses is copied by the wrapper, as at
//   D <= 128.
//   D = 256 n, n >= 2 (the split-D route; 257-511 are zero-padded to 512
//   by the wrapper): `flash_fwd_split_d_wgmma_kernel<T>`, one kernel for
//   every n.  A resident 128-row q tile is 128 n KB (192 KB at n = 3), so
//   the D = 256 layout cannot grow with D.  Instead:
//   * a grid dimension over 256-column chunks of O (folded into
//     blockIdx.x, the chunks of one q tile adjacent): each CTA owns 128
//     query rows and one chunk, 64 x 256 fp32 of O per consumer
//     warpgroup, 128 registers, as at D = 256;
//   * the reduction over D runs on the tensor cores: per key tile of
//     BK = 64 the producer streams the 4n (q box, k box) pairs of 64
//     columns (16,384 + 8,192 B) through a ring of 6 stages, and the
//     consumers accumulate S in registers with m64n64k16 wgmmas, one
//     commit group per pair, releasing a stage once the next pair's group
//     is in flight (wgmma wait 1); then the CTA's own four V boxes (two
//     V stages of 32,768 B) give O += P v as at D = 256.  The ring and
//     the V stages take 214,144 B with the barriers and the slack,
//     whatever n;
//   * every chunk's CTA computes S with the same instructions in the same
//     order, so m, l and lse agree to the bit across the chunks and the
//     normalised chunks of O fit together; only chunk 0 writes lse.
//   The price: each chunk's CTA recomputes the scores over all of D, n
//   times the q k^T work (at n = 2, 1.5x the forward's tensor work), and
//   q is re-read from L2 for every key tile while each CTA reads k over
//   all of D.  Bound at [8, 4, 512, 512]: 17.2 GFLOP of real work take
//   17.4 us on the tensor cores (25.8 GFLOP, 26.1 us, with the recompute),
//   67 MB of inputs and outputs take 20.1 us, so the bytes bound it; the
//   grid is 4 x 2 x 4 x 8 = 256 CTAs, which read about 0.47 GB from L2
//   per call (per key tile and CTA 128 KB of q, 64 KB of k, 32 KB of v).
//   Semantics (bottom-right causal mask with tiles above the diagonal
//   skipped, fully-masked rows 0 with lse -inf, P rounded to T before
//   P v) are those of the D <= 256 kernel.
//
// fp32 (serving, fp32 training): `flash_fwd_tf32_kernel`, 3xTF32 on
//   the tensor cores.  Bound at S = 512, D = 64: 6.4 GFLOP over the 67
//   TFLOP/s of fp32 FMA is 96 us, ~6x the time of moving the bytes once,
//   so a kernel on the FMA units is held to that.  The tensor cores take
//   fp32 only as TF32 (10-bit mantissa), so each operand x is split into
//   hi = x with its 13 low mantissa bits cleared and lo = x - hi (exact),
//   and each product is taken as lo*hi + hi*lo + hi*hi, accumulated in
//   fp32 (the 3xTF32 of CUTLASS's OpMultiplyAddFastF32): the dropped
//   lo*lo term and lo's truncation to TF32 leave a relative error of
//   ~2^-20 per product, at the order of an fp32 rounding and not TF32's
//   three digits.  The split is one AND and one subtract: the tensor
//   cores read only a TF32 operand's top 19 bits, so no conversion
//   instruction is needed (each warp splits every K and V element it
//   reads, so the split's cost is paid 4 times per tile).  Three TF32
//   products at 495 TFLOP/s bound the same work at 39 us.
//   `mma.sync.m16n8k8` rather than wgmma, because wgmma's TF32 B
//   operand must be K-major and v is MN-major for P v; mma.sync
//   fragments are loaded per thread, so V needs no transposed copy.
//   * one CTA of 4 warps per (64 query rows, head, batch), 16 rows per
//     warp; the warp's q fragments are loaded once and kept raw for the
//     whole K/V loop, in registers (at D = 128 they would spill, so there
//     they wait in the thread's own shared-memory slots), and split per
//     use;
//   * K/V tiles of 64 keys are double-buffered in shared memory by
//     cp.async (16-byte copies where the view's addresses allow it, else
//     4-byte ones; rows past Sk zero-filled), rows padded by 4 floats so
//     the fragment loads hit 32 distinct banks;
//   * S = q k^T and the online softmax run on the C fragment (a row's
//     values over a quad of 4 lanes, reduced with xor-shuffles 1 and 2;
//     log2 units, exp2f);
//   * P's C fragment (columns 2(l%4), +1 of each 8-key tile) is not the
//     layout of a TF32 A fragment (columns l%4, l%4 + 4).  Rather than
//     re-lay it with shuffles, the P v product takes the tile's keys in
//     the permuted order 0, 2, 4, 6, 1, 3, 5, 7: A = P's fragment as it
//     stands, and B reads v rows 2(l%4) and 2(l%4) + 1 to match.  A sum
//     over keys does not depend on their order;
//   * keys past Sk and above the causal diagonal are masked to -inf;
//     rows past Sq are computed on zero q and not stored.
//   The split, the m16n8k8 products, the cp.async copies and the
//   resident q fragments are in tf32.cuh, shared with the fp32 backward
//   kernels.
//   D = 256 n, n >= 1 (the split-D route; 129-255 are zero-padded to 256,
//   257-511 to 512 by the wrapper): `flash_fwd_split_d_tf32_kernel`, the
//   same 3xTF32 products on the structure of the 16-bit split-D kernel
//   above.  A resident fp32 q tile would be 128 n KB (at n = 1 already
//   more than half of shared memory beside K and V), so:
//   * a CTA of 8 warps owns 128 query rows (16 a warp) and one 256-column
//     chunk of O (the chunk folded into blockIdx.x): 16 x 256 fp32 of O a
//     warp, 128 registers a thread;
//   * one stream of steps through an 8-stage ring that TMA fills (24 KB a
//     stage, 197,696 B in all with the barriers and the alignment slack,
//     whatever n): per key tile of 64, the 8n score steps, each a q box
//     (128 rows) and a k box (64 rows) of 32 fp32 columns, S accumulating
//     over all of D in registers; then 4 V steps of 16 keys x the CTA's 256 columns (8
//     boxes), O += P v with P's C fragment as the A operand (the key order
//     of the D <= 128 kernel).  A V step splits the P fragments of its own
//     16 keys only: with 64 columns of all 64 keys a step, the splits the
//     compiler kept across steps took the kernel to 255 registers and
//     spilled;
//   * the boxes land in 128-byte swizzle (a 32-column fp32 row is 128
//     bytes; 16-byte chunk c of row r at chunk c ^ (r % 8)), so the
//     fragment loads of q, k (rows g mod 8: chunk 2 ks ^ g) and v (rows
//     2 t4 mod 8: chunk (2 (jj % 4) + g / 4) ^ 2 t4) hit 32 distinct banks;
//   * per step: every thread waits on the stage's full barrier, one
//     __syncthreads, then thread 0 starts the step STAGES - 1 ahead into
//     the stage the step before left.  Streamed by cp.async instead
//     (16-byte copies issued by every thread) the loads did not overlap
//     the products on an H100 (a build without the loads and one without
//     the products each took well under the full time, together about
//     all of it), and the kernel ran 1.6x slower at [8, 4, 512, 512];
//   * every chunk's CTA issues the same products in the same order, so
//     m, l and lse agree to the bit across the chunks; only chunk 0 writes
//     lse.  In fp32 the TPU kernel's `p.astype(vs.dtype)` is the identity:
//     P is not rounded;
//   * TMA takes 16-byte aligned views with byte strides that are multiples
//     of 16: the wrapper copies another view first, as in bf16.
//   Bound at [8, 4, 512, 512]: 17.2 GFLOP of real work as three TF32
//   products each take 0.104 ms at 495 TFLOP/s; with the scores
//   recomputed per chunk (n times the q k^T work) 0.156 ms; 134 MB of
//   inputs and outputs take 0.040 ms, so the operations bound it.  128-row
//   CTAs read each k and V box for twice the rows of 64-row ones (a
//   4-warp, 64-row layout was slower on an H100, fed by cp.async); the
//   grid is 4 x 2 x 4 x 8 = 256 CTAs, one per SM.  At n = 1 (D = 256) a
//   key tile is 8 score steps and 4 V steps and no score is recomputed;
//   bound at [8, 8, 512, 256] 0.104 ms (3xTF32 operations), the grid
//   4 x 8 x 8 = 256 CTAs.
//
// Built by paddle_tpu_torch/core/kernel_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through the plain C interface at the end of this file.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// ---------------------------------------------------------------------------
// fp32: 3xTF32 on the tensor cores (mma.sync m16n8k8)
// ---------------------------------------------------------------------------
namespace tf32 {

using namespace tf32x3;

constexpr int BQ = 64;        // query rows per CTA: 16 per warp
constexpr int BK = 64;        // keys per K/V tile
constexpr int THREADS = 128;
constexpr int PAD = 4;        // floats of padding per shared-memory row

// two stages of the K tile and of the V tile, [BK][D + PAD] fp32 each;
// at D = 128 also the q fragments, D / 2 floats per thread
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(4 * BK * (D + PAD) + (D > 64 ? THREADS * D / 2 : 0));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int H, int Sq, int Sk,
                      int64_t q_sb, int64_t q_sh, int64_t q_ss,
                      int64_t k_sb, int64_t k_sh, int64_t k_ss,
                      int64_t v_sb, int64_t v_sh, int64_t v_ss, int causal,
                      float scale_log2, int vec16) {
  constexpr int SD = D + PAD;   // shared row stride (floats)
  constexpr int KS = D / 8;     // k8 steps of q k^T / 8-column tiles of O
  constexpr int NT = BK / 8;    // 8-key tiles of S / k8 steps of P v
  // q k^T over the head dim: fully unrolled where q sits in registers;
  // at D = 128 (q in shared memory) partly, which keeps it from spilling
  constexpr int KS_UNROLL = D <= 64 ? KS : 4;
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  // stage s: K at smem + 2 s BK SD, V right after it; then the q slots

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const float* kb = k + bb * k_sb + hh * k_sh;
  const float* vb = v + bb * v_sb + hh * v_sh;
  const int rw0 = q0 + 16 * warp;  // the warp's first row
  const int row = rw0 + g;         // the thread's rows: row, row + 8

  const int shift = Sk - Sq;  // bottom-right causal alignment
  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {
    const int hi = q0 + BQ + shift;  // keys visible to the CTA's last row
    n_tiles = min(n_tiles, hi <= 0 ? 0 : (hi + BK - 1) / BK);
  }
  if (n_tiles > 0) {
    load_rows<BK, D, PAD, THREADS>(smem, kb, k_ss, 0, Sk, vec16);
    load_rows<BK, D, PAD, THREADS>(smem + BK * SD, vb, v_ss, 0, Sk, vec16);
  }
  cp_async_commit();

  // A fragment of m16n8k8 (TF32): a0 (g, t4), a1 (g + 8, t4),
  // a2 (g, t4 + 4), a3 (g + 8, t4 + 4); rows past Sq are zero
  RowFrags<D, THREADS> qf(smem + 4 * BK * SD);
  {
    const float* qb = q + bb * q_sb + hh * q_sh;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row + 8 * (i % 2), c = 8 * ks + t4 + 4 * (i / 2);
        qf.set(ks, i, r < Sq ? __ldg(qb + (int64_t)r * q_ss + c) : 0.f);
      }
  }

  float o_acc[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o_acc[j][i] = 0.f;
  // running max (log2 units) and this thread's share of the row sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    if (t + 1 < n_tiles) {
      float* nxt = smem + ((t + 1) & 1) * 2 * BK * SD;
      load_rows<BK, D, PAD, THREADS>(nxt, kb, k_ss, k0 + BK, Sk, vec16);
      load_rows<BK, D, PAD, THREADS>(nxt + BK * SD, vb, v_ss, k0 + BK, Sk, vec16);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t has landed for every thread
    const float* sK = smem + (t & 1) * 2 * BK * SD;
    const float* sV = sK + BK * SD;

    // S = q k^T.  B fragment: b0 (k = t4, n = g), b1 (k = t4 + 4), i.e.
    // k row 8 nt + g, columns 8 ks + t4 and + 4
    float sacc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sacc[nt][i] = 0.f;
#pragma unroll KS_UNROLL
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ahi[4], alo[4];
      qf.get(ks, ahi, alo);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* kr = sK + (8 * nt + g) * SD + 8 * ks + t4;
        uint32_t bhi[2], blo[2];
        split_b(kr[0], kr[4], bhi, blo);
        mma3(sacc[nt], ahi, alo, bhi, blo);
      }
    }

    // scale to log2 units; mask keys past Sk (zero-filled) and above the
    // causal diagonal.  C fragment: c0, c1 (g, 2 t4, +1), c2, c3 (g + 8)
    const bool need_mask =
        k0 + BK > Sk || (causal && k0 + BK - 1 > rw0 + shift);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = sacc[nt][i] * scale_log2;
        if (need_mask) {
          const int kpos = k0 + 8 * nt + 2 * t4 + (i % 2);
          const int qpos = row + 8 * (i / 2);
          if (kpos >= Sk || (causal && kpos > qpos + shift)) x = -INFINITY;
        }
        sacc[nt][i] = x;
      }

    // online softmax, rows row (h = 0) and row + 8 (h = 1)
    float alpha[2], safe[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mx = fmaxf(mx, fmaxf(sacc[nt][2 * h], sacc[nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row masked so far keeps m = -inf and P = exp2(-inf - 0) = 0
      safe[h] = mx == -INFINITY ? 0.f : mx;
      alpha[h] = m[h] == -INFINITY ? 0.f : exp2f(m[h] - safe[h]);
      m[h] = mx;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(sacc[nt][i] - safe[i / 2]);
        psum[i / 2] += p;
        sacc[nt][i] = p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + psum[h];
#pragma unroll
    for (int j = 0; j < KS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) o_acc[j][i] *= alpha[i / 2];

    // O += P v over the keys of 8-key tile nt taken in the order
    // 0, 2, 4, 6, 1, 3, 5, 7: A k-index t4 is key 2 t4 (P's c0 / c2) and
    // k-index t4 + 4 is key 2 t4 + 1 (c1 / c3); B reads v rows
    // 8 nt + 2 t4 (b0) and + 1 (b1), column 8 j + g
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t ahi[4], alo[4];
      split_c_as_a(sacc[nt], ahi, alo);
      const float* vr = sV + (8 * nt + 2 * t4) * SD + g;
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        uint32_t bhi[2], blo[2];
        split_b(vr[8 * j], vr[SD + 8 * j], bhi, blo);
        mma3(o_acc[j], ahi, alo, bhi, blo);
      }
    }
    __syncthreads();  // stage t & 1 is refilled with tile t + 2
  }

  // epilogue: O / l, lse = (m + log2 l) ln 2; rows past Sq are not stored
  const int64_t row_base = ((int64_t)bb * H + hh) * Sq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int qpos = row + 8 * h;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    float* orow = o + (row_base + qpos) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < KS; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) =
          make_float2(o_acc[j][2 * h] / denom, o_acc[j][2 * h + 1] / denom);
    if (t4 == 0)
      lse[row_base + qpos] =
          m[h] == -INFINITY ? -INFINITY : (m[h] + log2f(denom)) * kLn2;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Sq, int Sk,
                   const long long* st, int causal, float scale,
                   cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {};
  const size_t smem = smem_bytes<D>();
  cudaError_t err = opt_in_smem(flash_fwd_tf32_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  // K and V tiles stream by cp.async; q is read per element
  const bool vec16 = rows_16b_aligned(
      {k, v}, {st[3], st[4], st[5], st[6], st[7], st[8]});
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_tf32_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), H, Sq, Sk, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], causal, scale * kLog2e,
      (int)vec16);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 at D = 256 n, n >= 1: the split-D forward.  A CTA of 8 warps owns
// 128 query rows (16 a warp) and one 256-column chunk of O (16 x 256 fp32
// a warp: 128 registers a thread).  One stream of steps runs through a
// ring of STAGES stages that TMA fills: per key tile, the 8n score steps
// (a q box and a k box of 32 columns; S accumulates over all of D) and then
// the 4 V steps (16 keys of the CTA's own V chunk each, O += P v over
// them: each P fragment is split for one step only, and no split is live
// across steps).  Shared memory does not grow with D.
// ---------------------------------------------------------------------------
struct SplitFwd {
  static constexpr int THREADS = 256;
  static constexpr int BQ = 128;           // query rows per CTA, 16 a warp
  static constexpr int BK = 64;            // keys per tile
  static constexpr int CHUNK = 256;        // output columns per CTA
  static constexpr int BOX = 32;           // columns of a box (128 bytes)
  static constexpr int VKEYS = 16;         // keys of a V step
  static constexpr int VSTEPS = BK / VKEYS;
  static constexpr uint32_t Q_BYTES = BQ * BOX * 4;
  static constexpr uint32_t STAGE = Q_BYTES + BK * BOX * 4;  // q and k box
  static constexpr uint32_t VBOX = VKEYS * BOX * 4;  // a V box of a step
  static constexpr int STAGES = 8;
  static constexpr uint32_t BAR_OFF = STAGES * STAGE;
  static constexpr size_t SMEM = BAR_OFF + STAGES * 8 + 1024;  // + align
  static_assert(CHUNK / BOX * VBOX <= STAGE, "a V step must fit a stage");
  static_assert(STAGE % 1024 == 0 && Q_BYTES % 1024 == 0 && VBOX % 1024 == 0,
                "every box must start on a 1024-byte swizzle atom");
  static_assert(SMEM <= hopper::kMaxSmem,
                "split-D forward stages exceed the shared-memory opt-in");
};

__global__ void __launch_bounds__(SplitFwd::THREADS, 1)
flash_fwd_split_d_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              float* __restrict__ o, float* __restrict__ lse,
                              int H, int Sq, int Sk, int n_chunks,
                              int causal, float scale_log2) {
  using L = SplitFwd;
  constexpr int NT = L::BK / 8;        // 8-key tiles of S
  constexpr int VNT = L::VKEYS / 8;    // k8 steps of a V step
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int chunk = blockIdx.x % n_chunks;   // the CTA's output columns
  const int q0 = blockIdx.x / n_chunks * L::BQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int rw0 = q0 + 16 * warp;  // the warp's first row
  const int row = rw0 + g;         // the thread's rows: row, row + 8

  const int shift = Sk - Sq;  // bottom-right causal alignment
  int n_tiles = (Sk + L::BK - 1) / L::BK;
  if (causal) {
    const int hi = q0 + L::BQ + shift;  // keys visible to the CTA's last row
    n_tiles = min(n_tiles, hi <= 0 ? 0 : (hi + L::BK - 1) / L::BK);
  }
  const int nbox = n_chunks * L::CHUNK / L::BOX;  // score steps per tile
  const int per_tile = nbox + L::VSTEPS;
  const int total = n_tiles * per_tile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) hopper::mbar_init(full + s, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // thread 0 starts step i into stage i % STAGES; the stage's barrier
  // completes when the step's boxes have landed (rows past Sq or Sk
  // zero-filled)
  auto issue = [&](int i) {
    if (i >= total) return;
    const int t = i / per_tile, j = i % per_tile, s = i % L::STAGES;
    uint8_t* st = smem + s * L::STAGE;
    if (j < nbox) {
      hopper::mbar_arrive_expect_tx(full + s, L::STAGE);
      hopper::tma_load_4d(st, &tq, full + s, j * L::BOX, q0, hh, bb);
      hopper::tma_load_4d(st + L::Q_BYTES, &tk, full + s, j * L::BOX,
                          t * L::BK, hh, bb);
    } else {
      const int k0 = t * L::BK + (j - nbox) * L::VKEYS;
      hopper::mbar_arrive_expect_tx(full + s, L::CHUNK / L::BOX * L::VBOX);
      for (int b = 0; b < L::CHUNK / L::BOX; ++b)
        hopper::tma_load_4d(st + b * L::VBOX, &tv, full + s,
                            chunk * L::CHUNK + b * L::BOX, k0, hh, bb);
    }
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < L::STAGES - 1; ++i) issue(i);
  // wait for the next step's stage; once every thread is past the step
  // before it, thread 0 refills that step's stage with the step STAGES - 1
  // ahead
  int step = 0;
  auto next = [&]() -> const float* {
    const int s = step % L::STAGES;
    hopper::mbar_wait(full + s, (step / L::STAGES) & 1);
    __syncthreads();
    if (threadIdx.x == 0) issue(step + L::STAGES - 1);
    ++step;
    return reinterpret_cast<const float*>(smem + s * L::STAGE);
  };

  float o_acc[L::CHUNK / 8][4];
#pragma unroll
  for (int j = 0; j < L::CHUNK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o_acc[j][i] = 0.f;
  // running max (log2 units) and this thread's share of the row sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * L::BK;

    // S = q k^T over all of D, box by box, in the same order in every
    // chunk's CTA (so m, l and lse agree to the bit).  A fragment: q rows
    // 16 warp + g (+8), columns 8 ks + t4 (+4); B: k row 8 nt + g.  Each
    // row index is g modulo 8, so in the swizzled boxes columns 8 ks + t4
    // and + 4 sit at c0 + t4 and (c0 ^ 4) + t4 of the row
    float sacc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sacc[nt][i] = 0.f;
    for (int j = 0; j < nbox; ++j) {
      const float* sq = next();
      const float* qa = sq + (16 * warp + g) * L::BOX + t4;
      const float* kb = sq + L::Q_BYTES / 4 + g * L::BOX + t4;
#pragma unroll
      for (int ks = 0; ks < L::BOX / 8; ++ks) {
        const int c0 = ((2 * ks ^ g) & 7) << 2, c1 = c0 ^ 4;
        uint32_t ahi[4], alo[4];
        split(qa[c0], ahi[0], alo[0]);
        split(qa[8 * L::BOX + c0], ahi[1], alo[1]);
        split(qa[c1], ahi[2], alo[2]);
        split(qa[8 * L::BOX + c1], ahi[3], alo[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* kr = kb + 8 * nt * L::BOX;
          uint32_t bhi[2], blo[2];
          split_b(kr[c0], kr[c1], bhi, blo);
          mma3(sacc[nt], ahi, alo, bhi, blo);
        }
      }
    }

    // scale to log2 units; mask keys past Sk (zero-filled) and above the
    // causal diagonal.  C fragment: c0, c1 (g, 2 t4, +1), c2, c3 (g + 8)
    const bool need_mask =
        k0 + L::BK > Sk || (causal && k0 + L::BK - 1 > rw0 + shift);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = sacc[nt][i] * scale_log2;
        if (need_mask) {
          const int kpos = k0 + 8 * nt + 2 * t4 + (i % 2);
          const int qpos = row + 8 * (i / 2);
          if (kpos >= Sk || (causal && kpos > qpos + shift)) x = -INFINITY;
        }
        sacc[nt][i] = x;
      }

    // online softmax, rows row (h = 0) and row + 8 (h = 1); P in fp32
    // (in fp32 the TPU kernel's p.astype(vs.dtype) is the identity)
    float alpha[2], safe[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mx = fmaxf(mx, fmaxf(sacc[nt][2 * h], sacc[nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row masked so far keeps m = -inf and P = exp2(-inf - 0) = 0
      safe[h] = mx == -INFINITY ? 0.f : mx;
      alpha[h] = m[h] == -INFINITY ? 0.f : exp2f(m[h] - safe[h]);
      m[h] = mx;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(sacc[nt][i] - safe[i / 2]);
        psum[i / 2] += p;
        sacc[nt][i] = p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + psum[h];
#pragma unroll
    for (int j = 0; j < L::CHUNK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) o_acc[j][i] *= alpha[i / 2];

    // O += P v, 16 keys a step: keys of 8-key tile n in the order
    // 0, 2, 4, 6, 1, 3, 5, 7 (A = P's C fragment as it stands), B reads v
    // rows 8 n + 2 t4 (b0) and + 1 (b1) of the step, column 8 jj + g (box
    // jj / 4, swizzled)
#pragma unroll
    for (int vs = 0; vs < L::VSTEPS; ++vs) {
      const float* sv = next();
#pragma unroll
      for (int n = 0; n < VNT; ++n) {
        uint32_t ahi[4], alo[4];
        split_c_as_a(sacc[vs * VNT + n], ahi, alo);
        const int r = 8 * n + 2 * t4;
#pragma unroll
        for (int jj = 0; jj < L::CHUNK / 8; ++jj) {
          const float* vb = sv + jj / 4 * (L::VBOX / 4);
          const int c = 8 * (jj % 4) + g;
          uint32_t bhi[2], blo[2];
          split_b(vb[swz128(r, c)], vb[swz128(r + 1, c)], bhi, blo);
          mma3(o_acc[jj], ahi, alo, bhi, blo);
        }
      }
    }
  }

  // epilogue: the chunk's columns of O / l; lse = (m + log2 l) ln 2 from
  // chunk 0 only (every chunk computed the same m and l); rows past Sq
  // are not stored
  const int64_t row_base = ((int64_t)bb * H + hh) * Sq;
  const int64_t d_total = (int64_t)n_chunks * L::CHUNK;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int qpos = row + 8 * h;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    float* orow = o + (row_base + qpos) * d_total + chunk * L::CHUNK + 2 * t4;
#pragma unroll
    for (int j = 0; j < L::CHUNK / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) =
          make_float2(o_acc[j][2 * h] / denom, o_acc[j][2 * h + 1] / denom);
    if (chunk == 0 && t4 == 0)
      lse[row_base + qpos] =
          m[h] == -INFINITY ? -INFINITY : (m[h] + log2f(denom)) * kLn2;
  }
}

cudaError_t launch_split_d(const void* q, const void* k, const void* v,
                           void* o, void* lse, int B, int H, int Sq, int Sk,
                           int D, const long long* st, int causal,
                           float scale, cudaStream_t stream) {
  using L = SplitFwd;
  CUtensorMap tq, tk, tv;
  cudaError_t err = hopper::encode_bhsd<float>(&tq, q, B, H, Sq, D, st[0],
                                               st[1], st[2], L::BQ);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd<float>(&tk, k, B, H, Sk, D, st[3], st[4],
                                     st[5], L::BK);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd<float>(&tv, v, B, H, Sk, D, st[6], st[7],
                                     st[8], L::VKEYS);
  if (err != cudaSuccess) return err;
  static bool smem_set[kMaxDevices] = {};
  err = opt_in_smem(flash_fwd_split_d_tf32_kernel, L::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int n_chunks = D / L::CHUNK;
  dim3 grid((Sq + L::BQ - 1) / L::BQ * n_chunks, H, B);
  flash_fwd_split_d_tf32_kernel<<<grid, L::THREADS, L::SMEM, stream>>>(
      tq, tk, tv, static_cast<float*>(o), static_cast<float*>(lse), H, Sq,
      Sk, n_chunks, causal, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace tf32

// ---------------------------------------------------------------------------
// bf16 and fp16: warp-specialized wgmma kernel (T = __nv_bfloat16, __half)
// ---------------------------------------------------------------------------
namespace wg {

using hopper::Wgmma;

constexpr int BQ = 128;         // query rows per CTA: two consumer warpgroups
constexpr int THREADS = 384;    // warpgroups 0, 1 consume; 2 produces
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

// shared memory: the q tile, then two stages of K and two of V, each as
// D / COLS boxes of [rows][COLS] 16-bit elements, then the mbarriers.
// BK keys per K/V tile: 128 up to D = 128; 64 at D = 256, where 128 keys
// would need 64 KB of q and 4 x 64 KB of K/V stages, more than a block
// may hold
template <int D>
struct Layout {
  static constexpr int BK = D > 128 ? 64 : 128;
  static constexpr int COLS = hopper::box_cols(D);
  static constexpr int NBOX = D / COLS;
  static constexpr int SWIZZLE =
      COLS == 64 ? hopper::kSwizzle128B : hopper::kSwizzle64B;
  static constexpr uint32_t ROW = COLS * 2;        // bytes of a box row
  static constexpr uint32_t SBO = 8 * ROW;         // next 8-row group
  static constexpr uint32_t Q_BOX = BQ * ROW;
  static constexpr uint32_t KV_BOX = BK * ROW;
  static constexpr uint32_t Q_BYTES = NBOX * Q_BOX;
  static constexpr uint32_t KV_BYTES = NBOX * KV_BOX;
  static constexpr uint32_t K_OFF = Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + 2 * KV_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + 2 * KV_BYTES;
  static constexpr size_t SMEM = BAR_OFF + 7 * 8 + 1024;  // + align slack
  static_assert(SMEM <= hopper::kMaxSmem,
                "forward tiles exceed the shared-memory opt-in");
};

template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       T* __restrict__ o,
                       float* __restrict__ lse, int H, int Sq, int Sk,
                       int causal, float scale_log2) {
  using L = Layout<D>;
  constexpr int BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_full = bars;        // the q tile landed
  uint64_t* k_full = bars + 1;    // [2] the stage's K tile landed
  uint64_t* v_full = bars + 3;    // [2] the stage's V tile landed
  uint64_t* kv_empty = bars + 5;  // [2] both consumers are done with it

  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int shift = Sk - Sq;  // bottom-right causal alignment
  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {
    const int hi = q0 + BQ + shift;  // keys visible to the CTA's last row
    n_tiles = min(n_tiles, hi <= 0 ? 0 : (hi + BK - 1) / BK);
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
      hopper::mbar_arrive_expect_tx(q_full, L::Q_BYTES);
      for (int b = 0; b < L::NBOX; ++b)
        hopper::tma_load_4d(smem + b * L::Q_BOX, &tq, q_full, b * L::COLS,
                            q0, hh, bb);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t & 1;
        // stage s last held tile t - 2: wait for its release
        if (t >= 2) hopper::mbar_wait(kv_empty + s, ((t >> 1) + 1) & 1);
        uint8_t* sk = smem + L::K_OFF + s * L::KV_BYTES;
        uint8_t* sv = smem + L::V_OFF + s * L::KV_BYTES;
        hopper::mbar_arrive_expect_tx(k_full + s, L::KV_BYTES);
        for (int b = 0; b < L::NBOX; ++b)
          hopper::tma_load_4d(sk + b * L::KV_BOX, &tk, k_full + s,
                              b * L::COLS, t * BK, hh, bb);
        hopper::mbar_arrive_expect_tx(v_full + s, L::KV_BYTES);
        for (int b = 0; b < L::NBOX; ++b)
          hopper::tma_load_4d(sv + b * L::KV_BOX, &tv, v_full + s,
                              b * L::COLS, t * BK, hh, bb);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    constexpr int SN = BK / 2;        // S fragment: BK / 2 fp32 a thread
    constexpr int ON = L::COLS / 2;   // O fragment per box
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int qw0 = q0 + 64 * wg;               // the warpgroup's first row
    const int row = qw0 + 16 * (tid / 32) + lane / 4;  // rows row, row + 8
    const uint8_t* sq = smem + 64 * wg * L::ROW;  // its rows in box 0

    float o_acc[L::NBOX][ON];
#pragma unroll
    for (int b = 0; b < L::NBOX; ++b)
#pragma unroll
      for (int i = 0; i < ON; ++i) o_acc[b][i] = 0.f;
    float sacc[SN];
#pragma unroll
    for (int i = 0; i < SN; ++i) sacc[i] = 0.f;
    // running max (log2 units) and this thread's share of the row sum
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    if (n_tiles > 0) hopper::mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t & 1;
      const uint32_t phase = (t >> 1) & 1;
      const int k0 = t * BK;
      const uint8_t* sk = smem + L::K_OFF + s * L::KV_BYTES;
      const uint8_t* sv = smem + L::V_OFF + s * L::KV_BYTES;

      // S = q k^T: A = the q rows, B = the k tile, both K-major
      hopper::mbar_wait(k_full + s, phase);
      hopper::fence_regs(sacc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int b = kk * 16 / L::COLS, c = kk * 16 % L::COLS;
        Wgmma<BK, 0, T>::ss(
            sacc,
            hopper::make_desc(sq + b * L::Q_BOX + c * 2, 16, L::SBO,
                              L::SWIZZLE),
            hopper::make_desc(sk + b * L::KV_BOX + c * 2, 16, L::SBO,
                              L::SWIZZLE),
            kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sacc);

      // scale to log2 units; mask keys past Sk (TMA zero-filled them) and
      // above the causal diagonal, on the tiles that have such keys
      const bool need_mask =
          k0 + BK > Sk || (causal && k0 + BK - 1 > qw0 + shift);
#pragma unroll
      for (int i = 0; i < SN; ++i) {
        float x = sacc[i] * scale_log2;
        if (need_mask) {
          const int kpos = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
          const int qpos = row + 8 * ((i / 2) % 2);
          if (kpos >= Sk || (causal && kpos > qpos + shift)) x = -INFINITY;
        }
        sacc[i] = x;
      }

      // online softmax, rows row (h = 0) and row + 8 (h = 1); a row's
      // values sit in the 4 lanes of a quad
      float alpha[2], safe[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = m[h];
#pragma unroll
        for (int i = 0; i < SN; ++i)
          if ((i / 2) % 2 == h) mx = fmaxf(mx, sacc[i]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // a row masked so far keeps m = -inf and P = exp2(-inf - 0) = 0
        safe[h] = mx == -INFINITY ? 0.f : mx;
        alpha[h] = m[h] == -INFINITY ? 0.f : exp2f(m[h] - safe[h]);
        m[h] = mx;
      }
      // P in fp32 for the row sum, packed to T as the A operand of P v
      uint32_t pa[BK / 16][4];
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r, h = r % 2;
          const float p0 = exp2f(sacc[i] - safe[h]);
          const float p1 = exp2f(sacc[i + 1] - safe[h]);
          psum[h] += p0 + p1;
          pa[kk][r] = hopper::pack2<T>(p0, p1);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + psum[h];
#pragma unroll
      for (int b = 0; b < L::NBOX; ++b)
#pragma unroll
        for (int i = 0; i < ON; ++i) o_acc[b][i] *= alpha[(i / 2) % 2];

      // O += P v: A = P from registers, B = the v tile MN-major, one
      // 16-key slice and one box per instruction
      hopper::mbar_wait(v_full + s, phase);
#pragma unroll
      for (int b = 0; b < L::NBOX; ++b) hopper::fence_regs(o_acc[b]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int b = 0; b < L::NBOX; ++b)
          Wgmma<L::COLS, 1, T>::rs(
              o_acc[b], pa[kk],
              hopper::make_desc(sv + b * L::KV_BOX + kk * 16 * L::ROW,
                                L::KV_BOX, L::SBO, L::SWIZZLE),
              1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < L::NBOX; ++b) hopper::fence_regs(o_acc[b]);
      hopper::mbar_arrive(kv_empty + s);
    }

    // epilogue: O / l to T, lse = (m + log2 l) ln 2; rows past Sq are
    // not stored
    const int64_t row_base = ((int64_t)bb * H + hh) * Sq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int qpos = row + 8 * h;
      if (qpos >= Sq) continue;
      const float denom = fmaxf(l[h], 1e-30f);
      const float inv = 1.f / denom;
      T* orow = o + (row_base + qpos) * D + 2 * (lane % 4);
#pragma unroll
      for (int b = 0; b < L::NBOX; ++b)
#pragma unroll
        for (int j = 0; j < L::COLS / 8; ++j) {
          const int i = 4 * j + 2 * h;
          *reinterpret_cast<uint32_t*>(orow + b * L::COLS + 8 * j) =
              hopper::pack2<T>(o_acc[b][i] * inv, o_acc[b][i + 1] * inv);
        }
      if (lane % 4 == 0)
        lse[row_base + qpos] =
            m[h] == -INFINITY ? -INFINITY : (m[h] + log2f(denom)) * kLn2;
    }
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Sq, int Sk,
                   const long long* st, int causal, float scale,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err =
      hopper::encode_bhsd<T>(&tq, q, B, H, Sq, D, st[0], st[1], st[2], BQ);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd<T>(&tk, k, B, H, Sk, D, st[3], st[4], st[5],
                                 Layout<D>::BK);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd<T>(&tv, v, B, H, Sk, D, st[6], st[7], st[8],
                                 Layout<D>::BK);
  if (err != cudaSuccess) return err;
  static bool smem_set[kMaxDevices] = {};
  err = opt_in_smem(flash_fwd_wgmma_kernel<D, T>, Layout<D>::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_wgmma_kernel<D, T><<<grid, THREADS, Layout<D>::SMEM, stream>>>(
      tq, tk, tv, static_cast<T*>(o), static_cast<float*>(lse), H, Sq, Sk,
      causal, scale * kLog2e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 and fp16 at D = 256 n, n >= 2: the split-D forward.  A CTA owns 128
// query rows and one 256-column chunk of O (64 x 256 fp32 per consumer
// warpgroup, 128 registers, as at D = 256).  The scores reduce over all of
// D: (q box, k box) pairs of 64 columns stream by TMA through a ring of
// STAGES stages, so shared memory does not grow with D, and S accumulates
// in registers over the 4n pairs (m64n64k16, one commit group per pair).
// Then the CTA's own four V boxes (two V stages) give O += P v.
// ---------------------------------------------------------------------------
struct SplitLayout {
  static constexpr int BK = 64;        // keys per tile
  static constexpr int CHUNK = 256;    // output columns per CTA
  static constexpr int COLS = 64;      // columns of a box
  static constexpr int OWN = CHUNK / COLS;  // the CTA's V boxes
  static constexpr int STAGES = 6;     // (q box, k box) pairs in flight
  static constexpr uint32_t ROW = COLS * 2;        // bytes of a box row
  static constexpr uint32_t SBO = 8 * ROW;         // next 8-row group
  static constexpr uint32_t Q_BOX = BQ * ROW;      // 16,384
  static constexpr uint32_t K_BOX = BK * ROW;      // 8,192
  static constexpr uint32_t PAIR = Q_BOX + K_BOX;  // one ring stage
  static constexpr uint32_t V_BYTES = OWN * K_BOX; // one V stage
  static constexpr uint32_t V_OFF = STAGES * PAIR;
  static constexpr uint32_t BAR_OFF = V_OFF + 2 * V_BYTES;
  // pair_full, pair_empty per ring stage; v_full, v_empty per V stage
  static constexpr size_t SMEM = BAR_OFF + (2 * STAGES + 4) * 8 + 1024;
  static_assert(SMEM <= hopper::kMaxSmem,
                "split-D forward tiles exceed the shared-memory opt-in");
  static_assert(PAIR % 1024 == 0 && V_BYTES % 1024 == 0,
                "every tile must start on a 1024-byte swizzle atom");
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_split_d_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               T* __restrict__ o, float* __restrict__ lse,
                               int H, int Sq, int Sk, int n_chunks,
                               int causal, float scale_log2) {
  using L = SplitLayout;
  constexpr int BK = L::BK;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* pair_full = bars;                 // [STAGES] q and k box landed
  uint64_t* pair_empty = bars + STAGES;       // [STAGES] both consumers'
                                              // wgmmas read the stage
  uint64_t* v_full = bars + 2 * STAGES;       // [2] the V boxes landed
  uint64_t* v_empty = v_full + 2;             // [2] both consumers done

  const int chunk = blockIdx.x % n_chunks;    // the CTA's output columns
  const int q0 = blockIdx.x / n_chunks * BQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int nbox = n_chunks * L::OWN;         // 64-column boxes of D
  const int shift = Sk - Sq;  // bottom-right causal alignment
  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {
    const int hi = q0 + BQ + shift;  // keys visible to the CTA's last row
    n_tiles = min(n_tiles, hi <= 0 ? 0 : (hi + BK - 1) / BK);
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(pair_full + s, 1);
      hopper::mbar_init(pair_empty + s, 2 * 128);
    }
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(v_full + s, 1);
      hopper::mbar_init(v_empty + s, 2 * 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread starts every TMA load.  Per key tile the
    // CTA's V boxes (V stage t & 1), then the 4n (q box, k box) pairs
    // through the ring; a stage's use u waits for the release of use u - 1
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256 && n_tiles > 0) {
      int slot = 0, use = 0;
      for (int t = 0; t < n_tiles; ++t) {
        const int vs = t & 1;
        if (t >= 2) hopper::mbar_wait(v_empty + vs, ((t >> 1) + 1) & 1);
        uint8_t* sv = smem + L::V_OFF + vs * L::V_BYTES;
        hopper::mbar_arrive_expect_tx(v_full + vs, L::V_BYTES);
        for (int b = 0; b < L::OWN; ++b)
          hopper::tma_load_4d(sv + b * L::K_BOX, &tv, v_full + vs,
                              chunk * L::CHUNK + b * L::COLS, t * BK, hh, bb);
        for (int j = 0; j < nbox; ++j) {
          if (use > 0) hopper::mbar_wait(pair_empty + slot, (use - 1) & 1);
          uint8_t* sp = smem + slot * L::PAIR;
          hopper::mbar_arrive_expect_tx(pair_full + slot, L::PAIR);
          hopper::tma_load_4d(sp, &tq, pair_full + slot, j * L::COLS, q0,
                              hh, bb);
          hopper::tma_load_4d(sp + L::Q_BOX, &tk, pair_full + slot,
                              j * L::COLS, t * BK, hh, bb);
          if (++slot == STAGES) {
            slot = 0;
            ++use;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    constexpr int SN = BK / 2;        // S fragment: 32 fp32 a thread
    constexpr int ON = L::COLS / 2;   // O fragment per box
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int qw0 = q0 + 64 * wg;               // the warpgroup's first row
    const int row = qw0 + 16 * (tid / 32) + lane / 4;  // rows row, row + 8
    const uint32_t q_rows = 64 * wg * L::ROW;   // its rows in a q box

    float o_acc[L::OWN][ON];
#pragma unroll
    for (int b = 0; b < L::OWN; ++b)
#pragma unroll
      for (int i = 0; i < ON; ++i) o_acc[b][i] = 0.f;
    float sacc[SN];
#pragma unroll
    for (int i = 0; i < SN; ++i) sacc[i] = 0.f;
    // running max (log2 units) and this thread's share of the row sum
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    int slot = 0;
    uint32_t phase = 0;  // parity of the ring's current use
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * BK;

      // S = q k^T over the 4n pairs, in the same order in every chunk's
      // CTA (so m, l and lse agree to the bit): A = the warpgroup's q rows
      // of the pair's q box, B = its k box, both K-major.  One commit
      // group per pair; a stage is released once the next pair's group is
      // issued and its own has completed (wgmma wait 1)
      hopper::fence_regs(sacc);
      int prev = 0;
      for (int j = 0; j < nbox; ++j) {
        hopper::mbar_wait(pair_full + slot, phase);
        const uint8_t* sp = smem + slot * L::PAIR;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < L::COLS / 16; ++kk)
          Wgmma<BK, 0, T>::ss(
              sacc,
              hopper::make_desc(sp + q_rows + kk * 32, 16, L::SBO,
                                hopper::kSwizzle128B),
              hopper::make_desc(sp + L::Q_BOX + kk * 32, 16, L::SBO,
                                hopper::kSwizzle128B),
              (j | kk) != 0);
        hopper::wgmma_commit();
        if (j > 0) {
          hopper::wgmma_wait<1>();
          hopper::mbar_arrive(pair_empty + prev);
        }
        prev = slot;
        if (++slot == STAGES) {
          slot = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sacc);
      hopper::mbar_arrive(pair_empty + prev);

      // scale to log2 units; mask keys past Sk (TMA zero-filled them) and
      // above the causal diagonal, on the tiles that have such keys
      const bool need_mask =
          k0 + BK > Sk || (causal && k0 + BK - 1 > qw0 + shift);
#pragma unroll
      for (int i = 0; i < SN; ++i) {
        float x = sacc[i] * scale_log2;
        if (need_mask) {
          const int kpos = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
          const int qpos = row + 8 * ((i / 2) % 2);
          if (kpos >= Sk || (causal && kpos > qpos + shift)) x = -INFINITY;
        }
        sacc[i] = x;
      }

      // online softmax, rows row (h = 0) and row + 8 (h = 1)
      float alpha[2], safe[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = m[h];
#pragma unroll
        for (int i = 0; i < SN; ++i)
          if ((i / 2) % 2 == h) mx = fmaxf(mx, sacc[i]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // a row masked so far keeps m = -inf and P = exp2(-inf - 0) = 0
        safe[h] = mx == -INFINITY ? 0.f : mx;
        alpha[h] = m[h] == -INFINITY ? 0.f : exp2f(m[h] - safe[h]);
        m[h] = mx;
      }
      // P in fp32 for the row sum, packed to T as the A operand of P v
      uint32_t pa[BK / 16][4];
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r, h = r % 2;
          const float p0 = exp2f(sacc[i] - safe[h]);
          const float p1 = exp2f(sacc[i + 1] - safe[h]);
          psum[h] += p0 + p1;
          pa[kk][r] = hopper::pack2<T>(p0, p1);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + psum[h];
#pragma unroll
      for (int b = 0; b < L::OWN; ++b)
#pragma unroll
        for (int i = 0; i < ON; ++i) o_acc[b][i] *= alpha[(i / 2) % 2];

      // O += P v: A = P from registers, B = the CTA's V boxes MN-major,
      // one 16-key slice and one box per instruction
      const int vs = t & 1;
      const uint8_t* sv = smem + L::V_OFF + vs * L::V_BYTES;
      hopper::mbar_wait(v_full + vs, (t >> 1) & 1);
#pragma unroll
      for (int b = 0; b < L::OWN; ++b) hopper::fence_regs(o_acc[b]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int b = 0; b < L::OWN; ++b)
          Wgmma<L::COLS, 1, T>::rs(
              o_acc[b], pa[kk],
              hopper::make_desc(sv + b * L::K_BOX + kk * 16 * L::ROW,
                                L::K_BOX, L::SBO, hopper::kSwizzle128B),
              1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < L::OWN; ++b) hopper::fence_regs(o_acc[b]);
      hopper::mbar_arrive(v_empty + vs);
    }

    // epilogue: the chunk's columns of O / l to T; lse = (m + log2 l) ln 2
    // from chunk 0 only (every chunk computed the same m and l); rows past
    // Sq are not stored
    const int64_t row_base = ((int64_t)bb * H + hh) * Sq;
    const int64_t d_total = (int64_t)n_chunks * L::CHUNK;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int qpos = row + 8 * h;
      if (qpos >= Sq) continue;
      const float denom = fmaxf(l[h], 1e-30f);
      const float inv = 1.f / denom;
      T* orow = o + (row_base + qpos) * d_total + chunk * L::CHUNK +
                2 * (lane % 4);
#pragma unroll
      for (int b = 0; b < L::OWN; ++b)
#pragma unroll
        for (int j = 0; j < L::COLS / 8; ++j) {
          const int i = 4 * j + 2 * h;
          *reinterpret_cast<uint32_t*>(orow + b * L::COLS + 8 * j) =
              hopper::pack2<T>(o_acc[b][i] * inv, o_acc[b][i + 1] * inv);
        }
      if (chunk == 0 && lane % 4 == 0)
        lse[row_base + qpos] =
            m[h] == -INFINITY ? -INFINITY : (m[h] + log2f(denom)) * kLn2;
    }
  }
}

template <typename T>
cudaError_t launch_split_d(const void* q, const void* k, const void* v,
                           void* o, void* lse, int B, int H, int Sq, int Sk,
                           int D, const long long* st, int causal,
                           float scale, cudaStream_t stream) {
  using L = SplitLayout;
  CUtensorMap tq, tk, tv;
  cudaError_t err =
      hopper::encode_bhsd<T>(&tq, q, B, H, Sq, D, st[0], st[1], st[2], BQ);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd<T>(&tk, k, B, H, Sk, D, st[3], st[4], st[5],
                                 L::BK);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd<T>(&tv, v, B, H, Sk, D, st[6], st[7], st[8],
                                 L::BK);
  if (err != cudaSuccess) return err;
  static bool smem_set[kMaxDevices] = {};
  err = opt_in_smem(flash_fwd_split_d_wgmma_kernel<T>, L::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int n_chunks = D / L::CHUNK;
  dim3 grid((Sq + BQ - 1) / BQ * n_chunks, H, B);
  flash_fwd_split_d_wgmma_kernel<T><<<grid, THREADS, L::SMEM, stream>>>(
      tq, tk, tv, static_cast<T*>(o), static_cast<float*>(lse), H, Sq, Sk,
      n_chunks, causal, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace wg

typedef cudaError_t (*LaunchFn)(const void*, const void*, const void*, void*,
                                void*, int, int, int, int, const long long*,
                                int, float, cudaStream_t);

template <typename T>
LaunchFn pick_wgmma(int D) {
  if (D == 32) return wg::launch<32, T>;
  if (D == 64) return wg::launch<64, T>;
  if (D == 128) return wg::launch<128, T>;
  if (D == 256) return wg::launch<256, T>;
  return nullptr;
}

// the kernel instance for (dtype, D): fp32 -> 3xTF32, bf16 and fp16 ->
// wgmma
LaunchFn pick(int dtype, int D) {
  if (dtype == 0) {
    if (D == 32) return tf32::launch<32>;
    if (D == 64) return tf32::launch<64>;
    if (D == 128) return tf32::launch<128>;
    return nullptr;
  }
  if (dtype == 1) return pick_wgmma<__nv_bfloat16>(D);
  if (dtype == 2) return pick_wgmma<__half>(D);
  return nullptr;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; D is 32, 64, 128 (every
// dtype), 256 (bf16 and fp16: the wgmma kernel; fp32: the 3xTF32 split-D
// kernel at n = 1) or any multiple of 256 above it (the split-D kernels).
// strides (in elements) for q, k, v: batch, head, sequence; the head dim
// must be contiguous (bf16 and fp16, and fp32 from 256 up: the base
// addresses 16-byte aligned and the byte strides multiples of 16, as TMA
// needs).  out is [B, H, Sq, D] and lse
// [B, H, Sq], both contiguous.  Returns the CUDA error code of the launch
// (0 on success); the kernel is asynchronous on `stream`.  The caller
// makes the tensors' device current.
int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                   void* lse, int dtype, int B, int H, int Sq, int Sk, int D,
                   long long q_sb, long long q_sh, long long q_ss,
                   long long k_sb, long long k_sh, long long k_ss,
                   long long v_sb, long long v_sh, long long v_ss,
                   int causal, float scale, void* stream) {
  const long long st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh,
                           k_ss, v_sb, v_sh, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D >= 256 && D % tf32::SplitFwd::CHUNK == 0)
    return (int)tf32::launch_split_d(q, k, v, o, lse, B, H, Sq, Sk, D, st,
                                     causal, scale, s);
  if (D > 256 && D % wg::SplitLayout::CHUNK == 0) {
    if (dtype == 1)
      return (int)wg::launch_split_d<__nv_bfloat16>(
          q, k, v, o, lse, B, H, Sq, Sk, D, st, causal, scale, s);
    if (dtype == 2)
      return (int)wg::launch_split_d<__half>(q, k, v, o, lse, B, H, Sq, Sk,
                                             D, st, causal, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  const LaunchFn fn = pick(dtype, D);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)fn(q, k, v, o, lse, B, H, Sq, Sk, st, causal, scale, s);
}

const char* flash_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
