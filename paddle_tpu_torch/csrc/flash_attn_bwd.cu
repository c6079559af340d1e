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
//     input dtype (fp32, bf16 or fp16);
//   * in bf16 and fp16, P and dS are rounded to the input dtype before the
//     second products:
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
// bf16 (the AMP training path) and fp16: two warp-specialized wgmma
// kernels fed by TMA, `flash_bwd_dq_wgmma_kernel<D, T>` and
// `flash_bwd_dkv_wgmma_kernel<D, T>`, one source for both 16-bit types
// (the wgmma type suffix, the tensor-map element type and the packing of
// P, dS and the outputs differ).
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
//     packed to the input dtype (the TPU kernel's `ds.astype(ks.dtype)`)
//     as the register A operand of dQ += dS k, B = the same k tile read
//     MN-major.
//   * keys past Sk are masked in registers (TMA zero-fills them, and a
//     zero score is not -inf), as are keys above the causal diagonal;
//     key tiles wholly above it are skipped (`attention.py:273`).
//   * dQ stays in registers until the epilogue (x scale, input dtype,
//     rows past Sq not stored).  Each dQ element is summed by one thread
//     in a fixed order: no atomics, bitwise reproducible.
//   At the training shape the grid is 4 x 12 x 8 = 384 CTAs, one per SM.
//   D = 256 (and 129-255, zero-padded by the wrapper): the same kernel with
//   `DqLayout::BK` = 32.  At BK = 64, q and dO resident (2 x 65,536 B)
//   plus two stages of K and of V (4 x 32,768 B) would be 256 KB, over the
//   232,448 B a block may opt in to; with BK = 32 the stages take
//   4 x 16,384 B, 197,688 B in all with the barriers and the alignment
//   slack (a third stage would also fit, 230.5 KB, and was no faster in
//   a trial build on an H100; two are kept, as at D <= 128).  Per consumer thread: the dQ accumulator 64 x 256 fp32 over
//   128 threads = 128 registers, S and dP m64n32 fragments of 16 each, dS
//   packed 8, inside the 240 of `setmaxnreg`.  S = q k^T and dP = dO v^T
//   are m64n32k16 over 16 k-steps (K-major, from the 4 boxes); dQ += dS k
//   is two k16 slices x four n64 products, one per 64-column box of k read
//   MN-major.  Bound at [8, 8, 512, 256]: 25.8 GFLOP take 26.1 us on the
//   tensor cores, 84 MB of inputs and outputs take 25.1 us, so the
//   operations bound it; the grid is 4 x 8 x 8 = 256 CTAs.  The narrow
//   key tile doubles the barrier round trips and the dS packs per key
//   against D <= 128, and n32 products feed the tensor cores half as much
//   per instruction as n64: the price of holding the 128-register
//   accumulator beside two score fragments.  Causal tile skipping,
//   fully-masked rows and the absence of atomics are as above.
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
//     (the q index), packed to the input dtype as the register A operands
//     of dV += P^T dO and dK += dS^T q (B = the same dO / q tile read
//     MN-major).  dK and dV stay in registers until the epilogue.
//   * The causal start tile follows `attention.py:321`: the first q tile
//     that sees the CTA's first key.  Keys past Sk are computed on
//     zero-filled k and v and not stored (a key row of dK/dV depends only
//     on its own row of P^T and dS^T).
//   D = 256 (and 129-255, zero-padded by the wrapper).  The layout above
//   does not fit:
//   one warpgroup holding dK and dV for 64 keys x 256 columns in fp32
//   would need 2 x 128 = 256 registers a thread, over the 255 cap, and
//   K and V resident for 128 keys plus two q/dO stages would need 256 KB
//   of shared memory.  So a CTA owns 64 keys, shared by both consumer
//   warpgroups, which split dK and dV by head-dim columns: warpgroup w
//   owns columns 128 w .. 128 w + 127 of both (boxes 2w, 2w + 1), 64 + 64
//   accumulator registers, the register budget of the D = 128 instance.
//   Shared memory: K and V resident (2 x 32,768 B), q and dO in 64-row
//   tiles through the 2-stage TMA ring (4 x 32,768 B), the stages' lse
//   and D rows: 198,696 B with the barriers and slack (static_assert
//   against 232,448).  The score products S^T = k q^T and dP^T = v dO^T
//   reduce over all 256 columns; each warpgroup computes both in full
//   (choice (a): 1.5x the tensor-core work of the whole kernel; choice
//   (b), one warpgroup S^T and the other dP^T, would add a 32 KB fp32
//   exchange buffer, leaving under 1 KB of the 227 KB, and a named
//   barrier a tile), then dS^T and its own halves of dV += P^T dO and
//   dK += dS^T q, q and dO read MN-major from the stage.  Causal tile
//   skipping, fully-masked rows (lse +inf in log2 units, so P = 0) and
//   the absence of atomics are as above.  Bound at [8, 8, 512, 256]: 4
//   products of 2 S^2 D per head, 34.4 GFLOP, 34.7 us on the tensor
//   cores (operations); the grid is 8 x 8 x 8 = 512 CTAs.
//   dK/dV at D = 256 n, n >= 2 (257-511 zero-padded to 512 by the
//   wrapper): `flash_bwd_dkv_split_d_wgmma_kernel<T>`, the design of the
//   fp32 split-D dK/dV below on wgmma.  Resident K and V would be 64 n KB
//   each, so:
//   * a CTA owns 64 keys and one 256-column chunk of dK and dV (folded
//     into blockIdx.x); consumer warpgroup w owns the chunk's columns
//     128 w .. + 127 of both (two 64-column boxes, 128 registers), and a
//     producer warp fills a 6-stage ring by TMA;
//   * warpgroup 0 computes S^T = k q^T and P^T, warpgroup 1 dP^T = v dO^T
//     and dP^T - D, each once over all of D (m64n64k16 over the 4n
//     (k, q) or (v, dO) box pairs of a step, one commit group a step; a
//     stage is released once the next step's group is issued and its own
//     is done).  Both m64n64 fragments have the same layout, so each
//     warpgroup leaves its own in fp32 shared slots (2 x 16 KB, slot i of
//     thread t at [i][t]) between two named barriers of the 256 consumer
//     threads, and reads the other's as it stands; both then form
//     dS^T = P^T (dP^T - D) (the same product, the same bits), pack P^T
//     and dS^T to T as register A operands, and run dV += P^T dO and
//     dK += dS^T q on their own q and dO boxes (MN-major) of the two
//     second-product steps that follow the score steps of each q tile.
//     Computing both scores in each warpgroup (the D = 256 column split)
//     would be 2.5x the tensor work at n = 2; the role split is 1.5x;
//   * shared memory: 6 stages of 4 x 8 KB, the slots, 12 barriers:
//     230,496 B whatever n (static_assert against 232,448);
//   * the lse (log2 units) and D of the fragment's 16 q rows are read per
//     q tile with __ldg while the score products run; the causal start
//     tile, masks, fully-masked rows and keys past Sk are as at D = 256.
//   Bound at [8, 4, 512, 512]: 34.4 GFLOP of real work, 34.7 us on the
//   tensor cores (52 us with the scores recomputed per chunk); ~1.3 GB of
//   boxes read from L2 per call; the grid is 8 x 2 x 4 x 8 = 512 CTAs, one
//   an SM.  On an H100 it ran 0.25 ms there (PERF.md), and builds without
//   the loads after the ring's first fill, without the score products or
//   without the second products each took 94-96% of that (88-94% at
//   D = 768), and without all three 80% (72%; chip_diag.py): neither L2
//   nor the tensor cores bound it, but the skeleton of a q tile (stage
//   barriers, slot exchange, softmax, one CTA an SM), not measured part
//   by part.
//   dQ at D = 256 n, n >= 2: `flash_bwd_dq_split_d_wgmma_kernel<T, NB>`,
//   the 3xTF32 split-D dQ below turned onto wgmma, with the roles and the
//   ring of the split-D dK/dV.  q and dO resident would be 2 x 64 n KB, so:
//   * a CTA owns 64 query rows and one chunk of 2 C dQ columns (folded into
//     blockIdx.x), C = 64 NB: 256 where n is even (one CTA a q tile at
//     D = 512, the scores computed once), 192 where 3 divides n (two
//     chunks at D = 768), else 128.  Consumer warpgroup w owns the chunk's
//     columns C w .. + C - 1 (NB boxes, 32 NB accumulator registers);
//   * per 64-key tile the ring carries the 4n score steps ((q, k, dO, v)
//     64-column boxes): warpgroup 0 computes S = q k^T and P, warpgroup 1
//     dP = dO v^T and dP - D, each once over all of D; they swap their
//     m64n64 fragments through the slots between two named barriers, and
//     both form dS = P (dP - D), packed to T (`ds.astype(ks.dtype)`) as
//     the register A operand of dQ += dS k.  Then (NB + 1) / 2 steps carry
//     up to two k boxes of each warpgroup's own columns, read MN-major;
//   * a stage's empty barrier counts one arrival per consumer warpgroup
//     (one thread, after the wgmma wait that covers the stage), not one per
//     thread as in the dK/dV;
//   * the lse (log2 units) or D of the thread's two rows stays in
//     registers; keys past Sk and above the causal diagonal get P = 0, key
//     tiles wholly above it are skipped, rows past Sq are not stored.
//   Bound at [8, 4, 512, 512]: 25.8 GFLOP take 26.1 us on the tensor
//   cores (operations; 84 MB of inputs and outputs take 25 us); the grid
//   is 8 x 4 x 8 = 256 CTAs.
//
// fp32 (the fp32 training step): 3xTF32 on the tensor cores,
//   `flash_bwd_dq_tf32_kernel` and `flash_bwd_dkv_tf32_kernel`.  Bound at
//   the training shape: dQ's 9.7 GFLOP and dK/dV's 12.9 take 0.144 and
//   0.192 ms on the 67 TFLOP/s of fp32 FMA.  The tensor cores take fp32
//   only as TF32, so each operand is split as x = hi + lo (tf32.cuh: one
//   AND, one subtract) and each product taken as lo*hi + hi*lo + hi*hi in
//   fp32, which keeps an fp32-level error (~2^-20 per product, not TF32's
//   three digits): three TF32 products at 495 TFLOP/s bound the same work
//   at 0.059 and 0.078 ms, against ~0.02 ms of bytes.  The operations
//   bound both.
//   `mma.sync.m16n8k8` rather than wgmma: wgmma's TF32 operands must both
//   be K-major, and the second products (dS k; P^T dO and dS^T q) read
//   their B operand MN-major.  mma.sync fragments are loaded per thread
//   from shared memory, rows padded to D + 4 floats so that the loads of
//   both layouts hit 32 distinct banks, and no operand needs a transposed
//   copy.
//   * one CTA of 4 warps, each warp owning 16 of the CTA's 64 rows; the
//     tiles streamed past them are double-buffered by cp.async (16-byte
//     copies where every row start of the view is 16-byte aligned, else
//     4-byte ones, so any strided fp32 view works; rows past the end are
//     zero-filled);
//   * a first product's C fragment (columns 2(l%4), +1 of each 8-column
//     tile) becomes the A fragment of the second product as it stands:
//     the second product takes each tile's columns in the order 0, 2, 4,
//     6, 1, 3, 5, 7 and reads B rows 2(l%4) and 2(l%4) + 1 to match;
//   * dQ: one CTA per (64 query rows, head, batch).  The q and dO A
//     fragments stay resident, raw and split per use: in registers at
//     D <= 64, in the thread's own shared-memory slots at D = 128, where
//     registers would spill; lse (log2 units, +inf past Sq and on fully-
//     masked rows) and D of the thread's two rows in registers.  K/V tiles
//     of 64 keys stream.  S = q k^T and dP = dO v^T share one loop over
//     the head dim; P = exp2(S scale log2e - lse log2e), 0 for keys past
//     Sk and above the causal diagonal (key tiles wholly above it are
//     skipped); dS = P (dP - D) in place of S; dQ += dS k;
//   * dK/dV: one CTA per (64 keys, head, batch), computed transposed
//     (rows = keys).  The K and V tiles stay in shared memory, their A
//     fragments read and split per use; q and dO tiles of BQ rows stream
//     (64, or 32 at D = 128, where the dK and dV accumulators take 128
//     registers), each with its lse and D rows (4-byte copies; nothing is
//     read past [B, H, Sq]).  S^T = k q^T and dP^T = v dO^T; P^T and dS^T
//     on the fragments, lse and D read per column; dV += P^T dO and
//     dK += dS^T q.  The causal start tile follows `attention.py:321`;
//     keys past Sk are computed on zero-filled k and v and not stored.
//   Each output element is summed by one thread in a fixed order: no
//   atomics, bitwise reproducible.
//   dK/dV at D = 256 n, n >= 1 (the split-D route; 129-255 zero-padded to
//   256, 257-511 to 512 by the wrapper): `flash_bwd_dkv_split_d_tf32_kernel`.
//   Resident K and V tiles would be 2 x 64 n KB, and a warp holding dK and
//   dV for 16 keys x 256 columns would need 256 accumulator registers, so:
//   * a CTA of two warpgroups owns 64 keys and one 256-column chunk of dK
//     and dV (folded into blockIdx.x); warpgroup w owns the chunk's
//     columns 128 w .. + 127 of both, 128 accumulator registers a thread;
//   * the score products split by role, not by columns: warpgroup 0
//     computes S^T = k q^T and P^T (lse read per column), warpgroup 1
//     dP^T = v dO^T and dP^T - D, each once over all of D, and each leaves
//     its fragments in 32 KB of shared slots for the other.  Computing
//     both in each warpgroup (the column split of the 16-bit D = 256
//     kernel) would be 2.5x the tensor work at n = 2; the role split is
//     1.5x (the scores recomputed per chunk), and 1x at n = 1 (one chunk:
//     8 score steps and 4 second-product steps a q tile);
//   * one stream of steps through a 6-stage ring that TMA fills (32 KB a
//     stage, 230,448 B in all with the slots, the barriers and the
//     alignment slack, whatever n): per q tile of 64 rows, the 8n score
//     steps (a k, q, v and dO box of 32 fp32 columns), then 4 steps of the
//     second products (per warpgroup a q box and a dO box of its
//     columns): dV += P^T dO and dK += dS^T q, dS^T = P^T (dP^T - D) from
//     the slots, P^T's and dS^T's C fragments as the A operands.  Boxes
//     land in 128-byte swizzle, so the fragment loads hit 32 distinct
//     banks (the addressing of the split-D forward in flash_attn_fwd.cu).
//     Streamed by cp.async instead (16-byte copies from every thread) the
//     copies did not overlap the products on an H100, and the kernel ran
//     2.2x slower at [8, 4, 512, 512];
//   * the tensor cores round each accumulation toward zero, a bias that
//     grows with the 8n x 4 x 3 accumulations of a score over all of D,
//     and dS = P (dP - D) does not cancel it (D is summed apart).  With
//     dO = 2 O (the gradient of sum(O^2)) at [1, 2, 96, 320] causal on an
//     H100, dK was off by 8.6e-4 from the score-matrix gradient
//     (tests/test_torch_cuda.py::test_wide_head_dims_through_autograd,
//     gate 1e-4).  So each box's products go to a fresh fragment (12
//     accumulations) that is added to the running sum in fp32, half the q
//     rows at a time (16 registers), and the test passes;
//   * the causal start tile, masks and fully-masked rows are those of the
//     D <= 128 kernel; no atomics.  TMA takes 16-byte aligned views with
//     byte strides that are multiples of 16: the wrapper copies another
//     view first, as in bf16.
//   Bound at [8, 4, 512, 512]: 34.4 GFLOP of real work in 3xTF32 take
//   0.208 ms (0.312 with the recomputed scores), 168 MB take 0.050 ms;
//   the grid is 8 x 2 x 4 x 8 = 512 CTAs, one per SM.  At [8, 8, 512, 256]
//   the same 34.4 GFLOP over 8 x 8 x 8 = 512 CTAs of one chunk each.
//   dQ at D = 256 n, n >= 1: `flash_bwd_dq_split_d_tf32_kernel<W>`, the
//   split-D dK/dV turned around (rows are queries, the loop runs over key
//   tiles of 64):
//   * a CTA of two warpgroups owns 64 query rows and one chunk of 2 C
//     columns of dQ, C = 32 W columns a warpgroup (16 rows x C a warp:
//     C / 2 registers a thread).  C is 256 where n is even, 192 where 3
//     divides n, else 128: at D = 256 and 512 one CTA computes the scores
//     once for all of dQ, at D = 768 two chunks compute them twice.  On an
//     H100 the
//     128-column chunk everywhere took 1.62x as long at D = 512 and 1.40x
//     at D = 768 (PERF.md);
//   * warpgroup 0 computes S = q k^T and P, warpgroup 1 dP = dO v^T and
//     dP - D, each once over all of D from the score steps' (q, k) and
//     (dO, v) boxes, each box's products summed in a fresh fragment (the
//     accuracy lesson of the dK/dV); they leave their fragments in the
//     32 KB of slots, and each second-product step (two k boxes of each
//     warpgroup's columns) reads P and dP - D back to form dS = P (dP - D)
//     and its C fragment as the A operand of dQ += dS k.  Holding dS in
//     registers across the steps instead spilled 220 bytes at W = 8;
//   * the lse (log2 units; warpgroup 0) or D (warpgroup 1) of the thread's
//     two rows stays in registers; keys past Sk and above the causal
//     diagonal get P = 0; key tiles wholly above it are skipped; the ring,
//     its barriers and its 230,448 B are those of the dK/dV.
//   Bound at [8, 4, 512, 512]: 25.8 GFLOP in 3xTF32 take 0.156 ms; the
//   grid is 8 x 4 x 8 = 256 CTAs (8 x 8 x 8 = 512 at [8, 8, 512, 256], the
//   same work).
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

struct Strides {
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
      o_ss;
};

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

constexpr int BT = 64;        // rows per CTA (16 per warp); keys per dQ tile
constexpr int THREADS = 128;
constexpr int PAD = 4;        // floats of padding per shared-memory row
constexpr float kLog2e = 1.4426950408889634f;

// dK/dV: query rows per streamed q / dO tile.  At D = 128 the dK and dV
// accumulators take 128 registers, so the S^T and dP^T fragments shrink
// to 16 each.
template <int D>
__host__ __device__ constexpr int dkv_bq() {
  return D > 64 ? 32 : 64;
}

// dQ: two stages of the K tile and of the V tile, [BT][D + PAD] each; at
// D = 128 also the q and dO fragments, D / 2 floats each per thread
template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) *
         (size_t)(4 * BT * (D + PAD) + (D > 64 ? THREADS * D : 0));
}

// dK/dV: the K and V tiles, two stages of the q and dO tiles and of the
// q tile's lse and D rows
template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) *
         (size_t)((2 * BT + 4 * dkv_bq<D>()) * (D + PAD) + 4 * dkv_bq<D>());
}

// ---- dQ: one CTA per (64 query rows, head, batch)
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dd, float* __restrict__ dq,
                         int H, int Sq, int Sk, Strides st, int causal,
                         float scale, int vec16) {
  constexpr int SD = D + PAD;   // shared row stride (floats)
  constexpr int KS = D / 8;     // k8 steps of S and dP / 8-column tiles of dQ
  constexpr int NT = BT / 8;    // 8-key tiles of S and dP / k8 steps of dS k
  // the head-dim loop: fully unrolled where q and dO sit in registers
  constexpr int KS_UNROLL = D <= 64 ? KS : 4;
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  // stage s: K at smem + 2 s BT SD, V right after it; then the q and dO
  // slots (D = 128)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.x * BT;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const float* kb = k + bb * st.k_sb + hh * st.k_sh;
  const float* vb = v + bb * st.v_sb + hh * st.v_sh;
  const int rw0 = q0 + 16 * warp;  // the warp's first row
  const int row = rw0 + g;         // the thread's rows: row, row + 8

  const int shift = Sk - Sq;  // bottom-right causal alignment
  int n_tiles = (Sk + BT - 1) / BT;
  if (causal) {
    // keys visible to the CTA's last row (attention.py:273)
    const int hi = q0 + BT + shift;
    n_tiles = min(n_tiles, hi <= 0 ? 0 : (hi + BT - 1) / BT);
  }
  if (n_tiles > 0) {
    load_rows<BT, D, PAD, THREADS>(smem, kb, st.k_ss, 0, Sk, vec16);
    load_rows<BT, D, PAD, THREADS>(smem + BT * SD, vb, st.v_ss, 0, Sk,
                                   vec16);
  }
  cp_async_commit();

  // q and dO rows as A fragments, rows past Sq zero
  float* slots = smem + 4 * BT * SD;
  RowFrags<D, THREADS> qf(slots), of(slots + THREADS * D / 2);
  {
    const float* qb = q + bb * st.q_sb + hh * st.q_sh;
    const float* ob = dout + bb * st.o_sb + hh * st.o_sh;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row + 8 * (i % 2), c = 8 * ks + t4 + 4 * (i / 2);
        const bool in = r < Sq;
        qf.set(ks, i, in ? __ldg(qb + (int64_t)r * st.q_ss + c) : 0.f);
        of.set(ks, i, in ? __ldg(ob + (int64_t)r * st.o_ss + c) : 0.f);
      }
  }
  // lse in log2 units (+inf past Sq and on fully-masked rows: P = 0
  // there) and D of the thread's two rows
  const int64_t row_base = ((int64_t)bb * H + hh) * Sq;
  float lse2[2], drow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = row + 8 * h;
    const float lv = qpos < Sq ? lse[row_base + qpos] : -INFINITY;
    lse2[h] = lv == -INFINITY ? INFINITY : lv * kLog2e;
    drow[h] = qpos < Sq ? dd[row_base + qpos] : 0.f;
  }
  const float scale_log2 = scale * kLog2e;

  float acc[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BT;
    if (t + 1 < n_tiles) {
      float* nxt = smem + ((t + 1) & 1) * 2 * BT * SD;
      load_rows<BT, D, PAD, THREADS>(nxt, kb, st.k_ss, k0 + BT, Sk, vec16);
      load_rows<BT, D, PAD, THREADS>(nxt + BT * SD, vb, st.v_ss, k0 + BT,
                                     Sk, vec16);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t has landed for every thread
    const float* sK = smem + (t & 1) * 2 * BT * SD;
    const float* sV = sK + BT * SD;

    // S = q k^T and dP = dO v^T in one loop over the head dim.  B
    // fragment: k / v row 8 nt + g, columns 8 ks + t4 (b0) and + 4 (b1)
    float sacc[NT][4], dpacc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sacc[nt][i] = dpacc[nt][i] = 0.f;
#pragma unroll KS_UNROLL
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qhi[4], qlo[4], ohi[4], olo[4];
      qf.get(ks, qhi, qlo);
      of.get(ks, ohi, olo);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int off = (8 * nt + g) * SD + 8 * ks + t4;
        uint32_t bhi[2], blo[2];
        split_b(sK[off], sK[off + 4], bhi, blo);
        mma3(sacc[nt], qhi, qlo, bhi, blo);
        split_b(sV[off], sV[off + 4], bhi, blo);
        mma3(dpacc[nt], ohi, olo, bhi, blo);
      }
    }

    // P = exp2(S scale log2e - lse log2e), 0 for keys past Sk (zero-
    // filled, and a zero score is not -inf) and above the causal
    // diagonal; dS = P (dP - D) in place of S.  C fragment: c0, c1 (row
    // g, keys 2 t4, +1), c2, c3 (row g + 8)
    const bool need_mask =
        k0 + BT > Sk || (causal && k0 + BT - 1 > rw0 + shift);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i / 2;
        float p = exp2f(fmaf(sacc[nt][i], scale_log2, -lse2[h]));
        if (need_mask) {
          const int kpos = k0 + 8 * nt + 2 * t4 + (i % 2);
          if (kpos >= Sk || (causal && kpos > row + 8 * h + shift)) p = 0.f;
        }
        sacc[nt][i] = p * (dpacc[nt][i] - drow[h]);
      }

    // dQ += dS k over the keys of 8-key tile nt taken in the order
    // 0, 2, 4, 6, 1, 3, 5, 7: A = dS's C fragment as it stands, B reads
    // k rows 8 nt + 2 t4 (b0) and + 1 (b1), column 8 j + g
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t ahi[4], alo[4];
      split_c_as_a(sacc[nt], ahi, alo);
      const float* kr = sK + (8 * nt + 2 * t4) * SD + g;
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        uint32_t bhi[2], blo[2];
        split_b(kr[8 * j], kr[SD + 8 * j], bhi, blo);
        mma3(acc[j], ahi, alo, bhi, blo);
      }
    }
    __syncthreads();  // stage t & 1 is refilled with tile t + 2
  }

  // epilogue: dQ scale; rows past Sq are not stored
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = row + 8 * h;
    if (qpos >= Sq) continue;
    float* out = dq + (row_base + qpos) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < KS; ++j)
      *reinterpret_cast<float2*>(out + 8 * j) =
          make_float2(acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale);
  }
}

// ---- dK/dV: one CTA per (64 keys, head, batch), computed transposed
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dd,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int H, int Sq, int Sk, Strides st, int causal,
                          float scale, int vec16) {
  constexpr int BQ = dkv_bq<D>();
  constexpr int SD = D + PAD;   // shared row stride (floats)
  constexpr int KS = D / 8;     // k8 steps of S^T, dP^T / 8-col tiles of dK, dV
  constexpr int NT = BQ / 8;    // 8-row q tiles of S^T / k8 steps after
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* sK = smem;                       // [BT][SD], resident
  float* sV = sK + BT * SD;               // [BT][SD], resident
  float* stages = sV + BT * SD;           // stage s: q, dO [BQ][SD] each
  float* rows_all = stages + 4 * BQ * SD; // stage s: lse, D [BQ] each

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int k0 = blockIdx.x * BT;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kw0 = k0 + 16 * warp;  // the warp's first key
  const int key = kw0 + g;         // the thread's keys: key, key + 8
  const float* qb = q + bb * st.q_sb + hh * st.q_sh;
  const float* ob = dout + bb * st.o_sb + hh * st.o_sh;
  const int64_t qrow_base = ((int64_t)bb * H + hh) * Sq;

  const int shift = Sk - Sq;  // bottom-right causal alignment
  const int n_qt = (Sq + BQ - 1) / BQ;
  int first = 0;
  if (causal) {
    // the first q tile that sees key k0 (attention.py:321)
    const int lo = k0 - shift;
    first = lo <= 0 ? 0 : lo / BQ;
  }
  const int n_tiles = n_qt - first;  // <= 0: no query sees these keys

  // stage s <- q tile starting at row q0: its q and dO rows, and its lse
  // and D rows by 4-byte copies (zero past Sq, read nothing there)
  auto load_stage = [&](int s, int q0) {
    float* sq = stages + s * 2 * BQ * SD;
    load_rows<BQ, D, PAD, THREADS>(sq, qb, st.q_ss, q0, Sq, vec16);
    load_rows<BQ, D, PAD, THREADS>(sq + BQ * SD, ob, st.o_ss, q0, Sq, vec16);
    float* rows = rows_all + s * 2 * BQ;
    for (int i = threadIdx.x; i < 2 * BQ; i += THREADS) {
      const int qpos = q0 + i % BQ;
      const bool valid = qpos < Sq;
      cp_async(rows + i,
               (i < BQ ? lse : dd) + qrow_base + (valid ? qpos : 0), false,
               valid);
    }
  };
  if (n_tiles > 0) {
    load_rows<BT, D, PAD, THREADS>(sK, k + bb * st.k_sb + hh * st.k_sh,
                                   st.k_ss, k0, Sk, vec16);
    load_rows<BT, D, PAD, THREADS>(sV, v + bb * st.v_sb + hh * st.v_sh,
                                   st.v_ss, k0, Sk, vec16);
    load_stage(0, first * BQ);
  }
  cp_async_commit();

  float dk_acc[KS][4], dv_acc[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[j][i] = dv_acc[j][i] = 0.f;
  const float scale_log2 = scale * kLog2e;
  // the warp's k and v rows (A fragments), at the thread's element
  const float* ka = sK + (16 * warp + g) * SD + t4;
  const float* va = sV + (16 * warp + g) * SD + t4;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = (first + it) * BQ;
    if (it + 1 < n_tiles) {
      load_stage((it + 1) & 1, q0 + BQ);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it (and K, V) has landed for every thread
    const float* sQ = stages + (it & 1) * 2 * BQ * SD;
    const float* sDO = sQ + BQ * SD;
    const float* sL = rows_all + (it & 1) * 2 * BQ;
    const float* sD = sL + BQ;

    // S^T = k q^T and dP^T = v dO^T: A = the warp's k / v rows (raw in
    // shared memory, split per use), B fragment: q / dO row 8 nt + g,
    // columns 8 ks + t4 (b0) and + 4 (b1)
    float st_acc[NT][4], dpt[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) st_acc[nt][i] = dpt[nt][i] = 0.f;
#pragma unroll 4
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t khi[4], klo[4], vhi[4], vlo[4];
      split_a<SD>(ka + 8 * ks, khi, klo);
      split_a<SD>(va + 8 * ks, vhi, vlo);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int off = (8 * nt + g) * SD + 8 * ks + t4;
        uint32_t bhi[2], blo[2];
        split_b(sQ[off], sQ[off + 4], bhi, blo);
        mma3(st_acc[nt], khi, klo, bhi, blo);
        split_b(sDO[off], sDO[off + 4], bhi, blo);
        mma3(dpt[nt], vhi, vlo, bhi, blo);
      }
    }

    // P^T = exp2(S^T scale log2e - lse log2e) and dS^T = P^T (dP^T - D).
    // The fragment's columns are q rows (c0, c1: key g, q rows 2 t4, +1;
    // c2, c3: key g + 8), so lse and D are read per column pair; columns
    // past Sq and fully-masked rows (lse = -inf) get P = 0, as do keys
    // above the causal diagonal
    const bool need_mask = causal && kw0 + 15 > q0 + shift;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = 8 * nt + 2 * t4;
      const float2 lr = *reinterpret_cast<const float2*>(sL + col);
      const float2 dr = *reinterpret_cast<const float2*>(sD + col);
      const float l2[2] = {
          q0 + col < Sq && lr.x != -INFINITY ? lr.x * kLog2e : INFINITY,
          q0 + col + 1 < Sq && lr.y != -INFINITY ? lr.y * kLog2e
                                                 : INFINITY};
      const float d2[2] = {dr.x, dr.y};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = i % 2;
        float p = exp2f(fmaf(st_acc[nt][i], scale_log2, -l2[c]));
        if (need_mask && key + 8 * (i / 2) > q0 + col + c + shift) p = 0.f;
        st_acc[nt][i] = p;
        dpt[nt][i] = p * (dpt[nt][i] - d2[c]);
      }
    }

    // dV += P^T dO and dK += dS^T q over the q rows of 8-row tile nt
    // taken in the order 0, 2, 4, 6, 1, 3, 5, 7: A = P^T's / dS^T's C
    // fragment as it stands, B reads dO / q rows 8 nt + 2 t4 (b0) and
    // + 1 (b1), column 8 j + g
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t phi[4], plo[4], shi[4], slo[4];
      split_c_as_a(st_acc[nt], phi, plo);
      split_c_as_a(dpt[nt], shi, slo);
      const int off = (8 * nt + 2 * t4) * SD + g;
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        uint32_t bhi[2], blo[2];
        split_b(sDO[off + 8 * j], sDO[off + SD + 8 * j], bhi, blo);
        mma3(dv_acc[j], phi, plo, bhi, blo);
        split_b(sQ[off + 8 * j], sQ[off + SD + 8 * j], bhi, blo);
        mma3(dk_acc[j], shi, slo, bhi, blo);
      }
    }
    __syncthreads();  // stage it & 1 is refilled with tile it + 2
  }

  // epilogue: dK scale, dV; keys past Sk are not stored
  const int64_t krow_base = ((int64_t)bb * H + hh) * Sk;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kpos = key + 8 * h;
    if (kpos >= Sk) continue;
    float* ko = dk + (krow_base + kpos) * D + 2 * t4;
    float* vo = dv + (krow_base + kpos) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      *reinterpret_cast<float2*>(ko + 8 * j) = make_float2(
          dk_acc[j][2 * h] * scale, dk_acc[j][2 * h + 1] * scale);
      *reinterpret_cast<float2*>(vo + 8 * j) =
          make_float2(dv_acc[j][2 * h], dv_acc[j][2 * h + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dd,
                      void* dq, int B, int H, int Sq, int Sk,
                      const Strides& st, int causal, float scale,
                      cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {};
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = opt_in_smem(flash_bwd_dq_tf32_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  // K and V tiles stream by cp.async; q and dO are read per element
  const bool vec16 = rows_16b_aligned(
      {k, v}, {st.k_sb, st.k_sh, st.k_ss, st.v_sb, st.v_sh, st.v_ss});
  dim3 grid((Sq + BT - 1) / BT, H, B);
  flash_bwd_dq_tf32_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<float*>(dq), H, Sq, Sk, st, causal, scale, (int)vec16);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dd,
                       void* dk, void* dv, int B, int H, int Sq, int Sk,
                       const Strides& st, int causal, float scale,
                       cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {};
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = opt_in_smem(flash_bwd_dkv_tf32_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const bool vec16 = rows_16b_aligned(
      {q, k, v, dout}, {st.q_sb, st.q_sh, st.q_ss, st.k_sb, st.k_sh, st.k_ss,
                        st.v_sb, st.v_sh, st.v_ss, st.o_sb, st.o_sh,
                        st.o_ss});
  dim3 grid((Sk + BT - 1) / BT, H, B);
  flash_bwd_dkv_tf32_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Sq, Sk, st,
      causal, scale, (int)vec16);
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
      return launch_dkv<128>(q, k, v, dout, lse, dd, dk, dv, B, H, Sq, Sk,
                             st, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// dK/dV at D = 256 n, n >= 1: the split-D dK/dV.  A CTA of two warpgroups
// owns 64 keys and one 256-column chunk of dK and dV; warpgroup w owns the
// chunk's columns 128 w .. 128 w + 127 (16 keys x 128 columns of dK and of
// dV per warp: 128 registers a thread).  The score products split by role:
// warpgroup 0 computes S^T = k q^T, warpgroup 1 dP^T = v dO^T, each once
// over all of D, and they hand P^T and dP^T - D over through shared
// memory.  One stream of steps runs through a ring of stages that TMA
// fills: per q tile the 8n score steps (k, q, v and dO boxes of 32
// columns) and then the 4 second-product steps (for each warpgroup a q box
// and a dO box of its columns).  Shared memory does not grow with D.
// ---------------------------------------------------------------------------
// The ring of the two fp32 split-D backward kernels (dK/dV here, dQ
// below): 64-row boxes of 32 fp32 columns, four a stage, and two
// warpgroups' 64 x 64 score fragments handed over through shared slots.
struct SplitRing {
  static constexpr int THREADS = 256;
  static constexpr int ROWS = 64;          // rows of every box
  static constexpr int BOX = 32;           // columns of a box (128 bytes)
  static constexpr uint32_t BOXB = ROWS * BOX * 4;  // bytes of a box
  static constexpr uint32_t STAGE = 4 * BOXB;       // four boxes a step
  static constexpr int XSLOTS = ROWS / 8 * 4;  // fragment values a thread
  static constexpr int STAGES = 6;
  static constexpr uint32_t X_OFF = STAGES * STAGE;  // the two fragments
  static constexpr uint32_t BAR_OFF = X_OFF + 2 * XSLOTS * 128 * 4;
  static constexpr size_t SMEM = BAR_OFF + STAGES * 8 + 1024;  // + align
  static_assert(BOXB % 1024 == 0, "every box must start on 1024 bytes");
  static_assert(SMEM <= hopper::kMaxSmem,
                "split-D stages exceed the shared-memory opt-in");
};

struct SplitDkv : SplitRing {
  static constexpr int BKEY = ROWS;        // keys per CTA, 16 per warp
  static constexpr int BQ = ROWS;          // q rows per streamed tile
  static constexpr int CHUNK = 256;        // output columns per CTA
  static constexpr int CSTEPS = CHUNK / 2 / BOX;  // second-product steps
};

__global__ void __launch_bounds__(SplitDkv::THREADS, 1)
flash_bwd_dkv_split_d_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const __grid_constant__ CUtensorMap tdo,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ dd,
                                  float* __restrict__ dk,
                                  float* __restrict__ dv, int H, int Sq,
                                  int Sk, int n_chunks, int causal,
                                  float scale) {
  using L = SplitDkv;
  constexpr int NT = L::BQ / 8;    // 8-row q tiles of S^T / k8 steps after
  constexpr int CT = L::BOX / 8;   // 8-column tiles of an output box
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  float* xbuf = reinterpret_cast<float*>(smem + L::X_OFF);  // [2][XSLOTS][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);

  const int warp = threadIdx.x / 32;
  const int wg = warp / 4;               // 0: S^T, P^T; 1: dP^T
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int tid = threadIdx.x % 128;     // the thread in its warpgroup
  const int chunk = blockIdx.x % n_chunks;  // the CTA's output columns
  const int k0 = blockIdx.x / n_chunks * L::BKEY;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kw0 = k0 + 16 * (warp % 4);  // the warp's first key
  const int key = kw0 + g;               // the thread's keys: key, key + 8
  const int64_t qrow_base = ((int64_t)bb * H + hh) * Sq;

  const int shift = Sk - Sq;  // bottom-right causal alignment
  const int n_qt = (Sq + L::BQ - 1) / L::BQ;
  int first = 0;
  if (causal) {
    // the first q tile that sees key k0 (attention.py:321)
    const int lo = k0 - shift;
    first = lo <= 0 ? 0 : lo / L::BQ;
  }
  const int n_tiles = max(n_qt - first, 0);  // 0: no query sees these keys
  const int nbox = n_chunks * L::CHUNK / L::BOX;  // score steps per q tile
  const int per_tile = nbox + L::CSTEPS;
  const int total = n_tiles * per_tile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) hopper::mbar_init(full + s, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // thread 0 starts step i into stage i % STAGES (rows past Sq or Sk
  // zero-filled): a score step's k, q, v and dO boxes, or a second-product
  // step's q and dO box for each warpgroup's columns
  auto issue = [&](int i) {
    if (i >= total) return;
    const int it = i / per_tile, j = i % per_tile, s = i % L::STAGES;
    const int q0 = (first + it) * L::BQ;
    uint8_t* sp = smem + s * L::STAGE;
    hopper::mbar_arrive_expect_tx(full + s, L::STAGE);
    if (j < nbox) {
      const int c = j * L::BOX;
      hopper::tma_load_4d(sp, &tk, full + s, c, k0, hh, bb);
      hopper::tma_load_4d(sp + L::BOXB, &tq, full + s, c, q0, hh, bb);
      hopper::tma_load_4d(sp + 2 * L::BOXB, &tv, full + s, c, k0, hh, bb);
      hopper::tma_load_4d(sp + 3 * L::BOXB, &tdo, full + s, c, q0, hh, bb);
    } else {
      const int c = chunk * L::CHUNK + (j - nbox) * L::BOX;
      for (int w = 0; w < 2; ++w) {
        const int cw = c + w * L::CHUNK / 2;
        hopper::tma_load_4d(sp + 2 * w * L::BOXB, &tq, full + s, cw, q0, hh,
                            bb);
        hopper::tma_load_4d(sp + (2 * w + 1) * L::BOXB, &tdo, full + s, cw,
                            q0, hh, bb);
      }
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

  float dk_acc[L::CSTEPS * CT][4], dv_acc[L::CSTEPS * CT][4];
#pragma unroll
  for (int j = 0; j < L::CSTEPS * CT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[j][i] = dv_acc[j][i] = 0.f;
  const float scale_log2 = scale * kLog2e;
  // the thread's fragment slots: P^T (written by warpgroup 0) and
  // dP^T - D (by warpgroup 1), slot s of thread t at [s][t]
  float* xmine = xbuf + wg * L::XSLOTS * 128 + tid;
  const float* xp = xbuf + tid;
  const float* xd = xbuf + L::XSLOTS * 128 + tid;
  const int box_a = 2 * wg, box_b = 2 * wg + 1;  // k, q or v, dO

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = (first + it) * L::BQ;

    // warpgroup 0: S^T = k q^T, warpgroup 1: dP^T = v dO^T, over all of D
    // box by box.  A: the warp's k / v rows 16 (warp % 4) + g (+8),
    // columns 8 ks + t4 (+4); B: q / dO row 8 nt + g.  Each row index is g
    // modulo 8, so in the swizzled boxes columns 8 ks + t4 and + 4 sit at
    // c0 + t4 and (c0 ^ 4) + t4 of the row.  The tensor cores round each
    // accumulation toward zero, a bias that grows with the number of
    // accumulations and that dS = P (dP - D) does not cancel: so a box's
    // products go to a fresh fragment (12 accumulations), added to the
    // running sum in fp32, half the q rows at a time
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
    for (int j = 0; j < nbox; ++j) {
      const float* sp = next();
      const float* sa =
          sp + box_a * (L::BOXB / 4) + (16 * (warp % 4) + g) * L::BOX + t4;
      const float* sb = sp + box_b * (L::BOXB / 4) + g * L::BOX + t4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float part[NT / 2][4];
#pragma unroll
        for (int n = 0; n < NT / 2; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[n][i] = 0.f;
#pragma unroll
        for (int ks = 0; ks < L::BOX / 8; ++ks) {
          const int c0 = ((2 * ks ^ g) & 7) << 2, c1 = c0 ^ 4;
          uint32_t ahi[4], alo[4];
          split(sa[c0], ahi[0], alo[0]);
          split(sa[8 * L::BOX + c0], ahi[1], alo[1]);
          split(sa[c1], ahi[2], alo[2]);
          split(sa[8 * L::BOX + c1], ahi[3], alo[3]);
#pragma unroll
          for (int n = 0; n < NT / 2; ++n) {
            const float* br = sb + 8 * (half * NT / 2 + n) * L::BOX;
            uint32_t bhi[2], blo[2];
            split_b(br[c0], br[c1], bhi, blo);
            mma3(part[n], ahi, alo, bhi, blo);
          }
        }
#pragma unroll
        for (int n = 0; n < NT / 2; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[half * NT / 2 + n][i] += part[n][i];
      }
    }

    // The fragment's columns are q rows (c0, c1: key g, q rows 2 t4, +1;
    // c2, c3: key g + 8).  Warpgroup 0: P^T = exp2(S^T scale log2e - lse
    // log2e); columns past Sq and fully-masked rows (lse = -inf) get
    // P = 0, as do keys above the causal diagonal.  Warpgroup 1: dP^T - D.
    // Both then leave their fragment in their slots (the next step's
    // barrier orders the writes before the reads)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = 8 * nt + 2 * t4;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qpos = q0 + col + c;
        const bool in = qpos < Sq;
        if (wg == 0) {
          const float lv = in ? __ldg(lse + qrow_base + qpos) : -INFINITY;
          const float l2 = lv == -INFINITY ? INFINITY : lv * kLog2e;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float p = exp2f(fmaf(acc[nt][2 * h + c], scale_log2, -l2));
            if (causal && key + 8 * h > qpos + shift) p = 0.f;
            acc[nt][2 * h + c] = p;
          }
        } else {
          const float dval = in ? __ldg(dd + qrow_base + qpos) : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) acc[nt][2 * h + c] -= dval;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) xmine[(4 * nt + i) * 128] = acc[nt][i];
    }

    // dV[:, cols] += P^T dO[:, cols] and dK[:, cols] += dS^T q[:, cols],
    // dS^T = P^T (dP^T - D), over the q rows of 8-row tile nt taken in the
    // order 0, 2, 4, 6, 1, 3, 5, 7: A = the C fragments from the slots as
    // they stand, B reads dO / q rows 8 nt + 2 t4 (b0) and + 1 (b1),
    // column 8 jj + g of the warpgroup's box (swizzled)
#pragma unroll
    for (int cs = 0; cs < L::CSTEPS; ++cs) {
      const float* sp = next();
      const float* sq = sp + 2 * wg * (L::BOXB / 4);
      const float* so = sq + L::BOXB / 4;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = xp[(4 * nt + i) * 128];
          ds[i] = p[i] * xd[(4 * nt + i) * 128];
        }
        uint32_t phi[4], plo[4], shi[4], slo[4];
        split_c_as_a(p, phi, plo);
        split_c_as_a(ds, shi, slo);
        const int r = 8 * nt + 2 * t4;
#pragma unroll
        for (int jj = 0; jj < CT; ++jj) {
          const int o0 = swz128(r, 8 * jj + g), o1 = swz128(r + 1, 8 * jj + g);
          uint32_t bhi[2], blo[2];
          split_b(so[o0], so[o1], bhi, blo);
          mma3(dv_acc[cs * CT + jj], phi, plo, bhi, blo);
          split_b(sq[o0], sq[o1], bhi, blo);
          mma3(dk_acc[cs * CT + jj], shi, slo, bhi, blo);
        }
      }
    }
  }

  // epilogue: the warpgroup's columns of dK (x scale) and dV; keys past Sk
  // are not stored
  const int64_t krow_base = ((int64_t)bb * H + hh) * Sk;
  const int64_t d_total = (int64_t)n_chunks * L::CHUNK;
  const int col0 = chunk * L::CHUNK + wg * L::CHUNK / 2 + 2 * t4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kpos = key + 8 * h;
    if (kpos >= Sk) continue;
    float* ko = dk + (krow_base + kpos) * d_total + col0;
    float* vo = dv + (krow_base + kpos) * d_total + col0;
#pragma unroll
    for (int j = 0; j < L::CSTEPS * CT; ++j) {
      *reinterpret_cast<float2*>(ko + 8 * j) = make_float2(
          dk_acc[j][2 * h] * scale, dk_acc[j][2 * h + 1] * scale);
      *reinterpret_cast<float2*>(vo + 8 * j) =
          make_float2(dv_acc[j][2 * h], dv_acc[j][2 * h + 1]);
    }
  }
}

cudaError_t launch_dkv_split_d(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* dd, void* dk, void* dv, int B,
                               int H, int Sq, int Sk, int D,
                               const Strides& st, int causal, float scale,
                               cudaStream_t stream) {
  using L = SplitDkv;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = hopper::encode_bhsd<float>(&tq, q, B, H, Sq, D, st.q_sb,
                                               st.q_sh, st.q_ss, L::BQ);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd<float>(&tk, k, B, H, Sk, D, st.k_sb, st.k_sh,
                                     st.k_ss, L::BKEY);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd<float>(&tv, v, B, H, Sk, D, st.v_sb, st.v_sh,
                                     st.v_ss, L::BKEY);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd<float>(&tdo, dout, B, H, Sq, D, st.o_sb,
                                     st.o_sh, st.o_ss, L::BQ);
  if (err != cudaSuccess) return err;
  static bool smem_set[kMaxDevices] = {};
  err = opt_in_smem(flash_bwd_dkv_split_d_tf32_kernel, L::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int n_chunks = D / L::CHUNK;
  dim3 grid((Sk + L::BKEY - 1) / L::BKEY * n_chunks, H, B);
  flash_bwd_dkv_split_d_tf32_kernel<<<grid, L::THREADS, L::SMEM, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<float*>(dk),
      static_cast<float*>(dv), H, Sq, Sk, n_chunks, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dQ at D = 256 n, n >= 1: the split-D dQ, the split-D dK/dV turned
// around (rows are queries, the loop runs over key tiles).  A CTA of two
// warpgroups owns 64 query rows and one chunk of 2 C columns of dQ;
// warpgroup w owns the chunk's columns C w .. C w + C - 1 (16 rows x C
// columns per warp: C / 2 registers a thread, C = 32 W).  Warpgroup 0
// computes S = q k^T and P, warpgroup 1 dP = dO v^T and dP - D, each once
// over all of D, and they hand their fragments over through shared slots.
// Per key tile the ring carries the 8n score steps (q, k, dO and v boxes
// of 32 columns) and then W / 2 steps of k boxes for dQ += dS k (two boxes
// of its own columns per warpgroup).
// ---------------------------------------------------------------------------
template <int W>
__global__ void __launch_bounds__(SplitRing::THREADS, 1)
flash_bwd_dq_split_d_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap tdo,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ dd,
                                 float* __restrict__ dq, int H, int Sq,
                                 int Sk, int n_chunks, int causal,
                                 float scale) {
  using L = SplitRing;
  constexpr int BQ = L::ROWS;         // query rows per CTA, 16 a warp
  constexpr int BK = L::ROWS;         // keys per tile
  constexpr int NT = BK / 8;          // 8-key tiles of S / k8 steps of dS k
  constexpr int CT = L::BOX / 8;      // 8-column tiles of a box
  constexpr int CSTEPS = W / 2;       // second-product steps
  static_assert(W % 2 == 0, "a second-product step holds two own boxes");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  float* xbuf = reinterpret_cast<float*>(smem + L::X_OFF);  // [2][XSLOTS][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);

  const int warp = threadIdx.x / 32;
  const int wg = warp / 4;               // 0: S, P; 1: dP
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int tid = threadIdx.x % 128;     // the thread in its warpgroup
  const int chunk = blockIdx.x % n_chunks;  // the CTA's dQ columns
  const int q0 = blockIdx.x / n_chunks * BQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int rw0 = q0 + 16 * (warp % 4);  // the warp's first row
  const int row = rw0 + g;               // the thread's rows: row, row + 8

  const int shift = Sk - Sq;  // bottom-right causal alignment
  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {
    // keys visible to the CTA's last row (attention.py:273)
    const int hi = q0 + BQ + shift;
    n_tiles = min(n_tiles, hi <= 0 ? 0 : (hi + BK - 1) / BK);
  }
  const int nbox = n_chunks * 2 * W;  // D / BOX: score steps per key tile
  const int per_tile = nbox + CSTEPS;
  const int total = n_tiles * per_tile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) hopper::mbar_init(full + s, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // thread 0 starts step i into stage i % STAGES (rows past Sq or Sk
  // zero-filled): a score step's q, k, dO and v boxes, or a second-product
  // step's two k boxes of each warpgroup's columns
  auto issue = [&](int i) {
    if (i >= total) return;
    const int t = i / per_tile, j = i % per_tile, s = i % L::STAGES;
    const int k0 = t * BK;
    uint8_t* sp = smem + s * L::STAGE;
    hopper::mbar_arrive_expect_tx(full + s, L::STAGE);
    if (j < nbox) {
      const int c = j * L::BOX;
      hopper::tma_load_4d(sp, &tq, full + s, c, q0, hh, bb);
      hopper::tma_load_4d(sp + L::BOXB, &tk, full + s, c, k0, hh, bb);
      hopper::tma_load_4d(sp + 2 * L::BOXB, &tdo, full + s, c, q0, hh, bb);
      hopper::tma_load_4d(sp + 3 * L::BOXB, &tv, full + s, c, k0, hh, bb);
    } else {
      const int cs = j - nbox;
      for (int w = 0; w < 2; ++w)
        for (int b = 0; b < 2; ++b)
          hopper::tma_load_4d(sp + (2 * w + b) * L::BOXB, &tk, full + s,
                              ((2 * chunk + w) * W + 2 * cs + b) * L::BOX,
                              k0, hh, bb);
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

  // of the thread's two rows, warpgroup 0 keeps the lse in log2 units
  // (+inf past Sq and on fully-masked rows: P = 0 there), warpgroup 1 D
  const int64_t row_base = ((int64_t)bb * H + hh) * Sq;
  float rowv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = row + 8 * h;
    if (wg == 0) {
      const float lv = qpos < Sq ? __ldg(lse + row_base + qpos) : -INFINITY;
      rowv[h] = lv == -INFINITY ? INFINITY : lv * kLog2e;
    } else {
      rowv[h] = qpos < Sq ? __ldg(dd + row_base + qpos) : 0.f;
    }
  }
  const float scale_log2 = scale * kLog2e;

  float acc[W * CT][4];
#pragma unroll
  for (int j = 0; j < W * CT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  // the thread's fragment slots: P (written by warpgroup 0) and dP - D (by
  // warpgroup 1), slot s of thread t at [s][t]
  float* xmine = xbuf + wg * L::XSLOTS * 128 + tid;
  const float* xp = xbuf + tid;
  const float* xd = xbuf + L::XSLOTS * 128 + tid;
  const int box_a = 2 * wg, box_b = 2 * wg + 1;  // q, k or dO, v

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;

    // warpgroup 0: S = q k^T, warpgroup 1: dP = dO v^T, over all of D box
    // by box.  A: the warp's q / dO rows 16 (warp % 4) + g (+8), columns
    // 8 ks + t4 (+4); B: k / v row 8 nt + g.  Each row index is g modulo
    // 8, so in the swizzled boxes columns 8 ks + t4 and + 4 sit at c0 + t4
    // and (c0 ^ 4) + t4 of the row.  As in the dK/dV kernel, a box's
    // products go to a fresh fragment (12 accumulations), added to the
    // running sum in fp32, half the keys at a time: the tensor cores round
    // each accumulation toward zero, and dS = P (dP - D) keeps that bias
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    for (int j = 0; j < nbox; ++j) {
      const float* sp = next();
      const float* sa =
          sp + box_a * (L::BOXB / 4) + (16 * (warp % 4) + g) * L::BOX + t4;
      const float* sb = sp + box_b * (L::BOXB / 4) + g * L::BOX + t4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float part[NT / 2][4];
#pragma unroll
        for (int n = 0; n < NT / 2; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[n][i] = 0.f;
#pragma unroll
        for (int ks = 0; ks < L::BOX / 8; ++ks) {
          const int c0 = ((2 * ks ^ g) & 7) << 2, c1 = c0 ^ 4;
          uint32_t ahi[4], alo[4];
          split(sa[c0], ahi[0], alo[0]);
          split(sa[8 * L::BOX + c0], ahi[1], alo[1]);
          split(sa[c1], ahi[2], alo[2]);
          split(sa[8 * L::BOX + c1], ahi[3], alo[3]);
#pragma unroll
          for (int n = 0; n < NT / 2; ++n) {
            const float* br = sb + 8 * (half * NT / 2 + n) * L::BOX;
            uint32_t bhi[2], blo[2];
            split_b(br[c0], br[c1], bhi, blo);
            mma3(part[n], ahi, alo, bhi, blo);
          }
        }
#pragma unroll
        for (int n = 0; n < NT / 2; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[half * NT / 2 + n][i] += part[n][i];
      }
    }

    // C fragment: c0, c1 (row, keys 8 nt + 2 t4, +1), c2, c3 (row + 8).
    // Warpgroup 0: P = exp2(S scale log2e - lse log2e), 0 for keys past Sk
    // (zero-filled, and a zero score is not -inf) and above the causal
    // diagonal.  Warpgroup 1: dP - D.  Both leave the fragment in their
    // slots (the next step's barrier orders the writes before the reads)
    const bool need_mask =
        k0 + BK > Sk || (causal && k0 + BK - 1 > rw0 + shift);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i / 2;
        float x;
        if (wg == 0) {
          x = exp2f(fmaf(s[nt][i], scale_log2, -rowv[h]));
          if (need_mask) {
            const int kpos = k0 + 8 * nt + 2 * t4 + (i % 2);
            if (kpos >= Sk || (causal && kpos > row + 8 * h + shift)) x = 0.f;
          }
        } else {
          x = s[nt][i] - rowv[h];
        }
        xmine[(4 * nt + i) * 128] = x;
      }

    // dQ[:, cols] += dS k[:, cols], dS = P (dP - D) from the slots (the
    // same product in both warpgroups), over the keys of 8-key tile nt
    // taken in the order 0, 2, 4, 6, 1, 3, 5, 7: A = dS's C fragment as it
    // stands, B reads k rows 8 nt + 2 t4 (b0) and + 1 (b1), column 8 jj + g
    // of the warpgroup's box (swizzled)
#pragma unroll
    for (int cs = 0; cs < CSTEPS; ++cs) {
      const float* sp = next();
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ds[i] = xp[(4 * nt + i) * 128] * xd[(4 * nt + i) * 128];
        uint32_t ahi[4], alo[4];
        split_c_as_a(ds, ahi, alo);
        const int r = 8 * nt + 2 * t4;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const float* kb = sp + (2 * wg + b) * (L::BOXB / 4);
#pragma unroll
          for (int jj = 0; jj < CT; ++jj) {
            const int c = 8 * jj + g;
            uint32_t bhi[2], blo[2];
            split_b(kb[swz128(r, c)], kb[swz128(r + 1, c)], bhi, blo);
            mma3(acc[(2 * cs + b) * CT + jj], ahi, alo, bhi, blo);
          }
        }
      }
    }
  }

  // epilogue: the warpgroup's columns of dQ (x scale); rows past Sq are
  // not stored
  const int64_t d_total = (int64_t)n_chunks * 2 * W * L::BOX;
  const int col0 = (2 * chunk + wg) * W * L::BOX + 2 * t4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = row + 8 * h;
    if (qpos >= Sq) continue;
    float* out = dq + (row_base + qpos) * d_total + col0;
#pragma unroll
    for (int j = 0; j < W * CT; ++j)
      *reinterpret_cast<float2*>(out + 8 * j) =
          make_float2(acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale);
  }
}

template <int W>
cudaError_t launch_dq_split_d_w(const CUtensorMap& tq, const CUtensorMap& tk,
                                const CUtensorMap& tv, const CUtensorMap& tdo,
                                const void* lse, const void* dd, void* dq,
                                int B, int H, int Sq, int Sk, int D,
                                int causal, float scale,
                                cudaStream_t stream) {
  using L = SplitRing;
  static bool smem_set[kMaxDevices] = {};
  cudaError_t err =
      opt_in_smem(flash_bwd_dq_split_d_tf32_kernel<W>, L::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int n_chunks = D / (2 * W * L::BOX);
  dim3 grid((Sq + L::ROWS - 1) / L::ROWS * n_chunks, H, B);
  flash_bwd_dq_split_d_tf32_kernel<W><<<grid, L::THREADS, L::SMEM, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<float*>(dq), H, Sq, Sk,
      n_chunks, causal, scale);
  return cudaGetLastError();
}

// D = 256 n: each warpgroup owns C = 256 columns where n is even (one CTA
// a q tile at D = 512: the scores are computed once), 192 where n is a
// multiple of 3 (two chunks at D = 768), else 128 (n chunks; one at
// D = 256)
cudaError_t launch_dq_split_d(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* dd, void* dq, int B, int H, int Sq,
                              int Sk, int D, const Strides& st, int causal,
                              float scale, cudaStream_t stream) {
  using L = SplitRing;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = hopper::encode_bhsd<float>(&tq, q, B, H, Sq, D, st.q_sb,
                                               st.q_sh, st.q_ss, L::ROWS);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd<float>(&tk, k, B, H, Sk, D, st.k_sb, st.k_sh,
                                     st.k_ss, L::ROWS);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd<float>(&tv, v, B, H, Sk, D, st.v_sb, st.v_sh,
                                     st.v_ss, L::ROWS);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd<float>(&tdo, dout, B, H, Sq, D, st.o_sb,
                                     st.o_sh, st.o_ss, L::ROWS);
  if (err != cudaSuccess) return err;
  if (D % 512 == 0)
    return launch_dq_split_d_w<8>(tq, tk, tv, tdo, lse, dd, dq, B, H, Sq, Sk,
                                  D, causal, scale, stream);
  if (D % 384 == 0)
    return launch_dq_split_d_w<6>(tq, tk, tv, tdo, lse, dd, dq, B, H, Sq, Sk,
                                  D, causal, scale, stream);
  return launch_dq_split_d_w<4>(tq, tk, tv, tdo, lse, dd, dq, B, H, Sq, Sk,
                                D, causal, scale, stream);
}

}  // namespace tf32

// ---------------------------------------------------------------------------
// bf16 and fp16: warp-specialized wgmma kernels (dK/dV, then dQ), one
// source for both 16-bit types T = __nv_bfloat16, __half
// ---------------------------------------------------------------------------
namespace wg {

using hopper::Wgmma;

constexpr int BQ = 64;          // dK/dV: query rows per streamed tile
constexpr int DQ_BQ = 128;      // dQ: query rows per CTA (two consumers)
constexpr int THREADS = 384;    // warpgroups 0, 1 consume; 2 produces
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float kLog2e = 1.4426950408889634f;

// dK/dV shared memory: K and V (resident), two stages of q and of dO, each
// as D / COLS boxes of [rows][COLS] 16-bit elements; two stages of the q
// tile's lse (log2 units) and D rows; then the mbarriers.
// Up to D = 128 a CTA owns 128 keys, 64 per consumer warpgroup, each with
// all D columns of dK and dV.  At D = 256 that would be 256 accumulator
// registers a thread (and 256 KB of shared memory): there a CTA owns 64
// keys, and the two warpgroups split dK and dV by head-dim columns
// (warpgroup w owns boxes OWN w .. OWN w + OWN - 1), both computing the
// score products over all of D.
template <int D>
struct Layout {
  static constexpr bool SPLIT = D > 128;  // the warpgroups split columns
  static constexpr int BKV = SPLIT ? 64 : 128;  // keys per CTA
  static constexpr int COLS = hopper::box_cols(D);
  static constexpr int NBOX = D / COLS;
  // the boxes of dK and dV that one consumer accumulates
  static constexpr int OWN = SPLIT ? NBOX / 2 : NBOX;
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
  static_assert(SMEM <= hopper::kMaxSmem,
                "dK/dV tiles exceed the shared-memory opt-in");
};

template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ dd,
                           T* __restrict__ dk, T* __restrict__ dv, int H,
                           int Sq,
                           int Sk, int causal, float scale) {
  using L = Layout<D>;
  constexpr int BKV = L::BKV;
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
    // (D = 256: both own keys k0 .. k0 + 63, and boxes b0 .. b0 + OWN - 1
    // of dK and dV)
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    constexpr int SN = BQ / 2;        // S^T / dP^T fragment: 32 fp32
    constexpr int ON = L::COLS / 2;   // dK / dV fragment per box
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int wrow = L::SPLIT ? 0 : 64 * wg;  // the keys' row in the CTA
    const int b0 = L::SPLIT ? L::OWN * wg : 0;  // the first own box
    const int kw0 = k0 + wrow;                         // first key
    const int key = kw0 + 16 * (tid / 32) + lane / 4;  // keys key, key + 8
    const uint8_t* sk = smem + L::K_OFF + wrow * L::ROW;
    const uint8_t* sv = smem + L::V_OFF + wrow * L::ROW;
    const float scale_log2 = scale * kLog2e;

    float dk_acc[L::OWN][ON], dv_acc[L::OWN][ON];
#pragma unroll
    for (int b = 0; b < L::OWN; ++b)
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
        Wgmma<BQ, 0, T>::ss(
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
        Wgmma<BQ, 0, T>::ss(
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
          pa[kk][r] = hopper::pack2<T>(p0, p1);
          dsa[kk][r] = hopper::pack2<T>(p0 * (dpt[i] - dr.x),
                                        p1 * (dpt[i + 1] - dr.y));
        }

      // dV += P^T dO and dK += dS^T q over the own boxes: A from
      // registers, B = the same dO / q tile MN-major, one 16-row slice and
      // one box per instruction
#pragma unroll
      for (int b = 0; b < L::OWN; ++b) {
        hopper::fence_regs(dv_acc[b]);
        hopper::fence_regs(dk_acc[b]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int b = 0; b < L::OWN; ++b) {
          const uint32_t off = (b0 + b) * L::Q_BOX + kk * 16 * L::ROW;
          Wgmma<L::COLS, 1, T>::rs(
              dv_acc[b], pa[kk],
              hopper::make_desc(sdo + off, L::Q_BOX, L::SBO, L::SWIZZLE), 1);
          Wgmma<L::COLS, 1, T>::rs(
              dk_acc[b], dsa[kk],
              hopper::make_desc(sq + off, L::Q_BOX, L::SBO, L::SWIZZLE), 1);
        }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < L::OWN; ++b) {
        hopper::fence_regs(dv_acc[b]);
        hopper::fence_regs(dk_acc[b]);
      }
      hopper::mbar_arrive(q_empty + s);
    }

    // epilogue: dK scale and dV to T; keys past Sk are not stored
    const int64_t krow_base = ((int64_t)bb * H + hh) * Sk;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kpos = key + 8 * h;
      if (kpos >= Sk) continue;
      const int64_t off = (krow_base + kpos) * D + 2 * (lane % 4);
#pragma unroll
      for (int b = 0; b < L::OWN; ++b)
#pragma unroll
        for (int j = 0; j < L::COLS / 8; ++j) {
          const int i = 4 * j + 2 * h;
          const int64_t at = off + (b0 + b) * L::COLS + 8 * j;
          *reinterpret_cast<uint32_t*>(dk + at) = hopper::pack2<T>(
              dk_acc[b][i] * scale, dk_acc[b][i + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + at) =
              hopper::pack2<T>(dv_acc[b][i], dv_acc[b][i + 1]);
        }
    }
  }
}

template <int D, typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dd,
                       void* dk, void* dv, int B, int H, int Sq, int Sk,
                       const Strides& st, int causal, float scale,
                       cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = hopper::encode_bhsd<T>(&tq, q, B, H, Sq, D, st.q_sb,
                                           st.q_sh, st.q_ss, BQ);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd<T>(&tk, k, B, H, Sk, D, st.k_sb, st.k_sh,
                                 st.k_ss, Layout<D>::BKV);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd<T>(&tv, v, B, H, Sk, D, st.v_sb, st.v_sh,
                                 st.v_ss, Layout<D>::BKV);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd<T>(&tdo, dout, B, H, Sq, D, st.o_sb, st.o_sh,
                                 st.o_ss, BQ);
  if (err != cudaSuccess) return err;
  static bool smem_set[kMaxDevices] = {};
  err = opt_in_smem(flash_bwd_dkv_wgmma_kernel<D, T>, Layout<D>::SMEM,
                    smem_set);
  if (err != cudaSuccess) return err;
  constexpr int BKV = Layout<D>::BKV;
  dim3 grid((Sk + BKV - 1) / BKV, H, B);
  flash_bwd_dkv_wgmma_kernel<D, T>
      <<<grid, THREADS, Layout<D>::SMEM, stream>>>(
          tq, tk, tv, tdo, static_cast<const float*>(lse),
          static_cast<const float*>(dd), static_cast<T*>(dk),
          static_cast<T*>(dv), H, Sq, Sk, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dkv_dispatch(int D, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* dd,
                         void* dk, void* dv, int B, int H, int Sq, int Sk,
                         const Strides& st, int causal, float scale,
                         cudaStream_t s) {
  switch (D) {
    case 32:
      return launch_dkv<32, T>(q, k, v, dout, lse, dd, dk, dv, B, H, Sq, Sk,
                               st, causal, scale, s);
    case 64:
      return launch_dkv<64, T>(q, k, v, dout, lse, dd, dk, dv, B, H, Sq, Sk,
                               st, causal, scale, s);
    case 128:
      return launch_dkv<128, T>(q, k, v, dout, lse, dd, dk, dv, B, H, Sq, Sk,
                                st, causal, scale, s);
    case 256:
      return launch_dkv<256, T>(q, k, v, dout, lse, dd, dk, dv, B, H, Sq, Sk,
                                st, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// dK/dV at D = 256 n, n >= 2: the split-D dK/dV, the 3xTF32 split-D
// dK/dV's design on wgmma.  A CTA owns 64 keys and one 256-column chunk of
// dK and dV; consumer warpgroup w owns the chunk's columns 128 w .. 128 w
// + 127 of both (two 64-column boxes: 128 accumulator registers, as at
// D = 256).  The score products split by role: warpgroup 0 computes
// S^T = k q^T and P^T, warpgroup 1 dP^T = v dO^T and dP^T - D, each once
// over all of D, and they hand their m64n64 fragments over through fp32
// shared slots (the same fragment layout in both, so a thread reads the
// slots of its own index in the other warpgroup).  One stream of steps
// runs through a ring of stages that the producer warp fills by TMA: per
// q tile the 4n score steps (k, q, v and dO boxes of 64 columns), then two
// second-product steps (for each warpgroup a q box and a dO box of its
// columns).  Shared memory does not grow with D.
// ---------------------------------------------------------------------------
// The ring of the two 16-bit split-D backward kernels (dK/dV here, dQ
// below): 64-row boxes of 64 16-bit columns, four a stage, and the two
// warpgroups' m64n64 score fragments handed over through fp32 slots.
struct SplitBwdLayout {
  static constexpr int BKEY = 64;          // keys per dK/dV CTA, dQ tile
  static constexpr int CHUNK = 256;        // output columns per CTA
  static constexpr int COLS = 64;          // columns of a box (128 bytes)
  static constexpr int OWN = CHUNK / 2 / COLS;  // a consumer's dK, dV boxes
  static constexpr int STAGES = 6;
  static constexpr uint32_t ROW = COLS * 2;        // bytes of a box row
  static constexpr uint32_t SBO = 8 * ROW;         // next 8-row group
  static constexpr uint32_t BOX = BQ * ROW;        // 8,192: a 64-row box
  static constexpr uint32_t STAGE = 4 * BOX;       // four boxes a step
  static constexpr int SN = BQ / 2;                // S^T fragment: 32 fp32
  static constexpr uint32_t X_OFF = STAGES * STAGE;  // P^T and dP^T - D
  static constexpr uint32_t BAR_OFF = X_OFF + 2 * SN * 128 * 4;
  // full and empty per stage
  static constexpr size_t SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;
  static_assert(BKEY == BQ, "k and q boxes have the same rows");
  static_assert(BOX % 1024 == 0, "every box must start on 1024 bytes");
  static_assert(SMEM <= hopper::kMaxSmem,
                "split-D dK/dV stages exceed the shared-memory opt-in");
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_split_d_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                   const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tv,
                                   const __grid_constant__ CUtensorMap tdo,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ dd,
                                   T* __restrict__ dk, T* __restrict__ dv,
                                   int H, int Sq, int Sk, int n_chunks,
                                   int causal, float scale) {
  using L = SplitBwdLayout;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  float* xbuf = reinterpret_cast<float*>(smem + L::X_OFF);  // [2][SN][128]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = bars;             // [STAGES] the step's boxes landed
  uint64_t* empty = bars + STAGES;   // [STAGES] both consumers are done

  const int chunk = blockIdx.x % n_chunks;  // the CTA's output columns
  const int k0 = blockIdx.x / n_chunks * L::BKEY;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int shift = Sk - Sq;  // bottom-right causal alignment
  const int n_qt = (Sq + BQ - 1) / BQ;
  int first = 0;
  if (causal) {
    // the first q tile that sees key k0 (attention.py:321)
    const int lo = k0 - shift;
    first = lo <= 0 ? 0 : lo / BQ;
  }
  const int n_tiles = max(n_qt - first, 0);  // 0: no query sees these keys
  const int nbox = n_chunks * L::CHUNK / L::COLS;  // score steps per q tile
  const int per_tile = nbox + L::OWN;
  const int total = n_tiles * per_tile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 2 * 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread starts every TMA load; step i goes into
    // stage i % STAGES once both consumers released its use before
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      for (int i = 0; i < total; ++i) {
        const int s = i % STAGES, use = i / STAGES;
        if (use > 0) hopper::mbar_wait(empty + s, (use - 1) & 1);
        const int it = i / per_tile, j = i % per_tile;
        const int q0 = (first + it) * BQ;
        uint8_t* sp = smem + s * L::STAGE;
        hopper::mbar_arrive_expect_tx(full + s, L::STAGE);
        if (j < nbox) {  // a score step: k, q, v and dO boxes
          const int c = j * L::COLS;
          hopper::tma_load_4d(sp, &tk, full + s, c, k0, hh, bb);
          hopper::tma_load_4d(sp + L::BOX, &tq, full + s, c, q0, hh, bb);
          hopper::tma_load_4d(sp + 2 * L::BOX, &tv, full + s, c, k0, hh, bb);
          hopper::tma_load_4d(sp + 3 * L::BOX, &tdo, full + s, c, q0, hh,
                              bb);
        } else {  // a second-product step: each consumer's q and dO box
          const int c = chunk * L::CHUNK + (j - nbox) * L::COLS;
          for (int w = 0; w < 2; ++w) {
            const int cw = c + w * L::CHUNK / 2;
            hopper::tma_load_4d(sp + 2 * w * L::BOX, &tq, full + s, cw, q0,
                                hh, bb);
            hopper::tma_load_4d(sp + (2 * w + 1) * L::BOX, &tdo, full + s,
                                cw, q0, hh, bb);
          }
        }
      }
    }
  } else {
    // ---- consumers: both own keys k0 .. k0 + 63 as rows; warpgroup wg
    // computes S^T (0) or dP^T (1) and owns boxes OWN wg .. of the chunk's
    // dK and dV
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    constexpr int SN = L::SN;
    constexpr int ON = L::COLS / 2;   // dK / dV fragment per box
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int key = k0 + 16 * (tid / 32) + lane / 4;  // keys key, key + 8
    const float scale_log2 = scale * kLog2e;
    const int64_t qrow_base = ((int64_t)bb * H + hh) * Sq;
    // the thread's slots: P^T (written by warpgroup 0) and dP^T - D (by
    // warpgroup 1), slot i of thread t at [i][t]
    float* xmine = xbuf + wg * SN * 128 + tid;
    const float* xother = xbuf + (1 - wg) * SN * 128 + tid;
    // a score step's A (k or v) and B (q or dO) boxes
    const uint32_t box_a = 2 * wg * L::BOX, box_b = box_a + L::BOX;

    float dk_acc[L::OWN][ON], dv_acc[L::OWN][ON];
#pragma unroll
    for (int b = 0; b < L::OWN; ++b)
#pragma unroll
      for (int i = 0; i < ON; ++i) dk_acc[b][i] = dv_acc[b][i] = 0.f;
    float acc[SN];
#pragma unroll
    for (int i = 0; i < SN; ++i) acc[i] = 0.f;

    int slot = 0;
    uint32_t phase = 0;  // parity of the ring's current use
    for (int it = 0; it < n_tiles; ++it) {
      const int q0 = (first + it) * BQ;
      // the fragment's 16 columns are q rows 8 j + 2 (lane % 4) + c:
      // warpgroup 0 reads their lse (log2 units, +inf past Sq and on
      // fully-masked rows, so P = 0 there), warpgroup 1 their D, while
      // the score products run
      float rowv[BQ / 8][2];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qpos = q0 + 8 * j + 2 * (lane % 4) + c;
          if (wg == 0) {
            const float lv =
                qpos < Sq ? __ldg(lse + qrow_base + qpos) : -INFINITY;
            rowv[j][c] = lv == -INFINITY ? INFINITY : lv * kLog2e;
          } else {
            rowv[j][c] = qpos < Sq ? __ldg(dd + qrow_base + qpos) : 0.f;
          }
        }

      // warpgroup 0: S^T = k q^T, warpgroup 1: dP^T = v dO^T, over the 4n
      // boxes of D (m64n64k16, both operands K-major).  One commit group
      // per box; a stage is released once the next box's group is issued
      // and its own has completed (wgmma wait 1)
      hopper::fence_regs(acc);
      int prev = 0;
      for (int j = 0; j < nbox; ++j) {
        hopper::mbar_wait(full + slot, phase);
        const uint8_t* sp = smem + slot * L::STAGE;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < L::COLS / 16; ++kk)
          Wgmma<BQ, 0, T>::ss(
              acc,
              hopper::make_desc(sp + box_a + kk * 32, 16, L::SBO,
                                hopper::kSwizzle128B),
              hopper::make_desc(sp + box_b + kk * 32, 16, L::SBO,
                                hopper::kSwizzle128B),
              (j | kk) != 0);
        hopper::wgmma_commit();
        if (j > 0) {
          hopper::wgmma_wait<1>();
          hopper::mbar_arrive(empty + prev);
        }
        prev = slot;
        if (++slot == STAGES) {
          slot = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::mbar_arrive(empty + prev);

      // warpgroup 0: P^T = exp2(S^T scale log2e - lse log2e), 0 above the
      // causal diagonal; warpgroup 1: dP^T - D.  Both leave the fragment in
      // their slots; the barrier before the writes keeps them behind the
      // other warpgroup's reads of the last tile, the one after them
      // orders them before this tile's reads
      const bool need_mask = causal && k0 + L::BKEY - 1 > q0 + shift;
      if (it > 0) hopper::named_barrier_sync(1, 2 * 128);
#pragma unroll
      for (int i = 0; i < SN; ++i) {
        const int j = i / 4, c = i % 2;
        float x;
        if (wg == 0) {
          x = exp2f(acc[i] * scale_log2 - rowv[j][c]);
          if (need_mask &&
              key + 8 * ((i / 2) % 2) > q0 + 8 * j + 2 * (lane % 4) + c +
                                            shift)
            x = 0.f;
        } else {
          x = acc[i] - rowv[j][c];
        }
        acc[i] = x;
        xmine[i * 128] = x;
      }
      hopper::named_barrier_sync(1, 2 * 128);

      // dS^T = P^T (dP^T - D) (the same product in both warpgroups); P^T
      // and dS^T rounded to T as the register A operands (the TPU
      // kernel's `p.astype(do.dtype)`, `.astype(q.dtype)`)
      uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r;
          const float o0 = xother[i * 128], o1 = xother[(i + 1) * 128];
          const float p0 = wg == 0 ? acc[i] : o0;
          const float p1 = wg == 0 ? acc[i + 1] : o1;
          pa[kk][r] = hopper::pack2<T>(p0, p1);
          dsa[kk][r] = hopper::pack2<T>(acc[i] * o0, acc[i + 1] * o1);
        }

      // dV[:, own] += P^T dO[:, own] and dK[:, own] += dS^T q[:, own]: A
      // from registers, B = the step's q / dO box of the warpgroup's
      // columns read MN-major, one 16-row slice per instruction
#pragma unroll
      for (int b = 0; b < L::OWN; ++b) {
        hopper::fence_regs(dv_acc[b]);
        hopper::fence_regs(dk_acc[b]);
      }
#pragma unroll
      for (int b = 0; b < L::OWN; ++b) {
        hopper::mbar_wait(full + slot, phase);
        const uint8_t* sq = smem + slot * L::STAGE + 2 * wg * L::BOX;
        const uint8_t* sdo = sq + L::BOX;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          Wgmma<L::COLS, 1, T>::rs(
              dv_acc[b], pa[kk],
              hopper::make_desc(sdo + kk * 16 * L::ROW, L::BOX, L::SBO,
                                hopper::kSwizzle128B),
              1);
          Wgmma<L::COLS, 1, T>::rs(
              dk_acc[b], dsa[kk],
              hopper::make_desc(sq + kk * 16 * L::ROW, L::BOX, L::SBO,
                                hopper::kSwizzle128B),
              1);
        }
        hopper::wgmma_commit();
        if (b > 0) {
          hopper::wgmma_wait<1>();
          hopper::mbar_arrive(empty + prev);
        }
        prev = slot;
        if (++slot == STAGES) {
          slot = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < L::OWN; ++b) {
        hopper::fence_regs(dv_acc[b]);
        hopper::fence_regs(dk_acc[b]);
      }
      hopper::mbar_arrive(empty + prev);
    }

    // epilogue: the warpgroup's columns of dK (x scale) and dV to T; keys
    // past Sk are not stored
    const int64_t krow_base = ((int64_t)bb * H + hh) * Sk;
    const int64_t d_total = (int64_t)n_chunks * L::CHUNK;
    const int col0 = chunk * L::CHUNK + wg * L::CHUNK / 2 + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kpos = key + 8 * h;
      if (kpos >= Sk) continue;
      T* ko = dk + (krow_base + kpos) * d_total + col0;
      T* vo = dv + (krow_base + kpos) * d_total + col0;
#pragma unroll
      for (int b = 0; b < L::OWN; ++b)
#pragma unroll
        for (int j = 0; j < L::COLS / 8; ++j) {
          const int i = 4 * j + 2 * h;
          const int at = b * L::COLS + 8 * j;
          *reinterpret_cast<uint32_t*>(ko + at) = hopper::pack2<T>(
              dk_acc[b][i] * scale, dk_acc[b][i + 1] * scale);
          *reinterpret_cast<uint32_t*>(vo + at) =
              hopper::pack2<T>(dv_acc[b][i], dv_acc[b][i + 1]);
        }
    }
  }
}

template <typename T>
cudaError_t launch_dkv_split_d(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* dd, void* dk, void* dv, int B,
                               int H, int Sq, int Sk, int D,
                               const Strides& st, int causal, float scale,
                               cudaStream_t stream) {
  using L = SplitBwdLayout;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = hopper::encode_bhsd<T>(&tq, q, B, H, Sq, D, st.q_sb,
                                           st.q_sh, st.q_ss, BQ);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd<T>(&tk, k, B, H, Sk, D, st.k_sb, st.k_sh,
                                 st.k_ss, L::BKEY);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd<T>(&tv, v, B, H, Sk, D, st.v_sb, st.v_sh,
                                 st.v_ss, L::BKEY);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd<T>(&tdo, dout, B, H, Sq, D, st.o_sb, st.o_sh,
                                 st.o_ss, BQ);
  if (err != cudaSuccess) return err;
  static bool smem_set[kMaxDevices] = {};
  err = opt_in_smem(flash_bwd_dkv_split_d_wgmma_kernel<T>, L::SMEM,
                    smem_set);
  if (err != cudaSuccess) return err;
  const int n_chunks = D / L::CHUNK;
  dim3 grid((Sk + L::BKEY - 1) / L::BKEY * n_chunks, H, B);
  flash_bwd_dkv_split_d_wgmma_kernel<T><<<grid, THREADS, L::SMEM, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<T*>(dk), static_cast<T*>(dv),
      H, Sq, Sk, n_chunks, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dQ at D = 256 n, n >= 2: the split-D dQ, the 3xTF32 split-D dQ's design
// on wgmma with the warp roles of the split-D dK/dV.  A CTA owns 64 query
// rows and one chunk of 2 C dQ columns, C = 64 NB; consumer warpgroup w owns
// the chunk's columns C w .. C w + C - 1 (NB 64-column boxes: 32 NB
// accumulator registers a thread).  Warpgroup 0 computes S = q k^T and P,
// warpgroup 1 dP = dO v^T and dP - D, each once over all of D (m64n64k16
// over the 4n (q, k) or (dO, v) box pairs of a key tile's score steps), and
// they hand their fragments over through the fp32 slots.  Both then form
// dS = P (dP - D), rounded to T as the register A operand of dQ += dS k, B
// = the k boxes of the warpgroup's own columns (MN-major) that the
// second-product steps carry: per key tile, (NB + 1) / 2 steps of up to two
// boxes a warpgroup.  The ring and its 230,496 B are the dK/dV's.  A
// stage's empty barrier takes one arrival per consumer warpgroup, from one
// thread once the warpgroup's products on the stage have completed (wgmma
// wait), the way CUTLASS's TMA pipeline releases a stage.
// ---------------------------------------------------------------------------
template <typename T, int NB>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_split_d_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const __grid_constant__ CUtensorMap tdo,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ dd,
                                  T* __restrict__ dq, int H, int Sq, int Sk,
                                  int n_chunks, int causal, float scale) {
  using L = SplitBwdLayout;
  constexpr int STAGES = L::STAGES;
  constexpr int BK = L::BKEY;           // keys per tile
  constexpr int C = NB * L::COLS;       // dQ columns of a warpgroup
  constexpr int CSTEPS = (NB + 1) / 2;  // second-product steps per key tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  float* xbuf = reinterpret_cast<float*>(smem + L::X_OFF);  // [2][SN][128]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = bars;             // [STAGES] the step's boxes landed
  uint64_t* empty = bars + STAGES;   // [STAGES] both consumers are done

  const int chunk = blockIdx.x % n_chunks;  // the CTA's dQ columns
  const int q0 = blockIdx.x / n_chunks * BQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int shift = Sk - Sq;  // bottom-right causal alignment
  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {
    // keys visible to the CTA's last row (attention.py:273)
    const int hi = q0 + BQ + shift;
    n_tiles = min(n_tiles, hi <= 0 ? 0 : (hi + BK - 1) / BK);
  }
  const int nbox = n_chunks * 2 * NB;  // D / 64: score steps per key tile
  const int per_tile = nbox + CSTEPS;
  const int total = n_tiles * per_tile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 2);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread starts every TMA load (rows past Sq or Sk
    // zero-filled); step i goes into stage i % STAGES once both consumers
    // released its use before
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      for (int i = 0; i < total; ++i) {
        const int s = i % STAGES, use = i / STAGES;
        if (use > 0) hopper::mbar_wait(empty + s, (use - 1) & 1);
        const int t = i / per_tile, j = i % per_tile;
        const int k0 = t * BK;
        uint8_t* sp = smem + s * L::STAGE;
        if (j < nbox) {  // a score step: q, k, dO and v boxes
          const int c = j * L::COLS;
          hopper::mbar_arrive_expect_tx(full + s, L::STAGE);
          hopper::tma_load_4d(sp, &tq, full + s, c, q0, hh, bb);
          hopper::tma_load_4d(sp + L::BOX, &tk, full + s, c, k0, hh, bb);
          hopper::tma_load_4d(sp + 2 * L::BOX, &tdo, full + s, c, q0, hh,
                              bb);
          hopper::tma_load_4d(sp + 3 * L::BOX, &tv, full + s, c, k0, hh, bb);
        } else {  // a second-product step: each warpgroup's own k boxes
          const int b0 = 2 * (j - nbox);
          const int nb = min(2, NB - b0);
          hopper::mbar_arrive_expect_tx(full + s, 2 * nb * L::BOX);
          for (int w = 0; w < 2; ++w)
            for (int b = 0; b < nb; ++b)
              hopper::tma_load_4d(sp + (2 * w + b) * L::BOX, &tk, full + s,
                                  (2 * chunk + w) * C + (b0 + b) * L::COLS,
                                  k0, hh, bb);
        }
      }
    }
  } else {
    // ---- consumers: both own query rows q0 .. q0 + 63; warpgroup wg
    // computes S (0) or dP (1) and owns the chunk's dQ boxes NB wg ..
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    constexpr int SN = L::SN;         // S / dP fragment: 32 fp32
    constexpr int ON = L::COLS / 2;   // dQ fragment per box
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int rw0 = q0 + 16 * (tid / 32);  // the warp's first row
    const int row = rw0 + lane / 4;        // the thread's rows: row, row + 8
    const float scale_log2 = scale * kLog2e;
    const int64_t row_base = ((int64_t)bb * H + hh) * Sq;
    // of the thread's two rows, warpgroup 0 keeps the lse in log2 units
    // (+inf past Sq and on fully-masked rows: P = 0 there), warpgroup 1 D
    float rowv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = row + 8 * h;
      if (wg == 0) {
        const float lv = qpos < Sq ? __ldg(lse + row_base + qpos) : -INFINITY;
        rowv[h] = lv == -INFINITY ? INFINITY : lv * kLog2e;
      } else {
        rowv[h] = qpos < Sq ? __ldg(dd + row_base + qpos) : 0.f;
      }
    }
    // the thread's slots: P (written by warpgroup 0) and dP - D (by
    // warpgroup 1), slot i of thread t at [i][t]
    float* xmine = xbuf + wg * SN * 128 + tid;
    const float* xother = xbuf + (1 - wg) * SN * 128 + tid;
    // a score step's A (q or dO) and B (k or v) boxes
    const uint32_t box_a = 2 * wg * L::BOX, box_b = box_a + L::BOX;
    // one thread arrives for its warpgroup on a stage's empty barrier
    auto release = [&](int s) {
      if (tid == 0) hopper::mbar_arrive(empty + s);
    };

    float dq_acc[NB][ON];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < ON; ++i) dq_acc[b][i] = 0.f;
    float acc[SN];
#pragma unroll
    for (int i = 0; i < SN; ++i) acc[i] = 0.f;

    int slot = 0;
    uint32_t phase = 0;  // parity of the ring's current use
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * BK;

      // warpgroup 0: S = q k^T, warpgroup 1: dP = dO v^T, over the 4n
      // boxes of D (both operands K-major).  One commit group per box; a
      // stage is released once the next box's group is issued and its own
      // has completed (wgmma wait 1)
      hopper::fence_regs(acc);
      int prev = 0;
      for (int j = 0; j < nbox; ++j) {
        hopper::mbar_wait(full + slot, phase);
        const uint8_t* sp = smem + slot * L::STAGE;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < L::COLS / 16; ++kk)
          Wgmma<BK, 0, T>::ss(
              acc,
              hopper::make_desc(sp + box_a + kk * 32, 16, L::SBO,
                                hopper::kSwizzle128B),
              hopper::make_desc(sp + box_b + kk * 32, 16, L::SBO,
                                hopper::kSwizzle128B),
              (j | kk) != 0);
        hopper::wgmma_commit();
        if (j > 0) {
          hopper::wgmma_wait<1>();
          release(prev);
        }
        prev = slot;
        if (++slot == STAGES) {
          slot = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      release(prev);

      // warpgroup 0: P = exp2(S scale log2e - lse log2e), 0 for keys past
      // Sk (zero-filled, and a zero score is not -inf) and above the causal
      // diagonal; warpgroup 1: dP - D.  Both leave the fragment in their
      // slots; the barrier before the writes keeps them behind the other
      // warpgroup's reads of the last tile, the one after them orders
      // them before this tile's reads
      const bool need_mask =
          k0 + BK > Sk || (causal && k0 + BK - 1 > rw0 + shift);
      if (t > 0) hopper::named_barrier_sync(1, 2 * 128);
#pragma unroll
      for (int i = 0; i < SN; ++i) {
        const int h = (i / 2) % 2;
        float x;
        if (wg == 0) {
          x = exp2f(acc[i] * scale_log2 - rowv[h]);
          if (need_mask) {
            const int kpos = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
            if (kpos >= Sk || (causal && kpos > row + 8 * h + shift))
              x = 0.f;
          }
        } else {
          x = acc[i] - rowv[h];
        }
        acc[i] = x;
        xmine[i * 128] = x;
      }
      hopper::named_barrier_sync(1, 2 * 128);

      // dS = P (dP - D) (the same product in both warpgroups), rounded to
      // T as the register A operand (the TPU kernel's
      // `ds.astype(ks.dtype)`)
      uint32_t dsa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r;
          dsa[kk][r] = hopper::pack2<T>(acc[i] * xother[i * 128],
                                        acc[i + 1] * xother[(i + 1) * 128]);
        }

      // dQ[:, own] += dS k[:, own]: A from registers, B = the step's k
      // boxes of the warpgroup's columns read MN-major, one 16-key slice
      // per instruction
#pragma unroll
      for (int b = 0; b < NB; ++b) hopper::fence_regs(dq_acc[b]);
#pragma unroll
      for (int cs = 0; cs < CSTEPS; ++cs) {
        hopper::mbar_wait(full + slot, phase);
        const uint8_t* sk = smem + slot * L::STAGE + 2 * wg * L::BOX;
        hopper::wgmma_fence();
#pragma unroll
        for (int bi = 0; bi < 2; ++bi) {
          if (2 * cs + bi >= NB) continue;
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            Wgmma<L::COLS, 1, T>::rs(
                dq_acc[2 * cs + bi], dsa[kk],
                hopper::make_desc(sk + bi * L::BOX + kk * 16 * L::ROW, L::BOX,
                                  L::SBO, hopper::kSwizzle128B),
                1);
        }
        hopper::wgmma_commit();
        if (cs > 0) {
          hopper::wgmma_wait<1>();
          release(prev);
        }
        prev = slot;
        if (++slot == STAGES) {
          slot = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < NB; ++b) hopper::fence_regs(dq_acc[b]);
      release(prev);
    }

    // epilogue: the warpgroup's columns of dQ (x scale) to T; rows past Sq
    // are not stored
    const int64_t d_total = (int64_t)n_chunks * 2 * C;
    const int col0 = (2 * chunk + wg) * C + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = row + 8 * h;
      if (qpos >= Sq) continue;
      T* out = dq + (row_base + qpos) * d_total + col0;
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < L::COLS / 8; ++j) {
          const int i = 4 * j + 2 * h;
          *reinterpret_cast<uint32_t*>(out + b * L::COLS + 8 * j) =
              hopper::pack2<T>(dq_acc[b][i] * scale,
                               dq_acc[b][i + 1] * scale);
        }
    }
  }
}

template <typename T, int NB>
cudaError_t launch_dq_split_d_nb(const CUtensorMap& tq, const CUtensorMap& tk,
                                 const CUtensorMap& tv,
                                 const CUtensorMap& tdo, const void* lse,
                                 const void* dd, void* dq, int B, int H,
                                 int Sq, int Sk, int D, int causal,
                                 float scale, cudaStream_t stream) {
  using L = SplitBwdLayout;
  static bool smem_set[kMaxDevices] = {};
  cudaError_t err = opt_in_smem(flash_bwd_dq_split_d_wgmma_kernel<T, NB>,
                                L::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int n_chunks = D / (2 * NB * L::COLS);
  dim3 grid((Sq + BQ - 1) / BQ * n_chunks, H, B);
  flash_bwd_dq_split_d_wgmma_kernel<T, NB>
      <<<grid, THREADS, L::SMEM, stream>>>(
          tq, tk, tv, tdo, static_cast<const float*>(lse),
          static_cast<const float*>(dd), static_cast<T*>(dq), H, Sq, Sk,
          n_chunks, causal, scale);
  return cudaGetLastError();
}

// D = 256 n: each warpgroup owns C = 256 columns where n is even (one CTA
// a q tile at D = 512: the scores are computed once), 192 where n is a
// multiple of 3 (two chunks at D = 768), else 128 (n chunks)
template <typename T>
cudaError_t launch_dq_split_d(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* dd, void* dq, int B, int H, int Sq,
                              int Sk, int D, const Strides& st, int causal,
                              float scale, cudaStream_t stream) {
  using L = SplitBwdLayout;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = hopper::encode_bhsd<T>(&tq, q, B, H, Sq, D, st.q_sb,
                                           st.q_sh, st.q_ss, BQ);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd<T>(&tk, k, B, H, Sk, D, st.k_sb, st.k_sh,
                                 st.k_ss, L::BKEY);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd<T>(&tv, v, B, H, Sk, D, st.v_sb, st.v_sh,
                                 st.v_ss, L::BKEY);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd<T>(&tdo, dout, B, H, Sq, D, st.o_sb, st.o_sh,
                                 st.o_ss, BQ);
  if (err != cudaSuccess) return err;
  const int n = D / L::CHUNK;
  if (n % 2 == 0)
    return launch_dq_split_d_nb<T, 4>(tq, tk, tv, tdo, lse, dd, dq, B, H, Sq,
                                      Sk, D, causal, scale, stream);
  if (n % 3 == 0)
    return launch_dq_split_d_nb<T, 3>(tq, tk, tv, tdo, lse, dd, dq, B, H, Sq,
                                      Sk, D, causal, scale, stream);
  return launch_dq_split_d_nb<T, 2>(tq, tk, tv, tdo, lse, dd, dq, B, H, Sq,
                                    Sk, D, causal, scale, stream);
}

// dQ shared memory: q and dO (resident), two stages of K and two of V,
// each as D / COLS boxes of [rows][COLS] 16-bit elements; then the
// mbarriers.  BK keys per K/V tile: 64 up to D = 128; 32 at D = 256, where
// 64 keys would need 128 KB of q and dO plus 4 x 32 KB of K/V stages, more
// than a block may hold (S and dP are then m64n32 fragments, 16 fp32
// registers each, beside the 128 of the 64 x 256 dQ accumulator)
template <int D>
struct DqLayout {
  static constexpr int BK = D > 128 ? 32 : 64;
  static constexpr int COLS = hopper::box_cols(D);
  static constexpr int NBOX = D / COLS;
  static constexpr int SWIZZLE =
      COLS == 64 ? hopper::kSwizzle128B : hopper::kSwizzle64B;
  static constexpr uint32_t ROW = COLS * 2;        // bytes of a box row
  static constexpr uint32_t SBO = 8 * ROW;         // next 8-row group
  static constexpr uint32_t Q_BOX = DQ_BQ * ROW;
  static constexpr uint32_t KV_BOX = BK * ROW;
  static constexpr uint32_t Q_BYTES = NBOX * Q_BOX;
  static constexpr uint32_t KV_BYTES = NBOX * KV_BOX;
  static constexpr uint32_t Q_OFF = 0;
  static constexpr uint32_t DO_OFF = Q_BYTES;
  static constexpr uint32_t K_OFF = 2 * Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + 2 * KV_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + 2 * KV_BYTES;
  static constexpr size_t SMEM = BAR_OFF + 7 * 8 + 1024;  // + align slack
  static_assert(SMEM <= hopper::kMaxSmem,
                "dQ tiles exceed the shared-memory opt-in");
};

template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ dd,
                          T* __restrict__ dq, int H, int Sq,
                          int Sk, int causal, float scale) {
  using L = DqLayout<D>;
  constexpr int BK = L::BK;
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
  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {
    // keys visible to the CTA's last row (attention.py:273)
    const int hi = q0 + DQ_BQ + shift;
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
    constexpr int SN = BK / 2;        // S / dP fragment: 32 or 16 fp32
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
      const int k0 = t * BK;
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
        Wgmma<BK, 0, T>::ss(
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
        Wgmma<BK, 0, T>::ss(
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
          k0 + BK > Sk || (causal && k0 + BK - 1 > qw0 + shift);
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

      // dS = P (dP - D), rounded to T as the register A operand of
      // dQ += dS k (the TPU kernel's `ds.astype(ks.dtype)`)
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dpacc);
      uint32_t dsa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r, h = r % 2;
          dsa[kk][r] = hopper::pack2<T>(sacc[i] * (dpacc[i] - drow[h]),
                                        sacc[i + 1] * (dpacc[i + 1] - drow[h]));
        }

      // dQ += dS k: A from registers, B = the same k tile MN-major, one
      // 16-key slice and one box per instruction
#pragma unroll
      for (int b = 0; b < L::NBOX; ++b) hopper::fence_regs(dq_acc[b]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int b = 0; b < L::NBOX; ++b)
          Wgmma<L::COLS, 1, T>::rs(
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

    // epilogue: dQ scale to T; rows past Sq are not stored
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
              hopper::pack2<T>(dq_acc[b][i] * scale,
                               dq_acc[b][i + 1] * scale);
        }
    }
  }
}

template <int D, typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dd,
                      void* dq, int B, int H, int Sq, int Sk,
                      const Strides& st, int causal, float scale,
                      cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = hopper::encode_bhsd<T>(&tq, q, B, H, Sq, D, st.q_sb,
                                           st.q_sh, st.q_ss, DQ_BQ);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd<T>(&tk, k, B, H, Sk, D, st.k_sb, st.k_sh,
                                 st.k_ss, DqLayout<D>::BK);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd<T>(&tv, v, B, H, Sk, D, st.v_sb, st.v_sh,
                                 st.v_ss, DqLayout<D>::BK);
  if (err == cudaSuccess)
    err = hopper::encode_bhsd<T>(&tdo, dout, B, H, Sq, D, st.o_sb, st.o_sh,
                                 st.o_ss, DQ_BQ);
  if (err != cudaSuccess) return err;
  static bool smem_set[kMaxDevices] = {};
  err = opt_in_smem(flash_bwd_dq_wgmma_kernel<D, T>, DqLayout<D>::SMEM,
                    smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + DQ_BQ - 1) / DQ_BQ, H, B);
  flash_bwd_dq_wgmma_kernel<D, T>
      <<<grid, THREADS, DqLayout<D>::SMEM, stream>>>(
          tq, tk, tv, tdo, static_cast<const float*>(lse),
          static_cast<const float*>(dd), static_cast<T*>(dq), H, Sq, Sk,
          causal, scale);
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
      return launch_dq<32, T>(q, k, v, dout, lse, dd, dq, B, H, Sq, Sk, st,
                              causal, scale, s);
    case 64:
      return launch_dq<64, T>(q, k, v, dout, lse, dd, dq, B, H, Sq, Sk, st,
                              causal, scale, s);
    case 128:
      return launch_dq<128, T>(q, k, v, dout, lse, dd, dq, B, H, Sq, Sk, st,
                               causal, scale, s);
    case 256:
      return launch_dq<256, T>(q, k, v, dout, lse, dd, dq, B, H, Sq, Sk, st,
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

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; D is 32, 64, 128 (every
// dtype) or a multiple of 256: the fp32 dQ and dK/dV there run the 3xTF32
// split-D kernels (D = 256 n, n >= 1), the bf16 and fp16 ones the wgmma
// kernels at D = 256 and the split-D wgmma kernels above it; any other D
// returns cudaErrorInvalidValue and launches nothing.  Strides (in
// elements) of q, k, v and dO: batch, head, sequence; the head dim must be
// contiguous (bf16 and fp16, and fp32 from 256 up: the base addresses
// 16-byte aligned and the byte strides multiples of 16, as TMA needs).  lse and D are contiguous fp32 [B, H, Sq]; dq
// [B, H, Sq, D] (and dk, dv [B, H, Sk, D]) are written contiguous in the
// input dtype.  Each returns
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
  if (dtype == 0 && D >= 256 && D % 256 == 0)
    err = tf32::launch_dq_split_d(q, k, v, dout, lse, dd, dq, B, H, Sq, Sk,
                                  D, st, causal, scale, s);
  else if (dtype == 0)
    err = tf32::dq_dispatch(D, q, k, v, dout, lse, dd, dq, B, H, Sq, Sk,
                            st, causal, scale, s);
  else if (dtype == 1 && D > 256 && D % wg::SplitBwdLayout::CHUNK == 0)
    err = wg::launch_dq_split_d<__nv_bfloat16>(q, k, v, dout, lse, dd, dq, B,
                                               H, Sq, Sk, D, st, causal,
                                               scale, s);
  else if (dtype == 2 && D > 256 && D % wg::SplitBwdLayout::CHUNK == 0)
    err = wg::launch_dq_split_d<__half>(q, k, v, dout, lse, dd, dq, B, H, Sq,
                                        Sk, D, st, causal, scale, s);
  else if (dtype == 1)
    err = wg::dq_dispatch<__nv_bfloat16>(D, q, k, v, dout, lse, dd, dq, B,
                                         H, Sq, Sk, st, causal, scale, s);
  else if (dtype == 2)
    err = wg::dq_dispatch<__half>(D, q, k, v, dout, lse, dd, dq, B, H, Sq,
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
  if (dtype == 0 && D >= 256 && D % tf32::SplitDkv::CHUNK == 0)
    err = tf32::launch_dkv_split_d(q, k, v, dout, lse, dd, dk, dv, B, H, Sq,
                                   Sk, D, st, causal, scale, s);
  else if (dtype == 0)
    err = tf32::dkv_dispatch(D, q, k, v, dout, lse, dd, dk, dv, B, H, Sq,
                             Sk, st, causal, scale, s);
  else if (dtype == 1 && D > 256 && D % wg::SplitBwdLayout::CHUNK == 0)
    err = wg::launch_dkv_split_d<__nv_bfloat16>(q, k, v, dout, lse, dd, dk,
                                                dv, B, H, Sq, Sk, D, st,
                                                causal, scale, s);
  else if (dtype == 2 && D > 256 && D % wg::SplitBwdLayout::CHUNK == 0)
    err = wg::launch_dkv_split_d<__half>(q, k, v, dout, lse, dd, dk, dv, B,
                                         H, Sq, Sk, D, st, causal, scale, s);
  else if (dtype == 1)
    err = wg::dkv_dispatch<__nv_bfloat16>(D, q, k, v, dout, lse, dd, dk, dv,
                                          B, H, Sq, Sk, st, causal, scale, s);
  else if (dtype == 2)
    err = wg::dkv_dispatch<__half>(D, q, k, v, dout, lse, dd, dk, dv, B, H,
                                   Sq, Sk, st, causal, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* flash_attn_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
