#!/usr/bin/env python3
"""GPU smoke run of the paddle_tpu_torch port: build its CUDA kernels,
hold each against its plain PyTorch version, serve a BERT-base encoder
over HTTP /predict and train BERT-base, both through the kernels, the
training step also as a CUDA graph replayed by Executor.run_steps, train
BERT-base with google-research/bert's pretraining recipe (dropout,
AdamW, gradient clipping, lr schedule, gradient merge), serve GPT
/generate, train BERT-base through the dygraph 2.0 API (autograd,
auto_cast and GradScaler, paddle.optimizer, models.bert, hapi), and
train the BASELINE configs LeNet-5, ResNet-50 and Transformer-big (static,
eager and replayed) and vision.models.resnet50() in dygraph, and serve the
remainders: bf16 and PTQ-int8 /predict, a conv-bn-folded ResNet-50, and
speculative and int8 /generate, and train BERT-base with the breadth of
the training API (recompute, the other optimizers, EMA, ModelAverage,
Lookahead, sparse embedding gradients, graph-safe random ops, static
O2), and train it data-parallel (fleet, CompiledProgram, DataParallel
over gloo ranks, and NCCL at world size 1 with a captured step), with
ZeRO stages 1-3, and train the static transformer LM tensor-parallel,
and serve GPT /generate tp-sharded, train with sequence parallelism
(ring attention) and expert parallelism (switch MoE), replay the
gradient-merge window with its commit hoisted, and train it elastically:
killed, shrunk and regrown through checkpoints, bitwise, and train it
cut into pipeline stages, and train PaddleRec's CTR-DNN on a launched
parameter-server job and split into heterogeneous CPU / device sections,
and train Transformer-big, VGG-16 and MobileNet-V2 in dygraph with the
convolution, pooling and norm tier held against the CPU.

    python3 chip_smoke.py [--seed N] [--profile]

Needs one CUDA GPU (Hopper: the kernels are built for sm_90a) and nvcc.
Exits non-zero, printing no result line, when any phase fails or no GPU
is present.  Phases:

  1. device  - the card's name and power limit (nvidia-smi);
  2. build   - compile csrc/flash_attn_fwd.cu, flash_attn_bwd.cu,
               fused_xent_fwd.cu, dropout_philox.cu and philox_random.cu
               (with csrc/*.cuh)
               from this checkout, one nvcc process each, all at once
               (ptxas register, spill and warning lines);
  3. kernel  - the flash-attention forward kernel against its plain
               version (paddle_tpu_torch.ops.attention
               .flash_attention_plain) on the same inputs, at the serving
               shape [8, 12, 512, 64] in fp32 and bf16 (q/k/v as the
               strided head-split views the encoder produces), a causal
               case with Sq != Sk both ways (the Sq < Sk one in fp32 and
               bf16), and ragged S = 200 at D = 32 and 128 (fp32 and
               bf16: fp32 runs the 3xTF32 kernels, bf16 the wgmma
               kernels), fp16 at the training shape (the wgmma kernels'
               f16 instances), and head dims without a kernel instance,
               zero-padded by the wrapper: D = 96 (hidden 768 over 8
               heads) and D = 48 (over 16 heads) in fp32 and bf16 on the
               head-split views (bounds count the real D); head dim 256
               (hidden 2048 over 8 heads) in all three dtypes (bf16 and
               fp16: the wgmma forward, dQ and dK/dV; fp32: the 3xTF32
               split-D forward, dQ and dK/dV at n = 1), causal both ways
               and ragged S = 200 in bf16 and fp16, causal Sq > Sk and
               ragged causal S = 200 in fp32; head dim
               512 (hidden 2048 over 4 heads) in all three dtypes and
               causal with Sq > Sk in fp16, and head dim 768 (hidden 3072
               over 4 heads) in fp32 and bf16, causal Sq < Sk and Sq > Sk
               and ragged S = 200 at D = 512 and 768 in fp32 and bf16, on
               the split-D routes
               (the 16-bit forward, dQ and dK/dV: the split-D wgmma
               kernels; the fp32 forward, dQ and dK/dV: the 3xTF32
               split-D kernels).
               Tolerances: fp32 atol=rtol=1e-4 (summation order differs;
               3xTF32 keeps an fp32-level error); bf16 atol=rtol=2e-2
               and fp16 5e-3 against the plain version, which rounds P
               and dS to the input dtype where the kernels do.
               One JSON line per case: kernel_ms, plain_ms and library_ms
               (torch scaled_dot_product_attention, a yardstick the port
               never calls) as device time per call (CUDA events around
               10-20 calls queued behind a spin kernel, so they run back
               to back; one call of a plain version, whose hundreds of
               launches fill the device's queue; warm L2);
               kernel_ms_events (CUDA events around calls made one
               after another, host launch cost included: the earlier
               method); bound_ms (max of FLOPs over peak and bytes over
               bandwidth, from the H100 SXM datasheet, for the units the
               kernel uses: in fp32 three TF32 products per multiply over
               the TF32 peak, with fma_bound_ms beside it for fp32
               FMAs).  At [8, 12, 512, 64] every attention kernel, and at
               [8, 8, 512, 256] the fp32 ones, also get kernel_ms_cold: a
               64 MB write before every launch, so L2 (50 MB) holds none
               of the inputs.
               Then the flash backward kernels (dQ, dK/dV) against
               flash_attention_bwd_dq_plain / _dkv_plain at the same
               cases; library_ms is the whole backward of torch
               scaled_dot_product_attention (autograd.grad after one
               forward), bounds count 6 (dQ) and 8 (dK/dV) x B H pairs D
               FLOPs; a second launch of each gives the same bits (no
               atomics); at [8, 8, 512, 256] fp32 the profiler names the
               device kernels that ran (the 3xTF32 split-D forward, dQ
               and dK/dV, each counted on launches_tf32_split_d).  And the
               fused cross-entropy kernel against
               fused_xent_plain at [4096, 30522] in fp32, bf16 and fp16,
               a ragged V = 1000, and rows with a positive and a negative
               ignore_index; library_ms is F.cross_entropy(reduction=
               "none"), the bound is bytes.  Same tolerances, reasons and
               timing.  And the dropout kernel against dropout_plain (the
               same Philox-4x32-10 bits in PyTorch integer arithmetic)
               at [8, 12, 512, 512] and [8, 512, 768] in fp32, bf16 and
               fp16, Out and Mask equal to the last bit, the keep rate
               over the [8, 12, 512, 512] mask within 0.001 of 0.9, and
               bitwise in four more cases (downgrade_in_infer, a host
               seed, an unaligned view, a ragged tail); library_ms is
               F.dropout, the bound is bytes.  Last, a bf16 view 4
               bytes past a 16-byte
               boundary (which TMA refuses) is copied by the wrappers and
               launched: forward, dQ and dK/dV equal to the last bit to
               the aligned tensors', 5 copies counted; the same at D = 256
               and at D = 512 with 5 copies (the wgmma and split-D wgmma
               forward copy q, dQ and dK/dV q and dO), and an fp32 view at
               D = 256 (the 3xTF32 split-D forward, dQ and dK/dV: 5
               copies);
  4. slice   - the BERT-base encoder (vocab 30522, seq 512, hidden 768,
               12 layers, 12 heads) built with flash on, random weights
               from --seed, saved with save_inference_model and served by
               InferenceServer(model_dir, port=0) on the GPU; four
               concurrent /predict posts of 2 rows each.  Checks: every
               response equals Predictor.run on the same rows (1e-5), the
               flash kernel was launched 12 times per batch the server
               ran, and the outputs match the same weights run through
               the flash-off score-matrix program on the card
               (atol=rtol=2e-4, fp32 over 12 layers);
  5. train   - models.build_bert_pretrain (bench.build_bert_base) at
               full width, batch 8, flash and fused cross-entropy on,
               weights from --seed, one fixed numpy batch.
               (a) fp32: one Executor.run step of the kernel program
               against the same weights through the flash-off, fused-off
               program on the card: loss within rtol 1e-4, the gradients
               of the word embedding, the first attention projection and
               the vocab fc within a normalised max error of 1e-3 (fp32
               over 12 layers; the two attention algorithms and the two
               cross-entropies sum in different orders).
               (b) the bench configuration (AMP bf16): 6 steps after a
               warm-up, every loss finite and the last below the first;
               step_ms, tokens/s, MFU (6 x params x tokens/s over 989
               TFLOP/s, as bench.py reckons it) and peak memory.  Exact
               launch counts per step: flash forward 24 (12 forward ops
               + the 12 replays of the grad ops, which re-run the forward
               under torch.func.vjp), dQ 12, dK/dV 12, fused
               cross-entropy 2 (the forward op + its grad op's replay),
               and no copy of the head-split views before a launch
               (flash_attention.view_copies 0: TMA takes them as they
               are).
               (c) the fp32 training configuration (bench.py with
               BENCH_NO_AMP=1): the same model, 4 steps after a warm-up,
               the same gates and launch counts per step, through the
               fp32 kernels (3xTF32 forward, dQ and dK/dV, fp32 fused
               cross-entropy); MFU over the 67 TFLOP/s of fp32 FMA (its
               GEMMs run in fp32 with TF32 off).
  6. train_graph - the AMP bf16 and fp32 configurations of phase 5 from
               the same startup weights, through Executor.run_steps: one
               CUDA graph of the step captured, then replayed K times per
               call (K = 6 AMP, 4 fp32); step_ms (wall / K of a call),
               tokens/s, MFU, device busy per step and idle share over a
               profiled call (the profiler slows the replay's launches, so
               the idle share against the unprofiled step is given too),
               kernels replayed per step counted from the profiler over
               two calls (24 / 12 / 12 / 2, as in the eager step; the
               profiler can lose records, so each kernel's largest count
               is gated), one
               capture then hits, peak memory; the first 2K losses equal
               to 2K eager Executor.run steps from the same weights (to
               the last bit, else within rtol 1e-5 fp32 / 2e-3 AMP, the
               largest difference reported), finite and falling.
  8. recipe  - google-research/bert's pretraining recipe at the same
               width (build_recipe: dropout 0.1 after the embedding
               layer_norm, on the attention weights, the attention output
               and the FFN output; AdamW weight decay 0.01 without biases
               and layer_norm; global-norm clip 1.0; linear warmup then
               polynomial decay from 1e-4; AMP bf16; gradient merge k = 2),
               fused CE on, in two variants: attention dropout 0.1 (the
               score-matrix route) and 0 (the flash kernels).  4 eager
               steps (the scheduler stepped after each), then run_steps
               calls of K = 4 (one capture, 3 timed, 2 profiled).  Gates:
               launches per step (dropout 37 / 25, fused CE 2, flash 0 / 0
               / 0 and 24 / 12 / 12), twice that in the capturing call,
               the same per replayed step from the profiler; parameters
               unchanged after the first micro-step of each window and
               accumulators zero after its commit; the first call's
               losses equal to the last bit to 4 eager steps from the
               same state and seeds; the embedding dropout's mask new in
               every replayed step; one capture, then hits; losses
               finite, the last below the first; wide launches 0.
  9. dygraph - BertForPretraining(BertModel(BertConfig())) (the JAX
               package's defaults: google-research/bert base, vocab
               30522, hidden 768, 12 heads, FFN 3072, 512 positions,
               dropout 0.1) cut to DYGRAPH_LAYERS = 4 layers (12 before
               phase 19 took the full-depth step), batch 8 x seq 512, no padding
               mask, weights from --seed, one fixed batch (MLM labels at
               every position, NSP labels); AdamW(weight decay 0.01,
               ClipGradByGlobalNorm(1.0), LinearWarmup(2 steps,
               PolynomialDecay(1e-4, 1000))); each step auto_cast + a
               GradScaler, loss.backward() on torch autograd, the
               scaler's minimize, clear_grad, the scheduler's step; fused
               CE on, flash forced on (taken where attention has no
               dropout).  Three variants: (a) "published", attention
               dropout 0.1, O1 (the score-matrix route); (b) "flash",
               attention dropout 0, O1 (q, k, v and the logits are fp32
               there: the fp32 flash and fused CE kernels); (c)
               "flash_o2", as (b) at O2 (the bf16 kernels).  Each: one
               warm-up step, 6 timed steps (step ms, tokens/s, MFU over
               989 TFLOP/s, peak memory), two profiled steps, the second
               read (device busy, kernels a step, idle share of the
               profiled and of the median timed step).  Gates: launches per step
               exact (dropout 37 / 25 / 25, fused CE 2, flash forward /
               dQ / dK/dV 0 / 0 / 0 and 12 / 12 / 12: autograd keeps the
               forward's Out and lse, so no forward replay), every flash
               and fused CE launch in the variant's dtype (each wrapper
               counts launches by dtype), wide launches 0, losses finite
               and the last below the first.  Then hapi: Model(net)
               .prepare(AdamW, criterion, amp_configs={"level": "O1"}),
               2 train_batch steps equal to the last bit (losses and
               parameters) to 2 bare-loop steps from the same weights and
               draw state; and one fp32 step of (b)'s model through the
               kernels against flash and fused CE off (the same dropout
               masks): loss rtol 1e-4, the gradients of the word
               embedding, the first layer's q, k and v projections and
               the MLM transform within a normalised max error of 1e-3.

 10. baseline - the BASELINE configs at the widths the JAX package's
               tools run on the chip, weights from --seed, one fixed numpy
               batch each (the tools' synthetic data): (a) LeNet-5
               (models.build_lenet), batch 256 x 1x28x28, fp32, SGD 0.01,
               K = 10; (b) ResNet-50 v1.5 (build_resnet50), batch 128 x
               3x224x224, 1000 classes, bf16 AMP, Momentum 0.1 / 0.9, K =
               4; (c) Transformer-big (build_transformer_big), 6 + 6
               layers, d 1024, 16 heads, FFN 4096, vocab 32000, src = trg
               = 256, batch 16, bf16 AMP, Adam 2e-4, label smoothing 0.1,
               K = 4.  Each: K eager Executor.run steps from the startup
               weights, then run_steps calls of K steps from the same
               weights (one capture, 2 timed, 1 profiled): step ms,
               images or tokens/s and MFU (ResNet: 3 x 4.1 GFLOP an image
               at 224; Transformer-big: tools/bench_transformer.py's
               count; LeNet: 3 x its forward's 2 x MACs; over 989 TFLOP/s
               bf16, 67 fp32) eager and replayed, peak memory, device
               busy, kernels a step and idle share from the profiled
               call.  Gates: losses finite, the eager ones' last below
               the first (the replayed trace is not read so: Momentum
               0.1 / 0.9 swings for ~20 steps on one batch, so its end
               reads the swing; it is held to the eager steps instead);
               the first batch_norm's running mean
               (fetched each step) new at every step, eager and
               replayed; the capturing call's K losses equal to the K
               eager ones (to the last bit, else rtol 1e-5 fp32 / 2e-3
               AMP, the largest difference reported); one capture, then
               hits; no launch of a hand kernel (flash, fused CE,
               dropout, the wide routes).  After (a), one fp32 LeNet step
               on the card against the same program and weights on the
               CPU with cuDNN's TF32 flag switched on around it (the
               conv2d kernel must turn it off itself): loss rtol 1e-5,
               the conv weight gradients within a normalised 1e-4.  (d)
               vision.models.resnet50(), batch 128 at 224, auto_cast O1,
               F.cross_entropy, loss.backward(),
               optimizer.Momentum(0.1, 0.9): a warm-up step, 10 timed
               steps, 1 profiled; the same gates (bn1's running mean).
 11. remainders - the serving remainders, on phase 4's model dir and
               phase 7's model and posts (run after phase 7): (a) bf16
               /predict: Config(dir).enable_bfloat16() (the AMP rewrite
               after the passes) on the served 8 x 512 rows, exactly 12
               bf16 flash-forward launches a run, relative RMS error
               against the fp32 Predictor within 5e-2; (b) int8 /predict:
               slim.PostTrainingQuantization of the loaded program (4
               calibration batches from --seed), saved and loaded in a
               Predictor: quant_int8_pass rewrites 2-D activations only,
               as the JAX package's does, so no int8_matmul op and no
               int8 product a run, 72 fp32 products over dequantized int8
               weights and 12 fp32 flash launches a run; one
               projection's int32 accumulators at the served shape
               (torch._int_mm) equal to the plain version; max |int8 -
               fp32| / max |fp32| within 0.1
               (tests/test_int8_execution.py's bound); (c) ResNet-50
               inference: build_resnet50(use_amp=False) at batch 32 x 224,
               batch-norm statistics, scale and bias from --seed, saved,
               run through the full pipeline (53 conv_bn_fuse_pass folds,
               no batch_norm left) and with delete_pass(
               "conv_bn_fuse_pass"), normalised max error within 1e-4
               (fp32, TF32 off); (d) speculative /generate: phase 7's
               server setup with gen_speculative="auto" (a 2-layer stamp,
               k = 4) and its 16 posts: each reply equal to phase 7's, or
               a greedy divergence at a top-2 margin under 1e-4 of the
               fp32 model (reported); the same with a 2-layer draft of
               its own weights, block weights doubled (rejected
               proposals rolled back, replies held the same way); a full-depth stamp over 4 greedy
               posts accepts every proposal; the distinct tokens of each
               plain reply reported; (e) int8 /generate: the same
               posts with weight_dtype="int8" over a kv_dtype="int8" pool
               of GEN_PLAN's bytes (3.98x the pages): no scale clip,
               every product through torch._int_mm, divergences from
               phase 7's replies reported with the fp32 top-2 margin
               (docs/serving.md's rule).  Each: run ms, peak memory,
               tokens/s, TTFT; every pool drained.

 12. breadth - BERT-base width (vocab 30522, seq 512, hidden 768, 12
               layers, 12 heads), batch 8, weights from --seed (the
               startup programs through the Philox kernel, one launch per
               random op), one fixed numpy batch.  (d) first: the Philox
               kernel (csrc/philox_random.cu) against its plain version
               on the card at [30522, 768] and [1000003] in fp32 and bf16,
               uniform equal to the last bit, normal within 4 ulps of the
               output dtype, mean and variance within 5 sigma; times
               (library_ms: torch.rand / torch.randn, bound: bytes written
               over 3.35 TB/s); uniform_random and gaussian_random in a
               main program under run_steps: new draws on each replay,
               equal to eager run() bitwise.  (a) recompute: phase 5b's
               AMP program (flash, fused CE) with FLAGS_recompute="always",
               serialized equal to the same program through
               RecomputeOptimizer(Adam) at select_layer_checkpoints'
               picks; 4 eager steps against the program without
               recompute from the same weights: launches per step as the
               program implies (35 flash forwards: 12 + 11 segment
               replays + 12 vjp replays; 12 dQ, 12 dK/dV, 2 fused CE),
               losses equal to the last bit (else rtol 2e-3), peak memory
               lower; then run_steps K = 4 (one capturing call equal to
               the eager steps, 2 timed calls, one profiled): step ms,
               tokens/s, MFU (6 x params x tokens/s over 989 TFLOP/s),
               device busy and idle share; and phase 8's recipe with
               attention dropout 0.1 (gradient merge k = 2) with and
               without recompute: losses equal bitwise, the replayed
               dropouts launched.  (b) LarsMomentum, Adamax, Adagrad,
               DecayedAdagrad, Adadelta, RMSProp, ProximalGD,
               ProximalAdagrad, Ftrl, Dpsgd and Adam on the bench AMP
               program: 4 eager steps (accumulators non-zero after the
               first) and one run_steps call of K = 4 from the same
               weights, losses equal (else rtol 2e-3), finite; each new
               op at [30522, 768] on the card against the CPU
               (normalised max error 1e-5: an element that cancels to
               near 0 has no bounded relative error; the largest
               elementwise relative error is reported); dpsgd's noise new on each
               replay and equal to eager; EMA shadows after K replayed
               steps equal to K eager steps and apply / restore bitwise;
               ModelAverage apply / restore bitwise; Lookahead(Adam, k =
               5, alpha 0.5): fast == slow after step 5 only, the
               replayed state equal to eager; the 2.0 Adamax, Adagrad,
               Adadelta and RMSProp, 3 steps on phase 9's variant (b)
               model: losses finite.  (c) sparse: `bench_program`'s copy
               with is_sparse on the word embedding, fp32: SGD against
               dense SGD over 4 steps (losses rtol 1e-5, embedding within
               1e-5); sparse SGD and Adam(lazy_mode=True) each replayed
               K = 4 (the capturing call) equal to its 4 eager steps,
               losses and every persistable to the last bit; lazy Adam's
               untouched rows and moments bitwise unchanged, touched rows
               moved.
               (e) amp.cast_model_to_fp16 on the bench program: 4 eager
               steps and one run_steps call, every flash and fused-CE
               launch bf16, losses finite.
 13. dp      - data parallel over torch.distributed, bench.py's step at
               a global batch of 8, cut to DIST_LAYERS (2) layers as
               phase 14 and phase 15's hoist (the whole run must keep
               inside its limit).  2 ranks (paddle_tpu_torch.distributed
               .spawn, both on cuda:0, gloo: NCCL refuses two ranks on one
               device), each: (d) the collective API on CUDA tensors
               (all_reduce sum / max / min / prod, broadcast, all_gather,
               the c_reducescatter op, alltoall, barrier) equal to numpy;
               (a) fleet.init(is_collective=True) + amp strategy (bf16,
               the bench's loss scale) + distributed_optimizer(Adam) and
               fleet.main_program (CompiledProgram.with_data_parallel), 2
               Executor.run steps of the global batch from a startup of
               seed + rank (the start broadcast makes rank 1 rank 0's),
               sound, then with rank 1's gradients zeroed before their
               allreduce (a planted fault); (c) phase 9's variant (c)
               under DataParallel (scale_loss, apply_collective_grads), 2
               steps of its half batch, with BERT's hidden dropout 0.1,
               then every dropout 0, sound and with the planted fault.
               Gates: the ranks' parameters bitwise equal after every
               step; a rank-step's launches: 8 / 4 / 4 / 2 (static)
               and 4 / 4 / 4 / 2 (dygraph) flash forward / dQ / dK/dV /
               fused CE, all bf16, 25 dropouts with hidden dropout on,
               else 0, no random draw; its collective calls: one
               allreduce a gradient and one for the loss (and the start
               broadcast in a static run's first step); step 1's mean
               loss within DP_LOSS_RTOL and the update gap
               (||update - update_ref|| / ||update_ref||) within
               DP_UPDATE_TOL of one process at batch 8 from the same
               start (every dropout 0), the fault's gap above it; each
               rank's step ms and, in step 2 of (a), the collectives'
               synchronised share.  Then (b) in this process under NCCL
               at world 1: (d) again, and the static program through 2
               eager steps and 2 run_steps calls of K = 4 (one captured
               graph holding the NCCL allreduces): every loss bitwise the
               plain Executor's, launches as the step implies (twice that
               in the capturing call), the allreduces of each eager step,
               the capture's warm-up and its captured step reaching the
               NCCL group, none in the replaying call, the replayed step
               ms beside phase 6's.
 14. zero_tp - ZeRO stages 1-3 and Megatron tensor parallelism over
               torch.distributed, 2 gloo ranks on cuda:0 as phase 13,
               global batch 8, DIST_LAYERS layers.  (a) phase 13 (a)'s
               fleet step with
               strategy.sharding at stage 1, stage 2 with gradient merge
               k = 2, and stage 3 (distributed/sharding.py), 2 Executor
               .run steps each, sound and with rank 1's gradient buckets
               zeroed before their reduce-scatter (a planted fault);
               (b) models.build_transformer_lm(30522, 768, 4, 12, 512,
               tensor_parallel_degree=2) with AMP bf16 and Adam, the tp =
               1 program's startup carried in through the placement
               (io.load_params_from_numpy(..., compiled=)), 2 steps.
               Gates: the ranks' replicated state bitwise equal after
               every step and their gathered global state
               (CompiledProgram.global_state) after the last; a rank-step's
               launches 8 / 4 / 4 / 2 flash forward / dQ / dK/dV /
               fused CE, all bf16, no random draw; its collective calls
               by op as the program holds (one reduce-scatter a bucket,
               one all-gather a bucket at stages 1-2, one a bucket and
               phase at stage 3; (b): one mp_allreduce_sum and one
               c_identity gradient a Megatron block, the ring-0
               allreduces); step 1's loss and the update gap against one
               process (the same sharded program with no process group;
               (b) the tp = 1 program of the same weights) within
               DP_LOSS_RTOL / DP_UPDATE_TOL (b: TP_LOSS_RTOL /
               TP_UPDATE_TOL), the faults' gaps above; each rank holding
               1/2 of the padded optimizer-slot buckets (stage 3 also of
               the parameter buckets) and each tp-sharded weight at half
               its bytes; stage 3's per-rank peak memory below stage
               1's.  (c) in this process under NCCL at world 1: the
               stage-3 program through 2 eager steps and 2 run_steps
               calls of K = 4 (one captured graph): every loss bitwise
               the plain Executor's, the reduce-scatters and all-gathers
               of each eager step and of the capture reaching the NCCL
               group, none in the replaying call.  Prints its seconds.
 15. parallel_axes - the remaining parallel axes over torch.distributed.
               First the flash-composed ring (each ring step a flash
               forward; dQ and dK/dV with the merged lse) against the
               plain ring (the JAX step arithmetic) at [8, 12, 512, 64]
               cut in 1 and 2 blocks, causal and not, bf16 and fp32
               (RING_TOL of max(1, max |plain|)).  Then one spawn of 2
               gloo ranks on cuda:0: (a) phase 7's GPT-2-small model
               under TPShardedDecoder at tp = 2 (rank 0 leads an engine
               with a tp-2 plan and the radix cache, rank 1 follows),
               phase 7's first 4 posts with 8 new tokens, plain, with
               the 2-layer speculative draft (k = 4) and with int8
               weights; (b) bench.py's AMP BERT-base step with use_ring
               (12 layers) and build_transformer_lm(30522, 768, 4, 12,
               512, sequence_parallel=True) (DIST_LAYERS layers) at sp =
               2, 2 steps, BERT also with
               rank 1's K block zeroed before its first send (a planted
               fault); (c) a 4-layer static encoder at Switch-Base-8's
               widths (d_model 768, d_ff 3072, 8 experts, capacity factor
               1.25; flash attention, switch_moe), tokens 8 x 512, fp32,
               Adam, at ep = 2 (tokens and experts split).  (d) in this
               process under NCCL at world 1: phase 14's ZeRO-2 step with
               gradient merge k = 2, run_steps K = 4 twice, hoisted and
               with PADDLE_TPU_SCAN_HOIST=0.  Gates: (a) replies equal to
               the tp = 1 engine's (or a greedy near tie; int8 reported
               with the fp32 top-2 margin), the pools drained, the
               follower fed half the K/V bytes and each rank holding half
               the sharded weight bytes, no hand kernel on the path; (b)
               launches 48 / 24 / 24 / 2 (BERT; the LM 16 / 8 / 8 / 2)
               flash forward / dQ / dK/dV / fused CE a rank-step
               (bf16), the ranks' state bitwise
               equal, step 1's loss within SP_LOSS_RTOL and the update
               gap within SP_UPDATE_TOL of the same program in one
               process (the ring op one flash call), the fault's gap
               above; (c) each rank holding 4 experts, 24 all-to-alls and
               8 / 4 / 4 fp32 flash launches a rank-step, step 1's loss,
               aux loss and update gap within EP_LOSS_RTOL / EP_AUX_RTOL
               / EP_UPDATE_TOL of the dense run in one process, each
               run's dropped tokens equal to a recount from its routing
               (reported beside each other); (d) losses and the final
               global state bitwise equal, the replays issuing one
               publish all-gather a bucket a window hoisted against one a
               step unhoisted.  Prints its seconds.
 16. elastic - elastic data parallelism and its recovery tier:
               bench.py's BERT-base AMP step (DIST_LAYERS = 2 layers,
               widths unchanged, flash + fused CE) elasticized at
               logical dp 2 (distributed/elastic.py),
               micro-batch 4 of the global batch 8.  (a) here, under NCCL
               at world 1 (K = 2): 4 global steps eagerly, then the same
               from the same weights through Executor.run_steps, one
               window a call; and 4 global steps at DIST_LAYERS layers,
               (c)'s reference.  (b) `launch --elastic --nproc_per_node
               2` (2 gloo ranks on cuda:0, each running this script with
               --elastic-rank), a checkpoint every global step
               (CheckpointManager, every rank stages, rank 0 commits):
               chaos SIGKILLs rank 1 after global step 2, the supervisor
               tears the pod down and re-forms it at world 1 under NCCL,
               which restores the world-2 checkpoint rank-merged and is
               SIGTERM'd mid-window (its preemption save staged); a
               fresh 2-rank launch restores that (rounded down to the
               window) and finishes global step 4.  (c) two
               `--fleet_dir` launchers (hosts 0 and 1, one rank each,
               DIST_LAYERS layers, 3 global steps), started with (b)'s
               regrow launch (the kill and the shrink run alone):
               chaos `lose_host` takes host 1 down after global step 2,
               host 0 agrees members {0} and the newest mutual
               checkpoint from the journals, re-forms and finishes.
               Gates: (a) run_steps bitwise eager (losses and
               parameters), one capture; (b) every global step's
               `loss@ELASTIC_AVG` and every final parameter bitwise (a)'s,
               the backends gloo / NCCL, the journals holding the merged
               restore and the re-anchor; (c) the same against its
               reference, the re-formed fleet {0} at world 1 restored at
               global step 2; on every path 24 / 12 / 12 / 2 flash
               forward / dQ / dK/dV / fused CE a micro-step (8 / 4 / 4 /
               2 at DIST_LAYERS), bf16, none for head dims above 128.
               Reports the global-step ms (eager, replayed, world 2;
               without the checkpoint and its barrier wait, which are
               reported apart), the recovery seconds (kill to the
               re-formed pod's first step; the ranks parse the program
               the parent serialized, so no program build is in it),
               each rank's checkpoint bytes and save / restore seconds,
               the fold's gathered bytes a micro-step, the fleet's
               agreement seconds, epoch and restore step.
 17. pp_ps   - the pipeline and the parameter-server tier: (a) the
               AMP bench step at 12 layers cut into 2 pipeline stages
               under device_guard (the embeddings and layers 0-5 on
               "gpu:0", layers 6-11, the MLM head and the loss on
               "gpu:1"; both stages wrap onto the card), trained by
               PipelineOptimizer(Adam, M = 4) on a batch of 8 (one 2 x 512
               block tiled 4 times), 2 steps against 2 plain Executor.run
               steps from the same startup weights: losses within 1e-2,
               the update gap under PP_UPDATE_TOL, and a planted fault
               (the boundary activation's gradient zeroed into stage 0's
               backward) above it; each stage's launches a step (stage 0
               48 / 24 / 24 / 0, stage 1 48 / 24 / 24 / 8 forward, the
               vjp replay included / dQ / dK/dV / fused CE, bf16), the
               pipelined and plain step ms and peaks.  (b) `python -m
               paddle_tpu_torch.distributed.launch --run_mode ps
               --server_num 2 --worker_num 2 chip_smoke.py --ps-rank
               <cfg>`: PaddleRec's CTR-DNN at its widths (26 slots into a
               [1000001, 9] table row-sharded over the servers, 13 dense
               features, fc 512-256-128-32, softmax CE, SGD, sync, batch
               512 a trainer, synthetic data from --seed), 3 steps, the
               dense tower on the card in each trainer; every trainer's
               parameters (the table pulled from the servers) within an
               update gap of 1e-4 and 1e-5 an element of one process of
               SGD on the concatenated batch on the card (fp32); step ms,
               KV bytes pushed and pulled a step and the KV plane's share
               (contended: the processes share the card and host).  (c)
               the same program transpiled in heter mode and cut by
               split_heter_program at the slots' embeddings: the CPU
               section in a launched CPU process (`--heter-cpu <spec>`),
               the device section here on the card, over a KV server of
               this process; 3 steps' losses within 1e-5 and the
               parameters within the same gates of the unsplit program.
 18. analysis - the analysis and planner tiers (static/verifier.py,
               layout_analysis.py, memory_analysis.py, flops_analysis.py,
               planner.py) on bench.py's BERT-base AMP step at full width
               (batch 8, flash and fused CE), with PADDLE_TPU_VERIFY=strict
               for the whole phase, run after phase 11 (it reuses phase
               4's model directory and phase 7's GPT-2 model and posts).
               (d) kv_pool="auto": phase 7's first 4 posts (8 new tokens
               each) through a pool that static.page_budget sized from the
               card's memory against the explicit GEN_PLAN pool (equal, or
               a greedy near tie), budget_drift empty.  (a) 0 diagnostics
               at level "all" on the AMP main and startup programs, the
               fp32 program, the Predictor's post-pipeline program (phase
               4's model) and phase 14's ZeRO-1 program at world 2 (4
               layers); a collective planted in a sub-block raises
               ProgramVerificationError with V205 at the executor's
               first-run check, a read after donation V302.  (b) the
               walked FLOPs within 10% of 6 params tokens + 12 L s h
               tokens; the train.mfu gauge of 20 replayed steps within 1%
               of walked FLOPs x 20 / measured seconds / the data-sheet
               peak.  (c) predicted (analyze_program) against measured
               (max_memory_allocated) peak bytes of the eager, the
               replayed (its capturing call) and the recompute "always"
               step: measured / predicted is the port's slack;
               FLAGS_recompute="auto" at the card's budget builds the plain
               program, at the midpoint of the plain and "always" walked
               peaks the "always" program (JSON), 2 replayed steps' losses
               bitwise.  (e) plan_program at world 1 over batch {8, 16,
               32} x remat x gradient merge {1, 2}, no calibration; the
               plan applied (apply_plan) verifies at level "collective",
               runs 3 replayed steps beside the runner-up's (predicted and
               measured step ms, tokens/s; the ranking recorded, not
               gated), and its first loss equals bitwise a hand-applied
               build's first step.
 19. high_level - the 2.0 high-level path (hapi/, io/, metric/, jit/).
               (a) Model.fit of dygraph BERT-base pretraining (attention
               dropout 0, hidden 0.1; AdamW lr 1e-4; amp_configs O2;
               flash and fused CE forced on) over io.DataLoader of 6
               batches of 8 (one fixed batch, repeated), with
               ProgBarLogger and a recording callback; evaluate over 2
               batches, predict over 1: the 6 fit losses bitwise 6
               train_batch calls of an identical model from the same draw
               state; 12 / 12 / 12 flash forward / dQ / dK/dV, 2 fused CE
               and 25 dropouts a step, the flash and CE ones all bf16;
               losses finite and falling; save(training=True) -> load
               into a fresh model -> the next train_batch loss bitwise the
               unreloaded model's.  (b) prepare(use_jit=True) on vision
               ResNet-50 (224 x 224, 1000 classes, fp32, batch 32,
               Momentum 0.01 / 0.9), fused CE on, DataLoader(num_workers=
               2) over 4 batches, Accuracy(topk=(1, 5)): each jit fit
               step against a use_jit=False step from a copy of the
               state it started from, its loss (rtol 1e-5) and the state
               after it (every weight, batch-norm statistic and Momentum
               velocity within 1e-3, max |a - b| / max |b| a leaf), a
               planted fault of each kind (gradients zeroed, the
               batch-norm write-back left out) above 1e-3; with cuDNN
               deterministic, a jit fit and a use_jit=False fit of weight
               copies within both tolerances over the 4 steps (in the
               default mode the two fits' parting is recorded); fp32
               fused CE launches measured a step, 2 in the first (its
               trace, then its replay) and 1 in each later one; the
               Accuracy values equal to numpy over the logits the metric
               saw, under the fit's labels and under labels placed in
               each row's ranking (both strictly between 0 and 1);
               jit.save -> jit.load ->
               TranslatedLayer in eval and a Predictor over the same files
               (ir_optim off) within 1e-5 (normalised) of the eval
               forward.  (c) dy2static on CUDA tensors: a tensor `if` and
               the decode loop's `while` with `break`: the recorded
               program holds cond and while, outputs and the gradient
               bitwise the eager run's; run_steps over a program holding
               `while` runs step by step (no capture).
               Phase 9 runs BERT-base cut to DYGRAPH_LAYERS = 4
               layers (its three variants, the fp32 check and the hapi
               check), widths unchanged: (a) carries the full-depth
               dygraph AMP step.
 20. tensor    - the paddle.tensor functions (tensor/, the ops they
               dispatch, the truncated-normal, integer and Bernoulli
               draws of csrc/philox_random.cu).  (a) dygraph BERT-base
               (12 layers, full widths, batch 8 x 512), auto_cast O2 +
               GradScaler, AdamW, flash forced on, fused CE: the word
               embedding drawn as TruncatedNormal(0.02), then 4 steps
               whose masking and head are ported tensor functions
               (bernoulli(full(0.15)) picks, randint replaces, where
               applies; the padding mask unsqueezed to [8, 1, 1, 512] and
               dropped, since it keeps every key; nonzero / gather_nd /
               index_select gather the rows and labels; F.cross_entropy;
               topk / argmax / equal / cast / mean the accuracy); the
               same with every hand kernel swapped for its plain version:
               masks bit for bit, the embedding within 4 ulps, losses
               within 2e-2; launches a step gated (flash 12 / 12 / 12 and
               fused CE 1, bf16; Bernoulli 1, randint 1; the truncated
               normal 1 over the path), none in the plain run.  (b) the
               encoder and head under jit.to_static, fp32, 4 layers,
               flash off, fused CE on: each of 3 steps against an eager
               step from the state it started from (loss 1e-5, the state
               1e-3 a leaf), a planted fault above the gate; fused CE 2
               then 1 a step.  (c) every op this slice registers on CUDA
               and on the CPU, same numpy inputs: integers equal, floats
               within 1e-5 (normalised), ties and NaNs for top_k_v2 /
               argsort / arg_max / unique, the draws against their plain
               versions.  (d) the truncated normal at [30522, 768],
               randint and Bernoulli at [8, 512] against their plain
               versions; device ms, plain ms, the library call's ms
               (trunc_normal_, randint, bernoulli), the byte bound.
 21. vision_seq2seq - (a) models.transformer.transformer_big (d_model
               1024, 16 heads, 6 + 6 layers, d_inner 4096, one shared
               32000 vocabulary) in dygraph, fp32, batch 16 x 256 source
               and target tokens: (1) as published (dropout 0.3: every
               attention on the score matrix), Adam, a warm-up and 3
               timed steps (ms, target tokens/s, peak memory; launches a
               step: no flash, 62 dropout); (2) dropout 0, flash forced on,
               one SGD step with the kernels (the encoder self-attention
               and decoder cross-attention: flash 12 / 12 / 12, fp32)
               against the same step through the plain versions (loss
               1e-4, update gap 1e-2, each flash attention's q / k / v
               projection 0.1) and two planted faults above their gates
               (the encoder's gradients zeroed; one dQ kernel's output
               zeroed); (3) beam_search, beam 4,
               2 source rows, 16 target tokens, flash on and off: tokens
               equal or parted at a beam choice within NEAR_TIE.  (b)
               vision.models.vgg16() and mobilenet_v2() at 224 x 224,
               1000 classes, batch 32, fp32, Momentum: a warm-up and 3
               timed steps (ms, images/s), a batch-2 forward against the
               CPU (1e-4 normalised).  (c) every op type of the slice and
               its grad op on CUDA and on the CPU (fp32 1e-5 normalised,
               bf16 2e-2 for the AMP-white convolutions), and every new
               dygraph layer (forward and gradients, 1e-5).  (d) runs in
               phase 13: nn.SyncBatchNorm and BuildStrategy.sync_batch_
               norm on its 2 gloo ranks against one process over the
               global batch (Y, dX, running stats, the program's state
               after a step; 1e-5; the ranks' running stats bitwise
               equal), and SyncBatchNorm under NCCL at world 1.

`--profile` adds one torch.profiler window around a Predictor.run of
the served batch and one around a step of each training configuration
(device time by kernel, device busy share, the attention kernels' device
ms; the fp32 flash forward's device ms in the served batch) and the host
time of encoding one /predict response.

The line before the last is the kernels summary (the dropout kernel's
row last: its times at [8, 12, 512, 512] bf16, launches over phase 8's
eager steps with attention dropout): the four bf16 kernels
of the training step (launches counted over the training run of phase
5b), the fp32 forward at the serving shape (launches counted over the
served burst of phase 4), the fp32 dQ, dK/dV and fused cross-entropy
(launches counted over the fp32 training run of phase 5c), each with its
launches per graph-replayed step of phase 6, the fp16 instances
(kernel cases only, 0 launches: no configuration runs fp16), and the
kernels for head dims above 128 (the D = 256 and D = 512 cases, and
D = 768 for every split-D kernel in fp32 and bf16; their launches on every
main path, gated at 0 in each: no configuration has a head dim above
128); each row also gives its kernel's launches per dygraph step in each
phase 9 variant, in the row's dtype (`launches_per_dygraph_step`), and
its launches on each phase 10 path (`launches_on_baseline_paths`, all 0:
those paths run no hand kernel); the random kernel's row after the
dropout's: its times at [30522, 768] fp32 uniform, its launches on each
phase 12 path (`launches_by_phase12_path`) and the other cases' times;
every row its launches on phase 13's paths as counted there
(`phase13_launches`: a rank-step of each run of (a) and (c), an eager
step and the capturing call of (b), in the row's dtype; the random
kernel's also at each path's start; the kernels for head dims above 128
over each whole path), and on phase 14's (`phase14_launches`: a
rank-step of each ZeRO run and of the tp run, an eager step and the
capturing call of the stage-3 NCCL run), phase 15's and phase 16's
(`phase16_launches`: a micro-step of (a)'s eager run and (a)'s
capturing call, a micro-step of each launched rank), and phase 17's
(`phase17_launches`: a pipelined step of (a), both stages, and each
stage's; (b) and (c) launch no hand kernel), and phase 18's
(`phase18_launches`: the eager AMP step of (c), the whole phase, in the
row's dtype), and phase 19's (`phase19_launches`: each fit step of (a)
and each jit fit step of (b), measured, in the row's dtype), and phase
20's (`phase20_launches`: each step of (a) and each jit step of (b), in
the row's dtype), and phase 21's (`phase21_launches`: a step of (a) 1,
the step of (a) 2, (a) 3's beam search, a step of each (b) model); then
the rows of the three new Philox distributions
(truncated normal, randint, Bernoulli: times from phase 20 (d), launches
over phase 20 (a)'s path);
every phase's seconds on a line of its own ({"phase_seconds": ...});
the last line
{"ok": true, "device": {...}}.
"""
import argparse
import copy
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

# H100 SXM datasheet peaks (dense): fp32 outside the tensor cores, bf16
# and TF32 on the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12
BERT = dict(vocab=30522, seq=512, hidden=768, layers_n=12, heads=12)
ROWS_PER_POST = (2, 2, 2, 2)
TRAIN_BATCH = 8
TRAIN_STEPS = 6
FP32_TRAIN_STEPS = 4
GRAPH_TIMED_CALLS = 3  # run_steps calls timed after the capturing one
# run_steps calls profiled after the timed ones: the profiler can lose
# device records (phase 6 takes each kernel's largest count over them)
GRAPH_PROFILED_CALLS = 2
# kernel-case tolerances against the plain versions: fp32 summation order
# (3xTF32 keeps an fp32-level error); bf16 and fp16 a few ulps of the
# rounded outputs (2^-8 and 2^-11 relative)
TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 5e-3}
# kernel cases also timed with a cold L2 (kernel_ms_cold)
COLD_CASES = ("slice_bf16", "slice_fp32", "d256_fp32")
KERNEL_SOURCES = ("flash_attn_fwd", "flash_attn_bwd", "fused_xent_fwd",
                  "dropout_philox", "philox_random")
# phase 7: GPT-2 small widths (random weights from --seed), served through
# the paged pool of GEN_PLAN with the radix prefix cache
GPT2 = dict(vocab_size=50257, hidden_size=768, num_layers=12, num_heads=12,
            intermediate_size=3072, max_position=1024)
GEN_PLAN = dict(num_layers=12, num_heads=12, head_dim=64, page_tokens=16,
                pages=512, max_slots=8, max_context=1024)
GEN_POSTS = 16        # concurrent /generate posts, prompts of 32-512 tokens
GEN_SAMPLING = 2      # of them decode with sampling (top_k 40, T 0.8)
GEN_PREFIX = 256      # every other post starts with one shared prefix
GEN_MAX_LENGTH = 64
GEN_TOL = 1e-4        # greedy token vs the teacher-forced top logit
# the kernels of the training and serving paths and the TPU kernels they
# replace
KERNELS = {
    "flash_attn_fwd": ("paddle_tpu_torch/csrc/flash_attn_fwd.cu",
                       "paddle_tpu/ops/attention.py:125"),
    "flash_attn_fwd_fp32": ("paddle_tpu_torch/csrc/flash_attn_fwd.cu",
                            "paddle_tpu/ops/attention.py:125"),
    "flash_attn_bwd_dq": ("paddle_tpu_torch/csrc/flash_attn_bwd.cu",
                          "paddle_tpu/ops/attention.py:240"),
    "flash_attn_bwd_dkv": ("paddle_tpu_torch/csrc/flash_attn_bwd.cu",
                           "paddle_tpu/ops/attention.py:281"),
    "flash_attn_bwd_dq_fp32": ("paddle_tpu_torch/csrc/flash_attn_bwd.cu",
                               "paddle_tpu/ops/attention.py:240"),
    "flash_attn_bwd_dkv_fp32": ("paddle_tpu_torch/csrc/flash_attn_bwd.cu",
                                "paddle_tpu/ops/attention.py:281"),
    "fused_xent_fwd": ("paddle_tpu_torch/csrc/fused_xent_fwd.cu",
                       "paddle_tpu/ops/fused_xent.py:42"),
    "fused_xent_fwd_fp32": ("paddle_tpu_torch/csrc/fused_xent_fwd.cu",
                            "paddle_tpu/ops/fused_xent.py:42"),
    "flash_attn_fwd_fp16": ("paddle_tpu_torch/csrc/flash_attn_fwd.cu",
                            "paddle_tpu/ops/attention.py:125"),
    "flash_attn_bwd_dq_fp16": ("paddle_tpu_torch/csrc/flash_attn_bwd.cu",
                               "paddle_tpu/ops/attention.py:240"),
    "flash_attn_bwd_dkv_fp16": ("paddle_tpu_torch/csrc/flash_attn_bwd.cu",
                                "paddle_tpu/ops/attention.py:281"),
    "fused_xent_fwd_fp16": ("paddle_tpu_torch/csrc/fused_xent_fwd.cu",
                            "paddle_tpu/ops/fused_xent.py:42"),
    "dropout_philox": ("paddle_tpu_torch/csrc/dropout_philox.cu",
                       "no TPU kernel: `jax.random.bernoulli` under XLA, "
                       "`paddle_tpu/ops/kernels/nn.py:490`"),
    "philox_random": ("paddle_tpu_torch/csrc/philox_random.cu",
                      "no TPU kernel: `jax.random.uniform` / "
                      "`jax.random.normal` under XLA, "
                      "`paddle_tpu/ops/kernels/random.py:20,40`"),
    "philox_trunc_normal": ("paddle_tpu_torch/csrc/philox_random.cu",
                            "no TPU kernel: `jax.random.truncated_normal` "
                            "under XLA, "
                            "`paddle_tpu/ops/kernels/random.py:48`"),
    "philox_randint": ("paddle_tpu_torch/csrc/philox_random.cu",
                       "no TPU kernel: `jax.random.randint` under XLA, "
                       "`paddle_tpu/ops/kernels/random.py:64`"),
    "philox_bernoulli": ("paddle_tpu_torch/csrc/philox_random.cu",
                         "no TPU kernel: `jax.random.bernoulli` under XLA, "
                         "`paddle_tpu/ops/kernels/random.py:58`"),
}
# the kernels for head dims above 128, by route, kernel and dtype: the
# 16-bit wgmma forward, dQ and dK/dV at D = 256 (csrc/flash_attn_fwd.cu,
# flash_attn_bwd.cu), and the split-D kernels of the same files (the
# 16-bit wgmma forward, dQ and dK/dV, the fp32 3xTF32 forward, dQ and
# dK/dV) at D = 512 and 768 (named with the suffix _d768) and the fp32
# ones at D = 256 (suffix _d256), each with the kernel case whose times
# it reports
_TPU_LINE = {"fwd": 125, "bwd_dq": 240, "bwd_dkv": 281}
_KINDS = ("fwd", "bwd_dq", "bwd_dkv")
WIDE_KERNELS = []  # (summary name, route, kernel, kernel case)
for _route, _dts, _case in (
        ("wgmma256", ("bf16", "fp16"), "d256"),
        ("tf32_split_d", ("fp32",), "d256"),
        ("wgmma_split_d", ("bf16", "fp16"), "d512"),
        ("wgmma_split_d", ("bf16",), "d768"),
        ("tf32_split_d", ("fp32",), "d512"),
        ("tf32_split_d", ("fp32",), "d768")):
    for _kind in _KINDS:
        for _dt in _dts:
            _name = f"flash_attn_{_route}_{_kind}_{_dt}" + \
                (f"_{_case}" if "split_d" in _route and _case != "d512"
                 else "")
            _file = "flash_attn_fwd" if _kind == "fwd" else "flash_attn_bwd"
            KERNELS[_name] = (f"paddle_tpu_torch/csrc/{_file}.cu",
                              f"paddle_tpu/ops/attention.py:"
                              f"{_TPU_LINE[_kind]}")
            WIDE_KERNELS.append((_name, _route, _kind, f"{_case}_{_dt}"))


def log(obj):
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def dtype_name(dt):
    return str(dt).replace("torch.", "")


def cuda_time_ms(fn, reps):
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps, flush=None):
    """Device time of one call of fn: CUDA events around `reps` calls that
    the host queued while a spin kernel (torch.cuda._sleep) held the
    device, so the calls run back to back and the host's launch cost is
    left out; it fails if the device reached the first event before the
    host had queued the last call.  `flush`, if given, runs before every
    call, and the time of `reps` flushes alone is subtracted (an L2 flush:
    each call meets a cold cache)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    if flush is not None:
        flush()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()

    def run(body):
        # hold the device ~10x the host's queueing time (~2 GHz SM
        # clock); if it still caught up, hold it longer and run again
        hold_s = 10 * reps * host_s + 0.02
        for _ in range(4):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(2e9 * hold_s))
            start.record()
            for _ in range(reps):
                body()
            end.record()
            drained = start.query()
            torch.cuda.synchronize()
            if not drained:
                return start.elapsed_time(end)
            hold_s *= 4
        raise AssertionError("device_ms: the device kept catching up with "
                             "the host; the time would include launch gaps")

    if flush is None:
        return run(fn) / reps

    def flushed():
        flush()
        fn()

    return (run(flushed) - run(flush)) / reps


def l2_flush(torch):
    """A callable that writes 64 MB, more than the H100's 50 MB L2."""
    buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    return buf.zero_


def visible_pairs(sq, sk, causal):
    if not causal:
        return sq * sk
    shift = sk - sq
    return sum(max(0, min(sk, i + shift + 1)) for i in range(sq))


def roofline(flops, nbytes, dtype):
    """(bound_ms, bound_by): the larger of FLOPs over the dtype's peak and
    bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        ("operations" if t_ops >= t_bytes else "bytes")


def unit_bound(flops, nbytes, dtype):
    """(bound_ms, bound_by, fma_bound_ms) against the units the kernels
    use: bf16 on the tensor cores; fp32 as three TF32 products per
    multiply (3xTF32) on the tensor cores, with the bound on fp32 FMAs
    beside it (None in bf16)."""
    if dtype != "float32":
        return roofline(flops, nbytes, "bfloat16") + (None,)  # fp16: same
    return roofline(3 * flops, nbytes, "tf32") + \
        (roofline(flops, nbytes, "float32")[0],)


def bound(b, h, sq, sk, d, dtype, causal):
    """unit_bound of one forward call: each input read once, each output
    written once; FLOPs of the two products over the (query, key) pairs
    the mask leaves visible."""
    esize = 4 if dtype == "float32" else 2
    nbytes = esize * b * h * d * (2 * sq + 2 * sk) + 4 * b * h * sq
    return unit_bound(4.0 * b * h * d * visible_pairs(sq, sk, causal),
                      nbytes, dtype)


def bwd_bounds(b, h, sq, sk, d, dtype, causal):
    """{"dq": unit_bound, "dkv": unit_bound}.  Both read q, k, v, dO (input
    dtype) and lse, D (fp32 [B, H, Sq]); dQ writes dq, dK/dV dk and dv.
    FLOPs over the visible pairs: dQ 3 products (S, dP, dS.k), dK/dV 4
    (S, dP, P^T.dO, dS^T.q), 2 FLOPs per multiply-add."""
    esize = 4 if dtype == "float32" else 2
    ins = esize * b * h * d * (2 * sq + 2 * sk) + 8 * b * h * sq
    pairs = b * h * visible_pairs(sq, sk, causal)
    return {"dq": unit_bound(6.0 * pairs * d, ins + esize * b * h * sq * d,
                             dtype),
            "dkv": unit_bound(8.0 * pairs * d,
                              ins + 2 * esize * b * h * sk * d, dtype)}


def attention_cases(torch):
    return [
        # name, B, H, Sq, Sk, D, dtype, causal, strided head-split views
        ("slice_fp32", 8, 12, 512, 512, 64, torch.float32, False, True),
        ("slice_bf16", 8, 12, 512, 512, 64, torch.bfloat16, False, True),
        ("causal_sq_lt_sk", 2, 12, 384, 512, 64, torch.float32, True, False),
        ("causal_sq_gt_sk", 2, 12, 512, 384, 64, torch.bfloat16, True,
         False),
        ("ragged_s200_d32", 2, 12, 200, 200, 32, torch.float32, False, False),
        ("ragged_s200_d128", 2, 12, 200, 200, 128, torch.float32, False,
         False),
        ("causal_sq_lt_sk_bf16", 2, 12, 384, 512, 64, torch.bfloat16, True,
         False),
        ("ragged_s200_d32_bf16", 2, 12, 200, 200, 32, torch.bfloat16, False,
         False),
        ("ragged_s200_d128_bf16", 2, 12, 200, 200, 128, torch.bfloat16,
         False, False),
        # fp16 (the wgmma kernels' f16 instances) at the training shape
        ("slice_fp16", 8, 12, 512, 512, 64, torch.float16, False, True),
        # head dims without an instance, zero-padded to 128 and 64:
        # hidden 768 over 8 and over 16 heads, on the head-split views
        ("pad_d96_fp32", 8, 8, 512, 512, 96, torch.float32, False, True),
        ("pad_d96_bf16", 8, 8, 512, 512, 96, torch.bfloat16, False, True),
        ("pad_d48_fp32", 8, 16, 512, 512, 48, torch.float32, False, True),
        ("pad_d48_bf16", 8, 16, 512, 512, 48, torch.bfloat16, False, True),
        # head dim 256 (hidden 2048 over 8 heads): the 16-bit wgmma
        # forward, dQ and dK/dV; in fp32 the 3xTF32 split-D forward, dQ
        # and dK/dV at n = 1; causal both ways and ragged in 16 bits,
        # causal Sq > Sk and ragged causal in fp32
        ("d256_fp32", 8, 8, 512, 512, 256, torch.float32, False, True),
        ("d256_causal_sq_gt_sk_fp32", 2, 8, 512, 384, 256, torch.float32,
         True, False),
        ("d256_ragged_s200_causal_fp32", 2, 8, 200, 200, 256,
         torch.float32, True, False),
        ("d256_bf16", 8, 8, 512, 512, 256, torch.bfloat16, False, True),
        ("d256_fp16", 8, 8, 512, 512, 256, torch.float16, False, True),
        ("d256_causal_sq_lt_sk_bf16", 2, 8, 384, 512, 256, torch.bfloat16,
         True, False),
        ("d256_causal_sq_gt_sk_fp16", 2, 8, 512, 384, 256, torch.float16,
         True, False),
        ("d256_ragged_s200_bf16", 2, 8, 200, 200, 256, torch.bfloat16,
         False, False),
        ("d256_ragged_s200_causal_fp16", 2, 8, 200, 200, 256,
         torch.float16, True, False),
        # head dim 512 (hidden 2048 over 4 heads), two 256-column chunks:
        # the 16-bit forward, dQ and dK/dV on the split-D wgmma kernels,
        # the fp32 forward, dQ and dK/dV on the 3xTF32 split-D kernels;
        # causal with Sq > Sk in fp16
        ("d512_fp32", 8, 4, 512, 512, 512, torch.float32, False, True),
        ("d512_bf16", 8, 4, 512, 512, 512, torch.bfloat16, False, True),
        ("d512_fp16", 8, 4, 512, 512, 512, torch.float16, False, True),
        ("d512_causal_sq_gt_sk_fp16", 2, 4, 512, 384, 512, torch.float16,
         True, False),
        # head dim 768 (hidden 3072 over 4 heads): three chunks
        ("d768_fp32", 8, 4, 512, 512, 768, torch.float32, False, True),
        ("d768_bf16", 8, 4, 512, 512, 768, torch.bfloat16, False, True),
        # the split-D dQ and dK/dV (and the forwards): causal Sq < Sk and
        # Sq > Sk, ragged S = 200
        ("d512_causal_sq_lt_sk_fp32", 2, 4, 384, 512, 512, torch.float32,
         True, False),
        ("d512_causal_sq_gt_sk_fp32", 2, 4, 512, 384, 512, torch.float32,
         True, False),
        ("d512_ragged_s200_fp32", 2, 4, 200, 200, 512, torch.float32, False,
         False),
        ("d512_causal_sq_lt_sk_bf16", 2, 4, 384, 512, 512, torch.bfloat16,
         True, False),
        ("d512_ragged_s200_causal_bf16", 2, 4, 200, 200, 512,
         torch.bfloat16, True, False),
        ("d768_ragged_s200_causal_fp32", 2, 4, 200, 200, 768, torch.float32,
         True, False),
        ("d768_causal_sq_gt_sk_bf16", 2, 4, 512, 384, 768, torch.bfloat16,
         True, False),
    ]


def attention_inputs(torch, gen, b, h, s, d, dt, strided):
    if strided:  # [B, S, H*D] -> [B, H, S, D] view, as transpose2
        x = torch.randn(b, s, h * d, device="cuda", generator=gen)
        return x.to(dt).reshape(b, s, h, d).permute(0, 2, 1, 3)
    return torch.randn(b, h, s, d, device="cuda", generator=gen).to(dt)


def kernel_phase(torch, attn):
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = {}
    for name, b, h, sq, sk, d, dt, causal, strided in attention_cases(torch):
        q, k, v = (attention_inputs(torch, gen, b, h, s, d, dt, strided)
                   for s in (sq, sk, sk))
        out, lse = attn.flash_attention_cuda(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref, ref_lse = attn.flash_attention_plain(q, k, v, causal=causal)
        dname = dtype_name(dt)
        tol = TOL[dname]
        err = (out.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol)
        fin = torch.isfinite(ref_lse)
        if not torch.equal(torch.isfinite(lse), fin):
            raise AssertionError(f"{name}: lse -inf rows differ")
        torch.testing.assert_close(lse[fin], ref_lse[fin], rtol=tol,
                                   atol=tol)
        if causal and sq > sk and not torch.all(out[:, :, :sq - sk] == 0):
            raise AssertionError(f"{name}: fully-masked rows are not 0")
        mask = None
        if causal:  # bottom-right alignment (SDPA's is_causal is top-left)
            mask = torch.ones(sq, sk, dtype=torch.bool,
                              device="cuda").tril(sk - sq)
        def kern():
            attn.flash_attention_cuda(q, k, v, causal=causal)

        bound_ms, bound_by, fma_bound_ms = bound(b, h, sq, sk, d, dname,
                                                 causal)
        row = dict(case=name, shape=[b, h, sq, sk, d], dtype=dname,
                   causal=causal, strided=strided, max_abs_err=err, tol=tol,
                   kernel_head_dim=attn.kernel_head_dim(d),
                   kernel_ms=device_ms(torch, kern, 20),
                   kernel_ms_events=cuda_time_ms(kern, 20),
                   plain_ms=device_ms(
                       torch, lambda: attn.flash_attention_plain(
                           q, k, v, causal=causal), 1),
                   library_ms=device_ms(
                       torch, lambda: F.scaled_dot_product_attention(
                           q, k, v, attn_mask=mask), 20),
                   bound_ms=bound_ms, bound_by=bound_by)
        if fma_bound_ms is not None:
            row["fma_bound_ms"] = fma_bound_ms
        if name in COLD_CASES:
            row["kernel_ms_cold"] = device_ms(torch, kern, 10,
                                              flush=l2_flush(torch))
        log(row)
        results[name] = row
    return results


def bwd_kernel_phase(torch, attn):
    """The dQ and dK/dV kernels against their plain versions, at the
    forward's cases; dO is random, out/lse come from the forward kernel."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    results = {}
    for name, b, h, sq, sk, d, dt, causal, strided in attention_cases(torch):
        q, k, v, do = (attention_inputs(torch, gen, b, h, s, d, dt, strided)
                       for s in (sq, sk, sk, sq))
        out, lse = attn.flash_attention_cuda(q, k, v, causal=causal)
        dd = (do.float() * out.float()).sum(-1)
        args = (q, k, v, do, lse, dd, causal)
        dq = attn.flash_attention_bwd_dq_cuda(*args)
        dk, dv = attn.flash_attention_bwd_dkv_cuda(*args)
        again = (attn.flash_attention_bwd_dq_cuda(*args),
                 *attn.flash_attention_bwd_dkv_cuda(*args))
        torch.cuda.synchronize()
        for tag, x, y in zip(("dq", "dk", "dv"), (dq, dk, dv), again):
            if not torch.equal(x, y):
                raise AssertionError(f"{name} {tag}: two launches differ")
        ref_dq = attn.flash_attention_bwd_dq_plain(*args)
        ref_dk, ref_dv = attn.flash_attention_bwd_dkv_plain(*args)
        dname = dtype_name(dt)
        tol = TOL[dname]
        errs = {}
        for tag, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                              ("dv", dv, ref_dv)):
            torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                       atol=tol, msg=lambda m: f"{name} "
                                       f"{tag}: {m}")
            errs[tag] = (got.float() - ref.float()).abs().max().item()
        if causal and sq > sk and not torch.all(dq[:, :, :sq - sk] == 0):
            raise AssertionError(f"{name}: fully-masked rows have dq != 0")
        mask = None
        if causal:  # bottom-right alignment (SDPA's is_causal is top-left)
            mask = torch.ones(sq, sk, dtype=torch.bool,
                              device="cuda").tril(sk - sq)
        ql, kl, vl = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=mask)
        # the whole SDPA backward (dq, dk and dv): the yardstick of both
        library_ms = device_ms(
            torch, lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                               retain_graph=True), 10)
        bounds = bwd_bounds(b, h, sq, sk, d, dname, causal)
        results[name] = {}
        for kern, cuda_fn, plain_fn, err in (
                ("dq", attn.flash_attention_bwd_dq_cuda,
                 attn.flash_attention_bwd_dq_plain, errs["dq"]),
                ("dkv", attn.flash_attention_bwd_dkv_cuda,
                 attn.flash_attention_bwd_dkv_plain,
                 max(errs["dk"], errs["dv"]))):
            row = dict(case=name, kernel=kern, shape=[b, h, sq, sk, d],
                       dtype=dname, causal=causal, strided=strided, tol=tol,
                       max_abs_err=err,
                       kernel_head_dim=attn.kernel_head_dim(d),
                       kernel_ms=device_ms(torch, lambda: cuda_fn(*args), 10),
                       kernel_ms_events=cuda_time_ms(lambda: cuda_fn(*args),
                                                     10),
                       plain_ms=device_ms(torch, lambda: plain_fn(*args), 1),
                       library_ms=library_ms, bound_ms=bounds[kern][0],
                       bound_by=bounds[kern][1])
            if bounds[kern][2] is not None:
                row["fma_bound_ms"] = bounds[kern][2]
            if name in COLD_CASES:
                row["kernel_ms_cold"] = device_ms(
                    torch, lambda: cuda_fn(*args), 10, flush=l2_flush(torch))
            log(dict(phase="kernel_bwd", **row))
            results[name][kern] = row
    return results


def xent_kernel_phase(torch, fx):
    """The fused cross-entropy kernel against its plain version."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(99)
    cases = [  # name, T, V, dtype, ignore_index, share of ignored rows
        ("train_fp32", 4096, 30522, torch.float32, -100, 0),
        ("train_bf16", 4096, 30522, torch.bfloat16, -100, 0),
        ("train_fp16", 4096, 30522, torch.float16, -100, 0),
        ("ragged_v1000", 300, 1000, torch.float32, -100, 0),
        ("ignore_pos", 512, 30522, torch.float32, 7, 4),
        ("ignore_neg", 512, 30522, torch.bfloat16, -1, 4),
    ]
    results = {}
    for name, t, v, dt, ign, every in cases:
        logits = (2.0 * torch.randn(t, v, device="cuda", generator=gen)).to(dt)
        label = torch.randint(0, v, (t,), device="cuda", generator=gen)
        if every:
            label[::every] = ign
        loss, lse = fx.fused_xent_cuda(logits, label, ign)
        torch.cuda.synchronize()
        ref_loss, ref_lse = fx.fused_xent_plain(logits, label, ign)
        dname = dtype_name(dt)
        tol = TOL[dname]
        torch.testing.assert_close(loss, ref_loss, rtol=tol, atol=tol)
        torch.testing.assert_close(lse, ref_lse, rtol=tol, atol=tol)
        if every and not torch.all(loss[::every] == 0):
            raise AssertionError(f"{name}: ignored rows have loss != 0")
        esize = 4 if dt == torch.float32 else 2
        # logits and labels read once, loss and lse written once; ~4
        # operations per logit (max, subtract, exp, add)
        bound_ms, bound_by = roofline(4.0 * t * v, esize * t * v + 16 * t,
                                      "float32" if esize == 4 else
                                      "bfloat16")
        lib_label = label.clone()
        row = dict(case=name, shape=[t, v], dtype=dname, ignore_index=ign,
                   tol=tol, max_abs_err=(loss - ref_loss).abs().max().item(),
                   kernel_ms=device_ms(
                       torch, lambda: fx.fused_xent_cuda(logits, label, ign),
                       20),
                   kernel_ms_events=cuda_time_ms(
                       lambda: fx.fused_xent_cuda(logits, label, ign), 20),
                   plain_ms=device_ms(
                       torch, lambda: fx.fused_xent_plain(logits, label, ign),
                       1),
                   library_ms=device_ms(
                       torch, lambda: F.cross_entropy(logits, lib_label,
                                                      ignore_index=ign,
                                                      reduction="none"), 20),
                   bound_ms=bound_ms, bound_by=bound_by)
        log(dict(phase="kernel_xent", **row))
        results[name] = row
    return results


DROPOUT_SHAPES = (("attn_weights", (8, 12, 512, 512)),  # B, H, S, S
                  ("hidden", (8, 512, 768)))              # B, S, hidden
DROPOUT_P = 0.1


def dropout_kernel_phase(torch, dr):
    """The dropout kernel against its plain version (the same Philox bits
    in PyTorch integer arithmetic, on the card): Out and Mask equal to the
    last bit in fp32, bf16 and fp16 at the attention-weights and hidden
    shapes of the recipe (upscale_in_train, the seed read through a
    device pointer), and in four more cases: downgrade_in_infer, a host
    seed (fix_seed), a view 2 bytes past a 16-byte boundary (the scalar
    path) and a ragged tail.  The keep rate over the [8, 12, 512, 512]
    mask within 0.001 of 1 - p.  library_ms is F.dropout (it draws other
    numbers: a yardstick the port never calls); the bound is bytes, each
    input read once and Out and Mask written once."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(17)
    seed = torch.tensor([20241017], dtype=torch.int64, device="cuda")

    def same_bits(a, b):
        return a.shape == b.shape and a.dtype == b.dtype and \
            torch.equal(a.contiguous().view(torch.uint8),
                        b.contiguous().view(torch.uint8))

    def check(name, x, p, key, upscale):
        out, mask = dr.dropout_cuda(x, p, key, 123, upscale)
        torch.cuda.synchronize()
        ref_out, ref_mask = dr.dropout_plain(x, p, key, 123, upscale)
        if not (same_bits(out, ref_out) and same_bits(mask, ref_mask)):
            raise AssertionError(f"dropout {name}: kernel and plain version "
                                 "differ")
        return out, mask

    results = {}
    for shape_name, shape in DROPOUT_SHAPES:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            x = torch.randn(shape, device="cuda", generator=gen).to(dt)
            dname = dtype_name(dt)
            name = f"{shape_name}_{dname}"
            _, mask = check(name, x, DROPOUT_P, seed, True)
            keep = mask.double().mean().item()
            if shape_name == "attn_weights" and \
                    abs(keep - (1 - DROPOUT_P)) > 1e-3:
                raise AssertionError(f"dropout {name}: keep rate {keep}")
            esize = x.element_size()
            n = x.numel()
            row = dict(case=name, shape=list(shape), dtype=dname,
                       p=DROPOUT_P, keep_rate=keep, max_abs_err=0.0,
                       kernel_ms=device_ms(
                           torch, lambda: dr.dropout_cuda(
                               x, DROPOUT_P, seed, 123, True), 20),
                       plain_ms=device_ms(
                           torch, lambda: dr.dropout_plain(
                               x, DROPOUT_P, seed, 123, True), 1),
                       library_ms=device_ms(
                           torch, lambda: F.dropout(x, DROPOUT_P,
                                                    training=True), 20),
                       # read x, write Out and the uint8 Mask
                       bound_ms=n * (2 * esize + 1) / PEAK_BYTES * 1e3,
                       bound_by="bytes")
            log(dict(phase="kernel_dropout", **row))
            results[name] = row
    x = torch.randn(4099, 37, device="cuda", generator=gen).to(
        torch.bfloat16)
    check("downgrade_in_infer", x, 0.3, seed, False)
    check("host_seed", x, 0.5, 987654321, True)
    flat = torch.randn(1 << 20, device="cuda", generator=gen).to(
        torch.float16)
    check("unaligned_view", flat[1:], DROPOUT_P, seed, True)
    check("ragged_tail", torch.randn(1001, device="cuda", generator=gen),
          DROPOUT_P, seed, True)
    log({"phase": "kernel_dropout_cases", "bitwise_equal": [
        "downgrade_in_infer", "host_seed", "unaligned_view", "ragged_tail"]})
    return results


def device_names_phase(torch, attn):
    """The fp32 forward, dQ and dK/dV at [8, 8, 512, 256] under
    torch.profiler: each runs its 3xTF32 split-D device kernel (named in
    WIDE_DEVICE_NAMES), counted on its wrapper's launches_tf32_split_d,
    and no other kernel of the routes for head dims above 128 ran."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (attention_inputs(torch, gen, 8, 8, 512, 256,
                                    torch.float32, True) for _ in range(4))
    zero_wide(attn)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out, lse = attn.flash_attention_cuda(q, k, v)
        dd = (do * out).sum(-1)
        attn.flash_attention_bwd_dq_cuda(q, k, v, do, lse, dd)
        attn.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, dd)
        torch.cuda.synchronize()
    counted = read_wide(attn)
    seen = count_kernels(prof, WIDE_DEVICE_NAMES)[0]
    want = {f"tf32_split_d/{kind}": 1 for kind in _KINDS}
    for name, got in (("launch counts", counted), ("profiler", seen)):
        if {key: n for key, n in got.items() if n} != want:
            raise AssertionError(f"fp32 D = 256: {name} {got}, expected "
                                 f"{want}")
    log({"phase": "kernel_device_names", "shape": [8, 8, 512, 256],
         "dtype": "float32", "device_kernels": seen,
         "launch_counts": counted})


def view_copy_phase(torch, attn):
    """A view that TMA refuses (4 bytes past a 16-byte boundary) is
    copied to a contiguous tensor where a kernel reads it through TMA and
    then launched: the forward, dQ and dK/dV on the shifted q and dO give
    the bits of the aligned tensors, and flash_attention.view_copies
    counts the copies: 5 in bf16 at D = 64, 256 and 512 and in fp32 at
    D = 256 (q in each of the three launches, dO in the dQ and the
    dK/dV)."""
    gen = torch.Generator(device="cuda").manual_seed(77)

    def shifted(t):  # t's values in a view 4 bytes past 16 bytes
        pad = 4 // t.element_size()
        flat = torch.empty(t.numel() + pad, dtype=t.dtype, device="cuda")
        view = flat[pad:].view(t.shape)
        view.copy_(t)
        return view

    for (b, h, s, d), dt, want_copies in (
            ((2, 12, 512, 64), torch.bfloat16, 5),
            ((2, 8, 512, 256), torch.bfloat16, 5),
            ((2, 4, 512, 512), torch.bfloat16, 5),
            ((2, 8, 512, 256), torch.float32, 5)):
        q, k, v, do = (attention_inputs(torch, gen, b, h, s, d, dt, False)
                       for _ in range(4))
        sq, sdo = shifted(q), shifted(do)
        if sq.data_ptr() % 16 != 4 or attn.tma_accepts(sq):
            raise AssertionError("the shifted view is not one TMA refuses")
        out, lse = attn.flash_attention_cuda(q, k, v)
        dd = (do.float() * out.float()).sum(-1)
        want = (out, attn.flash_attention_bwd_dq_cuda(q, k, v, do, lse, dd),
                *attn.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, dd))
        attn.flash_attention.view_copies = 0
        got = (attn.flash_attention_cuda(sq, k, v)[0],
               attn.flash_attention_bwd_dq_cuda(sq, k, v, sdo, lse, dd),
               *attn.flash_attention_bwd_dkv_cuda(sq, k, v, sdo, lse, dd))
        torch.cuda.synchronize()
        copies = attn.flash_attention.view_copies
        if copies != want_copies:
            raise AssertionError(f"D = {d}: {copies} view copies, expected "
                                 f"{want_copies}")
        for tag, x, y in zip(("out", "dq", "dk", "dv"), got, want):
            if not torch.equal(x, y):
                raise AssertionError(f"D = {d}: {tag} of the copied view "
                                     "differs")
        log({"phase": "kernel_view_copy", "shape": [b, h, s, d],
             "dtype": dtype_name(dt), "offset_bytes": sq.data_ptr() % 16,
             "view_copies": copies, "bitwise_equal_to_aligned": True})


def post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        body = json.loads(r.read())
    return body, time.perf_counter() - t0


def profile_phase(torch, predictor, feeds, reply, runs=3):
    """Where a served batch's time goes: device time by kernel over
    `runs` Predictor.runs in one profiler window (per run), and the host
    time of JSON-encoding one response.  Device busy is given with and
    without memory copies: the output's copy to pageable host memory
    varies with the host, the kernels do not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    predictor.run(feeds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            predictor.run(feeds)
    wall_ms = (time.perf_counter() - t0) * 1e3 / runs
    # device-side events only (kernels, memcpy): the aten:: rows carry
    # the same device time again
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total]

    def per_run_ms(events):
        return sum(e.self_device_time_total for e in events) / 1e3 / runs

    busy_ms = per_run_ms(dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:12]
    flash = [e for e in dev if "flash_fwd" in e.key]
    t0 = time.perf_counter()
    json.dumps(reply)
    log({"phase": "profile", "rows": int(feeds[0].shape[0]), "runs": runs,
         "run_wall_ms_under_profiler": wall_ms, "device_busy_ms": busy_ms,
         "device_kernel_ms": per_run_ms(
             [e for e in dev if not e.key.startswith("Mem")]),
         "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
         "flash_fwd_fp32_device_ms": per_run_ms(flash),
         "flash_fwd_fp32_launches": sum(e.count for e in flash) / runs,
         "json_encode_one_reply_ms": (time.perf_counter() - t0) * 1e3,
         "top_device_ms_per_run": [[e.key[:80], e.count / runs,
                                    e.self_device_time_total / 1e3 / runs]
                                   for e in top]})


def slice_phase(torch, seed, tmp, profile=False):
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.inference.server import InferenceServer
    from paddle_tpu_torch.io import save_inference_model
    from paddle_tpu_torch.models import build_bert_base
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.serving import metrics

    t0 = time.perf_counter()
    programs = {}
    for flash in (True, False):
        attn.enable_flash_attention(flash)
        _reset_unique_names()  # same parameter names in both programs
        programs[flash] = build_bert_base(use_amp=False, **BERT)
    attn._FLASH_STATE["mode"] = "auto"
    main, startup, out = programs[True]
    main_off, _, out_off = programs[False]
    if [op.type for op in main.global_block().ops].count(
            "flash_attention") != BERT["layers_n"]:
        raise AssertionError("flash program lacks its flash_attention ops")
    startup.random_seed = seed
    exe = static.Executor()  # CUDAPlace(0)
    scope = static.Scope()
    dirs = {True: os.path.join(tmp, "bert_flash"),
            False: os.path.join(tmp, "bert_score_matrix")}
    with static.scope_guard(scope):
        exe.run(startup)
        n_params = sum(int(t.numel()) for t in scope.vars.values())
        save_inference_model(dirs[True], ["ids", "pos"], [out], exe, main)
        save_inference_model(dirs[False], ["ids", "pos"], [out_off], exe,
                             main_off)
    del scope
    log({"phase": "slice_setup", "params": n_params,
         "build_init_save_s": time.perf_counter() - t0})

    rng = np.random.RandomState(seed)
    rows = sum(ROWS_PER_POST)
    ids = rng.randint(0, BERT["vocab"], (rows, BERT["seq"])).astype(np.int64)
    pos = np.tile(np.arange(BERT["seq"], dtype=np.int64), (rows, 1))
    spans, off = [], 0
    for n in ROWS_PER_POST:
        spans.append((off, off + n))
        off += n

    srv = InferenceServer(dirs[True], port=0, max_batch=8, max_wait_ms=200.0)
    srv.start()
    try:
        base = f"http://{srv.host}:{srv.port}"
        post(base + "/predict", {"inputs": {  # warm-up, not counted
            "ids": ids[:1].tolist(), "pos": pos[:1].tolist()}})
        out_name = srv.predictor.get_output_names()[0]
        torch.cuda.synchronize()
        replies = [None] * len(spans)
        lat = [None] * len(spans)

        def client(i):
            a, b = spans[i]
            replies[i], lat[i] = post(base + "/predict", {"inputs": {
                "ids": ids[a:b].tolist(), "pos": pos[a:b].tolist()}})

        # ---- the main path: counts from 0 just before, read just after
        runs0 = metrics.counter("batch.runs")
        attn.flash_attention.launches = 0
        zero_wide(attn)
        t_burst = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(spans))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        burst_s = time.perf_counter() - t_burst
        launches = attn.flash_attention.launches
        record_wide("serve", read_wide(attn))
        batches = metrics.counter("batch.runs") - runs0
        # ---- end of the main path
        if any(t.is_alive() for t in threads) or any(r is None
                                                     for r in replies):
            raise AssertionError("a /predict request did not complete")
        if launches != BERT["layers_n"] * batches or batches < 1:
            raise AssertionError(
                f"flash_attention launches {launches} != 12 x {batches} "
                "batches run")
        served = np.concatenate([
            np.asarray(r["outputs"][out_name]["data"], np.float32).reshape(
                r["outputs"][out_name]["shape"]) for r in replies])
        if served.shape != (rows, BERT["seq"], BERT["hidden"]) or \
                not np.isfinite(served).all():
            raise AssertionError(f"bad served output {served.shape}")
        direct_err = 0.0
        for (a, b), r in zip(spans, replies):
            (direct,) = srv.predictor.run([ids[a:b], pos[a:b]])
            np.testing.assert_allclose(served[a:b], direct, rtol=1e-5,
                                       atol=1e-5)
            direct_err = max(direct_err,
                             float(np.abs(served[a:b] - direct).max()))
        run_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            srv.predictor.run([ids, pos])
            run_ms.append((time.perf_counter() - t0) * 1e3)
        if profile:
            profile_phase(torch, srv.predictor, [ids, pos], replies[0])
        stats = srv.stats()
    finally:
        srv.stop()

    cfg = Config(dirs[False])
    off_pred = create_predictor(cfg)
    if any(op.type == "flash_attention"
           for op in off_pred._program.global_block().ops):
        raise AssertionError("flash-off program contains flash_attention")
    (score_matrix,) = off_pred.run([ids, pos])
    np.testing.assert_allclose(served, score_matrix, rtol=2e-4, atol=2e-4)
    log({"phase": "slice", "posts": len(spans), "rows": rows,
         "batches_run": batches, "flash_launches": launches,
         "request_latency_s": lat, "burst_s": burst_s,
         "predictor_run_ms": run_ms,
         "served_rows_per_s": rows / burst_s,
         "max_abs_err_vs_predictor_run": direct_err,
         "max_abs_err_vs_score_matrix":
             float(np.abs(served - score_matrix).max()),
         "pass_stats": srv.predictor._pass_stats,
         "queue_depth_after": stats.get("queue_depth"),
         "peak_gpu_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    return launches


def mha_route_phase(torch, attn, seed):
    """One port MultiHeadAttention at width 768 / 12 heads on [8, 512, 768]
    fp32 with no mask: flash forced on (the fp32 flash kernel, one launch)
    against the score-matrix route with the same weights, 1e-4.  Returns
    the flash launches of the call."""
    from paddle_tpu_torch import dygraph, nn
    from paddle_tpu_torch.core import generator
    from paddle_tpu_torch.core.place import CUDAPlace
    generator.seed(seed)
    with dygraph.guard(CUDAPlace(0)):
        mha = nn.MultiHeadAttention(768, 12).eval()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(8, 512, 768, device="cuda", generator=gen)
    try:
        with torch.inference_mode():
            attn.enable_flash_attention(True)
            before = attn.flash_attention.launches
            flash = mha(x)
            torch.cuda.synchronize()
            launches = attn.flash_attention.launches - before
            attn.enable_flash_attention(False)
            scores = mha(x)
            if attn.flash_attention.launches - before != launches:
                raise AssertionError("the score-matrix route launched flash")
    finally:
        attn._FLASH_STATE["mode"] = "auto"
    if launches != 1:
        raise AssertionError(f"MHA flash route: {launches} flash launches")
    torch.testing.assert_close(flash, scores, rtol=1e-4, atol=1e-4)
    log({"phase": "mha_flash_route", "shape": [8, 512, 768], "heads": 12,
         "dtype": "float32", "flash_launches": launches,
         "max_abs_err_vs_score_matrix":
             (flash - scores).abs().max().item(), "tol": 1e-4})
    return launches


def gen_requests(seed):
    """The /generate bodies of phase 7: prompt lengths 32-512 from the
    seed, every other one starting with one shared 256-token prefix;
    greedy, except GEN_SAMPLING sampling posts (top_k 40, temperature
    0.8, fixed seeds)."""
    rng = np.random.RandomState(seed)
    vocab = GPT2["vocab_size"]
    prefix = rng.randint(2, vocab, GEN_PREFIX)
    bodies = []
    for i in range(GEN_POSTS):
        if i % 2 == 0:
            n = int(rng.randint(GEN_PREFIX + 1, 513))
            ids = np.concatenate([prefix, rng.randint(2, vocab,
                                                      n - GEN_PREFIX)])
        else:
            ids = rng.randint(2, vocab, int(rng.randint(32, 513)))
        body = {"input_ids": [int(t) for t in ids],
                "max_length": GEN_MAX_LENGTH}
        if i in (3, 10)[:GEN_SAMPLING]:
            body.update(decode_strategy="sampling", top_k=40,
                        temperature=0.8, seed=100 + i)
        bodies.append(body)
    return bodies


def pct(values, q):
    return float(np.percentile(np.asarray(values, np.float64), q))


def decode_profile(torch, eng, seed):
    """Device busy and idle over a window of decode steps: 8 greedy
    requests (128-token prompts, 48 new tokens) into the engine; the
    window opens after 4 decode steps and closes after 20 more."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(seed + 1)
    s0 = len(eng.step_log)
    futs = [eng.submit(rng.randint(2, GPT2["vocab_size"], 128),
                       max_length=48) for _ in range(8)]

    def wait_steps(n):
        t_end = time.monotonic() + 120
        while len(eng.step_log) < s0 + n:
            if time.monotonic() > t_end:
                raise AssertionError("decode window: the engine stalled")
            time.sleep(0.001)

    wait_steps(4)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n0 = len(eng.step_log)
        wait_steps(24)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        steps = len(eng.step_log) - n0
    for f in futs:
        f.result(timeout=300)
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
    log({"phase": "generate_profile", "decode_steps": steps,
         "window_wall_ms": wall_ms, "device_busy_ms": busy_ms,
         "device_busy_ms_per_step": busy_ms / max(1, steps),
         "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms)
         if busy_ms else None,
         "top_device_ms_per_step": [[e.key[:80], e.count / max(1, steps),
                                     e.self_device_time_total / 1e3
                                     / max(1, steps)] for e in top]})


def generate_phase(torch, seed, model_dir, profile=False):
    """(7) GPT /generate at GPT-2 small widths (random weights from
    --seed, fp32, TF32 off, eval) through InferenceServer(model_dir,
    generator=..., gen_slots=8, gen_kv_pool=GEN_PLAN,
    gen_prefix_cache="auto"): 16 concurrent posts.  Gates: every greedy
    token within GEN_TOL of the top logit of one teacher-forced
    GPTModel.forward over its reply, radix hits and shared pages, the KV
    slabs on the card, the pool drained after stop.  Then the same
    requests through a fixed-slot engine (the share of equal tokens is
    printed).  Returns the kernel launches counted over the burst."""
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.core import generator
    from paddle_tpu_torch.core.place import CUDAPlace
    from paddle_tpu_torch.inference.server import InferenceServer
    from paddle_tpu_torch.models import GPTConfig, GPTForGeneration, GPTModel
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import fused_xent as fx
    from paddle_tpu_torch.serving import ContinuousBatchingEngine

    t0 = time.perf_counter()
    generator.seed(seed)
    with dygraph.guard(CUDAPlace(0)):
        model = GPTForGeneration(GPTModel(GPTConfig(**GPT2))).eval()
    n_params = sum(p.numel() for p in model.parameters())
    bodies = gen_requests(seed)
    srv = InferenceServer(model_dir, port=0, generator=model, gen_slots=8,
                          gen_kv_pool=dict(GEN_PLAN),
                          gen_prefix_cache="auto")
    eng, pool = srv.engine, srv.engine.kv_pool
    if not (pool.k.is_cuda and pool.v.is_cuda):
        raise AssertionError(f"KV slabs on {pool.k.device}, not the card")
    log({"phase": "generate_setup", "params": n_params,
         "pool_bytes": pool.pool_bytes, "kv_device": str(pool.k.device),
         "build_s": time.perf_counter() - t0})
    counters = (attn.flash_attention, attn.flash_attention_bwd_dq_cuda,
                attn.flash_attention_bwd_dkv_cuda, fx.fused_xent_cuda)
    srv.start()
    try:
        url = f"http://{srv.host}:{srv.port}/generate"
        warm, _ = post(url, {"input_ids": bodies[1]["input_ids"][:16],
                             "max_length": 4})  # not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps0, reqs0 = len(eng.step_log), len(eng.request_log)
        radix0 = eng.prefix_cache.hits, eng.prefix_cache.hit_tokens
        shared0 = pool.prefix_hits
        replies, lat = [None] * GEN_POSTS, [None] * GEN_POSTS

        def client(i):
            time.sleep(0.02 * i)  # arrival order = post order
            replies[i], lat[i] = post(url, bodies[i])

        # ---- the main path: counts from 0 just before, read just after
        for f in counters:
            f.launches = 0
        zero_wide(attn)
        t_burst = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(GEN_POSTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        burst_s = time.perf_counter() - t_burst
        launches = {"flash_attn_fwd": attn.flash_attention.launches,
                    "fused_xent_fwd": fx.fused_xent_cuda.launches}
        record_wide("generate", read_wide(attn))
        # ---- end of the main path
        if any(t.is_alive() for t in threads) or None in replies:
            raise AssertionError("a /generate request did not complete")
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        steps = list(eng.step_log)[steps0:]
        reqs = list(eng.request_log)[reqs0:]
        radix = (eng.prefix_cache.hits - radix0[0],
                 eng.prefix_cache.hit_tokens - radix0[1])
        shared = pool.prefix_hits - shared0
        outs = []
        for body, r in zip(bodies, replies):
            (out,) = r["output_ids"]
            out = np.asarray(out, np.int64)
            p = len(body["input_ids"])
            if not (p < out.size <= p + GEN_MAX_LENGTH) or \
                    list(out[:p]) != body["input_ids"] or \
                    out.min() < 0 or out.max() >= GPT2["vocab_size"]:
                raise AssertionError(f"bad /generate reply {out.size} "
                                     f"tokens for a {p}-token prompt")
            outs.append(out)
        # every greedy token is the top logit (within GEN_TOL) of one
        # teacher-forced forward over the reply, on the card
        worst = 0.0
        with torch.inference_mode():
            for body, out in zip(bodies, outs):
                if body.get("decode_strategy") == "sampling":
                    continue
                p = len(body["input_ids"])
                logits = model.gpt(torch.as_tensor(out[None],
                                                   device="cuda"))[0]
                rows = logits[p - 1:out.size - 1]
                picked = rows.gather(1, torch.as_tensor(
                    out[p:, None], device="cuda"))[:, 0]
                worst = max(worst, float((rows.max(1).values - picked)
                                         .max()))
        if worst > GEN_TOL:
            raise AssertionError(f"a greedy token is {worst} below the "
                                 f"teacher-forced top logit")
        if radix[0] < 1 or shared < 1:
            raise AssertionError(f"radix hits {radix[0]}, shared pages "
                                 f"{shared}: the prefix paths did not run")
        if profile:
            decode_profile(torch, eng, seed)
        stats = srv.stats()
    finally:
        srv.stop()
    pool.assert_drained()
    # the same requests through the fixed-slot engine
    fixed = ContinuousBatchingEngine(model, max_slots=8).start()
    try:
        futs = []
        for body in bodies:
            kw = {k: v for k, v in body.items() if k != "input_ids"}
            futs.append(fixed.submit(body["input_ids"], **kw))
        fixed_outs = [f.result(timeout=600) for f in futs]
    finally:
        fixed.stop()
    same = total = 0  # generated positions equal in both, of the longer
    for body, a, b in zip(bodies, outs, fixed_outs):
        p, n = len(body["input_ids"]), min(a.size, b.size)
        total += max(a.size, b.size) - p
        same += int(np.sum(a[p:n] == b[p:n]))
    new_tokens = sum(int(o.size) - len(b["input_ids"])
                     for b, o in zip(bodies, outs))
    log({"phase": "generate", "posts": GEN_POSTS,
         "sampling_posts": GEN_SAMPLING,
         "prompt_tokens": [len(b["input_ids"]) for b in bodies],
         "new_tokens": new_tokens, "burst_s": burst_s,
         "generated_tokens_per_s": new_tokens / burst_s,
         "ttft_ms_p50": pct([r["ttft_s"] for r in reqs], 50) * 1e3,
         "ttft_ms_p90": pct([r["ttft_s"] for r in reqs], 90) * 1e3,
         "latency_ms_p50": pct(lat, 50) * 1e3,
         "latency_ms_p90": pct(lat, 90) * 1e3,
         "decode_steps": len(steps),
         "decode_step_ms_p50": pct([s["ms"] for s in steps], 50),
         "slot_occupancy": float(np.mean([s["rows"] for s in steps]))
         / GEN_PLAN["max_slots"],
         "h2d_bytes_per_decode_step":
             float(np.mean([s["h2d_bytes"] for s in steps])),
         "d2h_bytes_per_decode_step":
             float(np.mean([s["d2h_bytes"] for s in steps])),
         "peak_gpu_mem_gb": peak_gb, "pool_bytes": pool.pool_bytes,
         "radix_hits": radix[0], "radix_hit_tokens": radix[1],
         "shared_prompt_pages": shared, "kv_buckets": eng.kv_buckets,
         "greedy_max_gap_to_teacher_forced_top_logit": worst,
         "tol": GEN_TOL, "kernel_launches_in_burst": launches,
         "wide_head_dim_launches_in_burst": WIDE_LAUNCHES["generate"],
         "tokens_equal_to_fixed_slot_share": same / max(1, total),
         "kv_device": str(pool.k.device),
         "pool_after": stats["kv_pool"], "warmup_ok": bool(warm)})
    return {"launches": launches, "model": model, "bodies": bodies,
            "outs": outs, "tokens_per_s": new_tokens / burst_s}


def train_feed(seed):
    rng = np.random.RandomState(seed)
    b, seq, vocab = TRAIN_BATCH, BERT["seq"], BERT["vocab"]
    return {"ids": rng.randint(0, vocab, (b, seq)).astype(np.int64),
            "pos": np.tile(np.arange(seq, dtype=np.int64), (b, 1)),
            "labels": rng.randint(0, vocab, (b, seq, 1)).astype(np.int64)}


def build_pretrain(flash, use_amp):
    """build_bert_pretrain with the flash_attention op (flash=True) or the
    score-matrix graph, from a fresh unique-name state.  The fused
    cross-entropy is chosen when the program runs (FLAGS_fused_xent)."""
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.models import build_bert_pretrain
    from paddle_tpu_torch.ops import attention as attn
    attn.enable_flash_attention(flash)
    try:
        _reset_unique_names()
        return build_bert_pretrain(use_amp=use_amp, batch=TRAIN_BATCH,
                                   **BERT)
    finally:
        attn._FLASH_STATE["mode"] = "auto"


def checked_params(main):
    """(word embedding, first attention projection, vocab fc) weights."""
    h, v = BERT["hidden"], BERT["vocab"]
    params = main.all_parameters()
    pick = [next(p for p in params if p.shape == shape)
            for shape in ((v, h), (h, h), (h, v))]
    return [p.name for p in pick]


def train_correctness(torch, static, fx, seed, feed):
    """(a): one fp32 step of the kernel program against the flash-off,
    fused-off program on the same weights."""
    main, startup, loss = build_pretrain(True, use_amp=False)
    main_off, _, loss_off = build_pretrain(False, use_amp=False)
    types = [op.type for op in main.global_block().ops]
    types_off = [op.type for op in main_off.global_block().ops]
    if types.count("flash_attention_grad") != BERT["layers_n"] or \
            "flash_attention" in types_off or "softmax" not in types_off:
        raise AssertionError("kernel / score-matrix programs are not as "
                             "built")
    startup.random_seed = seed
    exe = static.Executor()
    names = checked_params(main)
    fetched = {}
    scope = static.Scope()
    with static.scope_guard(scope):
        exe.run(startup)
    init = {n: t.clone() for n, t in scope.vars.items() if t is not None}
    for tag, prog, lv in (("kernels", main, loss), ("plain", main_off,
                                                    loss_off)):
        run_scope = static.Scope()
        for n, t in init.items():
            run_scope.set(n, t.clone())
        grads = [prog._grad_map[n] for n in names]
        fx.enable_fused_xent(tag == "kernels")
        fx.fused_xent_cuda.launches = 0
        try:
            with static.scope_guard(run_scope):
                fetched[tag] = exe.run(prog, feed=feed,
                                       fetch_list=[lv] + grads)
        finally:
            fx.enable_fused_xent(False)
        if (fx.fused_xent_cuda.launches > 0) != (tag == "kernels"):
            raise AssertionError(f"{tag} program: fused cross-entropy "
                                 f"launched {fx.fused_xent_cuda.launches} "
                                 "times")
        del run_scope
    del init, scope
    got, ref = fetched["kernels"], fetched["plain"]
    loss_k, loss_p = float(got[0].reshape(-1)[0]), float(ref[0].reshape(-1)[0])
    if not np.isfinite(loss_k) or abs(loss_k - loss_p) > 1e-4 * abs(loss_p):
        raise AssertionError(f"fp32 loss {loss_k} != plain {loss_p}")
    grad_err = {}
    for n, g, r in zip(names, got[1:], ref[1:]):
        if g.shape != r.shape or not np.isfinite(g).all():
            raise AssertionError(f"grad of {n}: bad {g.shape}")
        scale = float(np.abs(r).max())
        if not scale > 0:
            raise AssertionError(f"grad of {n} is zero in the plain program")
        grad_err[n] = float(np.abs(g - r).max()) / scale
        if not grad_err[n] <= 1e-3:
            raise AssertionError(f"grad of {n}: normalised max error "
                                 f"{grad_err[n]} > 1e-3")
    log({"phase": "train_fp32_check", "loss_kernels": loss_k,
         "loss_plain": loss_p, "grad_normalised_max_err": grad_err})


def train_phase(torch, seed, profile=False):
    """(a) the fp32 check step; (b) the bench configuration (AMP bf16) and
    (c) the fp32 training configuration (bench.py with BENCH_NO_AMP=1),
    the main paths of this slice.  Returns the per-kernel launch counts of
    (b) and of (c)."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops import fused_xent as fx

    feed = train_feed(seed)
    train_correctness(torch, static, fx, seed, feed)
    amp = train_config(torch, static, fx, seed, feed, True, TRAIN_STEPS,
                       profile)
    fp32 = train_config(torch, static, fx, seed, feed, False,
                        FP32_TRAIN_STEPS, profile)
    return amp, fp32


def train_config(torch, static, fx, seed, feed, use_amp, steps, profile):
    """One training configuration: `steps` Executor.run steps after a
    warm-up, every loss finite and the last below the first, exact launch
    counts per step; step_ms, tokens/s, MFU (6 x params x tokens/s over
    the peak of the dtype the GEMMs run in, as bench.py reckons it) and
    peak memory.  Returns the launch counts over the timed steps."""
    from paddle_tpu_torch.ops import attention as attn

    main, startup, loss = build_pretrain(True, use_amp=use_amp)
    startup.random_seed = seed
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    exe = static.Executor()
    counters = (attn.flash_attention, attn.flash_attention_bwd_dq_cuda,
                attn.flash_attention_bwd_dkv_cuda, fx.fused_xent_cuda)
    losses, step_ms = [], []
    fx.enable_fused_xent(True)
    try:
        with static.scope_guard(static.Scope()):
            exe.run(startup)
            exe.run(main, feed=feed, fetch_list=[loss])  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # ---- the main path: counts from 0 just before, read just after
            for c in counters:
                c.launches = 0
            zero_wide(attn)
            attn.flash_attention.view_copies = 0
            for _ in range(steps):
                t0 = time.perf_counter()
                (lv,) = exe.run(main, feed=feed, fetch_list=[loss])
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(np.asarray(lv).reshape(-1)[0]))
            launches = dict(zip(("flash_attn_fwd", "flash_attn_bwd_dq",
                                 "flash_attn_bwd_dkv", "fused_xent_fwd"),
                                (c.launches for c in counters)))
            view_copies = attn.flash_attention.view_copies
            record_wide("train_amp" if use_amp else "train_fp32",
                        read_wide(attn))
            # ---- end of the main path
            peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
            if profile:
                train_profile(torch, exe, main, feed, loss,
                              "amp" if use_amp else "fp32")
    finally:
        fx.enable_fused_xent(False)
    tag = "AMP bf16" if use_amp else "fp32"
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{tag} losses not finite and falling: "
                             f"{losses}")
    if view_copies:  # the head-split views are ones TMA takes as they are
        raise AssertionError(f"{tag}: {view_copies} view copies before "
                             "the flash kernels")
    n = BERT["layers_n"]
    want = {"flash_attn_fwd": 2 * n, "flash_attn_bwd_dq": n,
            "flash_attn_bwd_dkv": n, "fused_xent_fwd": 2}
    for name, per_step in want.items():
        if launches[name] != per_step * steps:
            raise AssertionError(
                f"{tag} {name}: {launches[name]} launches in {steps} "
                f"steps, expected {per_step} per step")
    steady = sorted(step_ms)[len(step_ms) // 2]
    tokens_s = TRAIN_BATCH * BERT["seq"] / (steady / 1e3)
    peak = "bfloat16" if use_amp else "float32"
    log({"phase": "train" if use_amp else "train_fp32",
         "config": f"bert-base pretrain, {tag}, flash + fused CE",
         "batch": TRAIN_BATCH, "seq": BERT["seq"], "params": n_params,
         "losses": losses, "step_ms": step_ms, "median_step_ms": steady,
         "tokens_per_s": tokens_s,
         "mfu": 6.0 * n_params * tokens_s / PEAK_FLOPS[peak],
         "mfu_peak_flops": PEAK_FLOPS[peak], "mfu_peak_dtype": peak,
         "launches": launches,
         "launches_per_step": {k: v // steps for k, v in launches.items()},
         "flash_view_copies": view_copies,
         "peak_gpu_mem_gb": peak_gb})
    return launches


def train_profile(torch, exe, main, feed, loss, config):
    """Where a training step's time goes: device time by kernel and the
    device's idle share over one step (torch.profiler), then the host
    time of each op role and the costliest op types over another step
    (host clock around each op's dispatch, no synchronisation: the device
    runs behind).  `config` ("amp", "fp32") tags the line."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.static import executor as executor_mod
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        exe.run(main, feed=feed, fetch_list=[loss])
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:15]

    roles = {0: "forward", 256: "forward", 257: "forward", 1: "backward",
             2: "optimize"}
    host_ms, by_type = {}, {}
    run_op = executor_mod._run_op

    def timed(op, env, ctx):
        t = time.perf_counter()
        run_op(op, env, ctx)
        dt = (time.perf_counter() - t) * 1e3
        role = roles.get(op.attrs.get("op_role", 0), "other")
        host_ms[role] = host_ms.get(role, 0.0) + dt
        n, ms = by_type.get(op.type, (0, 0.0))
        by_type[op.type] = (n + 1, ms + dt)

    executor_mod._run_op = timed
    try:
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[loss])
        step_host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        executor_mod._run_op = run_op
    # the three attention kernels (forward, dQ, dK/dV) by kernel name
    attn = {name: sum(e.self_device_time_total for e in dev
                      if name in e.key) / 1e3
            for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    attn_ms = sum(attn.values())
    log({"phase": "train_profile", "config": config,
         "step_wall_ms_under_profiler": wall_ms,
         "device_busy_ms": busy_ms,
         "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
         "attention_device_ms": attn_ms,
         "attention_share_of_busy": attn_ms / busy_ms,
         "attention_device_ms_by_kernel": attn,
         "top_device_ms": [[e.key[:80], e.count,
                            e.self_device_time_total / 1e3] for e in top],
         "step_ms_op_timed": step_host_ms, "host_ms_by_role": host_ms,
         "top_host_ms_by_op_type": sorted(
             ([t, n, ms] for t, (n, ms) in by_type.items()),
             key=lambda r: -r[2])[:12]})

# launches of the kernels for head dims above 128 on each main path, by
# "route/kernel" (routes wgmma256, wgmma_split_d, tf32_split_d of
# ops.attention), from the wrappers' launch counts of those routes: set
# to 0 just before the path and read just after; the graph-replayed steps
# add the profiler's count
WIDE_ROUTES = ("wgmma256", "wgmma_split_d", "tf32_split_d")
WIDE_LAUNCHES = {}
# "route/kernel" -> the substring of its device name, for the profiler
# (every route/kernel pair has a kernel of its own)
WIDE_DEVICE_NAMES = {"wgmma256/fwd": "flash_fwd_wgmma_kernel<256",
                     "wgmma256/bwd_dq": "flash_bwd_dq_wgmma_kernel<256",
                     "wgmma256/bwd_dkv": "flash_bwd_dkv_wgmma_kernel<256",
                     "wgmma_split_d/fwd": "flash_fwd_split_d_wgmma_kernel",
                     "wgmma_split_d/bwd_dq":
                         "flash_bwd_dq_split_d_wgmma_kernel",
                     "wgmma_split_d/bwd_dkv":
                         "flash_bwd_dkv_split_d_wgmma_kernel",
                     "tf32_split_d/fwd": "flash_fwd_split_d_tf32_kernel",
                     "tf32_split_d/bwd_dq": "flash_bwd_dq_split_d_tf32_kernel",
                     "tf32_split_d/bwd_dkv":
                         "flash_bwd_dkv_split_d_tf32_kernel"}


def wide_wrappers(attn):
    return {"fwd": attn.flash_attention,
            "bwd_dq": attn.flash_attention_bwd_dq_cuda,
            "bwd_dkv": attn.flash_attention_bwd_dkv_cuda}


def zero_wide(attn):
    for f in wide_wrappers(attn).values():
        for route in WIDE_ROUTES:
            setattr(f, attn.LAUNCH_COUNTS[route], 0)


def read_wide(attn):
    """{"route/kernel": launches since zero_wide}."""
    return {f"{route}/{kind}": getattr(f, attn.LAUNCH_COUNTS[route])
            for kind, f in wide_wrappers(attn).items()
            for route in WIDE_ROUTES}


def record_wide(path, got):
    """Record the head-dim-above-128 launches `got` of `path` and fail if
    there is any: every configuration here has head dim 64, so such a
    launch on a main path is a misrouted call."""
    WIDE_LAUNCHES[path] = got
    if any(got.values()):
        raise AssertionError(f"{path}: launches of the kernels for head "
                             f"dims above 128 {got} on a head-dim-64 "
                             "configuration")


def count_kernels(prof, names):
    """{name: launches} of the device kernels whose name contains each
    substring, from a torch.profiler run (kernels replayed by a CUDA
    graph are recorded one by one)."""
    from torch.autograd import DeviceType
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    return {name: sum(e.count for e in dev if sub in e.key)
            for name, sub in names.items()}, dev


GRAPH_STEP_MS = {}  # config -> median replayed step ms (phase 6)


def train_graph_phase(torch, seed):
    """(6) The training step through Executor.run_steps, one CUDA graph
    captured per configuration and replayed per step: AMP bf16 (K = 6)
    and fp32 (K = 4).  Returns {config: per-step kernel launches counted
    by the profiler over one run_steps call}."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops import fused_xent as fx

    feed = train_feed(seed)
    return {tag: train_graph_config(torch, static, fx, seed, feed, use_amp,
                                    k)
            for tag, use_amp, k in (("amp", True, TRAIN_STEPS),
                                    ("fp32", False, FP32_TRAIN_STEPS))}


def train_graph_config(torch, static, fx, seed, feed, use_amp, k):
    """run_steps with K steps per call on the fixed batch, from the
    startup weights of --seed (those of the eager phase):
      * call 1 warms up, captures and replays K steps; calls 2 to
        1 + GRAPH_TIMED_CALLS are timed (host clock around run_steps plus
        synchronize, per step = wall / K); GRAPH_PROFILED_CALLS more calls
        run under torch.profiler for the device busy time, the idle share
        and the kernels replayed per step (24 flash forward, 12 dQ, 12
        dK/dV, 2 fused cross-entropy, as in the eager step; each kernel's
        largest count over the profiled calls, since the profiler can
        lose records);
      * the 2K losses of calls 1 and 2 against 2K eager Executor.run
        steps from the same weights: equal to the last bit (the same
        kernels on the same inputs), else within rtol 1e-5 (fp32) or
        2e-3 (AMP bf16), with the largest difference reported;
      * every loss finite, the last below the first; one capture, then
        hits (cache_stats); peak memory with the graph's pool."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.ops import attention as attn

    main, startup, loss = build_pretrain(True, use_amp=use_amp)
    startup.random_seed = seed
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    exe = static.Executor()
    init_scope = static.Scope()
    with static.scope_guard(init_scope):
        exe.run(startup)
    init = {n: t.clone() for n, t in init_scope.vars.items()
            if t is not None}
    del init_scope
    stacked = {n: np.stack([v] * k) for n, v in feed.items()}
    counters = (attn.flash_attention, attn.flash_attention_bwd_dq_cuda,
                attn.flash_attention_bwd_dkv_cuda, fx.fused_xent_cuda)
    names = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv",
             "fused_xent_fwd")
    n = BERT["layers_n"]
    want = dict(zip(names, (2 * n, n, n, 2)))
    losses, step_ms = [], []
    fx.enable_fused_xent(True)
    try:
        scope = static.Scope()
        for name, t in init.items():
            scope.set(name, t.clone())
        graph_exe = static.Executor()
        with static.scope_guard(scope):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # ---- this path: counts from 0 just before, read just after
            # (the Python counters move when the step is captured, not on
            # a replay: the profiler below counts the replays)
            for c in counters:
                c.launches = 0
            zero_wide(attn)
            attn.flash_attention.view_copies = 0
            t0 = time.perf_counter()
            (lv,) = graph_exe.run_steps(main, feed=stacked,
                                        fetch_list=[loss])
            torch.cuda.synchronize()
            capture_call_s = time.perf_counter() - t0
            losses.extend(np.asarray(lv).reshape(-1).tolist())
            for _ in range(GRAPH_TIMED_CALLS):
                t0 = time.perf_counter()
                (lv,) = graph_exe.run_steps(main, feed=stacked,
                                            fetch_list=[loss])
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3 / k)
                losses.extend(np.asarray(lv).reshape(-1).tolist())
            capture_launches = dict(zip(names,
                                        (c.launches for c in counters)))
            view_copies = attn.flash_attention.view_copies
            capture_wide = read_wide(attn)
            # ---- end of this path
            peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
            profiled = []  # (profile, wall ms) of each profiled call
            for _ in range(GRAPH_PROFILED_CALLS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    graph_exe.run_steps(main, feed=stacked,
                                        fetch_list=[loss])
                    torch.cuda.synchronize()
                profiled.append((prof, (time.perf_counter() - t0) * 1e3))
        stats = graph_exe.cache_stats()
        graph_exe.close()
        del scope
        # the eager reference: 2K run() steps from the same weights
        eager_scope = static.Scope()
        for name, t in init.items():
            eager_scope.set(name, t)
        with static.scope_guard(eager_scope):
            eager = [float(np.asarray(exe.run(main, feed=feed,
                                              fetch_list=[loss])[0])
                           .reshape(-1)[0]) for _ in range(2 * k)]
        del eager_scope, init
    finally:
        fx.enable_fused_xent(False)
    tag = "AMP bf16" if use_amp else "fp32"
    graph = np.asarray(losses[:2 * k], np.float32)
    eager = np.asarray(eager, np.float32)
    bitwise = bool(np.array_equal(graph, eager))
    max_rel = float(np.max(np.abs(graph - eager) / np.abs(eager)))
    if not bitwise:
        np.testing.assert_allclose(graph, eager,
                                   rtol=2e-3 if use_amp else 1e-5, atol=0)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"graph {tag} losses not finite and falling: "
                             f"{losses}")
    if view_copies:
        raise AssertionError(f"graph {tag}: {view_copies} view copies")
    calls = 1 + GRAPH_TIMED_CALLS + GRAPH_PROFILED_CALLS
    if stats != {"hits": calls - 1, "misses": 1, "traces": 1}:
        raise AssertionError(f"graph {tag}: cache_stats {stats}, expected "
                             f"1 capture and {calls - 1} hits")
    # The profiler can lose device records: calls that replay one captured
    # graph record kernel counts that differ from call to call on the card
    # (kernels_recorded_per_profiled_call), and once a flash forward went
    # missing.  A lost record can only lower a count, so each kernel's
    # count is the largest any profiled call saw (still gated exactly
    # below); busy time, idle share and the top kernels come from the call
    # that recorded the most.
    subs = dict(zip(names, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                            "fused_xent")))
    per_call = [(count_kernels(p, subs),
                 count_kernels(p, WIDE_DEVICE_NAMES)[0], ms)
                for p, ms in profiled]
    recorded = [sum(e.count for e in dev) for (_, dev), _, _ in per_call]
    replayed = {n: max(c[0][0][n] for c in per_call) for n in names}
    (_, dev), _, prof_wall_ms = per_call[recorded.index(max(recorded))]
    # the capturing call's Python counts and the profiled calls' replays
    replayed_wide = {key: max(c[1][key] for c in per_call)
                     for key in WIDE_DEVICE_NAMES}
    record_wide("train_graph_amp" if use_amp else "train_graph_fp32",
                {key: n + replayed_wide.get(key, 0)
                 for key, n in capture_wide.items()})
    per_step = {name: c / k for name, c in replayed.items()}
    for name, per in want.items():
        # the capturing call ran the step twice outside the replays (the
        # warm-up and the capture); a profiled call replays K steps
        if per_step[name] != per or capture_launches[name] != 2 * per:
            raise AssertionError(
                f"graph {tag} {name}: {per_step[name]} launches per "
                f"replayed step, {capture_launches[name]} in the capturing "
                f"call; expected {per} and {2 * per}")
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    steady = sorted(step_ms)[len(step_ms) // 2]
    GRAPH_STEP_MS["amp" if use_amp else "fp32"] = steady
    tokens_s = TRAIN_BATCH * BERT["seq"] / (steady / 1e3)
    peak = "bfloat16" if use_amp else "float32"
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    log({"phase": "train_graph" if use_amp else "train_graph_fp32",
         "config": f"bert-base pretrain, {tag}, flash + fused CE, "
                   f"run_steps K={k} (CUDA graph replay)",
         "batch": TRAIN_BATCH, "seq": BERT["seq"], "params": n_params,
         "steps_per_call": k, "capture_call_s": capture_call_s,
         "step_ms": step_ms, "median_step_ms": steady,
         "tokens_per_s": tokens_s,
         "mfu": 6.0 * n_params * tokens_s / PEAK_FLOPS[peak],
         "mfu_peak_dtype": peak,
         "device_busy_ms_per_step": busy_ms / k,
         "device_idle_share": max(0.0, 1.0 - busy_ms / prof_wall_ms),
         "profiled_call_wall_ms": prof_wall_ms,
         "kernels_recorded_per_profiled_call": recorded,
         "device_idle_share_of_timed_step":
             max(0.0, 1.0 - busy_ms / k / steady),
         "launches_per_replayed_step": per_step,
         "launches_in_capturing_call": capture_launches,
         "flash_view_copies": view_copies,
         "cache_stats": stats, "peak_gpu_mem_gb": peak_gb,
         "losses": losses, "eager_losses": eager.tolist(),
         "losses_bitwise_equal_to_eager": bitwise,
         "losses_max_rel_diff_vs_eager": max_rel,
         "top_device_ms_per_step": [[e.key[:80], e.count / k,
                                     e.self_device_time_total / 1e3 / k]
                                    for e in top]})
    return per_step


# phase 8: google-research/bert's pretraining recipe at BERT-base width
RECIPE_STEPS = 4        # eager steps, then run_steps calls of K micro-steps
RECIPE_K = 4
RECIPE_MERGE = 2        # gradient merge: one commit every 2 micro-steps
RECIPE_WARMUP = 2       # lr warmup steps, then polynomial decay
RECIPE_DECAY = 1000
RECIPE_VARIANTS = (("attn_dropout", 0.1), ("flash", 0.0))


def build_recipe(attn_dropout, vocab=30522, seq=512, hidden=768,
                 layers_n=12, heads=12, hidden_dropout=0.1, use_amp=True,
                 k_steps=RECIPE_MERGE, warmup_steps=RECIPE_WARMUP,
                 decay_steps=RECIPE_DECAY):
    """The recipe of tests/test_torch_recipe.py (its build_recipe, for the
    port only): bench.build_bert_base's encoder with dropout 0.1 after the
    embedding layer_norm, on the attention weights (nets), on the
    attention output projection and on the FFN output; AdamW(weight_decay
    0.01, biases and layer_norm excluded), GradientClipByGlobalNorm(1.0),
    LinearWarmup(PolynomialDecay(1e-4, ...)); bf16 AMP; gradient merge k.
    Returns (main, startup, loss, lr scheduler, dropout Mask names)."""
    from paddle_tpu_torch import amp, static
    from paddle_tpu_torch.optimizer import lr_scheduler as lr
    from paddle_tpu_torch.static import layers, nets

    def no_decay(name):
        return not (name.endswith(".b_0") or name.startswith("layer_norm"))

    def drop(x):
        return layers.dropout(x, hidden_dropout,
                              dropout_implementation="upscale_in_train")

    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        ids = layers.data("ids", [-1, seq], dtype="int64")
        pos = layers.data("pos", [-1, seq], dtype="int64")
        labels = layers.data("labels", [-1, seq, 1], dtype="int64")
        h = layers.elementwise_add(layers.embedding(ids, size=[vocab, hidden]),
                                   layers.embedding(pos, size=[seq, hidden]))
        h = drop(layers.layer_norm(h, begin_norm_axis=2))
        for _ in range(layers_n):
            q = layers.fc(h, hidden, num_flatten_dims=2)
            k = layers.fc(h, hidden, num_flatten_dims=2)
            v = layers.fc(h, hidden, num_flatten_dims=2)
            ctx = nets.scaled_dot_product_attention(
                q, k, v, num_heads=heads, dropout_rate=attn_dropout)
            attn_out = drop(layers.fc(ctx, hidden, num_flatten_dims=2))
            h = layers.layer_norm(layers.elementwise_add(h, attn_out),
                                  begin_norm_axis=2)
            ffn = layers.fc(h, hidden * 4, num_flatten_dims=2, act="gelu")
            ffn = drop(layers.fc(ffn, hidden, num_flatten_dims=2))
            h = layers.layer_norm(layers.elementwise_add(h, ffn),
                                  begin_norm_axis=2)
        logits = layers.fc(h, vocab, num_flatten_dims=2)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, labels))
        sched = lr.LinearWarmup(
            lr.PolynomialDecay(1e-4, decay_steps, end_lr=0.0, power=1.0),
            warmup_steps, 0.0, 1e-4)
        opt = static.optimizer.AdamW(
            learning_rate=sched, weight_decay=0.01,
            apply_decay_param_fun=no_decay,
            grad_clip=static.optimizer.GradientClipByGlobalNorm(1.0))
        if use_amp:
            opt = amp.decorate(opt, init_loss_scaling=1.0,
                               use_dynamic_loss_scaling=False,
                               dest_dtype="bfloat16")
        _, params_grads = opt.minimize(loss)
        static.gradient_merge(main, k_steps, startup,
                              params_grads=params_grads)
    masks = [op.outputs["Mask"][0] for op in main.global_block().ops
             if op.type == "dropout"]
    return main, startup, loss, sched, masks


def recipe_phase(torch, seed):
    """(8) The recipe at BERT-base width (vocab 30522, seq 512, hidden 768,
    12 layers, 12 heads), batch 8, AMP bf16, fused CE on, in two variants:
    attention dropout 0.1 (the score-matrix route) and 0 (hidden dropout
    only, the flash kernels).  Returns {variant: result}."""
    feed = train_feed(seed)
    return {variant: recipe_config(torch, seed, feed, variant, rate)
            for variant, rate in RECIPE_VARIANTS}


def recipe_config(torch, seed, feed, variant, attn_dropout):
    """One variant: RECIPE_STEPS eager Executor.run steps from the startup
    weights of --seed, the scheduler stepped after each, then
    Executor.run_steps calls of K = RECIPE_K (the first captures); gates:
      * launches per eager step: dropout 1 + 3 x 12 = 37 with attention
        dropout, 1 + 2 x 12 = 25 without; fused CE 2; flash forward / dQ /
        dK/dV 0 / 0 / 0 with attention dropout, 24 / 12 / 12 without; the
        capturing call twice each (warm-up and capture); per replayed step
        the same counts from the profiler (each kernel's largest count over
        two profiled calls); wide launches 0;
      * gradient merge k = 2: every parameter unchanged after the first
        micro-step of each window, every accumulator zero after its commit;
      * the first run_steps call's losses equal to the last bit to K eager
        run() steps from the same state and seeds (the lr held, as it is
        over a call); the embedding dropout's mask differs between
        consecutive replayed steps;
      * every loss finite, the last (of eager and replayed) below the
        first."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import fused_xent as fx

    attn.enable_flash_attention(True)  # taken where attention has no dropout
    try:
        _reset_unique_names()
        main, startup, loss, sched, masks = build_recipe(attn_dropout,
                                                         **BERT)
    finally:
        attn._FLASH_STATE["mode"] = "auto"
    startup.random_seed = seed
    n = BERT["layers_n"]
    names = ("dropout", "flash_attn_fwd", "flash_attn_bwd_dq",
             "flash_attn_bwd_dkv", "fused_xent_fwd")
    counters = dict(zip(names, (dr.dropout_cuda, attn.flash_attention,
                                attn.flash_attention_bwd_dq_cuda,
                                attn.flash_attention_bwd_dkv_cuda,
                                fx.fused_xent_cuda)))
    flash = 0 if attn_dropout else 1
    want = dict(zip(names, (1 + (3 if attn_dropout else 2) * n,
                            2 * n * flash, n * flash, n * flash, 2)))
    if len(masks) != want["dropout"]:
        raise AssertionError(f"recipe {variant}: {len(masks)} dropout ops")
    params = [p.name for p in main.all_parameters()]
    accs = main._gm_meta["accs"]
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    exe, scope = static.Executor(), static.Scope()
    losses, step_ms, lrs = [], [], []

    def zero_counts():
        for c in counters.values():
            c.launches = 0
        zero_wide(attn)

    fx.enable_fused_xent(True)
    try:
        with static.scope_guard(scope):
            exe.run(startup)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # ---- the main path (eager): counts from 0 just before
            zero_counts()
            for step in range(RECIPE_STEPS):
                first = step % RECIPE_MERGE == 0
                before = {p: scope.vars[p].clone() for p in params} \
                    if first else None
                lrs.append(float(scope.vars[sched._var.name].reshape(-1)[0]))
                t0 = time.perf_counter()
                (lv,) = exe.run(main, feed=feed, fetch_list=[loss])
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                sched.step()
                losses.append(float(np.asarray(lv).reshape(-1)[0]))
                if first:
                    moved = [p for p in params
                             if not torch.equal(scope.vars[p], before[p])]
                    if moved:
                        raise AssertionError(
                            f"recipe {variant}: step {step} (first of its "
                            f"window) moved {len(moved)} parameters")
                    del before
                elif any(bool(scope.vars[a].any()) for a in accs):
                    raise AssertionError(f"recipe {variant}: accumulators "
                                         f"not zero after commit {step}")
            launches = {k: c.launches for k, c in counters.items()}
            record_wide(f"recipe_{variant}", read_wide(attn))
            # ---- end of the main path
            eager_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
            state = {k: t.clone() for k, t in scope.vars.items()
                     if t is not None}
        step0 = exe._step
        del scope
        for name, per in want.items():
            if launches[name] != per * RECIPE_STEPS:
                raise AssertionError(
                    f"recipe {variant} {name}: {launches[name]} launches in "
                    f"{RECIPE_STEPS} steps, expected {per} per step")

        stacked = {k: np.stack([v] * RECIPE_K) for k, v in feed.items()}
        graph_exe, gscope = static.Executor(), static.Scope()
        graph_exe._step = step0  # the seeds continue the eager walk
        for k, t in state.items():
            gscope.set(k, t.clone())
        with static.scope_guard(gscope):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # ---- the replayed path: counts from 0 just before (they move
            # in the capturing call; the profiler counts the replays)
            zero_counts()
            t0 = time.perf_counter()
            fetch = [loss, masks[0]]  # one fetch list: one captured graph
            graph_loss, graph_mask = graph_exe.run_steps(
                main, feed=stacked, fetch_list=fetch)
            torch.cuda.synchronize()
            capture_call_s = time.perf_counter() - t0
            capture_launches = {k: c.launches for k, c in counters.items()}
            capture_wide = read_wide(attn)
            # ---- end of the replayed path's capture
            graph_step_ms, timed_loss = [], np.zeros(0, np.float32)
            for _ in range(GRAPH_TIMED_CALLS):
                t0 = time.perf_counter()
                (lv, _) = graph_exe.run_steps(main, feed=stacked,
                                              fetch_list=fetch)
                torch.cuda.synchronize()
                graph_step_ms.append((time.perf_counter() - t0) * 1e3 /
                                     RECIPE_K)
                timed_loss = np.concatenate([timed_loss, lv])
            # the graph alone: K replays of the captured step, nothing of
            # run_steps around them (no feed, seed or fetch copies)
            (entry,) = graph_exe._graphs.values()
            t0 = time.perf_counter()
            for _ in range(RECIPE_K):
                entry.graph.replay()
            torch.cuda.synchronize()
            replay_only_ms = (time.perf_counter() - t0) * 1e3 / RECIPE_K
            graph_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
            profiled = []  # (profile, wall ms) of each profiled call
            for _ in range(GRAPH_PROFILED_CALLS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    (lv, _) = graph_exe.run_steps(main, feed=stacked,
                                                  fetch_list=fetch)
                    torch.cuda.synchronize()
                profiled.append((prof, (time.perf_counter() - t0) * 1e3))
                timed_loss = np.concatenate([timed_loss, lv])
        cache = graph_exe.cache_stats()
        graph_exe.close()
        del gscope
        # the eager reference of the first call: K run() steps from the
        # same state and step count, the lr held
        ref_exe, rscope = static.Executor(), static.Scope()
        ref_exe._step = step0
        for k, t in state.items():
            rscope.set(k, t)
        with static.scope_guard(rscope):
            eager_ref = [float(np.asarray(ref_exe.run(
                main, feed=feed, fetch_list=[loss])[0]).reshape(-1)[0])
                for _ in range(RECIPE_K)]
        del rscope, state
    finally:
        fx.enable_fused_xent(False)
        torch.cuda.empty_cache()
    calls = 1 + GRAPH_TIMED_CALLS + GRAPH_PROFILED_CALLS
    if cache != {"hits": calls - 1, "misses": 1, "traces": 1}:
        raise AssertionError(f"recipe {variant}: cache_stats {cache}, "
                             f"expected 1 capture and {calls - 1} hits")
    graph = np.asarray(graph_loss, np.float32).reshape(-1)
    if not np.array_equal(graph, np.asarray(eager_ref, np.float32)):
        raise AssertionError(f"recipe {variant}: replayed losses {graph} != "
                             f"eager {eager_ref}")
    same = [bool(np.array_equal(graph_mask[i], graph_mask[i + 1]))
            for i in range(RECIPE_K - 1)]
    if any(same):
        raise AssertionError(f"recipe {variant}: a replayed step drew the "
                             f"mask of the step before ({same})")
    everything = losses + graph.tolist() + \
        np.asarray(timed_loss).reshape(-1).tolist()
    if not all(np.isfinite(everything)) or \
            not everything[-1] < everything[0]:
        raise AssertionError(f"recipe {variant}: losses not finite and "
                             f"falling: {everything}")
    subs = dict(zip(names, ("dropout_philox", "flash_fwd", "flash_bwd_dq",
                            "flash_bwd_dkv", "fused_xent")))
    counted = [(count_kernels(p, subs), count_kernels(
        p, WIDE_DEVICE_NAMES)[0], ms) for p, ms in profiled]
    replayed = {k: max(c[0][0][k] for c in counted) / RECIPE_K
                for k in names}
    # busy time and idle share from the call that recorded the most
    recorded = [sum(e.count for e in c[0][1]) for c in counted]
    (_, dev), _, prof_ms = counted[recorded.index(max(recorded))]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    record_wide(f"recipe_graph_{variant}", {
        key: n_cap + max(c[1][key] for c in counted)
        for key, n_cap in capture_wide.items()})
    for name, per in want.items():
        if replayed[name] != per or capture_launches[name] != 2 * per:
            raise AssertionError(
                f"recipe {variant} {name}: {replayed[name]} launches per "
                f"replayed step, {capture_launches[name]} in the capturing "
                f"call; expected {per} and {2 * per}")
    tokens = TRAIN_BATCH * BERT["seq"]
    steady = sorted(step_ms)[len(step_ms) // 2]
    graph_steady = sorted(graph_step_ms)[len(graph_step_ms) // 2]
    result = {"phase": "recipe", "variant": variant,
              "config": "bert-base pretrain recipe (google-research/bert): "
                        f"dropout 0.1 hidden, {attn_dropout} attention; "
                        "AdamW wd 0.01, global-norm clip 1.0, warmup + "
                        f"linear decay, gradient merge k={RECIPE_MERGE}; "
                        "AMP bf16, fused CE",
              "batch": TRAIN_BATCH, "seq": BERT["seq"], "params": n_params,
              "eager_losses": losses, "eager_lr": lrs,
              "eager_step_ms": step_ms, "median_eager_step_ms": steady,
              "eager_tokens_per_s": tokens / (steady / 1e3),
              "graph_capture_call_s": capture_call_s,
              "graph_step_ms": graph_step_ms,
              "median_graph_step_ms": graph_steady,
              "graph_tokens_per_s": tokens / (graph_steady / 1e3),
              "graph_replay_only_ms": replay_only_ms,
              "graph_device_kernels_per_step":
                  sum(e.count for e in dev) / RECIPE_K,
              "graph_device_busy_ms_per_step": busy_ms / RECIPE_K,
              "graph_device_idle_share": max(0.0, 1.0 - busy_ms / prof_ms),
              "graph_device_idle_share_of_timed_step":
                  max(0.0, 1.0 - busy_ms / RECIPE_K / graph_steady),
              "graph_top_device_ms_per_step": [
                  [e.key[:80], e.count / RECIPE_K,
                   e.self_device_time_total / 1e3 / RECIPE_K]
                  for e in sorted(dev, key=lambda e:
                                  -e.self_device_time_total)[:8]],
              "graph_losses": graph.tolist(),
              "graph_losses_bitwise_equal_to_eager": True,
              "graph_later_losses": np.asarray(timed_loss).reshape(-1)
              .tolist(),
              "launches": launches,
              "launches_per_step": {k: v // RECIPE_STEPS
                                    for k, v in launches.items()},
              "launches_in_capturing_call": capture_launches,
              "launches_per_replayed_step": replayed,
              "cache_stats": cache,
              "peak_gpu_mem_gb": {"eager": eager_peak_gb,
                                  "graph": graph_peak_gb}}
    log(result)
    return result


# phase 9: BERT-base pretraining through the dygraph 2.0 API
DYGRAPH_STEPS = 6       # timed steps, after one warm-up step
# (variant, attention dropout, auto_cast level, dtype at the flash and
# fused cross-entropy kernels: O1 keeps q, k, v and the logits in fp32)
DYGRAPH_VARIANTS = (("published", 0.1, "O1", "float32"),
                    ("flash", 0.0, "O1", "float32"),
                    ("flash_o2", 0.0, "O2", "bfloat16"))
DYGRAPH_HIDDEN_DROPOUTS = 1 + 2 * BERT["layers_n"]  # embeddings, 2 a layer
# phase 9's variants, fp32 check and hapi check run BERT-base cut to
# DYGRAPH_LAYERS layers (12 before phase 19), widths unchanged: phase 19 (a)
# carries the full-depth dygraph BERT-base AMP step, through hapi fit
DYGRAPH_LAYERS = 4
DYGRAPH_DROPOUTS = 1 + 2 * DYGRAPH_LAYERS
# phases 13-14, phase 15's hoist (on phase 14's program) and sp LM, and
# phase 16 train BERT-base cut to DIST_LAYERS layers, widths unchanged,
# so that the whole run keeps inside its time limit (at 4 layers a slow
# call read 1,233 s with phase 20 added; at 1 layer phases 13-16 read
# 13 s less in all, within a call's spread, so they stay at 2)
DIST_LAYERS = 2


def dygraph_batch(torch, seed):
    """One fixed batch: ids and MLM labels at every position [8, 512],
    NSP labels [8], on the card."""
    rng = np.random.RandomState(seed)
    b, seq, vocab = TRAIN_BATCH, BERT["seq"], BERT["vocab"]
    return tuple(torch.from_numpy(a).cuda() for a in (
        rng.randint(0, vocab, (b, seq)).astype(np.int64),
        rng.randint(0, vocab, (b, seq)).astype(np.int64),
        rng.randint(0, 2, (b,)).astype(np.int64)))


def dygraph_model(seed, attn_dropout, hidden_dropout=0.1, layers=None):
    """BertForPretraining(BertModel(BertConfig())) at the JAX package's
    defaults (google-research/bert base: hidden and attention dropout 0.1)
    with the dropouts given (and `layers` encoder layers where given),
    weights from `seed`, on CUDAPlace(0); and its criterion."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                         BertModel, BertPretrainingCriterion)
    _reset_unique_names()
    paddle.seed(seed)
    cfg = BertConfig(attention_probs_dropout_prob=attn_dropout,
                     hidden_dropout_prob=hidden_dropout)
    if (cfg.vocab_size, cfg.hidden_size, cfg.num_hidden_layers,
            cfg.num_attention_heads, cfg.max_position_embeddings) != (
            BERT["vocab"], BERT["hidden"], BERT["layers_n"], BERT["heads"],
            BERT["seq"]):
        raise AssertionError("BertConfig() is not BERT-base")
    if layers is not None:
        cfg.num_hidden_layers = layers
    return (BertForPretraining(BertModel(cfg)),
            BertPretrainingCriterion(cfg.vocab_size))


def dygraph_optimizer(net, lr=None):
    """AdamW(weight decay 0.01, global-norm clip 1.0) over LinearWarmup(2
    steps, PolynomialDecay(1e-4, 1000)), or a constant `lr`."""
    from paddle_tpu_torch import optimizer as opt
    sched = opt.lr.LinearWarmup(opt.lr.PolynomialDecay(1e-4, 1000), 2, 0.0,
                                1e-4) if lr is None else lr
    return opt.AdamW(learning_rate=sched, parameters=net.parameters(),
                     weight_decay=0.01,
                     grad_clip=opt.ClipGradByGlobalNorm(1.0))


def dygraph_counters(attn, dr, fx):
    return {"dropout": dr.dropout_cuda, "flash_attn_fwd": attn.flash_attention,
            "flash_attn_bwd_dq": attn.flash_attention_bwd_dq_cuda,
            "flash_attn_bwd_dkv": attn.flash_attention_bwd_dkv_cuda,
            "fused_xent_fwd": fx.fused_xent_cuda}


def zero_dygraph_counts(attn, dr, fx):
    import collections
    for c in dygraph_counters(attn, dr, fx).values():
        c.launches = 0
        c.dtype_launches = collections.Counter()
    zero_wide(attn)


def dygraph_phase(torch, seed):
    """(9) BERT-base pretraining through the dygraph 2.0 API: three
    variants, the fp32 kernels-against-plain step and hapi.train_batch
    against the bare loop.  Returns {variant: result}."""
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import fused_xent as fx
    batch = dygraph_batch(torch, seed)
    out = {}
    try:
        attn.enable_flash_attention(True)  # taken where attention has no
        fx.enable_fused_xent(True)         # dropout
        for variant, attn_dropout, level, dtype in DYGRAPH_VARIANTS:
            out[variant] = dygraph_config(torch, attn, dr, fx, seed, batch,
                                          variant, attn_dropout, level,
                                          dtype)
            torch.cuda.empty_cache()
        dygraph_hapi(torch, seed, batch)
        torch.cuda.empty_cache()
    finally:
        attn._FLASH_STATE["mode"] = "auto"
        fx.enable_fused_xent(False)
    dygraph_correctness(torch, attn, dr, fx, seed, batch)
    torch.cuda.empty_cache()
    return out


def dygraph_step(net, crit, opt, scaler, batch, level):
    """One step of the bare loop: forward and loss under auto_cast, the
    scaled backward, unscale / skip-on-inf / step / scale update, then
    clear the gradients and step the lr scheduler."""
    from paddle_tpu_torch import amp
    ids, labels, nsp = batch
    with amp.auto_cast(level=level):
        loss = crit(*net(ids), labels, nsp)
    scaler.scale(loss).backward()
    scaler.minimize(opt, loss)
    opt.clear_grad()
    opt._learning_rate.step()
    return loss


def dygraph_config(torch, attn, dr, fx, seed, batch, variant, attn_dropout,
                   level, dtype):
    """One variant: a warm-up step, DYGRAPH_STEPS timed steps (the main
    path: counts from 0 just before), two profiled steps (the second is
    read: device busy ms, kernels, idle share of its wall time and of the
    median timed step, since the profiler slows the host).  Gates: launches
    per step (dropout 37 with attention dropout, 25 without; fused
    cross-entropy 2; flash forward / dQ / dK/dV 0 / 0 / 0 with attention
    dropout, 12 / 12 / 12 without), all of them in `dtype`; wide launches
    0; losses finite, the last below the first."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import amp
    net, crit = dygraph_model(seed, attn_dropout, layers=DYGRAPH_LAYERS)
    opt = dygraph_optimizer(net)
    scaler = amp.GradScaler()
    n_params = sum(p.numel() for p in net.parameters())
    net.train()
    n = DYGRAPH_LAYERS
    flash = 0 if attn_dropout else 1
    want = {"dropout": DYGRAPH_DROPOUTS + (n if attn_dropout else 0),
            "flash_attn_fwd": n * flash, "flash_attn_bwd_dq": n * flash,
            "flash_attn_bwd_dkv": n * flash, "fused_xent_fwd": 2}
    losses = [float(dygraph_step(net, crit, opt, scaler, batch,
                                 level).detach())]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts from 0 just before
    zero_dygraph_counts(attn, dr, fx)
    step_ms = []
    for _ in range(DYGRAPH_STEPS):
        t0 = time.perf_counter()
        loss = dygraph_step(net, crit, opt, scaler, batch, level)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.detach()))
    counters = dygraph_counters(attn, dr, fx)
    launches = {k: c.launches for k, c in counters.items()}
    by_dtype = {k: dict(c.dtype_launches) for k, c in counters.items()
                if k != "dropout"}
    record_wide(f"dygraph_{variant}", read_wide(attn))
    # ---- end of the main path
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    # two profiled steps, the second one read: the first window pays the
    # profiler's start-up (7.9 s of wall time in a first chip run)
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            loss = dygraph_step(net, crit, opt, scaler, batch, level)
            torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
        losses.append(float(loss.detach()))
    (_, dev) = count_kernels(prof, {})
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    for name, per in want.items():
        if launches[name] != per * DYGRAPH_STEPS:
            raise AssertionError(
                f"dygraph {variant} {name}: {launches[name]} launches in "
                f"{DYGRAPH_STEPS} steps, expected {per} per step")
        if name != "dropout" and per and \
                by_dtype[name] != {dtype: per * DYGRAPH_STEPS}:
            raise AssertionError(f"dygraph {variant} {name}: launches by "
                                 f"dtype {by_dtype[name]}, expected all "
                                 f"{dtype}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"dygraph {variant}: losses not finite and "
                             f"falling: {losses}")
    tokens = TRAIN_BATCH * BERT["seq"]
    steady = sorted(step_ms)[len(step_ms) // 2]
    result = {"phase": "dygraph", "variant": variant,
              "config": "BertForPretraining(BertModel(BertConfig())) "
                        f"(bert-base cut to {DYGRAPH_LAYERS} layers, "
                        f"hidden dropout 0.1, attention "
                        f"{attn_dropout}); AdamW wd 0.01, global-norm clip "
                        f"1.0, warmup + linear decay; auto_cast {level} + "
                        "GradScaler; fused CE",
              "batch": TRAIN_BATCH, "seq": BERT["seq"], "params": n_params,
              "losses": losses, "step_ms": step_ms,
              "median_step_ms": steady,
              "tokens_per_s": tokens / (steady / 1e3),
              "mfu": 6 * n_params * tokens / (steady / 1e3)
              / PEAK_FLOPS["bfloat16"],
              "peak_gpu_mem_gb": peak_gb,
              "profiled_step_ms": prof_ms,
              "device_busy_ms": busy_ms,
              "device_idle_share": max(0.0, 1.0 - busy_ms / prof_ms),
              "device_idle_share_of_timed_step":
                  max(0.0, 1.0 - busy_ms / steady),
              "device_kernels_per_step": sum(e.count for e in dev),
              "top_device_ms": [[e.key[:80], e.count,
                                 e.self_device_time_total / 1e3]
                                for e in sorted(dev, key=lambda e:
                                                -e.self_device_time_total)
                                [:8]],
              "launches": launches,
              "launches_per_step": {k: v // DYGRAPH_STEPS
                                    for k, v in launches.items()},
              "launches_by_dtype": by_dtype,
              "loss_scale": scaler.get_loss_scaling()}
    log(result)
    del net, opt, prof
    return result


def dygraph_correctness(torch, attn, dr, fx, seed, batch):
    """One fp32 step (no auto_cast) of the flash variant's model through
    the kernels (flash and fused cross-entropy on) against the same
    weights and dropout masks with both off (the score-matrix route and
    the cross-entropy in torch ops): loss within rtol 1e-4; the gradients
    of the word embedding, the first layer's q, k and v projections and
    the MLM transform within a normalised max error of 1e-3."""
    from paddle_tpu_torch.core.generator import get_rng_state, set_rng_state
    net, crit = dygraph_model(seed, 0.0, layers=DYGRAPH_LAYERS)
    net.train()
    attn0 = net.bert.encoder.layers[0].self_attn
    checked = {"word_embedding": net.bert.embeddings.word_embeddings.weight,
               "q_proj_0": attn0.q_proj.weight,
               "k_proj_0": attn0.k_proj.weight,
               "v_proj_0": attn0.v_proj.weight,
               "mlm_transform": net.cls.transform.weight}
    ids, labels, nsp = batch
    rng = get_rng_state()
    got = {}
    for tag in ("kernels", "plain"):
        attn.enable_flash_attention(tag == "kernels")
        fx.enable_fused_xent(tag == "kernels")
        set_rng_state(rng)  # the same dropout masks in both runs
        zero_dygraph_counts(attn, dr, fx)
        try:
            loss = crit(*net(ids), labels, nsp)
            loss.backward()
        finally:
            attn._FLASH_STATE["mode"] = "auto"
            fx.enable_fused_xent(False)
        counts = {k: c.launches
                  for k, c in dygraph_counters(attn, dr, fx).items()}
        expect = {"dropout": DYGRAPH_DROPOUTS,
                  **dict.fromkeys(("flash_attn_fwd", "flash_attn_bwd_dq",
                                   "flash_attn_bwd_dkv"),
                                  DYGRAPH_LAYERS if tag == "kernels"
                                  else 0),
                  "fused_xent_fwd": 2 if tag == "kernels" else 0}
        if counts != expect:
            raise AssertionError(f"dygraph fp32 {tag}: launches {counts}, "
                                 f"expected {expect}")
        got[tag] = (float(loss.detach()), {k: p.grad.detach().clone()
                                  for k, p in checked.items()})
        net.clear_gradients()
    (loss_k, gk), (loss_p, gp) = got["kernels"], got["plain"]
    if not np.isfinite(loss_k) or abs(loss_k - loss_p) > 1e-4 * abs(loss_p):
        raise AssertionError(f"dygraph fp32 loss {loss_k} != plain {loss_p}")
    err = {}
    for k in checked:
        scale = float(gp[k].abs().max())
        if not scale > 0 or not bool(torch.isfinite(gk[k]).all()):
            raise AssertionError(f"dygraph fp32 grad of {k}: bad")
        err[k] = float((gk[k] - gp[k]).abs().max()) / scale
        if not err[k] <= 1e-3:
            raise AssertionError(f"dygraph fp32 grad of {k}: normalised "
                                 f"max error {err[k]} > 1e-3")
    log({"phase": "dygraph_fp32_check", "loss_kernels": loss_k,
         "loss_plain": loss_p, "grad_normalised_max_err": err})
    del net, got


def dygraph_hapi(torch, seed, batch):
    """hapi.Model(net).prepare(AdamW, criterion, amp_configs={"level":
    "O1"}): 2 train_batch steps against 2 bare-loop steps (auto_cast O1,
    no loss scaling) from the same weights and eager draw state: losses
    and every parameter equal to the last bit."""
    from paddle_tpu_torch import amp, hapi
    from paddle_tpu_torch.core.generator import get_rng_state, set_rng_state
    net, crit = dygraph_model(seed, 0.0, layers=DYGRAPH_LAYERS)
    init = {k: v.detach().clone() for k, v in net.state_dict().items()}
    rng = get_rng_state()
    model = hapi.Model(net)
    model.prepare(dygraph_optimizer(net, lr=1e-4), crit,
                  amp_configs={"level": "O1"})
    ids, labels, nsp = batch
    via_hapi = [model.train_batch([ids], [labels, nsp])[0]
                for _ in range(2)]
    after = {k: v.detach().clone() for k, v in net.state_dict().items()}
    net.set_state_dict(init)
    opt = dygraph_optimizer(net, lr=1e-4)
    set_rng_state(rng)
    bare = []
    for _ in range(2):
        net.train()
        with amp.auto_cast(level="O1"):
            loss = crit(*net(ids), labels, nsp)
        loss.backward()
        opt.step()
        opt.clear_grad()
        bare.append(float(loss.detach()))
    same = all(torch.equal(after[k], v)
               for k, v in net.state_dict().items())
    if via_hapi != bare or not same:
        raise AssertionError(f"hapi train_batch {via_hapi} != bare loop "
                             f"{bare} (parameters equal: {same})")
    log({"phase": "dygraph_hapi", "train_batch_losses": via_hapi,
         "bare_loop_losses": bare, "bitwise_equal": True})
    del net, model, opt, init, after


# phase 10: the BASELINE configs LeNet-5, ResNet-50 and Transformer-big
# at the widths the JAX package's tools run on the chip
LENET_BATCH, LENET_K = 256, 10
RESNET_BATCH, RESNET_IMG, RESNET_CLASSES, RESNET_K = 128, 224, 1000, 4
TRANSFORMER_BIG = dict(src_len=256, trg_len=256, vocab=32000, d_model=1024,
                       heads=16, n_layers=6, d_inner=4096)
TRANSFORMER_BATCH, TRANSFORMER_K = 16, 4
# timed steps, after one warm-up step.  Momentum 0.1 / 0.9 on one fixed
# batch overshoots: the loss falls for 2 steps, climbs for ~6, then falls
# again (NVIDIA H100, --seed 0, static and dygraph alike), so 4 steps end
# above the first loss and 10 below it
DYGRAPH_RESNET_STEPS = 10
# forward FLOPs of one 1x28x28 image through LeNet-5: 2 x the MACs of
# conv 6@5x5 (pad 2) over 28x28, conv 16@5x5 over 10x10 and fc 400-120-84-10
LENET_FWD_FLOPS = 2 * (28 * 28 * 6 * 25 + 10 * 10 * 16 * 150
                       + 400 * 120 + 120 * 84 + 84 * 10)


def baseline_feed(name, seed):
    """One fixed numpy batch per configuration (the tools' synthetic data,
    drawn from `seed`)."""
    rng = np.random.RandomState(seed)
    if name == "lenet":
        return {"image": rng.rand(LENET_BATCH, 1, 28, 28).astype(np.float32),
                "label": rng.randint(0, 10, (LENET_BATCH, 1)).astype(
                    np.int64)}
    if name == "resnet50":
        return {"image": rng.rand(RESNET_BATCH, 3, RESNET_IMG,
                                  RESNET_IMG).astype(np.float32),
                "label": rng.randint(0, RESNET_CLASSES, (
                    RESNET_BATCH, 1)).astype(np.int64)}
    b, t, vocab = (TRANSFORMER_BATCH, TRANSFORMER_BIG["src_len"],
                   TRANSFORMER_BIG["vocab"])
    causal = np.triu(np.full((t, t), -1e9, np.float32), 1)
    return {"src_ids": rng.randint(0, vocab, (b, t)).astype(np.int64),
            "trg_ids": rng.randint(0, vocab, (b, t)).astype(np.int64),
            "labels": rng.randint(0, vocab, (b, t, 1)).astype(np.int64),
            "trg_bias": np.broadcast_to(causal, (b, 1, t, t)).copy(),
            "src_pos": np.tile(np.arange(t, dtype=np.int64), (b, 1)),
            "trg_pos": np.tile(np.arange(t, dtype=np.int64), (b, 1))}


def baseline_build(name):
    """(main, startup, loss, forward FLOPs x 3 a step, work units a step
    and their name, MFU dtype) of one configuration."""
    from paddle_tpu_torch import models
    from paddle_tpu_torch.core.program import _reset_unique_names
    _reset_unique_names()
    if name == "lenet":
        main, startup, loss = models.build_lenet()
        return (main, startup, loss, 3 * LENET_FWD_FLOPS * LENET_BATCH,
                LENET_BATCH, "images", "float32")
    if name == "resnet50":
        main, startup, loss = models.build_resnet50(
            RESNET_BATCH, RESNET_IMG, RESNET_CLASSES)
        flops = 3 * 4.1e9 * (RESNET_IMG / 224.0) ** 2 * RESNET_BATCH
        return (main, startup, loss, flops, RESNET_BATCH, "images",
                "bfloat16")
    cfg = TRANSFORMER_BIG
    main, startup, loss = models.build_transformer_big(**cfg)
    tokens = TRANSFORMER_BATCH * (cfg["src_len"] + cfg["trg_len"])
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    # tools/bench_transformer.py's count: 6 x params x tokens / 2 (each
    # stack sees half the tokens) + the score and context products
    flops = (6 * n_params * tokens / 2
             + 12 * cfg["n_layers"] * cfg["src_len"] * cfg["d_model"]
             * tokens)
    return main, startup, loss, flops, tokens, "tokens", "bfloat16"


def first_bn_mean(main):
    """The running mean of the program's first batch_norm, or None."""
    for op in main.global_block().ops:
        if op.type == "batch_norm":
            return op.inputs["Mean"][0]
    return None


def check_stats_move(tag, means):
    """Each step's running mean differs from the one before it."""
    for i in range(1, len(means)):
        if np.array_equal(means[i], means[i - 1]):
            raise AssertionError(f"{tag}: the first batch_norm's running "
                                 f"mean did not move at step {i}")


def profiled_window(torch, fn, steps):
    """Run fn() under torch.profiler; (device busy ms a step, device
    kernels a step, idle share of the window, wall ms, top kernels)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    (_, dev) = count_kernels(prof, {})
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    return (busy / steps, sum(e.count for e in dev) / steps,
            max(0.0, 1.0 - busy / wall), wall,
            [[e.key[:80], e.count / steps,
              e.self_device_time_total / 1e3 / steps] for e in top])


def baseline_static(torch, name, seed, k):
    """One static configuration: K eager Executor.run steps from the
    startup weights of `seed`, then run_steps calls of K steps from the
    same weights (one capture, 2 timed, 1 profiled).  Gates: the K eager
    losses finite and the last below the first; the 3 K replayed losses
    finite, the capturing call's K equal to the K eager ones (to the last
    bit, else rtol 1e-5 fp32 / 2e-3 AMP, the largest difference reported);
    the first batch_norm's running mean new at every step, eager and
    replayed (it is fetched each step); one capture, then hits; no launch
    of a hand kernel (flash, fused CE, dropout, the wide routes).

    The replayed trace is not read for "the last below the first":
    Momentum 0.1 / 0.9 on one fixed batch (ResNet-50) swings with a
    period of some 20 steps, so the loss at step 3 K reads where the
    swing is, not whether the step trains.  That the replayed steps train
    as the eager ones do is held by their equality."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import fused_xent as fx
    main, startup, loss, flops, units, unit, peak = baseline_build(name)
    startup.random_seed = seed
    feed = baseline_feed(name, seed)
    mean = first_bn_mean(main)
    fetch = [loss.name] + ([mean] if mean else [])
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    amp_on = any(op.type == "cast" for op in main.global_block().ops)
    exe = static.Executor()
    scope = static.Scope()
    with static.scope_guard(scope):
        exe.run(startup)
    init = {n: t.clone() for n, t in scope.vars.items() if t is not None}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- this path: counts from 0 just before, read just after
    zero_dygraph_counts(attn, dr, fx)
    eager, eager_ms, eager_means = [], [], []
    with static.scope_guard(scope):
        for _ in range(k):
            t0 = time.perf_counter()
            out = exe.run(main, feed=feed, fetch_list=fetch)
            eager_ms.append((time.perf_counter() - t0) * 1e3)
            eager.append(float(np.asarray(out[0]).reshape(-1)[0]))
            if mean:
                eager_means.append(np.asarray(out[1]))
    eager_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del scope
    gscope = static.Scope()
    for n, t in init.items():
        gscope.set(n, t.clone())
    del init
    stacked = {n: np.stack([v] * k) for n, v in feed.items()}
    gexe = static.Executor()
    losses, step_ms, graph_means = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with static.scope_guard(gscope):
        t0 = time.perf_counter()
        out = gexe.run_steps(main, feed=stacked, fetch_list=fetch)
        capture_call_s = time.perf_counter() - t0
        losses.extend(np.asarray(out[0]).reshape(-1).tolist())
        if mean:
            graph_means.extend(np.asarray(out[1]))
        for _ in range(2):
            t0 = time.perf_counter()
            out = gexe.run_steps(main, feed=stacked, fetch_list=fetch)
            step_ms.append((time.perf_counter() - t0) * 1e3 / k)
            losses.extend(np.asarray(out[0]).reshape(-1).tolist())
            if mean:
                graph_means.extend(np.asarray(out[1]))
        launches = {n: c.launches for n, c in
                    dygraph_counters(attn, dr, fx).items()}
        record_wide(f"baseline_{name}", read_wide(attn))
        # ---- end of this path
        graph_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        busy, kernels, idle, prof_wall, top = profiled_window(
            torch, lambda: gexe.run_steps(main, feed=stacked,
                                          fetch_list=fetch), k)
    stats = gexe.cache_stats()
    gexe.close()
    del gscope, stacked
    torch.cuda.empty_cache()
    tag = f"baseline {name}"
    graph = np.asarray(losses[:k], np.float32)
    ref = np.asarray(eager, np.float32)
    bitwise = bool(np.array_equal(graph, ref))
    max_rel = float(np.max(np.abs(graph - ref) / np.abs(ref)))
    if not bitwise:
        np.testing.assert_allclose(graph, ref, rtol=2e-3 if amp_on
                                   else 1e-5, atol=0)
    if not all(np.isfinite(eager)) or not eager[-1] < eager[0]:
        raise AssertionError(f"{tag}: eager losses not finite and "
                             f"falling: {eager}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: replayed losses not finite: {losses}")
    if mean:
        check_stats_move(f"{tag} eager", eager_means)
        check_stats_move(f"{tag} replayed", graph_means)
    if stats != {"hits": 3, "misses": 1, "traces": 1}:
        raise AssertionError(f"{tag}: cache_stats {stats}, expected 1 "
                             "capture and 3 hits")
    if any(launches.values()):
        raise AssertionError(f"{tag}: hand-kernel launches {launches}")
    eager_med = sorted(eager_ms)[len(eager_ms) // 2]
    steady = sorted(step_ms)[len(step_ms) // 2]
    result = {"phase": "baseline", "variant": name,
              "config": {"lenet": "LeNet-5, MNIST shapes, fp32, SGD 0.01",
                         "resnet50": "ResNet-50 v1.5, ImageNet shapes, "
                                     "bf16 AMP, Momentum 0.1 / 0.9",
                         "transformer_big": "Transformer-big 6+6, WMT14 "
                                            "en-de shapes, bf16 AMP, Adam "
                                            "2e-4, label smoothing 0.1"
                         }[name],
              "params": n_params, f"{unit}_per_step": units,
              "steps_per_call": k, "eager_step_ms": eager_ms,
              "eager_median_step_ms": eager_med,
              f"eager_{unit}_per_s": units / (eager_med / 1e3),
              "eager_mfu": flops / (eager_med / 1e3) / PEAK_FLOPS[peak],
              "capture_call_s": capture_call_s,
              "replayed_step_ms": step_ms,
              "replayed_median_step_ms": steady,
              f"replayed_{unit}_per_s": units / (steady / 1e3),
              "replayed_mfu": flops / (steady / 1e3) / PEAK_FLOPS[peak],
              "mfu_peak_dtype": peak, "flops_per_step": flops,
              "peak_gpu_mem_gb_eager": eager_peak,
              "peak_gpu_mem_gb_replayed": graph_peak,
              "device_busy_ms_per_step": busy,
              "device_kernels_per_step": kernels,
              "device_idle_share_profiled": idle,
              "device_idle_share_of_replayed_step":
                  max(0.0, 1.0 - busy / steady),
              "profiled_call_wall_ms": prof_wall,
              "losses_eager": eager, "losses_replayed": losses,
              "losses_bitwise_equal_to_eager": bitwise,
              "losses_max_rel_diff_vs_eager": max_rel,
              "bn_mean_moved_every_step": bool(mean),
              "cache_stats": stats, "hand_kernel_launches": launches,
              "top_device_ms_per_step": top}
    log(result)
    return result


def lenet_cpu_check(torch):
    """One fp32 LeNet step on the card against the same program and
    weights on the CPU, with cuDNN's TF32 switched ON process-wide around
    it: the conv2d kernel must turn it off itself.  Loss rtol 1e-5, the
    two convolutions' weight gradients within a normalised 1e-4 (TF32
    rounds each product's operands to 10 bits, ~1e-3)."""
    from paddle_tpu_torch import static
    main, startup, loss, *_ = baseline_build("lenet")
    feed = baseline_feed("lenet", 1)
    grads = [main._grad_map[p] for p in ("conv2d_0.w_0", "conv2d_1.w_0")]
    exe = static.Executor()
    scope = static.Scope()
    with static.scope_guard(scope):
        exe.run(startup)
    cpu_scope = static.Scope()
    for n, t in scope.vars.items():
        if t is not None:
            cpu_scope.set(n, t.cpu())
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with static.scope_guard(scope):
            card = exe.run(main, feed=feed, fetch_list=[loss] + grads)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    with static.scope_guard(cpu_scope):
        cpu = static.Executor(static.CPUPlace()).run(
            main, feed=feed, fetch_list=[loss] + grads)
    loss_c, loss_h = float(card[0].reshape(-1)[0]), float(
        cpu[0].reshape(-1)[0])
    if abs(loss_c - loss_h) > 1e-5 * abs(loss_h):
        raise AssertionError(f"lenet card loss {loss_c} != CPU {loss_h}")
    err = {}
    for name, g, r in zip(("conv2d_0", "conv2d_1"), card[1:], cpu[1:]):
        err[name] = float(np.abs(g - r).max() / np.abs(r).max())
        if not err[name] <= 1e-4:
            raise AssertionError(f"lenet {name} weight gradient: card vs "
                                 f"CPU normalised error {err[name]}")
    log({"phase": "baseline_lenet_cpu_check", "tf32_flag_on": True,
         "loss_card": loss_c, "loss_cpu": loss_h,
         "conv_grad_normalised_max_err": err})


def baseline_dygraph(torch, seed):
    """(d) vision.models.resnet50() in dygraph: auto_cast O1, F.cross_
    entropy, loss.backward(), optimizer.Momentum(0.1, 0.9); one warm-up
    step, DYGRAPH_RESNET_STEPS timed (the main path) and one profiled.
    Gates: losses finite, the last below the first; bn1's running mean new
    at every step; no hand-kernel launch."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import amp, nn, optimizer, vision
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import fused_xent as fx
    _reset_unique_names()
    paddle.seed(seed)
    net = vision.models.resnet50(num_classes=RESNET_CLASSES)
    net.train()
    opt = optimizer.Momentum(0.1, 0.9, parameters=net.parameters())
    feed = baseline_feed("resnet50", seed)
    x = torch.from_numpy(feed["image"]).cuda()
    y = torch.from_numpy(feed["label"]).cuda()
    n_params = sum(p.numel() for p in net.parameters())
    means = []

    def step():
        with amp.auto_cast(level="O1"):
            loss = nn.functional.cross_entropy(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        means.append(net.bn1._mean.detach().cpu().numpy())
        return float(loss.detach())

    losses = [step()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts from 0 just before
    zero_dygraph_counts(attn, dr, fx)
    step_ms = []
    for _ in range(DYGRAPH_RESNET_STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {n: c.launches for n, c in
                dygraph_counters(attn, dr, fx).items()}
    record_wide("baseline_resnet50_dygraph", read_wide(attn))
    # ---- end of the main path
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    busy, kernels, idle, prof_wall, top = profiled_window(
        torch, lambda: losses.append(step()), 1)
    check_stats_move("baseline resnet50_dygraph", means)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"baseline resnet50_dygraph: losses not "
                             f"finite and falling: {losses}")
    if any(launches.values()):
        raise AssertionError(f"baseline resnet50_dygraph: hand-kernel "
                             f"launches {launches}")
    steady = sorted(step_ms)[len(step_ms) // 2]
    flops = 3 * 4.1e9 * (RESNET_IMG / 224.0) ** 2 * RESNET_BATCH
    result = {"phase": "baseline", "variant": "resnet50_dygraph",
              "config": "vision.models.resnet50(), ImageNet shapes, "
                        "auto_cast O1, Momentum 0.1 / 0.9",
              "params": n_params, "images_per_step": RESNET_BATCH,
              "step_ms": step_ms, "median_step_ms": steady,
              "images_per_s": RESNET_BATCH / (steady / 1e3),
              "mfu": flops / (steady / 1e3) / PEAK_FLOPS["bfloat16"],
              "mfu_peak_dtype": "bfloat16", "peak_gpu_mem_gb": peak_gb,
              "device_busy_ms_per_step": busy,
              "device_kernels_per_step": kernels,
              "device_idle_share_profiled": idle,
              "device_idle_share_of_timed_step":
                  max(0.0, 1.0 - busy / steady),
              "profiled_step_ms": prof_wall, "losses": losses,
              "hand_kernel_launches": launches,
              "top_device_ms_per_step": top}
    log(result)
    del net, opt, x, y
    torch.cuda.empty_cache()
    return result


BASELINE_STATIC = (("lenet", LENET_K), ("resnet50", RESNET_K),
                   ("transformer_big", TRANSFORMER_K))


def baseline_phase(torch, seed):
    """(10) LeNet-5, ResNet-50 and Transformer-big through the static
    executor (eager and run_steps), the LeNet card-vs-CPU fp32 check, and
    vision.models.resnet50() in dygraph.  Returns {variant: result}."""
    t0 = time.perf_counter()
    out = {}
    for name, k in BASELINE_STATIC:
        out[name] = baseline_static(torch, name, seed, k)
        if name == "lenet":
            lenet_cpu_check(torch)
    out["resnet50_dygraph"] = baseline_dygraph(torch, seed)
    log({"phase": "baseline_done", "seconds": time.perf_counter() - t0})
    return out


# phase 11: the serving remainders (bf16 and int8 /predict, the conv-bn
# fold, speculative and int8 /generate), on the models of phases 4 and 7
BF16_RMS_TOL = 5e-2    # bf16 /predict vs fp32: relative RMS over 12 layers
INT8_MAX_TOL = 0.1     # int8 /predict vs fp32: max |q - f| / max |f|,
#                        tests/test_int8_execution.py's bound
FOLD_TOL = 1e-4        # ResNet-50 folded vs unfolded: normalised max error
PTQ_CALIB = 4          # calibration batches of 8 x 512 rows
RESNET_INFER = dict(batch=32, img=224, classes=1000)
SPEC_K = 4
SPEC_FULL_POSTS = (0, 1, 2, 4)   # greedy posts run with a full-depth stamp
NEAR_TIE = 1e-4        # a W-wide GEMM may sum in another order


def predict_rows(seed):
    """8 x 512 rows (phase 4's served batch: the same ids)."""
    rng = np.random.RandomState(seed)
    rows = sum(ROWS_PER_POST)
    ids = rng.randint(0, BERT["vocab"], (rows, BERT["seq"])).astype(np.int64)
    pos = np.tile(np.arange(BERT["seq"], dtype=np.int64), (rows, 1))
    return [ids, pos]


def timed_run(torch, pred, feeds, runs=3):
    """Median ms of `runs` Predictor.run calls after one warm-up, and the
    peak device memory over them."""
    out = pred.run(feeds)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = pred.run(feeds)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return out[0], float(np.median(ms)), \
        torch.cuda.max_memory_allocated() / 2 ** 30


def predict_bf16(torch, attn, model_dir, feeds):
    """(a) phase 4's BERT-base model dir through Config.enable_bfloat16():
    exactly 12 bf16 flash-forward launches a run, outputs against the fp32
    Predictor within BF16_RMS_TOL."""
    from paddle_tpu_torch.inference import Config, create_predictor
    f32 = create_predictor(Config(model_dir))
    out32, ms32, mem32 = timed_run(torch, f32, feeds)
    cfg = Config(model_dir)
    cfg.enable_bfloat16()
    b16 = create_predictor(cfg)
    b16.run(feeds)  # warm-up, not counted
    torch.cuda.synchronize()
    # ---- the main path: counts from 0 just before, read just after
    attn.flash_attention.launches = 0
    attn.flash_attention.dtype_launches.clear()
    zero_wide(attn)
    (out16,) = b16.run(feeds)
    torch.cuda.synchronize()
    launches = dict(attn.flash_attention.dtype_launches)
    record_wide("predict_bf16", read_wide(attn))
    # ---- end of the main path
    if launches != {"bfloat16": BERT["layers_n"]}:
        raise AssertionError(f"bf16 /predict flash launches {launches}, "
                             f"want 12 bf16")
    _, ms16, mem16 = timed_run(torch, b16, feeds)
    rms = float(np.sqrt(np.mean((out16 - out32) ** 2))
                / np.sqrt(np.mean(out32 ** 2)))
    if out16.dtype != np.float32 or not np.isfinite(out16).all() or \
            rms > BF16_RMS_TOL:
        raise AssertionError(f"bf16 /predict: relative RMS {rms} vs fp32 "
                             f"(tol {BF16_RMS_TOL})")
    ops = b16._program.global_block().ops
    result = {"flash_launches_by_dtype": launches,
              "rel_rms_err_vs_fp32": rms, "tol": BF16_RMS_TOL,
              "max_abs_err_vs_fp32": float(np.abs(out16 - out32).max()),
              "run_ms": ms16, "run_ms_fp32": ms32,
              "peak_gpu_mem_gb": mem16, "peak_gpu_mem_gb_fp32": mem32,
              "cast_ops": sum(op.type == "cast" for op in ops)}
    del b16, f32
    return result, out32


def predict_int8(torch, attn, tmp, model_dir, feeds, out32, seed):
    """(b) PostTrainingQuantization of phase 4's program (PTQ_CALIB
    calibration batches from the seed), saved and loaded in a Predictor.
    quant_int8_pass rewrites a product over a 2-D activation only, as the
    JAX package's does, so BERT's 72 [B, S, H] projections stay on the
    fp32 product of their dequantized int8 weights: no int8_matmul op, no
    int8 product a run, 12 fp32 flash launches a run; one projection's
    int32 accumulators at the served shape (its input from this run, its
    int8 weight) through torch._int_mm equal to the plain version; the
    error against fp32 within INT8_MAX_TOL."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.io import load_inference_model, \
        save_inference_model
    from paddle_tpu_torch.ops.kernels import quantize as tq
    from paddle_tpu_torch.slim import PostTrainingQuantization
    t0 = time.perf_counter()
    exe, scope = static.Executor(), static.Scope()
    with static.scope_guard(scope):
        prog, feed_names, targets = load_inference_model(model_dir, exe)
        rng = np.random.RandomState(seed + 11)
        calib = [{"ids": rng.randint(0, BERT["vocab"], feeds[0].shape)
                  .astype(np.int64), "pos": feeds[1]}
                 for _ in range(PTQ_CALIB)]
        quant = PostTrainingQuantization(exe, prog, feed_names,
                                         scope=scope).quantize(calib)
        qdir = os.path.join(tmp, "bert_int8")
        save_inference_model(qdir, feed_names, targets, exe, quant)
    del scope
    ptq_s = time.perf_counter() - t0
    pred = create_predictor(Config(qdir))
    block = pred._program.global_block()
    producer = {n: op for op in block.ops for n in op.output_names()}
    int8_ops = [op for op in block.ops if op.type == "int8_matmul"]
    # the products over a dequantized int8 weight the pass left fp32
    deq_muls = [op for op in block.ops if op.type == "mul" and
                producer.get(op.inputs["Y"][0]) is not None and
                producer[op.inputs["Y"][0]].type.startswith(
                    "fake_channel_wise_dequantize") and
                block.var(producer[op.inputs["Y"][0]].inputs["X"][0])
                .dtype == "int8"]
    if int8_ops or len(deq_muls) != 6 * BERT["layers_n"]:
        raise AssertionError(f"{len(int8_ops)} int8_matmul ops (want 0), "
                             f"{len(deq_muls)} products over int8 weights "
                             f"(want 72)")
    pred.run(feeds)  # warm-up, not counted
    torch.cuda.synchronize()
    # ---- the main path: counts from 0 just before, read just after
    attn.flash_attention.launches = 0
    attn.flash_attention.dtype_launches.clear()
    tq.int8_product.launches = 0
    tq.int8_product.padded_calls = 0
    zero_wide(attn)
    (out8,) = pred.run(feeds)
    torch.cuda.synchronize()
    flash = dict(attn.flash_attention.dtype_launches)
    products = tq.int8_product.launches
    padded = tq.int8_product.padded_calls
    record_wide("predict_int8", read_wide(attn))
    # ---- end of the main path
    if flash != {"float32": BERT["layers_n"]} or products:
        raise AssertionError(f"int8 /predict: flash {flash}, int8 products "
                             f"{products} (want 12 fp32, 0)")
    _, ms8, mem8 = timed_run(torch, pred, feeds)
    # one projection's accumulators: its input from this run, quantized as
    # int8_matmul does, through torch._int_mm and through the plain version
    op = deq_muls[0]
    (x,) = pred._exe.run(pred._program,
                         feed=dict(zip(pred.get_input_names(), feeds)),
                         fetch_list=[op.inputs["X"][0]], scope=pred._scope,
                         return_numpy=False)
    xq, _ = tq.quantize_activation(x)
    xq = xq.reshape(-1, xq.shape[-1])
    w = pred._scope.get(producer[op.inputs["Y"][0]].inputs["X"][0]).to(
        torch.int8)
    acc = tq.int8_product(xq, w)
    plain = tq.int8_product_plain(xq, w)
    if not torch.equal(acc, plain):
        raise AssertionError("int8 accumulators differ from the plain "
                             "version")
    err = float(np.abs(out8 - out32).max() / np.abs(out32).max())
    rms = float(np.sqrt(np.mean((out8 - out32) ** 2))
                / np.sqrt(np.mean(out32 ** 2)))
    if not np.isfinite(out8).all() or err > INT8_MAX_TOL:
        raise AssertionError(f"int8 /predict: normalised max error {err} "
                             f"vs fp32 (tol {INT8_MAX_TOL})")
    return {"int8_matmul_ops": len(int8_ops),
            "fp32_products_over_int8_weights": len(deq_muls),
            "int8_products_per_run": products,
            "padded_products_per_run": padded,
            "flash_launches_by_dtype": flash,
            "accumulators_equal_plain": True,
            "acc_shape": list(acc.shape),
            "norm_max_err_vs_fp32": err, "rel_rms_err_vs_fp32": rms,
            "tol": INT8_MAX_TOL, "run_ms": ms8, "peak_gpu_mem_gb": mem8,
            "ptq_calibrate_freeze_save_s": ptq_s,
            "pass_stats": pred._pass_stats}


def resnet_fold(torch, attn, tmp, seed):
    """(c) build_resnet50(use_amp=False) at batch 32 x 224 with running
    stats, scale and bias drawn from the seed, saved with
    save_inference_model, run through the full pipeline (53 folds, no
    batch_norm left) and with delete_pass("conv_bn_fuse_pass"): outputs
    within FOLD_TOL (fp32, TF32 off)."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.io import save_inference_model
    from paddle_tpu_torch.models import build_resnet50
    main, startup, _ = build_resnet50(use_amp=False, **RESNET_INFER)
    ops = main.global_block().ops
    logits = [op for op in ops if op.type == "softmax_with_cross_entropy"][
        0].inputs["Logits"][0]
    exe, scope = static.Executor(), static.Scope()
    rng = np.random.RandomState(seed + 13)
    d = os.path.join(tmp, "resnet50_infer")
    with static.scope_guard(scope):
        exe.run(startup)
        for op in ops:
            if op.type != "batch_norm":
                continue
            c = scope.get(op.inputs["Scale"][0]).shape
            for slot, draw in (("Scale", lambda: rng.rand(*c) + 0.5),
                               ("Bias", lambda: rng.randn(*c)),
                               ("Mean", lambda: rng.randn(*c) * 0.1),
                               ("Variance", lambda: rng.rand(*c) + 0.5)):
                scope.set(op.inputs[slot][0], torch.as_tensor(
                    draw(), dtype=torch.float32, device=exe.device))
        save_inference_model(d, ["image"], [main.global_block().var(logits)],
                             exe, main)
    del scope
    x = np.random.RandomState(seed + 14).rand(
        RESNET_INFER["batch"], 3, RESNET_INFER["img"],
        RESNET_INFER["img"]).astype(np.float32)
    folded = create_predictor(Config(d))
    cfg = Config(d)
    cfg.delete_pass("conv_bn_fuse_pass")
    plain = create_predictor(cfg)
    types = [op.type for op in folded._program.global_block().ops]
    folds = folded._pass_stats.get("conv_bn_fused", 0)
    if folds != 53 or "batch_norm" in types:
        raise AssertionError(f"conv_bn_fuse_pass folded {folds} (want 53), "
                             f"{types.count('batch_norm')} batch_norm left")
    zero_wide(attn)
    attn.flash_attention.launches = 0
    out_f, ms_f, mem_f = timed_run(torch, folded, [x])
    out_p, ms_p, mem_p = timed_run(torch, plain, [x])
    record_wide("resnet50_infer", read_wide(attn))
    if attn.flash_attention.launches:
        raise AssertionError("ResNet-50 inference launched flash")
    err = float(np.abs(out_f - out_p).max() / np.abs(out_p).max())
    if out_f.shape != (RESNET_INFER["batch"], RESNET_INFER["classes"]) or \
            not np.isfinite(out_f).all() or err > FOLD_TOL:
        raise AssertionError(f"folded ResNet-50: normalised max error {err} "
                             f"(tol {FOLD_TOL}), shape {out_f.shape}")
    return {"folds": folds, "batch_norm_left": types.count("batch_norm"),
            "norm_max_err_vs_unfolded": err, "tol": FOLD_TOL,
            "run_ms_folded": ms_f, "run_ms_unfolded": ms_p,
            "images_per_s_folded": RESNET_INFER["batch"] / ms_f * 1e3,
            "peak_gpu_mem_gb_folded": mem_f,
            "peak_gpu_mem_gb_unfolded": mem_p,
            "ops_folded": len(types),
            "ops_unfolded": len(plain._program.global_block().ops)}


def top2_margin(torch, model, out, step):
    """The fp32 model's top-2 logit margin at generated position `step`
    of the token sequence `out` (teacher-forced)."""
    with torch.inference_mode():
        logits = model.gpt(torch.as_tensor(out[None, :step],
                                           device=model.gpt.device))[0, -1]
        top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def compare_posts(torch, model, bodies, got, want, tag):
    """Post by post: equal, or the first differing position with its
    prefix equal and the fp32 engine's top-2 margin there; greedy
    divergences must sit at a margin under NEAR_TIE, sampling posts must
    be equal.  Returns the list of divergences."""
    diverged = []
    for i, (body, a, b) in enumerate(zip(bodies, got, want)):
        if a.size == b.size and np.array_equal(a, b):
            continue
        n = min(a.size, b.size)
        step = int(np.argmax(a[:n] != b[:n])) if not np.array_equal(
            a[:n], b[:n]) else n
        margin = top2_margin(torch, model, b, step) if step < b.size \
            else None
        diverged.append({"post": i, "step": step - len(body["input_ids"]),
                         "fp32_top2_margin": margin,
                         "sampling": body.get("decode_strategy")
                         == "sampling"})
    return diverged


def serve_posts(torch, srv, bodies):
    """The 16 posts of phase 7 against `srv` (arrival order = post order);
    returns (token arrays, wall seconds)."""
    url = f"http://{srv.host}:{srv.port}/generate"
    replies = [None] * len(bodies)

    def client(i):
        time.sleep(0.02 * i)
        replies[i], _ = post(url, bodies[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or None in replies:
        raise AssertionError("a /generate request did not complete")
    outs = []
    for body, r in zip(bodies, replies):
        out = np.asarray(r["output_ids"][0], np.int64)
        p = len(body["input_ids"])
        if not (p < out.size <= p + GEN_MAX_LENGTH) or \
                list(out[:p]) != body["input_ids"] or out.min() < 0 or \
                out.max() >= GPT2["vocab_size"]:
            raise AssertionError(f"bad /generate reply {out.size} tokens "
                                 f"for a {p}-token prompt")
        outs.append(out)
    return outs, wall


def gen_stats(eng, reqs0, steps0, outs, bodies, wall):
    steps = list(eng.step_log)[steps0:]
    reqs = list(eng.request_log)[reqs0:]
    new = sum(int(o.size) - len(b["input_ids"]) for b, o in zip(bodies, outs))
    return {"new_tokens": new, "burst_s": wall,
            "generated_tokens_per_s": new / wall,
            "ttft_ms_p50": pct([r["ttft_s"] for r in reqs], 50) * 1e3,
            "decode_steps": len(steps),
            "decode_step_ms_p50": pct([s["ms"] for s in steps], 50)}


def spec_burst(torch, attn, model, model_dir, bodies, speculative, path):
    """Phase 7's server setup with gen_speculative=`speculative` and its
    posts (the `path` main path, counts from 0 just before, read just
    after).  Returns (token arrays, gen_stats, the spec counters of the
    burst, the server's speculative stats, flash launches)."""
    from paddle_tpu_torch.inference.server import InferenceServer
    from paddle_tpu_torch.serving import metrics
    srv = InferenceServer(model_dir, port=0, generator=model, gen_slots=8,
                          gen_kv_pool=dict(GEN_PLAN),
                          gen_prefix_cache="auto",
                          gen_speculative=speculative)
    eng, pool = srv.engine, srv.engine.kv_pool
    if eng.speculative.config.num_layers != 2 or eng.speculative.k != SPEC_K:
        raise AssertionError(f"{path}: the draft is not a 2-layer k=4 one")
    srv.start()
    try:
        post(f"http://{srv.host}:{srv.port}/generate",
             {"input_ids": bodies[1]["input_ids"][:16], "max_length": 4})
        torch.cuda.synchronize()
        steps0, reqs0 = len(eng.step_log), len(eng.request_log)
        c0 = {n: metrics.counter(n) for n in SPEC_COUNTERS}
        # ---- the main path: counts from 0 just before, read just after
        attn.flash_attention.launches = 0
        zero_wide(attn)
        outs, wall = serve_posts(torch, srv, bodies)
        flash = attn.flash_attention.launches
        record_wide(path, read_wide(attn))
        # ---- end of the main path
        counts = {n: metrics.counter(n) - v for n, v in c0.items()}
        stats = gen_stats(eng, reqs0, steps0, outs, bodies, wall)
        stats["accepted_per_step"] = float(np.mean(
            [s["committed"] / s["rows"]
             for s in list(eng.step_log)[steps0:]]))
        spec_stats = srv.stats()["speculative"]
    finally:
        srv.stop()
    pool.assert_drained()
    return outs, stats, counts, spec_stats, flash


def spec_divergences(torch, model, bodies, outs, plain, tag):
    """compare_posts, failing on a divergence that is not a greedy near
    tie of the fp32 model."""
    diverged = compare_posts(torch, model, bodies, outs, plain, tag)
    bad = [d for d in diverged if d["sampling"]
           or d["fp32_top2_margin"] is None
           or d["fp32_top2_margin"] >= NEAR_TIE]
    if bad:
        raise AssertionError(f"{tag} /generate parts from the plain "
                             f"engine: {bad}")
    return diverged


def own_weights_draft(torch, model, seed, scale=2.0):
    """A 2-layer k = SPEC_K draft of `model` with weights of its own
    (from the seed, block weights times `scale`): its proposals part from
    the target's chain at some positions (see generate_spec)."""
    from paddle_tpu_torch.core import generator
    from paddle_tpu_torch.serving import SpeculativeDecoder, stamp_draft
    generator.seed(seed + 17)
    draft = stamp_draft(model, 2, copy_weights=False)
    with torch.no_grad():
        for p in draft.gpt.blocks.parameters():
            if p.dim() == 2:
                p.mul_(scale)
    return SpeculativeDecoder(draft, k=SPEC_K)


def generate_spec(torch, attn, model, model_dir, bodies, plain, seed):
    """(d) phase 7's engine and posts with gen_speculative="auto" (a
    2-layer stamp, k = 4): tokens equal to phase 7's post by post (or a
    near-tie divergence), the pool drained; the same with a 2-layer draft
    of its own weights (from the seed, block weights doubled), whose
    rejected proposals must roll columns back; then a full-depth stamp over SPEC_FULL_POSTS accepts
    every proposal."""
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          SpeculativeDecoder, metrics,
                                          stamp_draft)
    outs, stats, counts, spec_stats, flash = spec_burst(
        torch, attn, model, model_dir, bodies, "auto", "generate_spec")
    diverged = spec_divergences(torch, model, bodies, outs, plain, "spec")
    # a draft with its own weights, whose proposals part from the target's
    # chain, so pool.truncate and the decoder's commit rollback run on the
    # card.  A random GPT-2 is a copy model: its std-1 tied embedding
    # makes the last token the argmax, so a draft of its own weights at
    # the init scale guesses every proposal.  Block weights at twice
    # their init scale let the blocks outweigh the copy at some positions
    # and not at others: some proposals are accepted, some rolled back.
    own = own_weights_draft(torch, model, seed)
    o_outs, o_stats, o_counts, _, o_flash = spec_burst(
        torch, attn, model, model_dir, bodies, own,
        "generate_spec_own_draft")
    o_div = spec_divergences(torch, model, bodies, o_outs, plain,
                             "spec_own_draft")
    if o_counts["spec.rollback_cols"] < 1 or \
            o_counts["spec.accepted"] >= o_counts["spec.proposed"]:
        raise AssertionError(f"own-weights draft: {o_counts} (want "
                             f"rejections rolled back)")
    # a full-depth stamp: every proposal accepted
    full = SpeculativeDecoder(stamp_draft(model, GPT2["num_layers"]),
                              k=SPEC_K)
    eng2 = ContinuousBatchingEngine(model, kv_pool=dict(GEN_PLAN),
                                    speculative=full).start()
    c1 = {n: metrics.counter(n) for n in ("spec.proposed", "spec.accepted")}
    try:
        futs = [eng2.submit(bodies[i]["input_ids"],
                            max_length=GEN_MAX_LENGTH)
                for i in SPEC_FULL_POSTS]
        full_outs = [f.result(timeout=600) for f in futs]
    finally:
        eng2.stop()
    eng2.kv_pool.assert_drained()
    fc = {n: metrics.counter(n) - v for n, v in c1.items()}
    full_steps = list(eng2.step_log)
    full_div = compare_posts(torch, model,
                             [bodies[i] for i in SPEC_FULL_POSTS],
                             full_outs, [plain[i] for i in SPEC_FULL_POSTS],
                             "spec_full")
    if fc["spec.accepted"] != fc["spec.proposed"] or \
            fc["spec.proposed"] < 1 or any(
                d["fp32_top2_margin"] is None
                or d["fp32_top2_margin"] >= NEAR_TIE for d in full_div):
        raise AssertionError(f"full-depth stamp: accepted "
                             f"{fc['spec.accepted']} of "
                             f"{fc['spec.proposed']}, divergences {full_div}")
    # how much the equality gates prove: the distinct tokens each plain
    # reply generated
    distinct = [len(set(o[len(b["input_ids"]):].tolist()))
                for b, o in zip(bodies, plain)]
    return {**stats, "flash_launches_in_burst": flash,
            "proposed": counts["spec.proposed"],
            "accepted": counts["spec.accepted"],
            "rollback_cols": counts["spec.rollback_cols"],
            "draft_tokens": spec_stats["draft_tokens"],
            "posts_equal_to_plain": len(bodies) - len(diverged),
            "divergences": diverged,
            "plain_distinct_generated_tokens": distinct,
            "plain_distinct_generated_tokens_all": len(set(
                t for b, o in zip(bodies, plain)
                for t in o[len(b["input_ids"]):].tolist())),
            "own_draft": {**o_stats, "flash_launches_in_burst": o_flash,
                          "proposed": o_counts["spec.proposed"],
                          "accepted": o_counts["spec.accepted"],
                          "rollback_cols": o_counts["spec.rollback_cols"],
                          "posts_equal_to_plain": len(bodies) - len(o_div),
                          "divergences": o_div},
            "full_depth": {"posts": len(SPEC_FULL_POSTS),
                           "proposed": fc["spec.proposed"],
                           "accepted": fc["spec.accepted"],
                           "tokens_per_step": float(np.mean(
                               [s["committed"] / s["rows"]
                                for s in full_steps])),
                           "divergences": full_div}}


def generate_int8(torch, attn, model, model_dir, bodies, plain):
    """(e) phase 7's posts through weight_dtype="int8" over a
    kv_dtype="int8" pool of the same bytes as GEN_PLAN's: no clip, the
    pool drained, every product through torch._int_mm (72 a forward);
    tokens equal to the fp32 engine, or a divergence step reported with
    the fp32 top-2 margin there (docs/serving.md's rule)."""
    from paddle_tpu_torch.inference.server import InferenceServer
    from paddle_tpu_torch.ops.kernels import quantize as tq
    L, H, T, Dh = (GEN_PLAN["num_layers"], GEN_PLAN["num_heads"],
                   GEN_PLAN["page_tokens"], GEN_PLAN["head_dim"])
    fp32_page = 2 * L * H * T * Dh * 4
    int8_page = 2 * L * H * T * Dh + 2 * L * H * 4
    pages = GEN_PLAN["pages"] * fp32_page // int8_page
    plan = dict(GEN_PLAN, pages=pages, kv_dtype="int8", weight_dtype="int8")
    srv = InferenceServer(model_dir, port=0, generator=model, gen_slots=8,
                          gen_kv_pool=plan, gen_prefix_cache="auto")
    eng, pool = srv.engine, srv.engine.kv_pool
    if not (pool.is_quantized and pool.k.device == model.gpt.device and
            eng.weight_dtype == "int8"):
        raise AssertionError("the int8 engine did not resolve its dtypes")
    srv.start()
    try:
        post(f"http://{srv.host}:{srv.port}/generate",
             {"input_ids": bodies[1]["input_ids"][:16], "max_length": 4})
        torch.cuda.synchronize()
        steps0, reqs0 = len(eng.step_log), len(eng.request_log)
        # ---- the main path: counts from 0 just before, read just after
        tq.int8_product.launches = 0
        tq.int8_product.padded_calls = 0
        attn.flash_attention.launches = 0
        zero_wide(attn)
        outs, wall = serve_posts(torch, srv, bodies)
        products = tq.int8_product.launches
        padded = tq.int8_product.padded_calls
        flash = attn.flash_attention.launches
        record_wide("generate_int8", read_wide(attn))
        # ---- end of the main path
        stats = gen_stats(eng, reqs0, steps0, outs, bodies, wall)
        kv = srv.stats()["kv_pool"]
    finally:
        srv.stop()
    pool.assert_drained()
    per_forward = 6 * GPT2["num_layers"]
    if products < per_forward or products % per_forward or \
            kv["quant_scale_clips"] != 0:
        raise AssertionError(f"int8 /generate: {products} int8 products, "
                             f"{kv['quant_scale_clips']} clips")
    diverged = compare_posts(torch, model, bodies, outs, plain, "int8")
    return {**stats, "int8_products_in_burst": products,
            "padded_products_in_burst": padded,
            "flash_launches_in_burst": flash,
            "pages_int8": pages, "pages_fp32": GEN_PLAN["pages"],
            "kv_device": str(pool.k.device),
            "page_bytes_int8": kv["page_bytes"], "page_bytes_fp32": fp32_page,
            "pool_bytes_int8": kv["pool_bytes"],
            "pool_bytes_fp32": GEN_PLAN["pages"] * fp32_page,
            "quant_scale_clips": kv["quant_scale_clips"],
            "posts_equal_to_fp32": len(bodies) - len(diverged),
            "divergences": diverged}


def remainders_phase(torch, attn, seed, tmp, gen):
    """(11) the serving remainders: (a) bf16 /predict, (b) int8 /predict,
    (c) the ResNet-50 conv-bn fold, (d) speculative /generate, (e) int8
    /generate.  Returns {part: result}."""
    t0 = time.perf_counter()
    model_dir = os.path.join(tmp, "bert_flash")
    feeds = predict_rows(seed)
    out = {}
    out["bf16_predict"], out32 = predict_bf16(torch, attn, model_dir, feeds)
    log({"phase": "remainders_bf16_predict", **out["bf16_predict"]})
    out["int8_predict"] = predict_int8(torch, attn, tmp, model_dir, feeds,
                                       out32, seed)
    log({"phase": "remainders_int8_predict", **out["int8_predict"]})
    out["resnet50_fold"] = resnet_fold(torch, attn, tmp, seed)
    log({"phase": "remainders_resnet50_fold", **out["resnet50_fold"]})
    out["spec_generate"] = generate_spec(torch, attn, gen["model"],
                                         model_dir, gen["bodies"],
                                         gen["outs"], seed)
    log({"phase": "remainders_spec_generate", **out["spec_generate"]})
    out["int8_generate"] = generate_int8(torch, attn, gen["model"],
                                         model_dir, gen["bodies"],
                                         gen["outs"])
    log({"phase": "remainders_int8_generate", **out["int8_generate"],
         "plain_generated_tokens_per_s": gen["tokens_per_s"]})
    log({"phase": "remainders_done", "seconds": time.perf_counter() - t0})
    return out


# phase 12: training breadth at BERT-base width (recompute, the other
# optimizers with EMA / ModelAverage / Lookahead, sparse embedding
# gradients, graph-safe random ops, static O2)
BREADTH_STEPS = 4       # eager steps; run_steps calls of K = 4
BREADTH_K = 4
# (b)'s optimizer sweep trains the bench program at 1 layer (widths
# unchanged): eleven optimizers, each with a program build, a startup and
# a captured run_steps call, are most of the phase, so its depth is cut
# to keep the script inside its time limit.  Its gate (the replayed losses equal the eager ones, else
# within BREADTH_RTOL) is shown to fail on a planted fault at that depth:
# the replay fed step 2's labels rolled by one token
BREADTH_OPT_LAYERS = 1  # 2 before phase 21
# (a)'s dropout variant (recompute against plain, bitwise) at 4 layers
# (12 before phase 21; with the sweep at 1 layer the phase read 92.5 s
# against 101.6 s, NVIDIA H100 80GB HBM3, 700 W)
BREADTH_RECIPE_LAYERS = 4
BREADTH_RTOL = 2e-3
BREADTH_TIMED_CALLS = 2  # recompute: run_steps calls timed after the capture
BREADTH_RECIPE_STEPS = 2  # the dropout variant, with and without recompute
LOOKAHEAD_K = 5
OPT_OP_SHAPE = (30522, 768)  # the word embedding
CARD = "cuda"
OPT_OP_TOL = 1e-5        # card against CPU, normalised max error
RANDOM_CASES = (("word_embedding", (30522, 768)), ("odd", (1000003,)))
RANDOM_ULPS = 4          # the normal: the card's logf / sincosf vs plain
# the static optimizers of the port's module 3 and Adam(lazy_mode=False),
# each on the bench AMP program
BREADTH_OPTIMIZERS = (
    ("lars_momentum", lambda s: s.LarsMomentum(1e-3, momentum=0.9)),
    ("adamax", lambda s: s.Adamax(1e-4)),
    ("adagrad", lambda s: s.Adagrad(1e-3)),
    ("decayed_adagrad", lambda s: s.DecayedAdagrad(1e-3)),
    ("adadelta", lambda s: s.Adadelta(1.0)),
    ("rmsprop", lambda s: s.RMSProp(1e-4)),
    ("proximal_gd", lambda s: s.ProximalGD(1e-2, l1=1e-6, l2=1e-4)),
    ("proximal_adagrad", lambda s: s.ProximalAdagrad(1e-2, l1=1e-6,
                                                     l2=1e-4)),
    ("ftrl", lambda s: s.Ftrl(1e-2, l1=1e-6, l2=1e-4)),
    ("dpsgd", lambda s: s.Dpsgd(1e-3, clip=1.0, batch_size=8.0, sigma=1.0)),
    ("adam", lambda s: s.Adam(1e-4, lazy_mode=False)))


def bench_program(make_opt, use_amp=True, is_sparse=False, o2=False,
                  recompute_picks=False, outer=None, after=None,
                  layers_n=None, stages=None):
    """A copy of models.build_bert_pretrain (bench.build_bert_base) at
    BERT-base width, flash on, from a fresh unique-name state, with the
    optimizer `make_opt(static)`: `is_sparse` on the word embedding; `o2`
    casts the forward with amp.cast_model_to_fp16 (no decorate);
    `recompute_picks` wraps the optimizer in RecomputeOptimizer at
    select_layer_checkpoints' picks; `outer(static, opt)` wraps the
    (decorated) optimizer; `after(static)` runs after minimize inside the
    program guard; `stages` cuts the forward into that many pipeline
    stages under device_guard ("gpu:0": the embeddings and the first
    layers, ..., the last: the last layers, the MLM head and the loss).
    Returns (main, startup, loss, extra: what `outer` or `after`
    returned)."""
    from paddle_tpu_torch import amp, static
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.static import layers, nets
    import contextlib
    vocab, seq, hidden = BERT["vocab"], BERT["seq"], BERT["hidden"]
    n_layers = layers_n or BERT["layers_n"]

    def stage(i):
        """device_guard of the stage holding layer i (-1: the
        embeddings, n_layers: the head)."""
        if not stages:
            return contextlib.nullcontext()
        s = min(max(i, 0) * stages // n_layers, stages - 1)
        return static.device_guard(f"gpu:{s}")
    attn.enable_flash_attention(True)
    try:
        _reset_unique_names()
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            with stage(-1):
                ids = layers.data("ids", [-1, seq], dtype="int64")
                pos = layers.data("pos", [-1, seq], dtype="int64")
                labels = layers.data("labels", [-1, seq, 1], dtype="int64")
                h = layers.elementwise_add(
                    layers.embedding(ids, size=[vocab, hidden],
                                     is_sparse=is_sparse),
                    layers.embedding(pos, size=[seq, hidden]))
                h = layers.layer_norm(h, begin_norm_axis=2)
            for i in range(n_layers):
                with stage(i):
                    q = layers.fc(h, hidden, num_flatten_dims=2)
                    k = layers.fc(h, hidden, num_flatten_dims=2)
                    v = layers.fc(h, hidden, num_flatten_dims=2)
                    ctx = nets.scaled_dot_product_attention(
                        q, k, v, num_heads=BERT["heads"])
                    attn_out = layers.fc(ctx, hidden, num_flatten_dims=2)
                    h = layers.layer_norm(
                        layers.elementwise_add(h, attn_out),
                        begin_norm_axis=2)
                    ffn = layers.fc(h, hidden * 4, num_flatten_dims=2,
                                    act="gelu")
                    ffn = layers.fc(ffn, hidden, num_flatten_dims=2)
                    h = layers.layer_norm(layers.elementwise_add(h, ffn),
                                          begin_norm_axis=2)
            with stage(n_layers):
                logits = layers.fc(h, vocab, num_flatten_dims=2)
                loss = layers.mean(
                    layers.softmax_with_cross_entropy(logits, labels))
            if o2:
                amp.cast_model_to_fp16(main)
                if loss.dtype != "float32":
                    loss = layers.cast(loss, "float32")
            opt = make_opt(static)
            if recompute_picks:
                picks = static.select_layer_checkpoints(main)
                opt = static.RecomputeOptimizer(opt)
                opt._set_checkpoints(picks)
            if use_amp:
                opt = amp.decorate(opt, init_loss_scaling=1.0,
                                   use_dynamic_loss_scaling=False,
                                   dest_dtype="bfloat16")
            extra = outer(static, opt) if outer is not None else None
            (extra or opt).minimize(loss)
            if after is not None:
                extra = after(static)
    finally:
        attn._FLASH_STATE["mode"] = "auto"
    return main, startup, loss, extra


def startup_weights(torch, static, rnd, startup, seed):
    """Run `startup` (random_seed = seed) on the card; returns (the
    persistables, the Philox kernel's launches, the random ops in it)."""
    startup.random_seed = seed
    n_random = sum(op.type in ("uniform_random", "gaussian_random")
                   for op in startup.global_block().ops)
    scope = static.Scope()
    before = rnd.random_cuda.launches
    with static.scope_guard(scope):
        static.Executor().run(startup)
    torch.cuda.synchronize()
    launches = rnd.random_cuda.launches - before
    check_equal("startup philox_random", launches, n_random)
    return {n: t for n, t in scope.vars.items() if t is not None}, \
        launches, n_random


def scope_of(static, init):
    """A scope holding copies of `init` (a captured step updates its
    persistables in place)."""
    scope = static.Scope()
    for n, t in init.items():
        scope.set(n, t.clone())
    return scope


def eager_run(torch, static, main, loss, init, feed, steps, each=None,
              fetch=()):
    """`steps` Executor.run steps from `init` (a fresh executor, so the
    step seeds are those of a fresh run_steps call); `each(i, scope)`
    after every step.  Returns (losses, scope, step ms, fetches)."""
    exe = static.Executor()
    scope = scope_of(static, init)
    losses, ms, fetched = [], [], []
    with static.scope_guard(scope):
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = exe.run(main, feed=feed, fetch_list=[loss] + list(fetch))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
            fetched.append(out[1:])
            if each is not None:
                each(i, scope)
    return losses, scope, ms, fetched


def replayed_run(torch, static, main, loss, init, feed, k, fetch=()):
    """One run_steps call of K steps from `init` (the capturing call);
    returns (losses, scope, executor, fetches)."""
    exe = static.Executor()
    scope = scope_of(static, init)
    stacked = {n: np.stack([v] * k) for n, v in feed.items()}
    with static.scope_guard(scope):
        out = exe.run_steps(main, feed=stacked,
                            fetch_list=[loss] + list(fetch))
    return np.asarray(out[0], np.float32).reshape(-1).tolist(), scope, exe, \
        out[1:]


def same_losses(tag, got, want, rtol):
    """Equal to the last bit, else within rtol (largest reported)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{tag}: losses {got} against {want}")
    bitwise = bool(np.array_equal(got, want))
    max_rel = float(np.max(np.abs(got - want) / np.abs(want)))
    if not bitwise and not max_rel <= rtol:
        raise AssertionError(f"{tag}: losses {got.tolist()} against "
                             f"{want.tolist()}: rel diff {max_rel} > {rtol}")
    return bitwise, max_rel


def kernel_counts(counters):
    return {n: c.launches for n, c in counters.items()}


def check_equal(tag, got, want):
    """Fail unless a count (launches on a path, graph captures) is as the
    path implies."""
    if got != want:
        raise AssertionError(f"{tag}: {got}, expected {want}")


def breadth_phase(torch, seed):
    """(12) Training breadth at BERT-base width: (a) recompute, (b) the
    optimizers, EMA, ModelAverage, Lookahead and the 2.0 optimizers, (c)
    sparse embedding gradients, (d) the random ops and their kernel, (e)
    static O2.  Returns {part: result}."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import fused_xent as fx
    from paddle_tpu_torch.ops import random as rnd
    feed = train_feed(seed)
    out, philox = {}, {}

    def part(name, fn, *args):
        rnd.random_cuda.launches = 0  # this path: counts from 0
        t0 = time.perf_counter()
        out[name] = fn(*args)
        philox[name] = rnd.random_cuda.launches  # read just after
        log({"phase_seconds": f"12_breadth/{name}",
             "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()

    part("random", breadth_random, torch, static, rnd, seed)
    zero_wide(attn)
    fx.enable_fused_xent(True)
    try:
        part("recompute", breadth_recompute, torch, static, attn, dr, fx,
             rnd, seed, feed)
        part("optimizers", breadth_optimizers, torch, static, rnd, seed,
             feed)
        part("sparse", breadth_sparse, torch, static, rnd, seed, feed)
        part("o2", breadth_o2, torch, static, attn, fx, rnd, seed, feed)
        part("dygraph_optimizers", breadth_dygraph, torch, seed)
    finally:
        fx.enable_fused_xent(False)
    record_wide("breadth", read_wide(attn))
    out["philox_launches_by_path"] = philox
    if not all(philox[p] > 0 for p in ("random", "recompute", "optimizers",
                                       "sparse", "o2")):
        raise AssertionError(f"phase 12 paths without a Philox launch: "
                             f"{philox}")
    return out


def breadth_recompute(torch, static, attn, dr, fx, rnd, seed, feed):
    """(a) The bench AMP program (flash, fused CE) with
    FLAGS_recompute="always" and through RecomputeOptimizer(Adam) at
    select_layer_checkpoints' picks (the two serialize equal), against
    the same program without recompute: 4 eager steps each from the same
    weights (losses equal, peak memory lower, launches per step exact),
    then run_steps K = 4 (one capturing call equal to the eager steps,
    timed calls, one profiled call); and the recipe with attention
    dropout 0.1 with and without recompute (losses equal bit for bit)."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.core.flags import set_flags
    n = BERT["layers_n"]
    main_p, startup, loss_p = build_pretrain(True, use_amp=True)
    set_flags({"recompute": "always"})
    try:
        main_r, _, loss_r = build_pretrain(True, use_amp=True)
    finally:
        set_flags({"recompute": ""})
    main_o, _, _, _ = bench_program(lambda s: s.Adam(learning_rate=1e-4),
                                    recompute_picks=True)
    if main_o.serialize_to_string() != main_r.serialize_to_string():
        raise AssertionError("FLAGS_recompute=always and RecomputeOptimizer"
                             " programs differ")
    types = [op.type for op in main_r.global_block().ops]
    want = {"flash_attn_fwd": types.count("flash_attention")
            + types.count("flash_attention_grad"),
            "flash_attn_bwd_dq": types.count("flash_attention_grad"),
            "flash_attn_bwd_dkv": types.count("flash_attention_grad"),
            "fused_xent_fwd": types.count("softmax_with_cross_entropy")
            + types.count("softmax_with_cross_entropy_grad")}
    if want["flash_attn_bwd_dq"] != n:
        raise AssertionError(f"recompute program: {want}")
    counters = {"flash_attn_fwd": attn.flash_attention,
                "flash_attn_bwd_dq": attn.flash_attention_bwd_dq_cuda,
                "flash_attn_bwd_dkv": attn.flash_attention_bwd_dkv_cuda,
                "fused_xent_fwd": fx.fused_xent_cuda}
    init, startup_launches, n_random = startup_weights(torch, static, rnd,
                                                       startup, seed)
    n_params = sum(int(np.prod(p.shape)) for p in main_r.all_parameters())
    res = {"startup_philox_launches": startup_launches,
           "startup_random_ops": n_random,
           "barriers": types.count("optimization_barrier"),
           "launches_per_step_implied": want}
    runs = {}
    for tag, main, loss in (("plain", main_p, loss_p),
                            ("recompute", main_r, loss_r)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():  # this path: counts from 0
            c.launches = 0
        losses, scope, ms, _ = eager_run(torch, static, main, loss, init,
                                         feed, BREADTH_STEPS)
        counts = kernel_counts(counters)  # read just after
        runs[tag] = {"losses": losses, "step_ms": ms,
                     "peak_gpu_mem_gb":
                         torch.cuda.max_memory_allocated() / 2 ** 30,
                     "launches_per_step": {k: v / BREADTH_STEPS
                                           for k, v in counts.items()}}
        del scope
    rc, pl = runs["recompute"], runs["plain"]
    for name, per in want.items():
        check_equal(f"recompute {name} per step",
                       rc["launches_per_step"][name], per)
    if not rc["peak_gpu_mem_gb"] < pl["peak_gpu_mem_gb"]:
        raise AssertionError(f"recompute peak {rc['peak_gpu_mem_gb']} GB "
                             f"not below {pl['peak_gpu_mem_gb']} GB")
    bitwise, max_rel = same_losses("recompute vs plain", rc["losses"],
                                   pl["losses"], 2e-3)
    res.update(eager=runs, losses_bitwise_equal_to_plain=bitwise,
               losses_max_rel_diff_vs_plain=max_rel)
    # run_steps K = 4 from the same weights
    exe = static.Executor()
    scope = scope_of(static, init)
    stacked = {k: np.stack([v] * BREADTH_K) for k, v in feed.items()}
    step_ms = []
    with static.scope_guard(scope):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (lv,) = exe.run_steps(main_r, feed=stacked, fetch_list=[loss_r])
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        graph_losses = np.asarray(lv).reshape(-1).tolist()
        for _ in range(BREADTH_TIMED_CALLS):
            t0 = time.perf_counter()
            (lv,) = exe.run_steps(main_r, feed=stacked, fetch_list=[loss_r])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3 / BREADTH_K)
            graph_losses += np.asarray(lv).reshape(-1).tolist()
        graph_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            exe.run_steps(main_r, feed=stacked, fetch_list=[loss_r])
            torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    stats = exe.cache_stats()
    exe.close()
    del scope
    g_bitwise, g_rel = same_losses("recompute run_steps vs eager",
                                   graph_losses[:BREADTH_K], rc["losses"],
                                   2e-3)
    if not np.isfinite(graph_losses).all() or \
            not graph_losses[-1] < graph_losses[0]:
        raise AssertionError(f"recompute replayed losses {graph_losses}")
    check_equal("recompute run_steps cache_stats", stats,
                {"hits": BREADTH_TIMED_CALLS + 1, "misses": 1, "traces": 1})
    subs = {"flash_attn_fwd": "flash_fwd", "flash_attn_bwd_dq":
            "flash_bwd_dq", "flash_attn_bwd_dkv": "flash_bwd_dkv",
            "fused_xent_fwd": "fused_xent", "philox_random":
            "philox_random"}
    replayed, dev = count_kernels(prof, subs)
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    steady = sorted(step_ms)[len(step_ms) // 2]
    tokens_s = TRAIN_BATCH * BERT["seq"] / (steady / 1e3)
    eager_steady = sorted(rc["step_ms"][1:])[len(rc["step_ms"][1:]) // 2]
    res.update(
        run_steps_losses=graph_losses,
        run_steps_bitwise_equal_to_eager=g_bitwise,
        run_steps_max_rel_diff_vs_eager=g_rel, capture_call_s=capture_s,
        step_ms=step_ms, median_step_ms=steady, tokens_per_s=tokens_s,
        mfu=6.0 * n_params * tokens_s / PEAK_FLOPS["bfloat16"],
        eager_median_step_ms=eager_steady,
        eager_tokens_per_s=TRAIN_BATCH * BERT["seq"] / (eager_steady / 1e3),
        plain_eager_median_step_ms=sorted(pl["step_ms"][1:])[
            len(pl["step_ms"][1:]) // 2],
        device_busy_ms_per_step=busy_ms / BREADTH_K,
        device_idle_share=max(0.0, 1.0 - busy_ms / prof_ms),
        device_idle_share_of_timed_step=max(
            0.0, 1.0 - busy_ms / BREADTH_K / steady),
        launches_per_replayed_step={k: v / BREADTH_K
                                    for k, v in replayed.items()},
        graph_peak_gpu_mem_gb=graph_peak, cache_stats=stats,
        params=n_params)
    del init
    res["dropout_variant"] = breadth_recompute_dropout(torch, static, dr,
                                                       rnd, seed, feed)
    log({"phase": "breadth_recompute",
         "config": "bert-base pretrain, AMP bf16, flash + fused CE, "
                   "FLAGS_recompute=always (== RecomputeOptimizer at "
                   "select_layer_checkpoints' picks)",
         "batch": TRAIN_BATCH, "seq": BERT["seq"], **res})
    return res


def breadth_recompute_dropout(torch, static, dr, rnd, seed, feed):
    """Phase 8's recipe with attention dropout 0.1 (gradient merge k = 2
    included) at BREADTH_RECIPE_LAYERS layers (widths unchanged), with
    and without FLAGS_recompute="always": the same
    losses to the last bit from the same weights and step seeds (a
    replayed dropout redraws its mask)."""
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.core.program import _reset_unique_names
    _reset_unique_names()
    main_p, startup, loss_p, sched_p, _ = build_recipe(
        0.1, layers_n=BREADTH_RECIPE_LAYERS)
    set_flags({"recompute": "always"})
    try:
        _reset_unique_names()
        main_r, _, loss_r, sched_r, _ = build_recipe(
            0.1, layers_n=BREADTH_RECIPE_LAYERS)
    finally:
        set_flags({"recompute": ""})
    init, _, _ = startup_weights(torch, static, rnd, startup, seed)
    losses = {}
    for tag, main, loss, sched in (("plain", main_p, loss_p, sched_p),
                                   ("recompute", main_r, loss_r, sched_r)):
        dr.dropout_cuda.launches = 0
        losses[tag], scope, _, _ = eager_run(
            torch, static, main, loss, init, feed, BREADTH_RECIPE_STEPS,
            each=lambda i, s, sched=sched: sched.step())
        losses[tag + "_dropout_launches"] = dr.dropout_cuda.launches
        del scope
    if losses["plain"] != losses["recompute"]:
        raise AssertionError(f"recipe with attention dropout: recompute "
                             f"losses {losses['recompute']} != "
                             f"{losses['plain']}")
    check_equal("recompute replays the dropout kernel",
                losses["recompute_dropout_launches"]
                > losses["plain_dropout_launches"], True)
    types = [op.type for op in main_r.global_block().ops]
    return {"gradient_merge": 2, "losses": losses,
            "replayed_dropout_ops": types.count("dropout")
            - [op.type for op in main_p.global_block().ops].count(
                "dropout")}


def breadth_optimizers(torch, static, rnd, seed, feed):
    """(b) Each optimizer of BREADTH_OPTIMIZERS on the bench AMP program:
    4 eager steps from the startup weights (accumulators non-zero after
    the first), and one run_steps call of K = 4 from the same weights:
    losses equal to the eager ones to the last bit (else rtol 2e-3, the
    largest reported), finite.  Then each new op at [30522, 768] on the
    card against the CPU, dpsgd's noise new on every replay, EMA,
    ModelAverage and Lookahead."""
    out = {"ops": breadth_optimizer_ops(torch, rnd),
           "dpsgd_noise": breadth_dpsgd_noise(torch, static, rnd)}
    for name, make in BREADTH_OPTIMIZERS:
        main, startup, loss, _ = bench_program(make,
                                               layers_n=BREADTH_OPT_LAYERS)
        init, _, _ = startup_weights(torch, static, rnd, startup, seed)
        accs = [v.name for v in main.global_block().vars.values()
                if v.attrs.get("accum_of") and "pow" not in v.name]
        moved = {}

        def first(i, scope, accs=accs, moved=moved):
            if i == 0:
                moved.update({a: bool(scope.vars[a].float().abs().sum() > 0)
                              for a in accs})
        eager, scope, ms, _ = eager_run(torch, static, main, loss, init,
                                        feed, BREADTH_STEPS, each=first)
        del scope
        graph, scope, exe, _ = replayed_run(torch, static, main, loss, init,
                                            feed, BREADTH_K)
        exe.close()
        del scope
        if name == BREADTH_OPTIMIZERS[-1][0]:
            out["planted_fault"] = breadth_fault(torch, static, main, loss,
                                                 init, feed, eager)
        del init
        if accs and not any(moved.values()):
            raise AssertionError(f"{name}: accumulators all zero after the "
                                 f"first step: {moved}")
        bitwise, max_rel = same_losses(f"{name} run_steps vs eager", graph,
                                       eager, BREADTH_RTOL)
        out[name] = {"losses": eager, "run_steps_losses": graph,
                     "bitwise_equal": bitwise, "max_rel_diff": max_rel,
                     "accumulators": len(accs),
                     "accumulators_nonzero_after_step_1":
                         sum(moved.values()),
                     "eager_step_ms": ms}
        torch.cuda.empty_cache()
    out["ema"] = breadth_ema(torch, static, rnd, seed, feed)
    torch.cuda.empty_cache()
    out["model_average"] = breadth_model_average(torch, static, rnd, seed,
                                                 feed)
    torch.cuda.empty_cache()
    out["lookahead"] = breadth_lookahead(torch, static, rnd, seed, feed)
    log({"phase": "breadth_optimizers",
         "config": f"bert-base pretrain at {BREADTH_OPT_LAYERS} layers, "
                   "AMP bf16, flash + fused CE, 4 eager steps and "
                   "run_steps K=4 per optimizer",
         **out})
    return out


def breadth_fault(torch, static, main, loss, init, feed, eager):
    """The sweep's gate on a planted fault: one run_steps call of K steps
    from `init` whose step 2 is fed the labels rolled by one token; its
    losses against `eager` must fail same_losses.  Returns the fault's
    losses and largest relative difference."""
    stacked = {n: np.stack([v] * BREADTH_K) for n, v in feed.items()}
    stacked["labels"][1] = np.roll(stacked["labels"][1], 1, axis=1)
    exe = static.Executor()
    with static.scope_guard(scope_of(static, init)):
        out = exe.run_steps(main, feed=stacked, fetch_list=[loss])
    exe.close()
    got = np.asarray(out[0], np.float32).reshape(-1).tolist()
    try:
        same_losses("planted fault", got, eager, BREADTH_RTOL)
    except AssertionError:
        rel = float(np.max(np.abs(np.float32(got) - np.float32(eager))
                           / np.abs(np.float32(eager))))
        return {"losses": got, "max_rel_diff": rel, "gate": BREADTH_RTOL}
    raise AssertionError(f"the sweep's gate passed a planted fault: {got} "
                         f"against {eager}")


def opt_op_inputs(rng, op):
    """Inputs of one optimizer op at OPT_OP_SHAPE (numpy, fp32)."""
    s = OPT_OP_SHAPE

    def arr(pos):
        return rng.rand(*s).astype(np.float32) + (0.5 if pos else -0.5)
    lr = np.asarray([0.05], np.float32)
    slots = {"lars_momentum": ("Velocity",), "adamax": ("Moment",),
             "adagrad": (), "decayed_adagrad": (), "adadelta": (),
             "rmsprop": ("MeanGrad", "Moment"), "ftrl": (
                 "LinearAccumulator",), "dpsgd": (), "proximal_gd": (),
             "proximal_adagrad": ()}[op]
    pos = {"adamax": ("InfNorm",), "adagrad": ("Moment",),
           "decayed_adagrad": ("Moment",), "adadelta": (
               "AvgSquaredGrad", "AvgSquaredUpdate"), "rmsprop": (
               "MeanSquare",), "ftrl": ("SquaredAccumulator",),
           "proximal_adagrad": ("Moment",)}.get(op, ())
    ins = {"Param": arr(False), "Grad": arr(False)}
    ins.update({k: arr(False) for k in slots})
    ins.update({k: arr(True) for k in pos})
    if op != "adadelta":
        ins["LearningRate"] = lr
    if op == "adamax":
        ins["Beta1Pow"] = np.asarray([0.81], np.float32)
    return ins


OPT_OP_ATTRS = {
    "lars_momentum": {"mu": 0.9, "lars_coeff": 0.001,
                      "lars_weight_decay": 0.0005},
    "adamax": {}, "adagrad": {}, "decayed_adagrad": {}, "adadelta": {},
    "rmsprop": {"decay": 0.9, "momentum": 0.5, "centered": True},
    "ftrl": {"l1": 0.01, "l2": 0.02, "lr_power": -0.5},
    "dpsgd": {"clip": 1.0, "batch_size": 8.0, "sigma": 1.0, "op_uid": 5},
    "proximal_gd": {"l1": 0.01, "l2": 0.02},
    "proximal_adagrad": {"l1": 0.01, "l2": 0.02},
}


def breadth_optimizer_ops(torch, rnd):
    """Each new optimizer op (and average_accumulates) at [30522, 768] on
    the card against the same op on the CPU from the same inputs:
    normalised max error (over the slot's largest magnitude) within
    OPT_OP_TOL, the largest reported, and the largest elementwise relative
    error over the nonzero CPU values reported (not gated: an element that
    cancels to near 0 has no bounded relative error)."""
    from paddle_tpu_torch.ops.registry import OpContext, get_op_info
    rng = np.random.RandomState(11)
    errs, rel = {}, {}
    for op, attrs in OPT_OP_ATTRS.items():
        ins = opt_op_inputs(rng, op)
        outs = {}
        for dev in (CARD, "cpu"):
            ctx = OpContext(seed=3, device=dev)
            outs[dev] = get_op_info(op).kernel(
                {k: torch.from_numpy(v).to(dev) for k, v in ins.items()},
                dict(attrs), ctx)
        errs[op] = {}
        for slot, c in outs["cpu"].items():
            g = outs[CARD][slot].cpu().double()
            c = c.double()
            err = float((g - c).abs().max() / c.abs().max().clamp(min=1e-30))
            nz = c != 0
            rel[f"{op}.{slot}"] = float(((g - c)[nz] / c[nz]).abs().max()) \
                if bool(nz.any()) else 0.0
            errs[op][slot] = err
            if not err <= OPT_OP_TOL:
                raise AssertionError(f"{op}.{slot} on the card: normalised "
                                     f"max error {err} > {OPT_OP_TOL}")
        del outs
    # ModelAverage's op over a window turnover
    p = rng.randn(*OPT_OP_SHAPE).astype(np.float32)
    state = {"in_sum_1": p, "in_sum_2": p * 0.5, "in_sum_3": p * 0.25,
             "in_num_accumulates": np.asarray([3], np.int64),
             "in_old_num_accumulates": np.asarray([2], np.int64),
             "in_num_updates": np.asarray([9], np.int64)}
    attrs = {"average_window": 0.5, "min_average_window": 2,
             "max_average_window": 4}
    outs = {dev: get_op_info("average_accumulates").kernel(
        {k: torch.from_numpy(v).to(dev) for k, v in
         dict(state, param=p).items()}, dict(attrs), OpContext(device=dev))
        for dev in (CARD, "cpu")}
    for slot, c in outs["cpu"].items():  # elementwise adds: exact
        if not torch.equal(outs[CARD][slot].cpu(), c):
            raise AssertionError(f"average_accumulates.{slot} on the card "
                                 "differs from the CPU")
    errs["average_accumulates"] = "bitwise"
    return {"shape": list(OPT_OP_SHAPE), "normalised_max_err": errs,
            "elementwise_max_rel_err": rel}


def breadth_dpsgd_noise(torch, static, rnd):
    """dpsgd under run_steps: a [4096, 1] fc weight with a zero gradient
    (loss scaled by 0) moves by the noise alone; two replayed steps move
    it differently, and the capturing call equals eager run() steps of
    the same seeds to the last bit."""
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.static import layers
    _reset_unique_names()
    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = 5
    with static.program_guard(main, startup):
        x = layers.data("x", [-1, 4096])
        loss = layers.scale(layers.mean(layers.fc(x, 1)), 0.0)
        static.Dpsgd(1.0, clip=1.0, batch_size=1.0, sigma=1.0).minimize(loss)
    w = next(p.name for p in main.all_parameters() if p.shape == (4096, 1))
    feed = {"x": np.ones((2, 4096), np.float32)}
    init, _, _ = startup_weights(torch, static, rnd, startup, 5)
    _, _, _, eager = eager_run(torch, static, main, loss, init, feed, 3,
                               fetch=[w])
    graph, _, exe, (ws,) = replayed_run(torch, static, main, loss, init,
                                        feed, 3, fetch=[w])
    exe.close()
    w0 = init[w].cpu().numpy()
    ws = np.asarray(ws)
    eager = np.stack([np.asarray(e[0]) for e in eager])
    d1, d2 = ws[0] - w0, ws[1] - ws[0]
    if not np.array_equal(ws, eager):
        raise AssertionError("dpsgd: replayed weights differ from eager")
    if np.array_equal(d1, d2) or not np.abs(d1).max() > 0:
        raise AssertionError("dpsgd: the replayed steps drew one noise")
    return {"replays_equal_eager": True,
            "noise_std_step_1": float(d1.std()),
            "noise_std_step_2": float(d2.std())}


def breadth_ema(torch, static, rnd, seed, feed):
    """EMA(0.999) updated every step after Adam: the shadows after K
    replayed steps equal K eager steps bit for bit; apply() then
    restore() leaves the parameters bitwise as they were."""
    main, startup, loss, ema = bench_program(
        lambda s: s.Adam(1e-4), after=lambda s: _ema(s))
    init, _, _ = startup_weights(torch, static, rnd, startup, seed)
    eager, scope_e, _, _ = eager_run(torch, static, main, loss, init, feed,
                                     BREADTH_K)
    graph, scope_g, exe, _ = replayed_run(torch, static, main, loss, init,
                                          feed, BREADTH_K)
    exe.close()
    same_losses("ema run_steps vs eager", graph, eager, 2e-3)
    shadows = [s.name for _, s in ema._shadows]
    diff = [n for n in shadows
            if not torch.equal(scope_e.vars[n], scope_g.vars[n])]
    if diff:
        raise AssertionError(f"EMA shadows after K replayed steps differ "
                             f"from eager: {diff[:3]}")
    params = {p.name: scope_e.vars[p.name].clone() for p, _ in ema._shadows}
    with static.scope_guard(scope_e):
        ema.apply(None)
        applied = all(torch.equal(scope_e.vars[p.name], scope_e.vars[s.name])
                      for p, s in ema._shadows)
        ema.restore(None)
    if not applied or not all(torch.equal(scope_e.vars[n], t)
                              for n, t in params.items()):
        raise AssertionError("EMA apply/restore did not round-trip")
    return {"shadows": len(shadows), "losses": eager,
            "shadows_bitwise_equal": True, "apply_restore_bitwise": True}


def _ema(s):
    ema = s.ExponentialMovingAverage(0.999)
    ema.update()
    return ema


def breadth_model_average(torch, static, rnd, seed, feed):
    """ModelAverage(0.15, windows 2-4) after Adam, 4 eager steps: the
    averages differ from the parameters inside `with apply()`, and the
    parameters are bitwise as they were after it."""
    main, startup, loss, ma = bench_program(
        lambda s: s.Adam(1e-4),
        after=lambda s: s.ModelAverage(0.15, min_average_window=2,
                                       max_average_window=4))
    init, _, _ = startup_weights(torch, static, rnd, startup, seed)
    eager, scope, _, _ = eager_run(torch, static, main, loss, init, feed,
                                   BREADTH_STEPS)
    names = [p.name for p, _ in ma._accs]
    before = {n: scope.vars[n].clone() for n in names}
    with static.scope_guard(scope):
        with ma.apply(None):
            moved = sum(not torch.equal(scope.vars[n], before[n])
                        for n in names)
    if not moved or not all(torch.equal(scope.vars[n], t)
                            for n, t in before.items()):
        raise AssertionError(f"ModelAverage apply/restore: {moved} moved")
    return {"params": len(names), "averaged_params_differing": moved,
            "losses": eager, "apply_restore_bitwise": True}


def breadth_lookahead(torch, static, rnd, seed, feed):
    """Lookahead(Adam, k = 5, alpha = 0.5) with K = 5: the fast weights
    equal the slow ones bit for bit after step 5 and not before (eager),
    and one run_steps call of 5 steps ends in the eager state."""
    main, startup, loss, _ = bench_program(
        lambda s: s.Adam(1e-4),
        outer=lambda s, opt: s.LookaheadOptimizer(opt, alpha=0.5, k=5))
    init, _, _ = startup_weights(torch, static, rnd, startup, seed)
    params = [p.name for p in main.all_parameters()]
    slow = {p: next(n for n in main.global_block().vars
                    if n.startswith(p + "_slow")) for p in params}
    synced = []

    def check(i, scope):
        synced.append(all(torch.equal(scope.vars[p], scope.vars[s])
                          for p, s in slow.items()))
    eager, scope_e, _, _ = eager_run(torch, static, main, loss, init, feed,
                                     LOOKAHEAD_K, each=check)
    if synced != [False] * (LOOKAHEAD_K - 1) + [True]:
        raise AssertionError(f"lookahead fast == slow per step: {synced}")
    graph, scope_g, exe, _ = replayed_run(torch, static, main, loss, init,
                                          feed, LOOKAHEAD_K)
    exe.close()
    same_losses("lookahead run_steps vs eager", graph, eager, 2e-3)
    diff = [n for n in list(slow) + list(slow.values())
            if not torch.equal(scope_e.vars[n], scope_g.vars[n])]
    if diff:
        raise AssertionError(f"lookahead replayed state differs: {diff[:3]}")
    return {"params": len(params), "synced_per_step": synced,
            "losses": eager, "run_steps_losses": graph,
            "replayed_state_bitwise": True}


def breadth_dygraph(torch, seed):
    """The four 2.0 optimizers (Adamax, Adagrad, Adadelta, RMSProp), 3
    steps each on phase 9's variant (b) model (attention dropout 0, O1,
    flash and fused CE): losses finite."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import fused_xent as fx
    batch = dygraph_batch(torch, seed)
    ids, labels, nsp = batch
    out = {}
    try:
        attn.enable_flash_attention(True)
        fx.enable_fused_xent(True)
        for name, make in (
                ("Adamax", lambda p: opt.Adamax(1e-4, parameters=p)),
                ("Adagrad", lambda p: opt.Adagrad(1e-3, parameters=p)),
                ("Adadelta", lambda p: opt.Adadelta(1.0, parameters=p)),
                ("RMSProp", lambda p: opt.RMSProp(1e-4, parameters=p))):
            net, crit = dygraph_model(seed, 0.0)
            o = make(net.parameters())
            losses = []
            for _ in range(3):
                with amp.auto_cast(level="O1"):
                    loss = crit(*net(ids), labels, nsp)
                loss.backward()
                o.step()
                o.clear_grad()
                losses.append(float(loss))
            if not np.isfinite(losses).all():
                raise AssertionError(f"2.0 {name}: losses {losses}")
            out[name] = losses
            del net, crit, o
            torch.cuda.empty_cache()
    finally:
        attn._FLASH_STATE["mode"] = "auto"
        fx.enable_fused_xent(False)
    log({"phase": "breadth_dygraph_optimizers", "losses": out})
    return out


def breadth_sparse(torch, static, rnd, seed, feed):
    """(c) `bench_program`'s copy with `is_sparse=True` on the word
    embedding, fp32 (no AMP, no clip): sparse SGD against dense SGD from
    the same weights (K eager steps: losses rtol 1e-5, the word embedding
    within a normalised max error of 1e-5); sparse SGD and
    Adam(lazy_mode=True) each over one run_steps call of K steps (the
    capturing call) against its K eager steps: losses and every
    persistable to the last bit; lazy Adam's rows and moments that no id
    touched bitwise unchanged, the touched rows moved."""
    runs = {}
    for tag, sparse in (("dense", False), ("sparse", True)):
        main, startup, loss, _ = bench_program(lambda s: s.SGD(1e-2),
                                               use_amp=False,
                                               is_sparse=sparse)
        init, _, _ = startup_weights(torch, static, rnd, startup, seed)
        emb = next(p.name for p in main.all_parameters()
                   if p.shape == (BERT["vocab"], BERT["hidden"]))
        losses, scope, ms, _ = eager_run(torch, static, main, loss, init,
                                         feed, BREADTH_K)
        runs[tag] = (losses, scope, ms)
        if sparse:
            sgd_replayed = sparse_replay(torch, static, "sparse sgd", main,
                                         loss, init, feed, losses, scope)
        del init
    (ld, sd, _), (ls, ss, ms_s) = runs["dense"], runs["sparse"]
    np.testing.assert_allclose(ls, ld, rtol=1e-5)
    wd, ws = sd.vars[emb], ss.vars[emb]
    w_err = float((ws - wd).abs().max() / wd.abs().max())
    if not w_err <= 1e-5:
        raise AssertionError(f"sparse SGD word embedding: {w_err}")
    del runs, sd, ss, wd, ws
    main, startup, loss, _ = bench_program(
        lambda s: s.Adam(1e-3, lazy_mode=True), use_amp=False,
        is_sparse=True)
    init, _, _ = startup_weights(torch, static, rnd, startup, seed)
    emb = next(p.name for p in main.all_parameters()
               if p.shape == (BERT["vocab"], BERT["hidden"]))
    moments = [n for n in main.global_block().vars
               if n.startswith(emb + "_moment")]
    eager, scope_e, ms, _ = eager_run(torch, static, main, loss, init, feed,
                                      BREADTH_K)
    adam_replayed, scope_g = sparse_replay(
        torch, static, "lazy adam", main, loss, init, feed, eager, scope_e,
        keep=True)
    touched = torch.zeros(BERT["vocab"], dtype=torch.bool,
                          device=init[emb].device)
    touched[torch.from_numpy(feed["ids"]).reshape(-1)] = True
    for n in [emb] + moments:
        for sc in (scope_e, scope_g):
            if not torch.equal(sc.vars[n][~touched], init[n][~touched]):
                raise AssertionError(f"lazy adam moved untouched rows of {n}")
    if torch.equal(scope_g.vars[emb][touched], init[emb][touched]):
        raise AssertionError("lazy adam left the touched rows")
    res = {"sgd_losses_dense": ld, "sgd_losses_sparse": ls,
           "sgd_word_embedding_normalised_max_err": w_err,
           "sgd_sparse_step_ms": ms_s, "sgd_sparse_replayed": sgd_replayed,
           "lazy_adam_losses": eager, "lazy_adam_replayed": adam_replayed,
           "rows_touched": int(touched.sum())}
    log({"phase": "breadth_sparse",
         "config": "bert-base pretrain, fp32, is_sparse word embedding",
         **res})
    return res


def sparse_replay(torch, static, tag, main, loss, init, feed, eager,
                  scope_e, keep=False):
    """One run_steps call of K steps from `init` (the capturing call)
    against the K eager steps that left `scope_e`: the losses and every
    persistable equal to the last bit.  Returns the record (and the
    replayed scope when `keep`)."""
    graph, scope_g, exe, _ = replayed_run(torch, static, main, loss, init,
                                          feed, BREADTH_K)
    stats = exe.cache_stats()
    exe.close()
    check_equal(f"{tag} run_steps captures", stats["traces"], 1)
    if graph != eager:
        raise AssertionError(f"{tag}: replayed losses {graph} against "
                             f"eager {eager}")
    differ = {}
    for n, t in scope_e.vars.items():
        if t is not None and not torch.equal(scope_g.vars[n], t):
            differ[n] = float((scope_g.vars[n].double() - t.double())
                              .abs().max())
    if differ:
        raise AssertionError(f"{tag}: replayed state differs from eager "
                             f"(largest difference by name): {differ}")
    rec = {"run_steps_losses": graph, "losses_bitwise_equal": True,
           "state_bitwise_equal": True,
           "persistables_compared": sum(t is not None
                                        for t in scope_e.vars.values())}
    return (rec, scope_g) if keep else rec


def breadth_random(torch, static, rnd, seed):
    """(d) The Philox kernel against its plain version (on the card) at
    [30522, 768] and [1000003], fp32 and bf16, uniform and normal: the
    uniform equal to the last bit, the normal within RANDOM_ULPS ulps of
    the output dtype; mean and variance within 5 sigma; times (kernel,
    plain version, torch.rand / torch.randn, bound = bytes written over
    3.35 TB/s); then a program of uniform_random and gaussian_random under
    run_steps: new draws on every replay, equal to eager run()."""
    cases = {}
    seed_t = torch.tensor([seed + 12345], dtype=torch.int64, device="cuda")
    for tag, shape in RANDOM_CASES:
        for dt in (torch.float32, torch.bfloat16):
            for dist, a, b, lib in (
                    (rnd.UNIFORM, -0.1, 0.1, torch.rand),
                    (rnd.NORMAL, 0.0, 0.02, torch.randn)):
                def kernel():
                    return rnd.random_cuda(shape, dt, dist, a, b, seed_t, 7,
                                           "cuda")

                def plain():
                    return rnd.random_plain(shape, dt, dist, a, b, seed_t, 7,
                                            "cuda")
                got, want = kernel(), plain()
                if dist == rnd.UNIFORM:
                    if not torch.equal(got, want):
                        raise AssertionError(f"uniform {tag} {dt}: kernel "
                                             "differs from plain")
                    ulps = 0.0
                else:
                    scale = torch.finfo(dt).eps * torch.clamp(
                        want.float().abs(), min=b)
                    ulps = float(((got.float() - want.float()).abs()
                                  / scale).max())
                    if not ulps <= RANDOM_ULPS:
                        raise AssertionError(f"normal {tag} {dt}: {ulps} "
                                             "ulps from plain")
                x = got.double()
                n = x.numel()
                mean, var = ((a + b) / 2, (b - a) ** 2 / 12) \
                    if dist == rnd.UNIFORM else (a, b * b)
                var_sd = var * (np.sqrt(0.8) if dist == rnd.UNIFORM
                                else np.sqrt(2.0)) / np.sqrt(n)
                m, v = float(x.mean()), float(x.var())
                if dt == torch.float32 and (
                        abs(m - mean) > 5 * np.sqrt(var / n)
                        or abs(v - var) > 5 * var_sd):
                    raise AssertionError(f"{tag} {dt} dist {dist}: mean {m}"
                                         f" var {v} vs {mean} {var}")
                nbytes = n * got.element_size()
                key = f"{tag}_{dtype_name(dt)}_" + \
                    ("uniform" if dist == rnd.UNIFORM else "normal")
                cases[key] = {
                    "shape": list(shape), "max_abs_err": float(
                        (got.float() - want.float()).abs().max()),
                    "max_ulps": ulps, "mean": m, "var": v,
                    "kernel_ms": device_ms(torch, kernel, 20),
                    "plain_ms": cuda_time_ms(plain, 2),
                    "library_ms": device_ms(
                        torch, lambda: lib(shape, dtype=dt, device="cuda"),
                        20),
                    "bound_ms": nbytes / PEAK_BYTES * 1e3,
                    "bound_by": "bytes"}
                del got, want, x
    res = {"cases": cases, **breadth_random_ops(torch, static, rnd, seed)}
    log({"phase": "breadth_random", **res})
    return res


def breadth_random_ops(torch, static, rnd, seed):
    """A program of uniform_random and gaussian_random ops (the step seed,
    no seed attr) under run_steps: new draws on every replay, equal to
    3 eager run() steps to the last bit."""
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.static import layers
    _reset_unique_names()
    main, startup = static.Program(), static.Program()
    main.random_seed = seed
    with static.program_guard(main, startup):
        x = layers.data("x", [-1, 768])
        u = layers.uniform_random([512, 768], min=-1.0, max=1.0)
        g = layers.gaussian_random([512, 768], mean=0.0, std=1.0)
        y = layers.elementwise_add(x, layers.elementwise_mul(u, g))
    feed = {"x": np.zeros((512, 768), np.float32)}
    before = rnd.random_cuda.launches
    eager_exe = static.Executor()
    with static.scope_guard(static.Scope()):
        eager = [eager_exe.run(main, feed=feed, fetch_list=[u, g, y])
                 for _ in range(3)]
    exe = static.Executor()
    with static.scope_guard(static.Scope()):
        replayed = exe.run_steps(
            main, feed={"x": np.stack([feed["x"]] * 3)},
            fetch_list=[u, g, y])
    stats = exe.cache_stats()
    exe.close()
    graph_launches = rnd.random_cuda.launches - before
    # 3 eager steps, the warm-up and the capture: 2 draws each
    check_equal("random ops run + run_steps", graph_launches, 10)
    for j in range(3):
        if not np.array_equal(np.asarray(replayed[j]),
                              np.stack([e[j] for e in eager])):
            raise AssertionError("random ops under run_steps differ from "
                                 "eager run()")
    if np.array_equal(replayed[0][0], replayed[0][1]):
        raise AssertionError("random ops: two replays drew the same")
    return {"run_steps_equal_eager": True, "run_steps_cache_stats": stats,
            "philox_launches_run_and_run_steps": graph_launches}


def breadth_o2(torch, static, attn, fx, rnd, seed, feed):
    """(e) amp.cast_model_to_fp16 on the bench program (Adam, no
    decorate): 4 eager steps and one run_steps call of K = 4 from the
    startup weights; every flash and fused-CE launch in bf16 (counted by
    dtype), losses finite."""
    import collections
    main, startup, loss, _ = bench_program(lambda s: s.Adam(1e-4),
                                           use_amp=False, o2=True)
    init, _, _ = startup_weights(torch, static, rnd, startup, seed)
    counters = {"flash_attn_fwd": attn.flash_attention,
                "flash_attn_bwd_dq": attn.flash_attention_bwd_dq_cuda,
                "flash_attn_bwd_dkv": attn.flash_attention_bwd_dkv_cuda,
                "fused_xent_fwd": fx.fused_xent_cuda}
    for c in counters.values():  # this path: counts from 0
        c.launches = 0
        c.dtype_launches = collections.Counter()
    eager, scope, ms, _ = eager_run(torch, static, main, loss, init, feed,
                                    BREADTH_STEPS)
    del scope
    graph, scope, exe, _ = replayed_run(torch, static, main, loss, init,
                                        feed, BREADTH_K)
    exe.close()
    by_dtype = {n: dict(c.dtype_launches) for n, c in counters.items()}
    check_equal("O2 kernel dtypes", sorted(
        {dt for d in by_dtype.values() for dt in d}), ["bfloat16"])
    if not np.isfinite(eager + graph).all():
        raise AssertionError(f"O2 losses {eager} {graph}")
    bitwise, max_rel = same_losses("O2 run_steps vs eager", graph, eager,
                                   2e-3)
    res = {"losses": eager, "run_steps_losses": graph,
           "bitwise_equal": bitwise, "max_rel_diff": max_rel,
           "launches_by_dtype": by_dtype, "eager_step_ms": ms}
    log({"phase": "breadth_o2",
         "config": "bert-base pretrain, cast_model_to_fp16 (O2 bf16), "
                   "flash + fused CE", **res})
    return res


# phase 13: data-parallel training over torch.distributed, bench.py's
# step at the global batch TRAIN_BATCH
DP_RANKS = 2            # gloo ranks on the one card (NCCL refuses two)
DP_STEPS = 2            # steps of each two-rank run and of its reference
DP_EAGER, DP_K = 2, 4   # NCCL at world 1: eager steps, then run_steps K
# step 1's mean loss against one process at batch TRAIN_BATCH (the
# forward alone: nothing is updated yet).  The static fetch is fp32, the
# mean over the ranks of two batch-4 losses; it matched the batch-8 loss
# to the last bit on the card (PERF.md), so 1e-5 (about 80 ulps).  The
# dygraph O2 loss is bf16: two rounded losses averaged against one, so
# one bf16 ulp (at most 2^-7 of the value)
DP_LOSS_RTOL = {"static": 1e-5, "dygraph": 2.0 ** -7}
# the parameters' update over DP_STEPS steps against the reference's,
# ||update - update_ref|| / ||update_ref||, a tolerance a path, set
# between the sound run's reading and the planted fault's (one rank's
# gradients zeroed before their allreduce, the ranks still in step),
# which every run measures and requires above it.  On the card (PERF.md)
# static reads 0.161 sound (Adam moves each element by about lr whatever
# its gradient's size, so bf16 rounding flips the sign of the tiny
# gradients' steps) and 0.873 faulted; dygraph (its lr warms up from 0,
# AdamW, clip) 0.034 and 0.334
DP_UPDATE_TOL = {"static": 0.4, "dygraph": 0.1}
DP_AMP = {"init_loss_scaling": 1.0, "use_dynamic_loss_scaling": False,
          "dtype": "bfloat16"}
DP_KERNELS = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv",
              "fused_xent_fwd")
# every hand kernel a phase 13 path may launch: the four above (counted
# by dtype too), the dropout kernel and the random kernel
DP_COUNTED = DP_KERNELS + ("dropout_philox", "philox_random")


def dp_counters(attn, dr, fx, rnd):
    return dict(zip(DP_COUNTED, (attn.flash_attention,
                                 attn.flash_attention_bwd_dq_cuda,
                                 attn.flash_attention_bwd_dkv_cuda,
                                 fx.fused_xent_cuda, dr.dropout_cuda,
                                 rnd.random_cuda)))


def dp_zero(counters):
    import collections
    for name, c in counters.items():
        c.launches = 0
        if name in DP_KERNELS:
            c.dtype_launches = collections.Counter()


def dp_read(counters):
    """The launches since dp_zero: {kernel: n}, and {kernel: {dtype: n}}
    of DP_KERNELS."""
    return ({n: c.launches for n, c in counters.items()},
            {n: dict(counters[n].dtype_launches) for n in DP_KERNELS})


def dp_want(dygraph=False, dropout=False):
    """Launches a step on each rank: bench.py's static step 2 flash
    forwards a layer (one, and one replayed by the vjp), the dygraph step
    one (autograd keeps the forward's outputs); a dQ, a dK/dV a layer, 2
    fused CE,
    every one bf16; an embeddings' and 2 a layer's dropouts where BERT's
    hidden dropout is on (the static step has none); no random op; at
    DIST_LAYERS layers."""
    n = DIST_LAYERS
    return dict(zip(DP_COUNTED, (n if dygraph else 2 * n, n, n, 2,
                                 1 + 2 * n if dropout else 0, 0)))


def dp_check_launches(tag, launches, by_dtype, want):
    check_equal(f"{tag} launches", launches, want)
    check_equal(f"{tag} launches by dtype", by_dtype,
                {n: {"bfloat16": want[n]} for n in DP_KERNELS})


def dp_program():
    """bench.py's step through fleet: bench_program's forward (flash on),
    `fleet.init(is_collective=True)`, DistributedStrategy amp with the
    bench's AMP settings (bf16, loss scale 1, not dynamic) and
    `fleet.distributed_optimizer(Adam(1e-4), strategy).minimize(loss)`.
    Returns (main, startup, loss, fleet.main_program: the
    CompiledProgram)."""
    import paddle_tpu_torch.distributed.fleet as fleet

    def outer(static, opt):
        fleet.init(is_collective=True)
        strategy = fleet.DistributedStrategy()
        strategy.amp = True
        strategy.amp_configs.update(DP_AMP)
        return fleet.distributed_optimizer(opt, strategy)
    main, startup, loss, _ = bench_program(lambda s: s.Adam(1e-4),
                                           use_amp=False, outer=outer,
                                           layers_n=DIST_LAYERS)
    if fleet.applied_meta_list() != ["AMPOptimizer",
                                     "GraphExecutionOptimizer"]:
        raise AssertionError(f"fleet chose {fleet.applied_meta_list()}")
    return main, startup, loss, fleet.main_program


def dp_grad_allreduces(main, compiled):
    """The rewritten program's gradient allreduces: one a parameter."""
    n = sum(op.type == "c_allreduce_sum"
            for op in compiled._get_program().global_block().ops)
    check_equal("gradient allreduce ops", n, len(main.all_parameters()))
    return n


def dp_api(torch, device):
    """(d) The collective API on `device` tensors over the default group:
    all_reduce sum / max / min / prod, broadcast, all_gather,
    reduce_scatter (the c_reducescatter op), alltoall and barrier, each
    against numpy (small integers: every result exact).  Returns
    {case: True}."""
    import torch.distributed as tdist
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.ops.registry import OpContext, run_kernel
    w, r = tdist.get_world_size(), tdist.get_rank()

    def x_of(rank):
        return np.arange(4 * w * 2, dtype=np.float32).reshape(4 * w, 2) \
            + 10 * rank + 1

    xs = [x_of(i) for i in range(w)]
    out = {}

    def check(case, got, want):
        got = got.detach().float().cpu().numpy()
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"{case} on {device} over {w} ranks: "
                                 f"{got.tolist()} against {want.tolist()}")
        out[case] = True

    for op, fn in ((pdist.ReduceOp.SUM, np.sum), (pdist.ReduceOp.MAX,
                                                   np.max),
                   (pdist.ReduceOp.MIN, np.min), (pdist.ReduceOp.PROD,
                                                  np.prod)):
        t = torch.tensor(x_of(r)[:2], device=device)
        pdist.all_reduce(t, op=op)
        check(f"all_reduce_{op}", t, fn(np.stack([x[:2] for x in xs]),
                                        axis=0))
    t = torch.tensor(x_of(r), device=device)
    pdist.broadcast(t, src=w - 1)
    check("broadcast", t, xs[-1])
    parts = []
    pdist.all_gather(parts, torch.tensor(x_of(r), device=device))
    check("all_gather", torch.stack(parts), np.stack(xs))
    got = run_kernel("c_reducescatter",
                     {"X": torch.tensor(x_of(r), device=device)}, {},
                     OpContext(device=device))["Out"]
    check("reduce_scatter", got, np.sum(xs, axis=0)[4 * r:4 * (r + 1)])
    parts = []
    pdist.alltoall([torch.tensor(x_of(r)[4 * j:4 * (j + 1)], device=device)
                    for j in range(w)], parts)
    check("alltoall", torch.cat(parts),
          np.concatenate([x[4 * r:4 * (r + 1)] for x in xs]))
    pdist.barrier()
    out["barrier"] = True
    return out


def dp_tensors_differing(torch, tensors):
    """Every rank's `tensors` against rank 0's (a broadcast), to the last
    bit: the count of differing tensors summed over the ranks."""
    from paddle_tpu_torch.ops.kernels import collective as kc
    group = kc.ring_group(0)
    differ = sum(int(not torch.equal(kc.broadcast(t, 0, group), t))
                 for t in tensors)
    total = kc.all_reduce(torch.tensor([differ], device=tensors[0].device),
                          "sum", group)
    return int(total.item())


def dp_rank(seed, out_dir):
    """One rank of phases 13 (a), (c) and (d) (a `spawn` worker): a gloo
    process group over the PADDLE_* contract, the collective API on CUDA
    tensors, the static data-parallel runs, then the dygraph ones; writes
    rank<r>.json and, on rank 0, the parameters after each run held
    against one process."""
    import torch
    import torch.distributed as tdist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.core import kernel_build
    kernel_build.build_libraries(KERNEL_SOURCES)  # the parent built them
    env = pdist.init_parallel_env(backend="gloo")
    try:
        torch.cuda.set_device(env.device_id)
        res = {"rank": env.rank, "world": env.world_size,
               "device": torch.cuda.get_device_name(env.device_id),
               "api": dp_api(torch, CARD)}
        res["static"] = dp_static_rank(torch, seed, env.rank, out_dir)
        torch.cuda.empty_cache()
        res["dygraph"] = dp_dygraph_rank(torch, seed, env.rank, out_dir)
        torch.cuda.empty_cache()
        res["sync_bn"] = dp_sync_bn_rank(torch, seed, env.rank,
                                         env.world_size, out_dir)
    finally:
        tdist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{env.rank}.json"), "w") as f:
        json.dump(res, f)


def dp_static_rank(torch, seed, rank, out_dir):
    """(a) on one rank: a sound run (dp_static_run, step 2 with the
    collectives timed), then one with rank 1's gradients zeroed before
    their allreduce; rank 0 saves the parameters after each."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import fused_xent as fx
    from paddle_tpu_torch.ops import random as rnd
    fx.enable_fused_xent(True)
    try:
        main, startup, loss, compiled = dp_program()
        params = [p.name for p in main.all_parameters()]
        counters = dp_counters(attn, dr, fx, rnd)
        torch.cuda.reset_peak_memory_stats()
        zero_wide(attn)
        out = {}
        for run in ("sound", "fault"):
            out[run], scope = dp_static_run(
                torch, static, compiled, startup, loss, params, seed, rank,
                counters, timed=run == "sound",
                fault=run == "fault" and rank == 1)
            if rank == 0:
                torch.save({n: scope.vars[n].cpu() for n in params},
                           os.path.join(out_dir, f"static_{run}.pt"))
            del scope
        out.update(wide=read_wide(attn),
                   peak_gpu_mem_gb=torch.cuda.max_memory_allocated()
                   / 2 ** 30,
                   grad_allreduces=dp_grad_allreduces(main, compiled))
    finally:
        fx.enable_fused_xent(False)
    return out


def dp_static_run(torch, static, compiled, startup, loss, params, seed,
                  rank, counters, timed=False, fault=False):
    """DP_STEPS Executor.run steps of `compiled` (fleet.main_program) on
    the global batch from a fresh scope, its startup drawn with
    random_seed seed + rank (rank 1 starts elsewhere; the start broadcast
    makes it rank 0's); after each step the launches, the collective
    calls and the ranks' parameters compared bitwise.  `timed`: step 2
    runs with the collectives synchronised and timed (the allreduce
    share).  `fault`: this rank's gradients are zeroed before their
    allreduce (the c_allreduce_sum kernel wrapped for the run).  Returns
    (the record, the scope)."""
    from paddle_tpu_torch.ops.kernels import collective as kc
    from paddle_tpu_torch.ops.registry import get_op_info
    from paddle_tpu_torch.static.executor import _persistable_names
    feed = train_feed(seed)
    startup.random_seed = seed + rank
    exe, scope = static.Executor(), static.Scope()
    dp_zero(counters)
    with static.scope_guard(scope):
        exe.run(startup)
    torch.cuda.synchronize()
    rec = {"philox_at_start": counters["philox_random"].launches,
           "start_broadcasts": sum(
               scope.get(n) is not None
               for n in _persistable_names(compiled._get_program())),
           "losses": [], "step_ms": [], "launches": [],
           "launches_by_dtype": [], "collective_calls": [],
           "tensors_differing_after_each_step": []}
    info = get_op_info("c_allreduce_sum")
    kernel = info.kernel
    if fault:
        info.kernel = lambda ins, attrs, ctx: kernel(
            {**ins, "X": torch.zeros_like(ins["X"])}, attrs, ctx)
    try:
        with static.scope_guard(scope):
            for i in range(DP_STEPS):
                dp_zero(counters)
                kc.reset_comm_stats()
                kc.time_collectives(timed and i == 1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = exe.run(compiled, feed=feed, fetch_list=[loss])
                torch.cuda.synchronize()
                rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
                kc.time_collectives(False)
                if timed and i == 1:
                    rec["allreduce"] = {
                        "step_ms": rec["step_ms"][-1],
                        "collective_ms": kc.COMM_STATS["seconds"] * 1e3,
                        "calls": kc.COMM_STATS["calls"],
                        "bytes": kc.COMM_STATS["bytes"]}
                rec["collective_calls"].append(
                    dict(kc.COMM_STATS["calls_by_kind"]))
                launches, by_dtype = dp_read(counters)
                rec["launches"].append(launches)
                rec["launches_by_dtype"].append(by_dtype)
                rec["losses"].append(float(np.asarray(out[0]).reshape(-1)[0]))
                rec["tensors_differing_after_each_step"].append(
                    dp_tensors_differing(torch,
                                         [scope.vars[n] for n in params]))
    finally:
        info.kernel = kernel
    return rec, scope


def dp_dygraph_step(torch, model, crit, opt, scaler, batch, level,
                    fault=False):
    """One DataParallel step: the rank's loss over the world size
    (scale_loss), the scaled backward, the gradients allreduced (zeroed
    first with `fault`), then the GradScaler's unscale / step; returns
    the mean loss over the ranks."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops.kernels import collective as kc
    ids, labels, nsp = batch
    with amp.auto_cast(level=level):
        loss = crit(*model(ids), labels, nsp)
    scaler.scale(model.scale_loss(loss)).backward()
    if fault:
        for p in model.parameters():
            if p.grad is not None:
                p.grad.zero_()
    model.apply_collective_grads()
    scaler.minimize(opt, loss)
    opt.clear_grad()
    opt._learning_rate.step()
    group = kc.ring_group(0)
    return kc.all_reduce(loss.detach().float(), "sum", group) \
        / kc.world_of(group)


# (c)'s runs: (name, BERT's hidden dropout); "dropout" is phase 9's
# variant (c), whose masks no one process reproduces (both ranks draw
# the same ones), "sound" and "fault" are held against one process
DP_DYGRAPH_RUNS = (("dropout", 0.1), ("sound", 0.0), ("fault", 0.0))


def dp_dygraph_rank(torch, seed, rank, out_dir):
    """(c) on one rank: DP_DYGRAPH_RUNS (dp_dygraph_run), "fault" with
    rank 1's gradients zeroed before apply_collective_grads; rank 0 saves
    the parameters after "sound" and "fault"."""
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import fused_xent as fx
    from paddle_tpu_torch.ops import random as rnd
    import torch.distributed as tdist
    w = tdist.get_world_size()
    full = dygraph_batch(torch, seed)
    n = TRAIN_BATCH // w
    batch = tuple(t[rank * n:(rank + 1) * n] for t in full)
    attn.enable_flash_attention(True)
    fx.enable_fused_xent(True)
    try:
        counters = dp_counters(attn, dr, fx, rnd)
        torch.cuda.reset_peak_memory_stats()
        zero_wide(attn)
        out = {}
        for run, hidden in DP_DYGRAPH_RUNS:
            out[run], params = dp_dygraph_run(
                torch, seed, batch, counters, hidden,
                fault=run == "fault" and rank == 1)
            if rank == 0 and run != "dropout":
                torch.save(params, os.path.join(out_dir, f"dygraph_{run}.pt"))
            del params
            torch.cuda.empty_cache()
        out.update(wide=read_wide(attn),
                   peak_gpu_mem_gb=torch.cuda.max_memory_allocated()
                   / 2 ** 30)
    finally:
        attn._FLASH_STATE["mode"] = "auto"
        fx.enable_fused_xent(False)
    return out


def dp_dygraph_run(torch, seed, batch, counters, hidden_dropout,
                   fault=False):
    """DP_STEPS steps of phase 9's variant (c) (models.bert from --seed,
    flash, O2, AdamW, GradScaler) at `hidden_dropout` under DataParallel
    on the rank's half of the batch; after each step the launches, the
    collective calls and the ranks' parameters compared bitwise.  Returns
    (the record, the parameters on the host)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.ops.kernels import collective as kc
    dp_zero(counters)
    net, crit = dygraph_model(seed, 0.0, hidden_dropout, DIST_LAYERS)
    torch.cuda.synchronize()
    rec = {"philox_at_start": counters["philox_random"].launches,
           "trainable": sum(bool(p.requires_grad) for p in net.parameters()),
           "losses": [], "step_ms": [], "launches": [],
           "launches_by_dtype": [], "collective_calls": [],
           "tensors_differing_after_each_step": []}
    model = pdist.DataParallel(net)
    opt = dygraph_optimizer(net)
    scaler = amp.GradScaler()
    net.train()
    for _ in range(DP_STEPS):
        dp_zero(counters)
        kc.reset_comm_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = dp_dygraph_step(torch, model, crit, opt, scaler, batch, "O2",
                               fault)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["collective_calls"].append(dict(kc.COMM_STATS["calls_by_kind"]))
        launches, by_dtype = dp_read(counters)
        rec["launches"].append(launches)
        rec["launches_by_dtype"].append(by_dtype)
        rec["losses"].append(float(loss))
        rec["tensors_differing_after_each_step"].append(dp_tensors_differing(
            torch, [p.detach() for p in net.parameters()]))
    return rec, {k: p.detach().cpu() for k, p in net.named_parameters()}


def dp_update_gap(torch, before, got, want, device="cpu"):
    """||(got - before) - (want - before)|| / ||want - before|| over every
    tensor of `want`, and the largest elementwise difference, computed in
    float64 on `device`."""
    num = den = 0.0
    worst = 0.0
    for n, w in want.items():
        b = before[n].to(device, torch.float64)
        g, w = got[n].to(device, torch.float64), w.to(device, torch.float64)
        num += float(((g - b) - (w - b)).pow(2).sum())
        den += float((w - b).pow(2).sum())
        worst = max(worst, float((g - w).abs().max()))
    return (num / den) ** 0.5, worst


def dp_check_run(tag, ranks, path, run, want, calls, at_start):
    """One two-rank run's records: the ranks equal after each step and
    fetching the same losses; the random kernel's launches at the run's
    start `at_start`, each step's hand-kernel launches as `want` and its
    collective calls as `calls(record, step)` on every rank."""
    for r in ranks:
        rec = r[path][run]
        check_equal(f"{tag} rank {r['rank']} philox_random launches at "
                    "the start", rec["philox_at_start"], at_start)
        if any(rec["tensors_differing_after_each_step"]):
            raise AssertionError(
                f"{tag}: ranks differ after a step: "
                f"{rec['tensors_differing_after_each_step']}")
        for i, (got, by_dtype, c) in enumerate(zip(
                rec["launches"], rec["launches_by_dtype"],
                rec["collective_calls"])):
            step = f"{tag} rank {r['rank']} step {i}"
            dp_check_launches(step, got, by_dtype, want)
            check_equal(f"{step} collective calls", c, calls(rec, i))
    if [r[path][run]["losses"] for r in ranks][1:] != \
            [ranks[0][path][run]["losses"]] * (len(ranks) - 1):
        raise AssertionError(f"{tag}: the ranks fetched different losses")


def dp_gate(torch, tag, kind, tmp, before, want, losses, ref_losses):
    """A sound run within the tolerances of one process (step 1's loss,
    the update gap) and the planted fault's gap above the latter.
    Returns (step 1's relative loss difference, {run: (gap, max abs
    parameter difference)})."""
    gaps = {run: dp_update_gap(torch, before, torch.load(
        os.path.join(tmp, f"{kind}_{run}.pt")), want)
        for run in ("sound", "fault")}
    rel = abs(losses[0] - ref_losses[0]) / abs(ref_losses[0])
    tol = DP_UPDATE_TOL[kind]
    if not np.isfinite(losses).all() or not rel <= DP_LOSS_RTOL[kind] \
            or not gaps["sound"][0] <= tol or not gaps["fault"][0] > tol:
        raise AssertionError(
            f"{tag} against one process: losses {losses} / {ref_losses} "
            f"(step 1 rel {rel}, tolerance {DP_LOSS_RTOL[kind]}), update "
            f"gap {gaps['sound'][0]} (tolerance {tol}), planted fault's "
            f"gap {gaps['fault'][0]} (must exceed it)")
    return rel, gaps


def dp_path_launches(rec, step=-1):
    """A path's launches for the kernels line: a step's (gated above)
    and the random kernel's at the path's start."""
    return {"launches": rec["launches"][step],
            "by_dtype": rec["launches_by_dtype"][step],
            "philox_at_start": rec["philox_at_start"]}


def dp_phase(torch, seed):
    """(13) Data parallel at BERT-base width, global batch TRAIN_BATCH:
    (a) static (fleet + CompiledProgram) and (c) dygraph DataParallel on
    DP_RANKS gloo ranks sharing the card, against one process at the
    global batch; (d) the collective API on CUDA tensors on those ranks;
    (b) the static step under NCCL at world 1, eager then run_steps.
    Returns the records, with each path's launches."""
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import fused_xent as fx
    from paddle_tpu_torch.ops import random as rnd
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        pdist.spawn(dp_rank, args=(seed, tmp), nprocs=DP_RANKS,
                    selected_devices=",".join(["0"] * DP_RANKS))
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(DP_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        log({"phase": "dp_api", "backend": "gloo", "ranks": DP_RANKS,
             "device": CARD, "cases": ranks[0]["api"]})
        static_rec = dp_static_check(torch, static, fx, rnd, seed, tmp,
                                     ranks)
        dygraph_rec = dp_dygraph_check(torch, attn, fx, seed, tmp, ranks)
        sync_bn_rec = dp_sync_bn_check(torch, seed, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    nccl, nccl_launches = dp_nccl(torch, static, attn, dr, fx, rnd, seed)
    for path, rec in (("dp_static", static_rec), ("dp_dygraph", dygraph_rec)):
        record_wide(path, rec["wide"])
    log({"phase": "dp", "ranks_process_s": spawn_s})
    r0 = ranks[0]
    launches = {f"static_gloo_{run}": dp_path_launches(r0["static"][run])
                for run in ("sound", "fault")}
    launches.update({f"dygraph_gloo_{run}": dp_path_launches(
        r0["dygraph"][run]) for run, _ in DP_DYGRAPH_RUNS})
    launches.update(nccl_launches)
    return {"static": static_rec, "dygraph": dygraph_rec, "nccl": nccl,
            "sync_bn": {"gloo": sync_bn_rec, "nccl": nccl["sync_bn"]},
            "launches": launches}


def dp_static_check(torch, static, fx, rnd, seed, tmp, ranks):
    """(a) gated: each run's records, then the sound run and the fault
    against one process: the same program's plain main at the global
    batch, DP_STEPS Executor.run steps from the startup of --seed (rank
    0's)."""
    n_ar = ranks[0]["static"]["grad_allreduces"]

    def calls(rec, i):
        """The gradients' and the loss fetch's allreduces, and in the
        first step the start broadcast."""
        c = {"all_reduce": n_ar + 1}
        return {**c, "broadcast": rec["start_broadcasts"]} if i == 0 else c
    main, startup, loss, compiled = dp_program()
    n_random = sum(op.type in ("uniform_random", "gaussian_random")
                   for op in startup.global_block().ops)
    for run in ("sound", "fault"):
        dp_check_run(f"static data parallel ({run})", ranks, "static", run,
                     dp_want(), calls, n_random)
    plain = compiled._program
    fx.enable_fused_xent(True)
    try:
        init, _, _ = startup_weights(torch, static, rnd, startup, seed)
        feed = train_feed(seed)
        losses, scope, ms, _ = eager_run(torch, static, plain, loss, init,
                                         feed, DP_STEPS)
    finally:
        fx.enable_fused_xent(False)
    want = {p.name: scope.vars[p.name] for p in main.all_parameters()}
    dp = ranks[0]["static"]["sound"]
    rel, gaps = dp_gate(torch, "static data parallel", "static", tmp, init,
                        want, dp["losses"], losses)
    for r in ranks:
        a = r["static"]["sound"]["allreduce"]
        a["share_of_step"] = a["collective_ms"] / a["step_ms"]
    res = {"config": f"bert-base pretrain at {DIST_LAYERS} layers, fleet "
                     "amp (bf16) + Adam 1e-4, "
                     "flash + fused CE, CompiledProgram.with_data_"
                     f"parallel over {DP_RANKS} gloo ranks on one card",
           "global_batch": TRAIN_BATCH, "losses": dp["losses"],
           "single_process_losses": losses, "step1_loss_rel_diff": rel,
           "update_gap": gaps["sound"][0],
           "param_max_abs_diff": gaps["sound"][1],
           "fault_losses": ranks[0]["static"]["fault"]["losses"],
           "fault_update_gap": gaps["fault"][0],
           "fault_param_max_abs_diff": gaps["fault"][1],
           "single_process_step_ms": ms,
           "step_ms_by_rank": [r["static"]["sound"]["step_ms"]
                               for r in ranks],
           "allreduce_by_rank": [r["static"]["sound"]["allreduce"]
                                 for r in ranks],
           "collective_calls_per_step": dp["collective_calls"],
           "peak_gpu_mem_gb_by_rank": [r["static"]["peak_gpu_mem_gb"]
                                       for r in ranks],
           "launches_per_step": dp["launches"][-1],
           "philox_startup_launches": dp["philox_at_start"],
           "ranks_bitwise_equal_after_each_step": True,
           "wide": ranks[0]["static"]["wide"]}
    log({"phase": "dp_static", **res})
    return res


def dp_dygraph_check(torch, attn, fx, seed, tmp, ranks):
    """(c) gated: each run's records, then "sound" and "fault" against
    one process: the same model (every dropout 0), optimizer and scaler
    at the global batch, DP_STEPS steps."""
    from paddle_tpu_torch import amp

    def calls(rec, i):
        """The gradients' and the loss's allreduces."""
        return {"all_reduce": rec["trainable"] + 1}
    # the model's initializers draw through the random kernel
    at_start = ranks[0]["dygraph"]["dropout"]["philox_at_start"]
    if not at_start > 0:
        raise AssertionError("dygraph DataParallel: the model's build "
                             "launched no philox_random")
    for run, hidden in DP_DYGRAPH_RUNS:
        dp_check_run(f"dygraph DataParallel ({run})", ranks, "dygraph", run,
                     dp_want(dygraph=True, dropout=hidden > 0), calls,
                     at_start)
    batch = dygraph_batch(torch, seed)
    attn.enable_flash_attention(True)
    fx.enable_fused_xent(True)
    try:
        net, crit = dygraph_model(seed, 0.0, 0.0, DIST_LAYERS)
        before = {k: p.detach().clone() for k, p in net.named_parameters()}
        opt = dygraph_optimizer(net)
        scaler = amp.GradScaler()
        net.train()
        losses, ms = [], []
        for _ in range(DP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(dygraph_step(net, crit, opt, scaler, batch,
                                             "O2").detach()))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        want = {k: p.detach() for k, p in net.named_parameters()}
    finally:
        attn._FLASH_STATE["mode"] = "auto"
        fx.enable_fused_xent(False)
    dp = ranks[0]["dygraph"]["sound"]
    rel, gaps = dp_gate(torch, "dygraph DataParallel", "dygraph", tmp, before,
                        want, dp["losses"], losses)
    res = {"config": f"BertForPretraining (bert-base at {DIST_LAYERS} "
                     "layers), flash, auto_cast O2, "
                     "AdamW + GradScaler, DataParallel over "
                     f"{DP_RANKS} gloo ranks on one card; runs: hidden "
                     "dropout 0.1 (phase 9's variant (c)), every dropout "
                     "0 (held against one process), and its planted fault",
           "global_batch": TRAIN_BATCH, "losses": dp["losses"],
           "single_process_losses": losses, "step1_loss_rel_diff": rel,
           "update_gap": gaps["sound"][0],
           "param_max_abs_diff": gaps["sound"][1],
           "fault_update_gap": gaps["fault"][0],
           "fault_param_max_abs_diff": gaps["fault"][1],
           "dropout_run_losses": ranks[0]["dygraph"]["dropout"]["losses"],
           "single_process_step_ms": ms,
           "step_ms_by_rank": {run: [r["dygraph"][run]["step_ms"]
                                     for r in ranks]
                               for run, _ in DP_DYGRAPH_RUNS},
           "collective_calls_per_step": dp["collective_calls"],
           "peak_gpu_mem_gb_by_rank": [r["dygraph"]["peak_gpu_mem_gb"]
                                       for r in ranks],
           "launches_per_step": {run: ranks[0]["dygraph"][run]["launches"][-1]
                                 for run, _ in DP_DYGRAPH_RUNS},
           "ranks_bitwise_equal_after_each_step": True,
           "wide": ranks[0]["dygraph"]["wide"]}
    log({"phase": "dp_dygraph", **res})
    return res


def dp_nccl(torch, static, attn, dr, fx, rnd, seed):
    """(b) and (d) under NCCL at world size 1 in this process: the
    collective API on the card, then dp_nccl_steps.  Returns (its record,
    its paths' launches)."""
    import torch.distributed as tdist
    from paddle_tpu_torch.distributed.spawn import get_free_ports
    port = get_free_ports(1)[0]
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=1, rank=0)
    try:
        api = dp_api(torch, CARD)
        log({"phase": "dp_api", "backend": "nccl", "ranks": 1,
             "device": CARD, "cases": api})
        sync_bn = dp_nccl_sync_bn(torch, seed)
        fx.enable_fused_xent(True)
        try:
            rec, launches = dp_nccl_steps(torch, static, attn, dr, fx, rnd,
                                          seed)
        finally:
            fx.enable_fused_xent(False)
        rec["sync_bn"] = sync_bn
        return rec, launches
    finally:
        tdist.destroy_process_group()


def dp_nccl_steps(torch, static, attn, dr, fx, rnd, seed):
    """The static data-parallel step under NCCL at world 1: DP_EAGER
    eager Executor.run steps and two run_steps calls of K = DP_K (the
    first captures one CUDA graph of the step and its collectives, the
    second replays it, timed), against DP_EAGER + 2 DP_K plain Executor
    steps from the same weights: every loss equal to the last bit (an
    allreduce over one rank is a copy; the 1/W scale is off at W = 1).
    The collectives reach the NCCL group: each eager step, and the
    capturing call's warm-up and captured step, call one allreduce a
    gradient and one for the loss fetch (the first step also the start
    broadcast); the replaying call calls none."""
    import torch.distributed as tdist
    from paddle_tpu_torch.ops.kernels import collective as kc
    from paddle_tpu_torch.static.executor import _persistable_names
    check_equal("NCCL world 1 backend", tdist.get_backend(kc.ring_group(0)),
                "nccl")
    main, startup, loss, compiled = dp_program()
    init, philox, _ = startup_weights(torch, static, rnd, startup, seed)
    feed = train_feed(seed)
    n = DP_EAGER + 2 * DP_K
    plain, _, plain_ms, _ = eager_run(torch, static, compiled._program,
                                      loss, init, feed, n)
    step_calls = {"all_reduce": dp_grad_allreduces(main, compiled) + 1}
    counters = dp_counters(attn, dr, fx, rnd)
    want = dp_want()
    exe = static.Executor()
    scope = scope_of(static, init)
    start_broadcasts = sum(scope.get(v) is not None for v in
                           _persistable_names(compiled._get_program()))
    stacked = {k: np.stack([v] * DP_K) for k, v in feed.items()}
    zero_wide(attn)
    eager, calls, launches, by_dtype = [], [], [], []

    def count():
        got, dt = dp_read(counters)
        launches.append(got)
        by_dtype.append(dt)
        calls.append(dict(kc.COMM_STATS["calls_by_kind"]))
        dp_zero(counters)
        kc.reset_comm_stats()
    dp_zero(counters)
    kc.reset_comm_stats()
    with static.scope_guard(scope):
        for _ in range(DP_EAGER):
            out = exe.run(compiled, feed=feed, fetch_list=[loss])
            eager.append(float(np.asarray(out[0]).reshape(-1)[0]))
            count()
        first = exe.run_steps(compiled, feed=stacked, fetch_list=[loss])[0]
        count()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        second = exe.run_steps(compiled, feed=stacked, fetch_list=[loss])[0]
        torch.cuda.synchronize()
        replay_ms = (time.perf_counter() - t0) * 1e3 / DP_K
        count()
    stats = exe.cache_stats()
    exe.close()
    record_wide("dp_nccl", read_wide(attn))
    replayed = np.concatenate([np.asarray(first, np.float32).reshape(-1),
                               np.asarray(second, np.float32).reshape(-1)])
    got = np.concatenate([np.asarray(eager, np.float32), replayed])
    if not np.array_equal(got, np.asarray(plain, np.float32)):
        raise AssertionError(f"NCCL world 1: losses {got.tolist()} against "
                             f"the plain Executor's {plain}")
    for i in range(DP_EAGER):
        dp_check_launches(f"NCCL eager step {i}", launches[i], by_dtype[i],
                          want)
        check_equal(f"NCCL eager step {i} collective calls", calls[i],
                    {**step_calls, "broadcast": start_broadcasts}
                    if i == 0 else step_calls)
    dp_check_launches("NCCL run_steps capturing call", launches[DP_EAGER],
                      by_dtype[DP_EAGER], {k: 2 * v for k, v in want.items()})
    check_equal("NCCL run_steps capturing call collective calls",
                calls[DP_EAGER], {k: 2 * v for k, v in step_calls.items()})
    check_equal("NCCL run_steps replaying call collective calls",
                calls[DP_EAGER + 1], {})
    check_equal("NCCL run_steps captures", stats["traces"], 1)
    res = {"config": f"bert-base pretrain at {DIST_LAYERS} layers, fleet "
                     "amp (bf16) + Adam 1e-4, "
                     "flash + fused CE, CompiledProgram under NCCL, world "
                     "size 1", "batch": TRAIN_BATCH,
           "eager_losses": eager, "replayed_losses": replayed.tolist(),
           "plain_losses": plain, "bitwise_equal": True,
           "replayed_step_ms": replay_ms,
           "phase6_replayed_amp_step_ms": GRAPH_STEP_MS.get("amp"),
           "plain_eager_step_ms": plain_ms,
           "collective_calls": {"eager_steps": calls[:DP_EAGER],
                                "capturing_call": calls[DP_EAGER],
                                "replaying_call": calls[DP_EAGER + 1]},
           "launches_per_eager_step": launches[DP_EAGER - 1],
           "launches_in_capturing_call": launches[DP_EAGER],
           "cache_stats": stats}
    log({"phase": "dp_nccl", **res})
    at_start = {"philox_at_start": philox}
    return res, {
        "static_nccl_eager_step": {"launches": launches[DP_EAGER - 1],
                                   "by_dtype": by_dtype[DP_EAGER - 1],
                                   **at_start},
        "static_nccl_capturing_call": {"launches": launches[DP_EAGER],
                                       "by_dtype": by_dtype[DP_EAGER],
                                       **at_start}}


# phase 14: ZeRO stages 1-3 (strategy.sharding) and Megatron tensor
# parallelism (models/static_lm.py at tensor_parallel_degree 2) over
# torch.distributed
# (tag, ZeRO stage, gradient-merge k) of (a)'s runs
ZT_STAGES = (("stage1", 1, 1), ("stage2_gm2", 2, 2), ("stage3", 3, 1))
TP_DEGREE = 2
# (b) against the tp = 1 program of the same weights in one process.  The
# tp step sums each row-parallel product's two bf16 halves (each rounded
# to bf16 before the sum) where tp = 1 rounds one product once, so step
# 1's loss may differ by a few bf16 roundings averaged over 4096 tokens:
# 1e-3 of the loss.  The update gap is phase 13's static tolerance: Adam
# moves each element by about lr whatever its gradient's size, and bf16
# noise flips the tiny gradients' steps either way
TP_LOSS_RTOL = 1e-3
TP_UPDATE_TOL = DP_UPDATE_TOL["static"]
# op types whose calls a step makes on a process group (COMM_STATS
# "calls_by_op"), counted in the rewritten program
ZT_COMM_OPS = ("c_reducescatter", "c_allgather", "c_allreduce_sum",
               "mp_allreduce_sum", "c_identity_grad")


def zt_program(stage, gm):
    """bench.py's step through fleet as dp_program, with strategy.sharding
    at ZeRO `stage` for DP_RANKS ranks (and gradient merge over `gm`
    steps).  Returns (main, startup, loss, fleet.main_program)."""
    import paddle_tpu_torch.distributed.fleet as fleet

    def outer(static, opt):
        fleet.init(is_collective=True)
        strategy = fleet.DistributedStrategy()
        strategy.amp = True
        strategy.amp_configs.update(DP_AMP)
        strategy.sharding = True
        strategy.sharding_configs = {"stage": stage, "dp_degree": DP_RANKS}
        if gm > 1:
            strategy.gradient_merge = True
            strategy.gradient_merge_configs = {"k_steps": gm, "avg": True}
        return fleet.distributed_optimizer(opt, strategy)
    import warnings
    with warnings.catch_warnings():
        # under AMP gradient merge keeps full-size accumulators (the
        # buckets read the unscaled gradients), as the JAX package does
        warnings.simplefilter("ignore", RuntimeWarning)
        main, startup, loss, _ = bench_program(lambda s: s.Adam(1e-4),
                                               use_amp=False, outer=outer,
                                               layers_n=DIST_LAYERS)
    want = ["AMPOptimizer", "ShardingOptimizer"] + (
        ["GradientMergeOptimizer"] if gm > 1 else []) + \
        ["GraphExecutionOptimizer"]
    check_equal("fleet meta-optimizers", fleet.applied_meta_list(), want)
    if not main._zero_shard_plan.buckets:
        raise AssertionError(f"ZeRO stage {stage}: nothing was sharded")
    return main, startup, loss, fleet.main_program


def zt_tp_program(tp):
    """models.build_transformer_lm at bench.py's BERT-base width and
    `tensor_parallel_degree` tp, flash on, AMP bf16 (the bench's loss
    scale), Adam 1e-4.  Returns (main, startup, loss, parameters in
    creation order)."""
    from paddle_tpu_torch import amp, static
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.models import build_transformer_lm
    from paddle_tpu_torch.ops import attention as attn
    attn.enable_flash_attention(True)
    try:
        _reset_unique_names()
        main, startup, loss, _ = build_transformer_lm(
            BERT["vocab"], BERT["hidden"], DIST_LAYERS, BERT["heads"],
            BERT["seq"], tensor_parallel_degree=tp)
        with static.program_guard(main, startup):
            amp.decorate(static.Adam(1e-4), init_loss_scaling=1.0,
                         use_dynamic_loss_scaling=False,
                         dest_dtype="bfloat16").minimize(loss)
    finally:
        attn._FLASH_STATE["mode"] = "auto"
    return main, startup, loss, [p.name for p in main.all_parameters()]


def zt_tp_names(m1, m2):
    """{tp = 2 parameter: tp = 1 parameter} of the two builds' programs:
    they create their parameters in the same order at the same global
    shapes."""
    p1, p2 = m1.all_parameters(), m2.all_parameters()
    if [tuple(p.shape) for p in p1] != [tuple(p.shape) for p in p2]:
        raise AssertionError("tp = 1 and tp = 2 parameters differ in shape")
    return {b.name: a.name for a, b in zip(p1, p2)}


def zt_program_comms(compiled):
    """The collective ops of the program each rank runs, by ZT_COMM_OPS
    type (the calls a step makes)."""
    ops = compiled._get_program().global_block().ops
    got = {t: sum(op.type == t for op in ops) for t in ZT_COMM_OPS}
    return {t: n for t, n in got.items() if n}


def zt_scope_bytes(scope, plan):
    """This rank's bytes of the optimizer slots and (stage 3) the
    parameter buckets, beside the unsharded program's (each parameter's
    own moments, the parameters themselves) and the padded global
    buckets'."""
    def held(names):
        return sum(scope.vars[n].numel() * scope.vars[n].element_size()
                   for n in names)
    slots = [n for b in plan.buckets for n in b["slots"].values()]
    n_slots = {b["name"]: len(b["slots"]) for b in plan.buckets}
    # a bucket pads fewer than dp_degree elements
    pad = 4 * (plan.dp_degree - 1)
    out = {"slots_rank": held(slots),
           "slots_pad_max": sum(pad * n_slots[b["name"]]
                                for b in plan.buckets),
           "slots_unsharded": sum(4 * b["raw_len"] * n_slots[b["name"]]
                                  for b in plan.buckets),
           "slots_global_padded": sum(4 * b["padded_len"] *
                                      n_slots[b["name"]]
                                      for b in plan.buckets),
           "scope_rank": sum(t.numel() * t.element_size()
                             for t in scope.vars.values() if t is not None)}
    pb = plan.param_bucket_names()
    if pb:
        packed = [b for b in plan.buckets if b.get("param_bucket")]
        out.update(params_rank=held(pb),
                   params_pad_max=pad * len(packed),
                   params_unsharded=sum(4 * b["raw_len"] for b in packed),
                   params_global_padded=sum(4 * b["padded_len"]
                                            for b in packed))
    return out


def zt_check_bytes(tag, got, world):
    """A rank's shard of each sharded surface: 1/world of the padded
    global buckets, and the padding under world elements a bucket."""
    for kind in ("slots", "params"):
        if kind + "_rank" not in got:
            continue
        rank, padded = got[kind + "_rank"], got[kind + "_global_padded"]
        unsharded = got[kind + "_unsharded"]
        if rank * world != padded or not 0 <= padded - unsharded <= \
                got[kind + "_pad_max"]:
            raise AssertionError(
                f"{tag}: a rank holds {rank} bytes of {kind}, the padded "
                f"global buckets {padded}, the unsharded {unsharded}")


def zt_rank(seed, out_dir):
    """One rank of phase 14 (a) and (b) (a `spawn` worker): a gloo
    process group; (a) each ZT_STAGES run, sound and with a planted fault;
    (b) the tp = 2 language model.  Writes rank<r>.json and, on rank 0,
    the gathered parameters after each run."""
    import torch
    import torch.distributed as tdist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.core import kernel_build
    kernel_build.build_libraries(KERNEL_SOURCES)  # the parent built them
    env = pdist.init_parallel_env(backend="gloo")
    try:
        torch.cuda.set_device(env.device_id)
        res = {"rank": env.rank, "world": env.world_size, "zero": {}}
        for tag, stage, gm in ZT_STAGES:
            res["zero"][tag] = zt_zero_rank(torch, seed, env.rank, out_dir,
                                            tag, stage, gm)
            torch.cuda.empty_cache()
        res["tp"] = zt_tp_rank(torch, seed, env.rank, out_dir)
    finally:
        tdist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{env.rank}.json"), "w") as f:
        json.dump(res, f)


def zt_zero_rank(torch, seed, rank, out_dir, tag, stage, gm):
    """(a) on one rank at one stage: a sound run, then one with rank 1's
    gradient buckets zeroed before their reduce-scatter; rank 0 saves the
    gathered parameters (stage 3: the parameter buckets) after each."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import fused_xent as fx
    from paddle_tpu_torch.ops import random as rnd
    fx.enable_fused_xent(True)
    try:
        main, startup, loss, compiled = zt_program(stage, gm)
        plan = main._zero_shard_plan
        names = plan.param_bucket_names() if stage == 3 else \
            [p.name for p in main.all_parameters()]
        counters = dp_counters(attn, dr, fx, rnd)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_wide(attn)
        out = {}
        for run in ("sound", "fault"):
            out[run], scope = zt_run(
                torch, static, compiled, startup, loss, seed, rank,
                counters, fault=run == "fault" and rank == 1)
            if run == "sound":
                out["bytes"] = zt_scope_bytes(scope, plan)
            got = compiled.global_state(scope, names)
            if rank == 0:
                torch.save({n: t.cpu() for n, t in got.items()},
                           os.path.join(out_dir, f"zero_{tag}_{run}.pt"))
            del scope, got
        torch.cuda.synchronize()
        out.update(wide=read_wide(attn),
                   peak_gpu_mem_gb=torch.cuda.max_memory_allocated()
                   / 2 ** 30,
                   buckets=len(plan.buckets),
                   param_buckets=len(plan.param_bucket_names()),
                   program_comms=zt_program_comms(compiled))
    finally:
        fx.enable_fused_xent(False)
    return out


def zt_run(torch, static, compiled, startup, loss, seed, rank, counters,
           fault=False, feed=None, steps=DP_STEPS, carry=None):
    """`steps` Executor.run steps of `compiled` on the global batch from a
    fresh scope (startup random_seed seed + rank; `carry(scope)` then
    writes the start), after each: the launches, the collective calls by
    op and whether the ranks' replicated state (after the last step their
    whole gathered global state) is bitwise equal (but for gradient
    merge's full-size accumulators, which hold the rank's own
    gradients).  `fault`: this rank's gradient buckets are zeroed
    before their reduce-scatter (the c_reducescatter kernel wrapped).
    Returns (the record, the scope)."""
    from paddle_tpu_torch.ops.kernels import collective as kc
    from paddle_tpu_torch.ops.registry import get_op_info
    feed = feed if feed is not None else train_feed(seed)
    startup.random_seed = seed + rank
    exe, scope = static.Executor(), static.Scope()
    dp_zero(counters)
    with static.scope_guard(scope):
        exe.run(startup)
        if carry is not None:
            carry(scope)
    torch.cuda.synchronize()
    rec = {"philox_at_start": counters["philox_random"].launches,
           "losses": [], "step_ms": [], "launches": [],
           "launches_by_dtype": [], "collective_calls": [],
           "state_tensors_differing_after_each_step": []}
    # gradient merge's full-size accumulators hold each rank's own
    # gradients until the commit reduces them (as under plain data
    # parallel): every other persistable is compared across the ranks
    program = compiled._get_program()
    gm = getattr(program, "_gm_meta", None) or {}
    local = {n for n in gm.get("accs", ())
             if not program.global_block().var(n).attrs.get("dp_shard")}
    rec["rank_local_accumulators"] = len(local)
    from paddle_tpu_torch.static.executor import _persistable_names
    names = [n for n in _persistable_names(program)
             if scope.get(n) is not None]
    replicated = [n for n, p in compiled._placements(names).items()
                  if p == "replicated"]
    info = get_op_info("c_reducescatter")
    kernel = info.kernel
    if fault:
        info.kernel = lambda ins, attrs, ctx: kernel(
            {**ins, "X": torch.zeros_like(ins["X"])}, attrs, ctx)
    try:
        with static.scope_guard(scope):
            for step in range(steps):
                dp_zero(counters)
                kc.reset_comm_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = exe.run(compiled, feed=feed, fetch_list=[loss])
                torch.cuda.synchronize()
                rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
                rec["collective_calls"].append(
                    dict(kc.COMM_STATS["calls_by_op"]))
                launches, by_dtype = dp_read(counters)
                rec["launches"].append(launches)
                rec["launches_by_dtype"].append(by_dtype)
                rec["losses"].append(float(np.asarray(out[0]).reshape(-1)[0]))
                # a gathered shard is the same on every rank by the
                # all-gather; what may differ is the replicated state, so
                # it is compared after every step and the whole gathered
                # state after the last
                state = compiled.global_state(
                    scope, replicated if step < steps - 1 else None)
                rec["state_tensors_differing_after_each_step"].append(
                    dp_tensors_differing(torch, [
                        t for n, t in state.items() if n not in local]))
                del state
    finally:
        info.kernel = kernel
    return rec, scope


def zt_tp_rank(torch, seed, rank, out_dir):
    """(b) on one rank: the tp = 2 language model from the tp = 1
    program's startup (random_seed = seed), carried in through the
    CompiledProgram's placement, DP_STEPS steps of the global batch;
    after each the replicated parameters compared bitwise across the
    ranks (zt_run's gathered state too).  Rank 0 saves the gathered
    parameters under their tp = 1 names."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.distributed.compiled_program import (
        CompiledProgram, BuildStrategy)
    from paddle_tpu_torch.io import load_params_from_numpy
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import fused_xent as fx
    from paddle_tpu_torch.ops import random as rnd
    main1, startup1, _, _ = zt_tp_program(1)
    main, startup, loss, params = zt_tp_program(TP_DEGREE)
    to_tp1 = zt_tp_names(main1, main)
    counters = dp_counters(attn, dr, fx, rnd)
    init1, _, _ = startup_weights(torch, static, rnd, startup1, seed)
    params1 = {n: init1[n] for n in to_tp1.values()}
    del init1, main1, startup1
    bs = BuildStrategy()
    bs.tensor_parallel_degree = TP_DEGREE
    compiled = CompiledProgram(main, bs).with_data_parallel(
        loss_name=loss.name)

    def carry(scope):
        load_params_from_numpy(scope, {n: params1[to_tp1[n]]
                                       for n in params},
                               compiled=compiled)
    fx.enable_fused_xent(True)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_wide(attn)
        rec, scope = zt_run(torch, static, compiled, startup, loss, seed,
                            rank, counters, carry=carry)
        sharded = [n for n in params
                   if main.global_block().var(n).attrs.get("dist_attr")]
        replicated = [n for n in params if n not in sharded]
        rec["replicated_differing"] = dp_tensors_differing(
            torch, [scope.vars[n] for n in replicated])
        rec["sharded_bytes"] = {
            n: [scope.vars[n].numel() * scope.vars[n].element_size(),
                int(np.prod(main.global_block().var(n).shape)) * 4]
            for n in sharded}
        got = compiled.global_state(scope, params)
        if rank == 0:
            torch.save({to_tp1[n]: t.cpu() for n, t in got.items()},
                       os.path.join(out_dir, "tp_sound.pt"))
        torch.cuda.synchronize()
        rec.update(wide=read_wide(attn),
                   peak_gpu_mem_gb=torch.cuda.max_memory_allocated()
                   / 2 ** 30,
                   program_comms=zt_program_comms(compiled),
                   n_sharded=len(sharded), n_replicated=len(replicated))
    finally:
        fx.enable_fused_xent(False)
    return rec


def zt_phase(torch, seed):
    """(14) ZeRO and tensor parallelism at BERT-base width, global batch
    TRAIN_BATCH, on DP_RANKS gloo ranks sharing the card: (a) each
    ZT_STAGES run and (b) the tp = 2 language model against one process;
    (c) the stage-3 step under NCCL at world 1, eager then run_steps.
    Returns the records, with each path's launches."""
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import fused_xent as fx
    from paddle_tpu_torch.ops import random as rnd
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_zt_")
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        pdist.spawn(zt_rank, args=(seed, tmp), nprocs=DP_RANKS,
                    selected_devices=",".join(["0"] * DP_RANKS))
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(DP_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        zero = {tag: zt_zero_check(torch, static, fx, rnd, seed, tmp, ranks,
                                   tag, stage, gm)
                for tag, stage, gm in ZT_STAGES}
        tp = zt_tp_check(torch, static, fx, rnd, seed, tmp, ranks)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    peaks = {tag: max(r["zero"][tag]["peak_gpu_mem_gb"] for r in ranks)
             for tag, _, _ in ZT_STAGES}
    if not peaks["stage3"] < peaks["stage1"]:
        raise AssertionError(f"ZeRO per-rank peak memory: stage 3 "
                             f"{peaks['stage3']} GB is not below stage 1 "
                             f"{peaks['stage1']} GB")
    nccl, nccl_launches = zt_nccl(torch, static, attn, dr, fx, rnd, seed)
    for r in ranks:
        for tag, _, _ in ZT_STAGES:
            record_wide(f"zero_{tag}_rank{r['rank']}",
                        r["zero"][tag]["wide"])
        record_wide(f"tp_rank{r['rank']}", r["tp"]["wide"])
    r0 = ranks[0]
    launches = {f"zero_{tag}_gloo_{run}": dp_path_launches(
        r0["zero"][tag][run]) for tag, _, _ in ZT_STAGES
        for run in ("sound", "fault")}
    launches["tp2_gloo"] = dp_path_launches(r0["tp"])
    launches.update(nccl_launches)
    seconds = time.perf_counter() - t_phase
    log({"phase": "zero_tp", "ranks_process_s": spawn_s,
         "peak_gpu_mem_gb_by_stage": peaks, "seconds": seconds})
    return {"zero": zero, "tp": tp, "nccl": nccl, "launches": launches,
            "seconds": seconds}


def zt_gate(torch, tag, tmp, kind, before, want, losses, ref_losses,
            loss_rtol, update_tol, runs=("sound", "fault")):
    """A sound run within `loss_rtol` (step 1's loss) and `update_tol`
    (the update gap) of one process, and a planted fault's gap above the
    latter.  Returns (step 1's relative loss difference, {run: (gap, max
    abs difference)})."""
    gaps = {run: dp_update_gap(torch, before, torch.load(
        os.path.join(tmp, f"{kind}_{run}.pt")), want) for run in runs}
    rel = abs(losses[0] - ref_losses[0]) / abs(ref_losses[0])
    bad = not np.isfinite(losses).all() or not rel <= loss_rtol or \
        not gaps["sound"][0] <= update_tol
    if "fault" in gaps and not gaps["fault"][0] > update_tol:
        bad = True
    if bad:
        raise AssertionError(
            f"{tag} against one process: losses {losses} / {ref_losses} "
            f"(step 1 rel {rel}, tolerance {loss_rtol}), update gaps "
            f"{gaps} (tolerance {update_tol}; a planted fault's must "
            "exceed it)")
    return rel, gaps


def zt_check_ranks(tag, ranks, get, comms, want_launches, at_start):
    """One two-rank run's records (`get(rank's json)`): the gathered state
    equal on the ranks after each step, the same losses, the random
    kernel's launches at the start, each step's launches and its
    collective calls by op as the program holds (`comms(rank's json)`)."""
    for r in ranks:
        rec = get(r)
        check_equal(f"{tag} rank {r['rank']} philox_random launches at "
                    "the start", rec["philox_at_start"], at_start)
        if any(rec["state_tensors_differing_after_each_step"]):
            raise AssertionError(
                f"{tag}: the ranks' gathered state differs after a step: "
                f"{rec['state_tensors_differing_after_each_step']}")
        for i, (got, by_dtype, c) in enumerate(zip(
                rec["launches"], rec["launches_by_dtype"],
                rec["collective_calls"])):
            step = f"{tag} rank {r['rank']} step {i}"
            dp_check_launches(step, got, by_dtype, want_launches)
            check_equal(f"{step} collective calls by op", c, comms(r))
    if [get(r)["losses"] for r in ranks][1:] != \
            [get(ranks[0])["losses"]] * (len(ranks) - 1):
        raise AssertionError(f"{tag}: the ranks fetched different losses")


def zt_zero_check(torch, static, fx, rnd, seed, tmp, ranks, tag, stage, gm):
    """(a) gated at one stage: each run's records and scope bytes, then
    the sound run and the fault against one process: the same sharded
    program with no process group (every collective the identity, the
    shard the whole bucket), DP_STEPS Executor.run steps from the
    startup of --seed (rank 0's)."""
    main, startup, loss, compiled = zt_program(stage, gm)
    n_random = sum(op.type in ("uniform_random", "gaussian_random")
                   for op in startup.global_block().ops)
    for run in ("sound", "fault"):
        zt_check_ranks(f"ZeRO {tag} ({run})", ranks,
                       lambda r: r["zero"][tag][run],
                       lambda r: r["zero"][tag]["program_comms"],
                       dp_want(), n_random)
    for r in ranks:
        zt_check_bytes(f"ZeRO {tag} rank {r['rank']}",
                       r["zero"][tag]["bytes"], DP_RANKS)
    plan = main._zero_shard_plan
    names = plan.param_bucket_names() if stage == 3 else \
        [p.name for p in main.all_parameters()]
    fx.enable_fused_xent(True)
    try:
        init, _, _ = startup_weights(torch, static, rnd, startup, seed)
        losses, scope, ms, _ = eager_run(torch, static, compiled._program,
                                         loss, init, train_feed(seed),
                                         DP_STEPS)
    finally:
        fx.enable_fused_xent(False)
    want = {n: scope.vars[n] for n in names}
    before = {n: init[n] for n in names}
    dp = ranks[0]["zero"][tag]["sound"]
    rel, gaps = zt_gate(torch, f"ZeRO {tag}", tmp, f"zero_{tag}", before,
                        want, dp["losses"], losses, DP_LOSS_RTOL["static"],
                        DP_UPDATE_TOL["static"])
    res = {"config": f"bert-base pretrain at {DIST_LAYERS} layers, fleet "
                     "amp (bf16) + sharding "
                     f"(ZeRO stage {stage}"
                     + (f", gradient merge k = {gm}" if gm > 1 else "")
                     + f") + Adam 1e-4, flash + fused CE, {DP_RANKS} gloo "
                     "ranks on one card",
           "global_batch": TRAIN_BATCH, "losses": dp["losses"],
           "single_process_losses": losses, "step1_loss_rel_diff": rel,
           "update_gap": gaps["sound"][0],
           "param_max_abs_diff": gaps["sound"][1],
           "fault_losses": ranks[0]["zero"][tag]["fault"]["losses"],
           "fault_update_gap": gaps["fault"][0],
           "single_process_step_ms": ms,
           "step_ms_by_rank": [r["zero"][tag]["sound"]["step_ms"]
                               for r in ranks],
           "buckets": ranks[0]["zero"][tag]["buckets"],
           "param_buckets": ranks[0]["zero"][tag]["param_buckets"],
           "collective_calls_per_step_by_op":
               ranks[0]["zero"][tag]["program_comms"],
           "bytes_by_rank": [r["zero"][tag]["bytes"] for r in ranks],
           "peak_gpu_mem_gb_by_rank": [r["zero"][tag]["peak_gpu_mem_gb"]
                                       for r in ranks],
           "launches_per_step": dp["launches"][-1],
           "ranks_state_bitwise_equal": "replicated after each step, gathered after the last"}
    log({"phase": f"zero_{tag}", **res})
    return res


def zt_tp_check(torch, static, fx, rnd, seed, tmp, ranks):
    """(b) gated: the records (launches, collective calls, the ranks'
    gathered state and replicated parameters bitwise equal, each sharded
    weight's bytes halved), then against the tp = 1 program of the same
    weights in one process, DP_STEPS steps of the global batch."""
    main1, startup1, loss1, params1 = zt_tp_program(1)
    n_random = sum(op.type in ("uniform_random", "gaussian_random")
                   for op in zt_tp_program(TP_DEGREE)[1].global_block().ops)
    zt_check_ranks("tensor parallel", ranks, lambda r: r["tp"],
                   lambda r: r["tp"]["program_comms"], dp_want(), n_random)
    for r in ranks:
        rec = r["tp"]
        if rec["replicated_differing"]:
            raise AssertionError(f"tensor parallel rank {r['rank']}: "
                                 f"{rec['replicated_differing']} replicated "
                                 "parameters differ across the ranks")
        for n, (held, whole) in rec["sharded_bytes"].items():
            if held * TP_DEGREE != whole:
                raise AssertionError(f"tensor parallel rank {r['rank']}: "
                                     f"{n} holds {held} of {whole} bytes")
    fx.enable_fused_xent(True)
    try:
        init, _, _ = startup_weights(torch, static, rnd, startup1, seed)
        losses, scope, ms, _ = eager_run(torch, static, main1, loss1, init,
                                         train_feed(seed), DP_STEPS)
    finally:
        fx.enable_fused_xent(False)
    want = {n: scope.vars[n] for n in params1}
    before = {n: init[n] for n in params1}
    tp = ranks[0]["tp"]
    rel, gaps = zt_gate(torch, "tensor parallel", tmp, "tp", before, want,
                        tp["losses"], losses, TP_LOSS_RTOL, TP_UPDATE_TOL,
                        runs=("sound",))
    res = {"config": f"models.build_transformer_lm(30522, 768, "
                     f"{DIST_LAYERS}, 12, 512, "
                     f"tensor_parallel_degree={TP_DEGREE}), AMP bf16 + Adam "
                     "1e-4, flash + fused CE, 2 gloo ranks on one card, "
                     "weights carried from the tp = 1 program",
           "global_batch": TRAIN_BATCH, "losses": tp["losses"],
           "tp1_single_process_losses": losses, "step1_loss_rel_diff": rel,
           "loss_rtol": TP_LOSS_RTOL, "update_gap": gaps["sound"][0],
           "update_tol": TP_UPDATE_TOL,
           "param_max_abs_diff": gaps["sound"][1],
           "tp1_single_process_step_ms": ms,
           "step_ms_by_rank": [r["tp"]["step_ms"] for r in ranks],
           "collective_calls_per_step_by_op": tp["program_comms"],
           "sharded_weights": tp["n_sharded"],
           "replicated_parameters": tp["n_replicated"],
           "sharded_bytes_rank0_of_whole": sum(
               h for h, _ in tp["sharded_bytes"].values()) / sum(
               w for _, w in tp["sharded_bytes"].values()),
           "peak_gpu_mem_gb_by_rank": [r["tp"]["peak_gpu_mem_gb"]
                                       for r in ranks],
           "launches_per_step": tp["launches"][-1],
           "ranks_state_bitwise_equal": "replicated after each step, gathered after the last"}
    log({"phase": "tp", **res})
    return res


def zt_nccl(torch, static, attn, dr, fx, rnd, seed):
    """(c) the stage-3 step under NCCL at world 1 in this process: DP_EAGER
    eager Executor.run steps and two run_steps calls of K = DP_K (the
    first captures one CUDA graph of the step, its reduce-scatters and
    all-gathers included, the second replays it) against DP_EAGER + 2
    DP_K plain Executor steps of the same program from the same weights:
    every loss equal to the last bit.  The collectives reach the NCCL
    group: each eager step, and the capturing call's warm-up and captured
    step, call one reduce-scatter a bucket, one all-gather a bucket and
    phase, and one allreduce for the loss fetch (the first step also the
    start broadcast); the replaying call calls none."""
    import torch.distributed as tdist
    from paddle_tpu_torch.distributed.spawn import get_free_ports
    from paddle_tpu_torch.ops.kernels import collective as kc
    from paddle_tpu_torch.static.executor import _persistable_names
    port = get_free_ports(1)[0]
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=1, rank=0)
    fx.enable_fused_xent(True)
    try:
        check_equal("NCCL world 1 backend",
                    tdist.get_backend(kc.ring_group(0)), "nccl")
        main, startup, loss, compiled = zt_program(3, 1)
        init, philox, _ = startup_weights(torch, static, rnd, startup, seed)
        feed = train_feed(seed)
        n = DP_EAGER + 2 * DP_K
        plain, _, plain_ms, _ = eager_run(torch, static, compiled._program,
                                          loss, init, feed, n)
        ops = compiled._get_program().global_block().ops
        kinds = {"c_reducescatter": "reduce_scatter",
                 "c_allgather": "all_gather", "c_allreduce_sum": "all_reduce"}
        step_calls = {}
        for op in ops:
            if op.type in kinds:
                k = kinds[op.type]
                step_calls[k] = step_calls.get(k, 0) + 1
        step_calls["all_reduce"] = step_calls.get("all_reduce", 0) + 1
        counters = dp_counters(attn, dr, fx, rnd)
        want = dp_want()
        exe = static.Executor()
        scope = scope_of(static, init)
        start_broadcasts = sum(scope.get(v) is not None for v in
                               _persistable_names(compiled._get_program()))
        stacked = {k: np.stack([v] * DP_K) for k, v in feed.items()}
        eager, calls, launches, by_dtype = [], [], [], []

        def count():
            got, dt = dp_read(counters)
            launches.append(got)
            by_dtype.append(dt)
            calls.append(dict(kc.COMM_STATS["calls_by_kind"]))
            dp_zero(counters)
            kc.reset_comm_stats()
        zero_wide(attn)
        dp_zero(counters)
        kc.reset_comm_stats()
        with static.scope_guard(scope):
            for _ in range(DP_EAGER):
                out = exe.run(compiled, feed=feed, fetch_list=[loss])
                eager.append(float(np.asarray(out[0]).reshape(-1)[0]))
                count()
            first = exe.run_steps(compiled, feed=stacked,
                                  fetch_list=[loss])[0]
            count()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            second = exe.run_steps(compiled, feed=stacked,
                                   fetch_list=[loss])[0]
            torch.cuda.synchronize()
            replay_ms = (time.perf_counter() - t0) * 1e3 / DP_K
            count()
        stats = exe.cache_stats()
        exe.close()
        record_wide("zero_nccl", read_wide(attn))
    finally:
        fx.enable_fused_xent(False)
        tdist.destroy_process_group()
    replayed = np.concatenate([np.asarray(first, np.float32).reshape(-1),
                               np.asarray(second, np.float32).reshape(-1)])
    got = np.concatenate([np.asarray(eager, np.float32), replayed])
    if not np.array_equal(got, np.asarray(plain, np.float32)):
        raise AssertionError(f"ZeRO-3 NCCL world 1: losses {got.tolist()} "
                             f"against the plain Executor's {plain}")
    for i in range(DP_EAGER):
        dp_check_launches(f"ZeRO-3 NCCL eager step {i}", launches[i],
                          by_dtype[i], want)
        check_equal(f"ZeRO-3 NCCL eager step {i} collective calls",
                    calls[i], {**step_calls, "broadcast": start_broadcasts}
                    if i == 0 else step_calls)
    dp_check_launches("ZeRO-3 NCCL run_steps capturing call",
                      launches[DP_EAGER], by_dtype[DP_EAGER],
                      {k: 2 * v for k, v in want.items()})
    check_equal("ZeRO-3 NCCL run_steps capturing call collective calls",
                calls[DP_EAGER], {k: 2 * v for k, v in step_calls.items()})
    check_equal("ZeRO-3 NCCL run_steps replaying call collective calls",
                calls[DP_EAGER + 1], {})
    check_equal("ZeRO-3 NCCL run_steps captures", stats["traces"], 1)
    res = {"config": f"bert-base pretrain at {DIST_LAYERS} layers, fleet "
                     "amp (bf16) + sharding (ZeRO "
                     f"stage 3, dp_degree {DP_RANKS}) + Adam 1e-4, flash + "
                     "fused CE, CompiledProgram under NCCL, world size 1",
           "batch": TRAIN_BATCH, "eager_losses": eager,
           "replayed_losses": replayed.tolist(), "plain_losses": plain,
           "bitwise_equal": True, "replayed_step_ms": replay_ms,
           "plain_eager_step_ms": plain_ms,
           "collective_calls": {"eager_steps": calls[:DP_EAGER],
                                "capturing_call": calls[DP_EAGER],
                                "replaying_call": calls[DP_EAGER + 1]},
           "launches_per_eager_step": launches[DP_EAGER - 1],
           "launches_in_capturing_call": launches[DP_EAGER],
           "cache_stats": stats}
    log({"phase": "zero_nccl", **res})
    at_start = {"philox_at_start": philox}
    return res, {
        "zero3_nccl_eager_step": {"launches": launches[DP_EAGER - 1],
                                  "by_dtype": by_dtype[DP_EAGER - 1],
                                  **at_start},
        "zero3_nccl_capturing_call": {"launches": launches[DP_EAGER],
                                      "by_dtype": by_dtype[DP_EAGER],
                                      **at_start}}



# phase 15: the remaining parallel axes over torch.distributed: tp-sharded
# /generate, sequence parallelism (ring attention), expert parallelism
# (switch MoE) and the gradient-merge commit hoist
PX_RANKS = 2            # gloo ranks on the one card, as phases 13-14
PX_TP = 2               # (a)'s tensor-parallel degree
PX_POSTS = 4            # (a) phase 7's first posts ...
PX_NEW = 8              # ... with 8 new tokens each
# (a): (variant, weight dtype, speculative) of the tp = 2 engine's runs.
# The stamp accepts every proposal (a random GPT-2 is a copy model, see
# generate_spec), so "own", a draft of its own weights, drives the
# rejections and the rollback (gated); its block weights are tripled
# (phase 7 doubles them over 16 posts of 64 new tokens) so that these
# few short posts meet rejections within PX_NEW tokens
PX_DRAFT_SCALE = 3.0
PX_TP_VARIANTS = (("plain", "float32", None), ("spec", "float32", "auto"),
                  ("spec_own", "float32", "own"), ("int8", "int8", None))
SPEC_COUNTERS = ("spec.proposed", "spec.accepted", "spec.rollback_cols")
SP_DEGREE = 2
SP_STEPS = 2            # (b)'s steps of each run and of its reference
# (b) against the same program in one process, where the ring op is one
# flash call: the ring merges two bf16 block outputs (each rounded to bf16
# before the merge) where one process rounds one output, so step 1's loss
# may move by a few bf16 roundings over 4096 tokens: phase 14's tp
# tolerance.  The update gap: Adam's sign noise on tiny gradients, which
# read 0.161 for phase 13's two-rank step on the card, so 0.3; a planted
# fault (rank 1's K block zeroed before its first send of every forward
# ring, the backward ring sending the true one) must land above it
SP_LOSS_RTOL = TP_LOSS_RTOL
SP_UPDATE_TOL = 0.3
# the flash-composed ring against the plain ring (the JAX step arithmetic)
# on the same inputs, max |kernel - plain| over max(1, max |plain|): bf16
# as the kernels against their plain versions (2e-2), plus the block
# outputs' and block gradients' bf16 rounding before the fp32 merge; fp32
# 3xTF32's
RING_TOL = {"bfloat16": 3e-2, "float32": 1e-4}
RING_SHAPE = (TRAIN_BATCH, BERT["heads"], BERT["seq"],
              BERT["hidden"] // BERT["heads"])
# (c) Switch-Base-8's widths (Fedus et al., "Switch Transformers", 2021)
# in a 4-layer static encoder block, tokens 8 x 512, fp32, Adam
SWITCH = dict(d_model=768, d_ff=3072, experts=8, capacity_factor=1.25,
              layers=4, heads=12, batch=8, seq=512, aux_weight=0.01)
EP_DEGREE = 2
EP_RING_ID = 7
EP_STEPS = 2
# against the dense run in one process: the MSE part of the loss is the
# mean of the ranks' means (equal token counts), the aux loss the mean of
# the ranks' aux losses, which is not the aux loss of all tokens (a mean of
# products of means), so step 1's loss 1e-3 and the aux loss 1e-2
# relative; the update gap as (b)'s (Adam)
EP_LOSS_RTOL = 1e-3
EP_AUX_RTOL = 1e-2
EP_UPDATE_TOL = DP_UPDATE_TOL["static"]
HOIST_K = 4             # (d) run_steps K, twice, over gradient merge k = 2


def px_ring_kernels(torch, attn):
    """The flash-composed ring (forward, dQ and dK/dV kernels with the
    global lse) against the plain ring, forward and backward, at the sp =
    2 shape of (b) (the global sequence cut in 1 and 2 blocks), causal and
    not, in bf16 and fp32.  The launches here compare and count nowhere."""
    from paddle_tpu_torch.ops.attention import (_ring_bwd_rank,
                                                _ring_fwd_rank, ring_blocks)
    res = {}
    gen = torch.Generator(device=CARD).manual_seed(15)
    scale = RING_SHAPE[3] ** -0.5
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, do = (torch.randn(RING_SHAPE, device=CARD,
                                   generator=gen).to(dt) for _ in range(4))
        for causal in (False, True):
            for n in (1, SP_DEGREE):
                sl = RING_SHAPE[2] // n

                def cut(t):
                    return [t[:, :, i * sl:(i + 1) * sl].contiguous()
                            for i in range(n)]

                def ring(kernels):
                    fw = ring_blocks([
                        _ring_fwd_rank(*b, i, n, causal, scale, kernels)
                        for i, b in enumerate(zip(cut(q), cut(k), cut(v)))])
                    bw = ring_blocks([
                        _ring_bwd_rank(*b, i, n, causal, scale, kernels)
                        for i, b in enumerate(zip(
                            cut(q), cut(k), cut(v), [o for o, _ in fw],
                            [lse for _, lse in fw], cut(do)))])
                    return [torch.cat([o for o, _ in fw], 2)] + [
                        torch.cat([g[j] for g in bw], 2) for j in range(3)]
                got, want = ring(True), ring(False)
                torch.cuda.synchronize()
                # max |kernel - plain| over max(1, max |plain|)
                errs = {name: float((a.float() - b.float()).abs().max()) /
                        max(1.0, float(b.float().abs().max()))
                        for name, a, b in zip(("out", "dq", "dk", "dv"),
                                              got, want)}
                tag = f"{dtype_name(dt)}_{'causal' if causal else 'full'}" \
                    f"_{n}block"
                if not max(errs.values()) <= RING_TOL[dtype_name(dt)] or \
                        not all(np.isfinite(list(errs.values()))):
                    raise AssertionError(
                        f"flash-composed ring {tag}: max abs errors {errs} "
                        f"against the plain ring (tolerance "
                        f"{RING_TOL[dtype_name(dt)]})")
                res[tag] = errs
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    sl = RING_SHAPE[2] // SP_DEGREE

    def fwd(kernels):
        return ring_blocks([
            _ring_fwd_rank(qb[:, :, i * sl:(i + 1) * sl],
                           kb[:, :, i * sl:(i + 1) * sl],
                           vb[:, :, i * sl:(i + 1) * sl], i, SP_DEGREE,
                           False, scale, kernels)
            for i in range(SP_DEGREE)])
    times = {"ring_fwd_bf16_2block_ms": cuda_time_ms(lambda: fwd(True), 3),
             "plain_ring_fwd_bf16_2block_ms":
                 cuda_time_ms(lambda: fwd(False), 3)}
    log({"phase": "parallel_axes_ring_kernels", "shape": list(RING_SHAPE),
         "tolerance_normalised": RING_TOL, "max_err_normalised": res,
         **times})
    return res


def px_counters():
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import fused_xent as fx
    from paddle_tpu_torch.ops import random as rnd
    return dp_counters(attn, dr, fx, rnd)


def px_sp_want(tag):
    """Launches of a rank-step of (b)'s program `tag`: each layer's ring
    forward runs SP_DEGREE flash forwards, and again in the gradient's
    replay; its backward ring SP_DEGREE dQ and dK/dV; 2 fused CE; all
    bf16."""
    n = px_sp_layers(tag) * SP_DEGREE
    return dict(zip(DP_COUNTED, (2 * n, n, n, 2, 0, 0)))


def px_bert_sp():
    """bench.py's AMP BERT-base step with use_ring (models
    .build_bert_pretrain(use_ring=True)): (main, startup, loss)."""
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.models import build_bert_pretrain
    _reset_unique_names()
    return build_bert_pretrain(BERT["vocab"], BERT["seq"], BERT["hidden"],
                               px_sp_layers("bert"), BERT["heads"],
                               TRAIN_BATCH, use_amp=True, use_ring=True)


def px_lm_sp():
    """models.build_transformer_lm(30522, 768, DIST_LAYERS, 12, 512,
    sequence_parallel=True) with AMP bf16 and Adam 1e-4: (main, startup,
    loss)."""
    from paddle_tpu_torch import amp, static
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.models import build_transformer_lm
    _reset_unique_names()
    main, startup, loss, _ = build_transformer_lm(
        BERT["vocab"], BERT["hidden"], px_sp_layers("lm"), BERT["heads"],
        BERT["seq"], sequence_parallel=True)
    with static.program_guard(main, startup):
        amp.decorate(static.Adam(1e-4), init_loss_scaling=1.0,
                     use_dynamic_loss_scaling=False,
                     dest_dtype="bfloat16").minimize(loss)
    return main, startup, loss


PX_SP_PROGRAMS = (("bert", px_bert_sp, ("sound", "fault")),
                  ("lm", px_lm_sp, ("sound",)))


def px_sp_layers(tag):
    """(b)'s depth: BERT at its 12 layers (at 4, its planted fault moved
    the update by 0.20, under the gate's 0.3: the gate needs the depth),
    the LM (no fault run) at DIST_LAYERS."""
    return BERT["layers_n"] if tag == "bert" else DIST_LAYERS


def px_zero_k_first_send(attn):
    """A planted fault on this rank: its K block zeroed before its first
    send of every forward ring (the ring generator wrapped)."""
    real = attn._ring_fwd_rank

    def faulty(q, k, v, me, n, causal, scale, flash):
        gen = real(q, k, v, me, n, causal, scale, flash)
        try:
            ks, vs = next(gen)
            wait = yield (ks.new_zeros(ks.shape), vs)
            out = gen.send(wait)
            while True:
                out = gen.send((yield out))
        except StopIteration as e:
            return e.value
    return faulty


def px_sp_rank(torch, seed, rank, out_dir):
    """(b) on one rank: each PX_SP_PROGRAMS program under a CompiledProgram
    with sequence_parallel_degree SP_DEGREE, SP_STEPS steps of the global
    batch (zt_run: launches, collective calls, the ranks' state), the K/V
    bytes this rank sent a step; rank 0 saves the gathered parameters."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.distributed.compiled_program import (
        BuildStrategy, CompiledProgram)
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import fused_xent as fx
    from paddle_tpu_torch.ops import random as rnd
    out = {}
    counters = px_counters()
    fx.enable_fused_xent(True)
    try:
        for tag, build, runs in PX_SP_PROGRAMS:
            main, startup, loss = build()
            bs = BuildStrategy()
            bs.sequence_parallel_degree = SP_DEGREE
            compiled = CompiledProgram(main, bs).with_data_parallel(
                loss_name=loss.name)
            params = [p.name for p in main.all_parameters()]
            out[tag] = {}
            for run in runs:
                real = attn._ring_fwd_rank
                if run == "fault" and rank == 1:
                    attn._ring_fwd_rank = px_zero_k_first_send(attn)
                zero_wide(attn)
                attn.RING_STATS.update(bytes_sent=0, steps=0)
                try:
                    rec, scope = zt_run(torch, static, compiled, startup,
                                        loss, seed, rank, counters,
                                        steps=SP_STEPS)
                finally:
                    attn._ring_fwd_rank = real
                rec["ring"] = {k: v / SP_STEPS
                               for k, v in attn.RING_STATS.items()}
                rec["wide"] = read_wide(attn)
                got = compiled.global_state(scope, params)
                if rank == 0:
                    torch.save({n: t.cpu() for n, t in got.items()},
                               os.path.join(out_dir, f"sp_{tag}_{run}.pt"))
                out[tag][run] = rec
                del scope, got
                torch.cuda.empty_cache()
            out[tag]["program_comms"] = zt_program_comms(compiled)
            out[tag]["philox_in_startup"] = sum(
                op.type in ("uniform_random", "gaussian_random")
                for op in startup.global_block().ops)
    finally:
        fx.enable_fused_xent(False)
    return out


def px_sp_check(torch, seed, tmp, ranks):
    """(b) gated: each run's records (launches px_sp_want(tag), the ranks'
    state bitwise equal, the same losses), then against the same program
    in one process (the ring op unbound: one flash call a layer), step 1's
    loss within SP_LOSS_RTOL and the update gap within SP_UPDATE_TOL, the
    fault's gap above."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops import fused_xent as fx
    from paddle_tpu_torch.ops import random as rnd
    out = {}
    for tag, build, runs in PX_SP_PROGRAMS:
        main, startup, loss = build()
        for run in runs:
            zt_check_ranks(f"sp {tag} ({run})", ranks,
                           lambda r: r["sp"][tag][run],
                           lambda r: r["sp"][tag]["program_comms"],
                           px_sp_want(tag),
                           ranks[0]["sp"][tag]["philox_in_startup"])
        params = [p.name for p in main.all_parameters()]
        fx.enable_fused_xent(True)
        try:
            init, _, _ = startup_weights(torch, static, rnd, startup, seed)
            losses, scope, ms, _ = eager_run(torch, static, main, loss,
                                             init, train_feed(seed),
                                             SP_STEPS)
        finally:
            fx.enable_fused_xent(False)
        want = {n: scope.vars[n] for n in params}
        before = {n: init[n] for n in params}
        sound = ranks[0]["sp"][tag]["sound"]
        rel, gaps = zt_gate(torch, f"sp {tag}", tmp, f"sp_{tag}", before,
                            want, sound["losses"], losses, SP_LOSS_RTOL,
                            SP_UPDATE_TOL, runs=runs)
        del init, scope, want, before
        res = {"config": ("bench.py's BERT-base AMP step with use_ring"
                          if tag == "bert" else
                          f"models.build_transformer_lm(30522, 768, "
                          f"{px_sp_layers('lm')}, 12, 512, "
                          "sequence_parallel=True), AMP bf16 + Adam 1e-4") +
                          f", global batch {TRAIN_BATCH}, sp "
                          f"{SP_DEGREE} x dp 1 on {PX_RANKS} gloo ranks, "
                          "flash + fused CE",
               "losses": sound["losses"], "single_process_losses": losses,
               "step1_loss_rel_diff": rel, "loss_rtol": SP_LOSS_RTOL,
               "update_gap": gaps["sound"][0],
               "update_tol": SP_UPDATE_TOL,
               "param_max_abs_diff": gaps["sound"][1],
               "rank_step_ms": [r["sp"][tag]["sound"]["step_ms"]
                                for r in ranks],
               "single_process_step_ms": ms,
               "kv_bytes_sent_per_rank_step": sound["ring"]["bytes_sent"],
               "ring_steps_per_rank_step": sound["ring"]["steps"],
               "collective_calls_per_step":
                   sound["collective_calls"][-1],
               "launches_per_rank_step": sound["launches"][-1]}
        if "fault" in gaps:
            res.update(fault_losses=ranks[0]["sp"][tag]["fault"]["losses"],
                       fault_update_gap=gaps["fault"][0])
        log({"phase": f"parallel_axes_sp_{tag}", **res})
        out[tag] = res
    return out


def px_moe_program():
    """A static encoder at SWITCH's widths: per layer pre-LN attention
    (q, k, v, out projections; the flash op) and a pre-LN switch_moe
    feed-forward (layers.switch_moe, its experts parallel over
    EP_RING_ID when that ring is bound), residuals; loss MSE against y
    plus aux_weight x the layers' aux losses; Adam 1e-4, fp32.  Returns
    (main, startup, loss, aux, the expert parameters)."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.static import layers, nets
    s = SWITCH
    attn.enable_flash_attention(True)
    try:
        _reset_unique_names()
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            x = layers.data("x", [-1, s["seq"], s["d_model"]])
            y = layers.data("y", [-1, s["seq"], s["d_model"]])
            h, aux = x, None
            for _ in range(s["layers"]):
                a = layers.layer_norm(h, begin_norm_axis=2)
                q, k, v = (layers.fc(a, s["d_model"], num_flatten_dims=2)
                           for _ in range(3))
                ctx = nets.scaled_dot_product_attention(
                    q, k, v, num_heads=s["heads"])
                h = layers.elementwise_add(
                    h, layers.fc(ctx, s["d_model"], num_flatten_dims=2))
                m = layers.layer_norm(h, begin_norm_axis=2)
                o, a_l = layers.switch_moe(
                    m, s["experts"], s["d_ff"],
                    capacity_factor=s["capacity_factor"],
                    ep_ring_id=EP_RING_ID)
                h = layers.elementwise_add(h, o)
                aux = a_l if aux is None else layers.elementwise_add(aux,
                                                                     a_l)
            mse = layers.mean(layers.square(layers.elementwise_sub(h, y)))
            loss = layers.elementwise_add(
                mse, layers.scale(aux, scale=s["aux_weight"]))
            static.Adam(1e-4).minimize(loss)
    finally:
        attn._FLASH_STATE["mode"] = "auto"
    experts = [op.inputs[slot][0] for op in main.global_block().ops
               if op.type == "switch_moe"
               for slot in ("W1", "B1", "W2", "B2")]
    return main, startup, loss, aux, experts


def px_ep_grads(main, experts, world):
    """Expert parallelism's gradients, written into the program: an
    expert's gradient already holds every rank's tokens (the backward
    all-to-all brought them), so it is scaled by 1 / world (each rank's
    loss is the mean over its tokens); every other gradient is averaged
    over the ranks (c_allreduce_sum, scale_by_world_size)."""
    from paddle_tpu_torch.core.program import OpDesc, OpRole, unique_name
    block = main.global_block()
    new_ops = []
    for op in block.ops:
        if op.attrs.get(OpRole.KEY) == OpRole.Optimize and \
                "Grad" in op.inputs:
            g = op.inputs["Grad"][0]
            out = unique_name(g + "@EP")
            block.create_var(name=out, stop_gradient=True)
            attrs = {OpRole.KEY: OpRole.Dist, "op_uid": main._next_uid()}
            if op.inputs["Param"][0] in experts:
                new_ops.append(OpDesc("scale", {"X": [g]}, {"Out": [out]},
                                      {**attrs, "scale": 1.0 / world,
                                       "bias": 0.0}))
            else:
                red = unique_name(g + "@ALLREDUCE")
                block.create_var(name=red, stop_gradient=True)
                new_ops.append(OpDesc("c_allreduce_sum", {"X": [g]},
                                      {"Out": [red]},
                                      {**attrs, "ring_id": 0}))
                new_ops.append(OpDesc("scale_by_world_size", {"X": [red]},
                                      {"Out": [out]},
                                      {OpRole.KEY: OpRole.Dist,
                                       "op_uid": main._next_uid(),
                                       "ring_id": 0}))
            op.inputs["Grad"] = [out]
        new_ops.append(op)
    block.ops = new_ops
    main._fingerprint_cache = None


def px_moe_feed(seed):
    rng = np.random.RandomState(seed + 15)
    s = SWITCH
    shape = (s["batch"], s["seq"], s["d_model"])
    return {"x": rng.randn(*shape).astype(np.float32),
            "y": rng.randn(*shape).astype(np.float32)}


def px_expert_slots(main, experts):
    """{expert parameter or one of its Adam moments: its parameter}."""
    out = {}
    for op in main.global_block().ops:
        if op.type == "adam" and op.inputs["Param"][0] in experts:
            for slot in ("Param", "Moment1", "Moment2"):
                out[op.inputs[slot][0]] = op.inputs["Param"][0]
    return out


def px_recount_dropped(torch, xs, gates, cf):
    """The tokens a switch layer must drop, recounted from its inputs:
    each token's top-1 expert under its gate, and per expert the tokens
    past the capacity C = max(1, int(cf * N / E)) of this rank's N."""
    total = 0
    for x, gw in zip(xs, gates):
        x2 = x.reshape(-1, x.shape[-1]).float()
        e = gw.shape[1]
        idx = torch.softmax(x2 @ gw.float(), dim=-1).argmax(dim=-1)
        per_expert = torch.bincount(idx, minlength=e)
        cap = max(1, int(cf * x2.shape[0] / e))
        total += int((per_expert - cap).clamp_min(0).sum())
    return total


def px_moe_run(torch, seed, rank, world, counters):
    """EP_STEPS steps of px_moe_program: dense (world 1, every expert
    here) or this rank's token rows and E / world experts with
    EP_RING_ID bound to the world.  Returns (record, the parameters after
    the last step: this rank's expert shards, the replicated ones)."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.incubate import moe
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops.kernels import collective as kc
    main, startup, loss, aux, experts = px_moe_program()
    if world > 1:
        px_ep_grads(main, experts, world)
    feed = px_moe_feed(seed)
    b = SWITCH["batch"] // world
    feed = {n: v[rank * b:(rank + 1) * b] for n, v in feed.items()}
    startup.random_seed = seed
    exe, scope = static.Executor(), static.Scope()
    e_loc = SWITCH["experts"] // world
    with static.scope_guard(scope):
        exe.run(startup)
    for n in px_expert_slots(main, experts):
        scope.set(n, scope.vars[n][rank * e_loc:(rank + 1) * e_loc]
                  .contiguous())
    group = kc.ring_group(0) if world > 1 else None
    moe_ops = [op for op in main.global_block().ops
               if op.type == "switch_moe"]
    moe_x = [op.inputs["X"][0] for op in moe_ops]
    moe_gate = [op.inputs["GateW"][0] for op in moe_ops]
    rec = {"losses": [], "aux": [], "step_ms": [], "launches": [],
           "launches_by_dtype": [], "collective_calls": [], "dropped": [],
           "dropped_recount": [],
           "expert_rows_held": {n: list(scope.vars[n].shape)[:1]
                                for n in experts}}
    if group is not None:
        kc.register_ring(EP_RING_ID, group)
    try:
        with static.scope_guard(scope):
            for _ in range(EP_STEPS):
                gates = [scope.vars[g].clone() for g in moe_gate]
                dp_zero(counters)
                kc.reset_comm_stats()
                moe.reset_moe_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lv, av, *xs = exe.run(main, feed=feed,
                                      fetch_list=[loss, aux] + moe_x,
                                      return_numpy=False)
                torch.cuda.synchronize()
                rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
                dropped = torch.as_tensor(moe.MOE_STATS["dropped"],
                                          device=lv.device).reshape(1)
                recount = torch.tensor([px_recount_dropped(
                    torch, xs, gates, SWITCH["capacity_factor"])],
                    device=lv.device)
                if group is not None:  # the mean (sum) over the ranks
                    lv = kc.all_reduce(lv, "sum", group) / world
                    av = kc.all_reduce(av, "sum", group) / world
                    dropped = kc.all_reduce(dropped, "sum", group)
                    recount = kc.all_reduce(recount, "sum", group)
                rec["dropped_recount"].append(int(recount.reshape(-1)[0]))
                rec["losses"].append(float(lv.reshape(-1)[0]))
                rec["aux"].append(float(av.reshape(-1)[0]))
                rec["dropped"].append(int(dropped.reshape(-1)[0]))
                launches, by_dtype = dp_read(counters)
                rec["launches"].append(launches)
                rec["launches_by_dtype"].append(by_dtype)
                rec["collective_calls"].append(
                    dict(kc.COMM_STATS["calls_by_op"]))
    finally:
        kc._RINGS.pop(EP_RING_ID, None)
    params = {p.name: scope.vars[p.name] for p in main.all_parameters()}
    return rec, params, experts


def px_ep_rank(torch, seed, rank, out_dir):
    """(c) on one rank: the ep run; saves this rank's parameters."""
    rec, params, _ = px_moe_run(torch, seed, rank, PX_RANKS, px_counters())
    torch.save({n: t.cpu() for n, t in params.items()},
               os.path.join(out_dir, f"ep_rank{rank}.pt"))
    return rec


def px_ep_want():
    """Launches of an ep rank-step (and of a dense step): 4 layers' flash
    forward (and its replay), dQ, dK/dV, fp32; no fused CE (the loss is
    an MSE); all-to-alls: 2 a layer forward, 2 in the replay, 2 backward."""
    n = SWITCH["layers"]
    return dict(zip(DP_COUNTED, (2 * n, n, n, 0, 0, 0)))


def px_ep_check(torch, seed, tmp, ranks):
    """(c) gated: each rank holds E / EP_DEGREE experts' weights, its
    launches (fp32) and all-to-all calls; against the dense run in one
    process: step 1's loss and aux loss, the update gap; the tokens each
    run dropped for capacity equal to a recount from its routing, and
    reported beside each other (they differ where a rank's share of an
    expert's tokens overflows the rank's capacity while the whole batch
    does not overflow the dense one's)."""
    counters = px_counters()
    dense, dparams, experts = px_moe_run(torch, seed, 0, 1, counters)
    want = px_ep_want()
    n_a2a = 6 * SWITCH["layers"]
    for r in ranks:
        rec = r["ep"]
        for n, rows in rec["expert_rows_held"].items():
            check_equal(f"ep rank {r['rank']} {n} experts held", rows,
                        [SWITCH["experts"] // EP_DEGREE])
        for i, (got, dt, calls) in enumerate(zip(
                rec["launches"], rec["launches_by_dtype"],
                rec["collective_calls"])):
            check_equal(f"ep rank {r['rank']} step {i} launches", got, want)
            check_equal(f"ep rank {r['rank']} step {i} launches by dtype",
                        dt, {n: ({"float32": want[n]} if want[n] else {})
                             for n in DP_KERNELS})
            check_equal(f"ep rank {r['rank']} step {i} all-to-alls",
                        calls.get("switch_moe_all_to_all"), n_a2a)
    for i, got in enumerate(dense["launches"]):
        check_equal(f"dense MoE step {i} launches", got, want)
    ep = ranks[0]["ep"]
    if [r["ep"]["losses"] for r in ranks][1:] != [ep["losses"]]:
        raise AssertionError("ep: the ranks fetched different losses")
    rel = abs(ep["losses"][0] - dense["losses"][0]) / abs(dense["losses"][0])
    aux_rel = abs(ep["aux"][0] - dense["aux"][0]) / abs(dense["aux"][0])
    shards = [torch.load(os.path.join(tmp, f"ep_rank{r}.pt"))
              for r in range(EP_DEGREE)]
    got = {n: (torch.cat([s[n] for s in shards]) if n in experts
               else shards[0][n]) for n in dparams}
    for n in dparams:
        if n not in experts and not torch.equal(shards[0][n],
                                                shards[1][n]):
            raise AssertionError(f"ep: replicated {n} differs across the "
                                 "ranks")
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops import random as rnd
    main, startup, _, _, _ = px_moe_program()
    init, _, _ = startup_weights(torch, static, rnd, startup, seed)
    before = {n: init[n] for n in dparams}
    gap, worst = dp_update_gap(torch, before, got, dparams)
    if not (rel <= EP_LOSS_RTOL and aux_rel <= EP_AUX_RTOL and
            gap <= EP_UPDATE_TOL and np.isfinite(ep["losses"]).all()):
        raise AssertionError(
            f"ep against dense: losses {ep['losses']} / {dense['losses']} "
            f"(rel {rel}, tolerance {EP_LOSS_RTOL}), aux {ep['aux']} / "
            f"{dense['aux']} (rel {aux_rel}, tolerance {EP_AUX_RTOL}), "
            f"update gap {gap} (tolerance {EP_UPDATE_TOL})")
    # the ep run computes each expert's capacity from a rank's tokens,
    # as the JAX package does, so its drops equal dense's only where no
    # capacity overflows: each run's count is held to its routing
    check_equal("tokens dropped for capacity, ep (recounted from its "
                "routing)", ep["dropped"], ep["dropped_recount"])
    check_equal("tokens dropped for capacity, dense (recounted)",
                dense["dropped"], dense["dropped_recount"])
    res = {"config": f"static encoder, {SWITCH['layers']} layers of pre-LN "
                     "attention (flash) + switch MoE at Switch-Base-8's "
                     f"widths (d_model {SWITCH['d_model']}, d_ff "
                     f"{SWITCH['d_ff']}, {SWITCH['experts']} experts, "
                     f"capacity factor {SWITCH['capacity_factor']}), "
                     f"tokens {SWITCH['batch']} x {SWITCH['seq']}, fp32, "
                     f"Adam 1e-4; dp 1 x ep {EP_DEGREE} on {PX_RANKS} gloo "
                     "ranks against dense in one process",
           "losses": ep["losses"], "dense_losses": dense["losses"],
           "step1_loss_rel_diff": rel, "loss_rtol": EP_LOSS_RTOL,
           "aux": ep["aux"], "dense_aux": dense["aux"],
           "step1_aux_rel_diff": aux_rel, "aux_rtol": EP_AUX_RTOL,
           "update_gap": gap, "update_tol": EP_UPDATE_TOL,
           "param_max_abs_diff": worst,
           "tokens_dropped": ep["dropped"],
           "dense_tokens_dropped": dense["dropped"],
           "tokens_dropped_equal_to_dense": ep["dropped"] ==
           dense["dropped"],
           "all_to_alls_per_rank_step": n_a2a,
           "rank_step_ms": [r["ep"]["step_ms"] for r in ranks],
           "dense_step_ms": dense["step_ms"],
           "launches_per_rank_step": ep["launches"][-1]}
    log({"phase": "parallel_axes_ep", **res})
    return res, dense


def px_tp_rank(torch, seed, rank, bodies):
    """(a) on one rank: phase 7's model (--seed) under a TPShardedDecoder
    for each PX_TP_VARIANTS run; the leader (rank 0) serves `bodies`
    through an engine with a tp-2 plan and the radix cache, the other rank
    follows.  Returns each run's record."""
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.core import generator
    from paddle_tpu_torch.core.place import CUDAPlace
    from paddle_tpu_torch.models import GPTConfig, GPTForGeneration, GPTModel
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          TPShardedDecoder, metrics)
    generator.seed(seed)
    with dygraph.guard(CUDAPlace(0)):
        model = GPTForGeneration(GPTModel(GPTConfig(**GPT2))).eval()
    out = {}
    for variant, wd, spec in PX_TP_VARIANTS:
        dec = TPShardedDecoder(model, PX_TP, weight_dtype=wd)
        if rank:
            rec = {"steps_followed": dec.follow(),
                   "bytes_received": dec.bytes_received,
                   "weights": dec.shard_bytes()}
            out[variant] = rec
            continue
        plan = dict(GEN_PLAN, tp_degree=PX_TP, weight_dtype=wd)
        if spec == "own":
            spec = own_weights_draft(torch, model, seed, PX_DRAFT_SCALE)
        eng = ContinuousBatchingEngine(dec, max_slots=GEN_PLAN["max_slots"],
                                       kv_pool=plan, prefix_cache="auto",
                                       speculative=spec)
        eng.start()
        counters = px_counters()
        c0 = {n: metrics.counter(n) for n in SPEC_COUNTERS}
        try:
            # ---- the main path: counts from 0 just before, read just after
            dp_zero(counters)
            zero_wide(attn)
            t0 = time.perf_counter()
            futs = [eng.submit(
                np.asarray(b["input_ids"], np.int64), max_length=PX_NEW,
                decode_strategy=b.get("decode_strategy", "greedy_search"),
                top_k=b.get("top_k", 0),
                temperature=b.get("temperature", 1.0),
                seed=b.get("seed", 0)) for b in bodies]
            outs = [np.asarray(f.result(timeout=600)) for f in futs]
            wall = time.perf_counter() - t0
            launches, by_dtype = dp_read(counters)
            wide = read_wide(attn)
            # ---- end of the main path
        finally:
            eng.stop()
        eng.prefix_cache.clear()
        eng.kv_pool.assert_drained()
        dec.stop()
        steps = list(eng.step_log)
        new = sum(int(o.size) - len(b["input_ids"])
                  for b, o in zip(bodies, outs))
        out[variant] = {
            "outs": [o.tolist() for o in outs], "wall_s": wall,
            "generated_tokens_per_s": new / wall,
            "decode_step_ms_p50": pct([s["ms"] for s in steps], 50),
            "forwards": dec.steps,
            "bytes_sent_per_forward": dec.bytes_sent / dec.steps,
            "cache_bytes": dec.cache_bytes, "bytes_sent": dec.bytes_sent,
            "weights": dec.shard_bytes(), "launches": launches,
            "by_dtype": by_dtype, "wide": wide,
            "spec_counts": {n: metrics.counter(n) - v
                            for n, v in c0.items()},
            "pool_tp_degree": eng.kv_pool.tp_degree,
            "page_bytes_per_chip": eng.kv_pool.page_bytes_per_chip,
            "page_bytes": eng.kv_pool.page_bytes}
    return out


def px_tp_check(torch, seed, bodies, ranks):
    """(a) gated: each run's replies against the tp = 1 engine in this
    process (equal, or a greedy near tie of the fp32 model: spec_divergences'
    rule; int8 reported with the fp32 top-2 margin), the pools drained
    (in the ranks), the follower's K/V feed 1 / tp of the whole and each
    rank's sharded weights 1 / tp of theirs."""
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.core import generator
    from paddle_tpu_torch.core.place import CUDAPlace
    from paddle_tpu_torch.models import GPTConfig, GPTForGeneration, GPTModel
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    generator.seed(seed)
    with dygraph.guard(CUDAPlace(0)):
        model = GPTForGeneration(GPTModel(GPTConfig(**GPT2))).eval()
    eng = ContinuousBatchingEngine(model, max_slots=GEN_PLAN["max_slots"],
                                   kv_pool=dict(GEN_PLAN),
                                   prefix_cache="auto").start()
    try:
        t0 = time.perf_counter()
        futs = [eng.submit(
            np.asarray(b["input_ids"], np.int64), max_length=PX_NEW,
            decode_strategy=b.get("decode_strategy", "greedy_search"),
            top_k=b.get("top_k", 0), temperature=b.get("temperature", 1.0),
            seed=b.get("seed", 0)) for b in bodies]
        ref = [np.asarray(f.result(timeout=600)) for f in futs]
        ref_wall = time.perf_counter() - t0
    finally:
        eng.stop()
    ref_steps = list(eng.step_log)
    leader, follower = ranks[0]["tp"], ranks[1]["tp"]
    res = {}
    for variant, wd, spec in PX_TP_VARIANTS:
        lead, fol = leader[variant], follower[variant]
        outs = [np.asarray(o, np.int64) for o in lead["outs"]]
        if wd == "int8":
            diverged = compare_posts(torch, model, bodies, outs, ref,
                                     f"tp {variant}")
        else:
            diverged = spec_divergences(torch, model, bodies, outs, ref,
                                        f"tp {variant}")
        check_equal(f"tp {variant} forwards followed", fol["steps_followed"],
                    lead["forwards"])
        if fol["bytes_received"] * PX_TP != lead["cache_bytes"]:
            raise AssertionError(
                f"tp {variant}: the follower received "
                f"{fol['bytes_received']} bytes of K/V feeds, the whole "
                f"feeds were {lead['cache_bytes']}")
        for who, rec in (("leader", lead), ("follower", fol)):
            w = rec["weights"]
            if w["sharded"] * PX_TP != w["sharded_whole"]:
                raise AssertionError(f"tp {variant} {who}: holds "
                                     f"{w['sharded']} of "
                                     f"{w['sharded_whole']} sharded weight "
                                     "bytes")
        check_equal(f"tp {variant} pool tp degree", lead["pool_tp_degree"],
                    PX_TP)
        counts = lead["spec_counts"]
        if spec == "own" and (counts["spec.rollback_cols"] < 1 or
                              counts["spec.accepted"] >=
                              counts["spec.proposed"]):
            raise AssertionError(f"tp {variant}: {counts} (want rejections "
                                 "rolled back)")
        # the decode program is the score-matrix graph (the JAX
        # package's): no hand kernel runs on this path
        check_equal(f"tp {variant} hand-kernel launches",
                    lead["launches"], {n: 0 for n in DP_COUNTED})
        res[variant] = {
            "posts_equal_to_tp1": len(bodies) - len(diverged),
            "divergences": diverged,
            "spec_proposed": counts["spec.proposed"],
            "spec_accepted": counts["spec.accepted"],
            "spec_rollback_cols": counts["spec.rollback_cols"],
            "generated_tokens_per_s": lead["generated_tokens_per_s"],
            "decode_step_ms_p50": lead["decode_step_ms_p50"],
            "forwards": lead["forwards"],
            "kv_bytes_sent_to_follower_per_forward":
                lead["bytes_sent_per_forward"],
            "sharded_weight_bytes_per_rank": lead["weights"]["sharded"],
            "sharded_weight_bytes_whole": lead["weights"]["sharded_whole"],
            "replicated_weight_bytes_per_rank":
                lead["weights"]["replicated"],
            "page_bytes_per_chip": lead["page_bytes_per_chip"],
            "page_bytes": lead["page_bytes"]}
    res["tp1_generated_tokens_per_s"] = sum(
        int(o.size) - len(b["input_ids"]) for b, o in zip(bodies, ref)) \
        / ref_wall
    res["tp1_decode_step_ms_p50"] = pct([s["ms"] for s in ref_steps], 50)
    log({"phase": "parallel_axes_tp_generate",
         "config": f"GPT-2 small widths (random weights from --seed), fp32, "
                   f"tp {PX_TP} on {PX_RANKS} gloo ranks on one card (rank "
                   "0 leads the engine, rank 1 follows), the radix cache, "
                   f"phase 7's first {PX_POSTS} posts with {PX_NEW} new "
                   "tokens each; plain, speculative (2-layer stamp, k = 4), "
                   "speculative with an own-weights draft (k = 4, block "
                   f"weights x{PX_DRAFT_SCALE}) "
                   "and int8 weights", **res})
    return res


def px_rank(seed, out_dir, bodies):
    """One rank of phase 15 (a) - (c) (a `spawn` worker): a gloo process
    group on cuda:0; writes rank<r>.json (and the parameter files)."""
    import torch
    import torch.distributed as tdist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.core import kernel_build
    kernel_build.build_libraries(KERNEL_SOURCES)  # the parent built them
    env = pdist.init_parallel_env(backend="gloo")
    try:
        torch.cuda.set_device(env.device_id)
        res = {"rank": env.rank, "world": env.world_size}
        t0 = time.perf_counter()
        res["tp"] = px_tp_rank(torch, seed, env.rank, bodies)
        res["tp_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res["sp"] = px_sp_rank(torch, seed, env.rank, out_dir)
        res["sp_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res["ep"] = px_ep_rank(torch, seed, env.rank, out_dir)
        res["ep_s"] = time.perf_counter() - t0
    finally:
        tdist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{env.rank}.json"), "w") as f:
        json.dump(res, f)


def px_hoist(torch, seed):
    """(d) phase 14's stage-2 ZeRO step with gradient merge k = 2 under
    NCCL at world 1 in this process: run_steps K = HOIST_K, twice, hoisted
    (the commit tail once a window: two captured graphs) and with
    PADDLE_TPU_SCAN_HOIST=0, each from the same weights.  Gates: the
    losses and the final global state bitwise equal; the replaying call's
    replays issue 1 publish all-gather a bucket a window hoisted, 1 a step
    unhoisted; no collective called outside a capture then."""
    import torch.distributed as tdist
    from paddle_tpu_torch import static
    from paddle_tpu_torch.distributed.spawn import get_free_ports
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import fused_xent as fx
    from paddle_tpu_torch.ops import random as rnd
    from paddle_tpu_torch.ops.kernels import collective as kc
    port = get_free_ports(1)[0]
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=1, rank=0)
    fx.enable_fused_xent(True)
    counters = px_counters()
    runs = {}
    try:
        init = None
        feed = train_feed(seed)
        stacked = {k: np.stack([v] * HOIST_K) for k, v in feed.items()}
        for mode in ("hoisted", "unhoisted"):
            os.environ["PADDLE_TPU_SCAN_HOIST"] = "1" if mode == "hoisted" \
                else "0"
            main, startup, loss, compiled = zt_program(2, 2)
            if init is None:
                init, _, _ = startup_weights(torch, static, rnd, startup,
                                             seed)
            buckets = sum(op.type == "c_allgather"
                          for op in compiled._get_program()
                          .global_block().ops)
            exe, scope = static.Executor(), scope_of(static, init)
            rec = {"buckets": buckets, "losses": [], "calls": [],
                   "replayed": []}
            with static.scope_guard(scope):
                for call in range(2):
                    kc.reset_comm_stats()
                    dp_zero(counters)
                    zero_wide(attn)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = exe.run_steps(compiled, feed=stacked,
                                        fetch_list=[loss])[0]
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3 / HOIST_K
                    rec["losses"] += np.asarray(out, np.float32) \
                        .reshape(-1).tolist()
                    rec["calls"].append(dict(kc.COMM_STATS["calls_by_op"]))
                    rec["replayed"].append(
                        dict(kc.COMM_STATS["replayed_by_op"]))
                    if call == 0:
                        rec["capturing_launches"], rec["capturing_by_dtype"] \
                            = dp_read(counters)
                        rec["wide"] = read_wide(attn)
                    else:
                        rec["replayed_step_ms"] = ms
                rec["hoisted"] = compiled._last_hoisted
                rec["state"] = {n: t.clone() for n, t in
                                compiled.global_state(scope).items()}
            rec["cache_stats"] = exe.cache_stats()
            exe.close()
            runs[mode] = rec
    finally:
        os.environ.pop("PADDLE_TPU_SCAN_HOIST", None)
        fx.enable_fused_xent(False)
        tdist.destroy_process_group()
    h, u = runs["hoisted"], runs["unhoisted"]
    check_equal("hoist: hoisted / unhoisted", (h["hoisted"], u["hoisted"]),
                (True, False))
    if h["losses"] != u["losses"] or \
            not np.isfinite(h["losses"]).all():
        raise AssertionError(f"hoist: losses {h['losses']} hoisted against "
                             f"{u['losses']} unhoisted")
    differing = [n for n in u["state"] if not torch.equal(h["state"][n],
                                                           u["state"][n])]
    if sorted(h["state"]) != sorted(u["state"]) or differing:
        raise AssertionError(f"hoist: the global state differs: "
                             f"{differing[:5]}")
    windows = HOIST_K // 2
    for mode, rec, per_call in (("hoisted", h, windows),
                                ("unhoisted", u, HOIST_K)):
        check_equal(f"hoist {mode}: the replaying call's eager collectives",
                    rec["calls"][1], {})
        check_equal(f"hoist {mode}: publish all-gathers replayed a call",
                    rec["replayed"][1].get("c_allgather"),
                    per_call * rec["buckets"])
        check_equal(f"hoist {mode}: captures", rec["cache_stats"]["traces"],
                    1)
    res = {"config": f"bench.py's BERT-base step at {DIST_LAYERS} layers "
                     "(phase 14's), fleet amp (bf16) + "
                     "sharding (ZeRO stage 2) + gradient merge k = 2, flash "
                     "+ fused CE, CompiledProgram under NCCL, world size 1, "
                     f"run_steps K = {HOIST_K} twice",
           "losses": h["losses"], "bitwise_equal": True,
           "buckets": h["buckets"],
           "publish_allgathers_per_call": {
               "hoisted": h["replayed"][1].get("c_allgather"),
               "unhoisted": u["replayed"][1].get("c_allgather")},
           "collectives_replayed_per_call": {"hoisted": h["replayed"][1],
                                             "unhoisted": u["replayed"][1]},
           "replayed_step_ms": {"hoisted": h["replayed_step_ms"],
                                "unhoisted": u["replayed_step_ms"]},
           "launches_in_capturing_call": {
               "hoisted": h["capturing_launches"],
               "unhoisted": u["capturing_launches"]}}
    log({"phase": "parallel_axes_hoist", **res})
    return res, h, u


def px_phase(torch, seed):
    """(15) the remaining parallel axes: the flash-composed ring's kernel
    checks; (a) tp /generate, (b) sp training, (c) ep training on PX_RANKS
    gloo ranks sharing the card (one spawn); (d) the hoist under NCCL at
    world 1 here.  Returns the records, with each path's launches."""
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.ops import attention as attn
    t_phase = time.perf_counter()
    ring = px_ring_kernels(torch, attn)
    bodies = gen_requests(seed)[:PX_POSTS]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_px_")
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        pdist.spawn(px_rank, args=(seed, tmp, bodies),
                    nprocs=PX_RANKS,
                    selected_devices=",".join(["0"] * PX_RANKS))
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(PX_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        tp = px_tp_check(torch, seed, bodies, ranks)
        sp = px_sp_check(torch, seed, tmp, ranks)
        ep, dense = px_ep_check(torch, seed, tmp, ranks)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    hoist, h, u = px_hoist(torch, seed)
    for r in ranks:
        for variant, _, _ in PX_TP_VARIANTS:
            if r["rank"] == 0:
                record_wide(f"px_tp_{variant}", r["tp"][variant]["wide"])
        for tag, _, runs in PX_SP_PROGRAMS:
            for run in runs:
                record_wide(f"px_sp_{tag}_{run}_rank{r['rank']}",
                            r["sp"][tag][run]["wide"])
    record_wide("px_hoist_hoisted", h["wide"])
    record_wide("px_hoist_unhoisted", u["wide"])
    r0 = ranks[0]
    launches = {f"sp_{tag}_gloo": dp_path_launches(r0["sp"][tag]["sound"])
                for tag, _, _ in PX_SP_PROGRAMS}
    for variant, _, _ in PX_TP_VARIANTS:
        launches[f"tp_{variant}_leader"] = {
            "launches": r0["tp"][variant]["launches"],
            "by_dtype": r0["tp"][variant]["by_dtype"], "philox_at_start": 0}
    launches["ep_gloo"] = {"launches": r0["ep"]["launches"][-1],
                           "by_dtype": r0["ep"]["launches_by_dtype"][-1],
                           "philox_at_start": 0}
    launches["ep_dense"] = {"launches": dense["launches"][-1],
                            "by_dtype": dense["launches_by_dtype"][-1],
                            "philox_at_start": 0}
    for mode, rec in (("hoisted", h), ("unhoisted", u)):
        launches[f"hoist_{mode}_capturing_call"] = {
            "launches": rec["capturing_launches"],
            "by_dtype": rec["capturing_by_dtype"], "philox_at_start": 0}
    seconds = time.perf_counter() - t_phase
    log({"phase": "parallel_axes", "ranks_process_s": spawn_s,
         "rank_part_s": {k: r0[k + "_s"] for k in ("tp", "sp", "ep")},
         "seconds": seconds})
    return {"ring": ring, "tp": tp, "sp": sp, "ep": ep, "hoist": hoist,
            "launches": launches, "seconds": seconds}


# phase 16: elastic data-parallel training and its recovery tier
# (distributed/elastic.py, checkpoint/, observability/, testing/chaos.py,
# launch --elastic / --fleet_dir): bench.py's BERT-base AMP step
# elasticized at logical dp EL_LOGICAL (micro-batch TRAIN_BATCH /
# EL_LOGICAL rows), a checkpoint every global step
EL_LOGICAL = 2
# (a) and (b) train DIST_LAYERS layers (widths unchanged), as (c) does:
# the gates are bitwise, whatever the depth
EL_LAYERS = DIST_LAYERS
EL_STEPS = 4            # global steps of every run
EL_KILL_AT = 2          # (b) rank 1 SIGKILLed after its 2nd micro-step
EL_TERM_AT = 3          # (b) the re-formed world-1 pod SIGTERM'd after its
                        # 3rd micro-step: mid-window (K = 2 at world 1)
EL_LOSE_AT = 4          # (c) host 1 lost after its 4th micro-step (global
                        # step 2 at K = 2)
EL_KEEP = 2             # checkpoints kept a writer rank
EL_GRACE = 2            # seconds between the teardown's SIGTERM and SIGKILL
EL_MEMBER_TIMEOUT = 3   # (c) seconds before a silent fleet host is lost
EL_FLEET_STEPS = 3      # (c)'s global steps: host 1 lost after the 2nd
EL_BARRIER_S = 300      # (c) the fleet barrier's patience (a lost peer is
                        # noticed by the launcher long before)
# the paths whose launches of the kernels for head dims above 128 phase 16
# reads (each gated at 0)
EL_PATHS = ("elastic_eager", "elastic_graph", "elastic_fleet_reference",
            "elastic_b1_rank0_r0", "elastic_b1_rank1_r0",
            "elastic_b1_rank0_r1", "elastic_b2_rank0_r0",
            "elastic_b2_rank1_r0", "elastic_fleet_host0_e0",
            "elastic_fleet_host1_e0", "elastic_fleet_host0_e1")


def el_want(layers):
    """Launches a micro-step: phase 6's eager AMP step at `layers` layers
    (2 flash forwards a layer, a dQ and a dK/dV a layer, 2 fused CE, all
    bf16; no dropout, no random op)."""
    return dict(zip(DP_COUNTED, (2 * layers, layers, layers, 2, 0, 0)))


def el_program(layers):
    """bench.py's AMP BERT-base step (build_bert_pretrain, flash on, at
    `layers` layers, widths unchanged) elasticized at EL_LOGICAL with its
    loss folded: (main, startup, loss, meta)."""
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.distributed.elastic import elasticize
    from paddle_tpu_torch.models import build_bert_pretrain
    from paddle_tpu_torch.ops import attention as attn
    attn.enable_flash_attention(True)
    try:
        _reset_unique_names()
        main, startup, loss = build_bert_pretrain(
            use_amp=True, batch=TRAIN_BATCH,
            **dict(BERT, layers_n=layers))
    finally:
        attn._FLASH_STATE["mode"] = "auto"
    meta = elasticize(main, startup, EL_LOGICAL, loss_name=loss)
    return main, startup, loss, meta


def el_save_program(d, program):
    """Write (main, startup, loss, meta) under `d` as the JSON wire format
    and the meta, for the launched ranks: parsing takes a tenth of a
    second where building the program (its shape inference) takes ~10 s
    on the card's host.  Returns the path of the record."""
    main, startup, loss, meta = program
    os.makedirs(d, exist_ok=True)
    for name, prog in (("main", main), ("startup", startup)):
        with open(os.path.join(d, f"{name}.json"), "wb") as f:
            f.write(prog.serialize_to_string())
    path = os.path.join(d, "program.json")
    with open(path, "w") as f:
        json.dump({"loss": loss.name, "meta": meta}, f)
    return path


def el_load_program(path):
    """The (main, startup, loss name, meta) `el_save_program` wrote; the
    elastic meta goes back on the parsed main program (it is not part of
    the wire format)."""
    from paddle_tpu_torch.core.program import Program
    d = os.path.dirname(path)
    with open(path) as f:
        rec = json.load(f)
    progs = []
    for name in ("main", "startup"):
        with open(os.path.join(d, f"{name}.json"), "rb") as f:
            progs.append(Program.parse_from_string(f.read()))
    progs[0]._elastic_meta = rec["meta"]
    return progs[0], progs[1], rec["loss"], rec["meta"]


def el_feeds(seed):
    """EL_STEPS global batches (TRAIN_BATCH rows each) from --seed."""
    return [train_feed(seed + g) for g in range(EL_STEPS)]


def el_params(main, scope):
    """The parameters on the host, by name."""
    return {p.name: scope.get(p.name).detach().cpu()
            for p in main.all_parameters()}


def el_reference(torch, seed, program, graph=False, steps=EL_STEPS):
    """The uninterrupted run in this process under NCCL at world 1 (K =
    EL_LOGICAL micro-steps a global step): `steps` global steps eagerly,
    each micro-step's launches counted; with `graph`, the same steps
    again from the same weights through Executor.run_steps, one window a
    call.  Returns the record, the final parameters and the run_steps
    call's.  `program` is el_program's (main, startup, loss, meta)."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.distributed.elastic import rebucket_feeds
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import fused_xent as fx
    from paddle_tpu_torch.ops import random as rnd
    from paddle_tpu_torch.ops.kernels import collective as kc
    main, startup, loss, meta = program
    layers = sum(op.type == "flash_attention"
                 for op in main.global_block().ops)
    init, philox, _ = startup_weights(torch, static, rnd, startup, seed)
    counters = dp_counters(attn, dr, fx, rnd)
    feeds = el_feeds(seed)[:steps]
    rec = {"layers": layers, "losses": [], "global_step_ms": [],
           "launches": [], "by_dtype": []}
    exe, scope = static.Executor(), scope_of(static, init)
    zero_wide(attn)
    with static.scope_guard(scope):
        cp = static.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
        for f in feeds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for mf in rebucket_feeds(f, EL_LOGICAL, 1):
                dp_zero(counters)
                out = exe.run(cp, feed=mf, fetch_list=[meta["loss_avg"]])
                got, dt = dp_read(counters)
                rec["launches"].append(got)
                rec["by_dtype"].append(dt)
            torch.cuda.synchronize()
            rec["global_step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["losses"].append(float(np.asarray(out[0]).reshape(-1)[0]))
        params = el_params(main, scope)
    rec["wide"] = read_wide(attn)
    exe.close()
    del exe, scope
    want = el_want(layers)
    for i, (got, dt) in enumerate(zip(rec["launches"], rec["by_dtype"])):
        dp_check_launches(f"elastic eager micro-step {i} ({layers} layers)",
                          got, dt, want)
    if not graph:
        return rec, params, None
    exe, scope = static.Executor(), scope_of(static, init)
    zero_wide(attn)
    replayed, calls = [], []
    with static.scope_guard(scope):
        cp = static.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
        for i, f in enumerate(feeds):
            micro = rebucket_feeds(f, EL_LOGICAL, 1)
            stacked = {n: np.stack([m[n] for m in micro]) for n in f}
            dp_zero(counters)
            kc.reset_comm_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = exe.run_steps(cp, feed=stacked,
                                fetch_list=[meta["loss_avg"]])[0]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            calls.append(dict(kc.COMM_STATS["calls_by_op"]))
            if i == 0:
                rec["capturing_launches"], rec["capturing_by_dtype"] = \
                    dp_read(counters)
            else:
                rec.setdefault("replayed_global_step_ms", []).append(ms)
            replayed.append(float(np.asarray(out).reshape(-1)[-1]))
        graph_params = el_params(main, scope)
    rec["graph_wide"] = read_wide(attn)
    rec["graph_losses"] = replayed
    rec["cache_stats"] = exe.cache_stats()
    exe.close()
    dp_check_launches("elastic run_steps capturing call", 
                      rec["capturing_launches"], rec["capturing_by_dtype"],
                      {n: 2 * v for n, v in want.items()})
    folds = sum(op.type == "c_elastic_fold"
                for op in main.global_block().ops)
    check_equal("elastic run_steps capturing call's eager folds", calls[0],
                {"c_elastic_fold": 2 * folds})
    for i, c in enumerate(calls[1:], 1):
        check_equal(f"elastic run_steps call {i}'s eager collectives", c,
                    {})
    check_equal("elastic run_steps captures", rec["cache_stats"]["traces"],
                1)
    rec["folds_per_micro_step"] = folds
    return rec, params, graph_params


def el_compare(tag, losses, params, ref_losses, ref_params):
    """Every global-step loss and every parameter bitwise equal."""
    import torch
    if [np.float32(v) for v in losses] != \
            [np.float32(v) for v in ref_losses]:
        raise AssertionError(f"{tag}: global-step losses {losses} against "
                             f"{ref_losses}")
    differing = [n for n in ref_params
                 if not torch.equal(params[n], ref_params[n])]
    if sorted(params) != sorted(ref_params) or differing:
        raise AssertionError(f"{tag}: parameters differ: {differing[:5]}")


def el_timed_manager(*args, **kw):
    """A CheckpointManager whose save / wait / commit seconds (the
    train-side cost of a checkpoint) add up in its `seconds`."""
    from paddle_tpu_torch.checkpoint import CheckpointManager

    class Timed(CheckpointManager):
        seconds = 0.0

        def _timed(self, fn, *a):
            t0 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                self.seconds += time.perf_counter() - t0

        def save(self, *a, **k):
            return self._timed(lambda: super(Timed, self).save(*a, **k))

        def wait(self):
            return self._timed(super().wait)

        def commit(self, step):
            return self._timed(super().commit, step)
    return Timed(*args, **kw)


def el_rank(cfg_path):
    """One launched rank of phase 16 (`python3 chip_smoke.py
    --elastic-rank <cfg.json>`, started by paddle_tpu_torch.distributed
    .launch): the launcher's env picks rank, world, restart and fleet
    (elastic.LaunchedRank, which also runs the resume, checkpoint and
    train loop).  NCCL at world 1, gloo at world 2 (two ranks share the
    card); the elastic step at cfg["layers"] as the parent serialized it,
    the startup of --seed (every process draws the same weights), a
    checkpoint every global step, training to cfg["steps"]; writes
    out_<tag>.json after every global step and, when done, rank 0's
    parameters (final_<tag>.pt).  A global step's ms leaves out its
    checkpoint (save, wait, commit) and its barrier wait, each reported
    on its own."""
    with open(cfg_path) as f:
        cfg = json.load(f)
    import torch
    import torch.distributed as tdist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core import kernel_build, monitor
    from paddle_tpu_torch.distributed.elastic import LaunchedRank
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import fused_xent as fx
    from paddle_tpu_torch.ops import random as rnd
    from paddle_tpu_torch.ops.kernels import collective as kc
    t_start = time.time()
    t_mark = time.perf_counter()
    setup = {}

    def mark(what):
        nonlocal t_mark
        now = time.perf_counter()
        setup[what] = now - t_mark
        t_mark = now
    kernel_build.build_libraries(KERNEL_SOURCES)  # the parent built them
    fx.enable_fused_xent(True)
    lr = LaunchedRank(barrier_timeout_s=EL_BARRIER_S)
    world = lr.world
    tag = lr.tag if lr.fleet else f"{cfg['tag']}_{lr.tag}"
    torch.cuda.set_device(lr.device_id)
    tdist.init_process_group("nccl" if world == 1 else "gloo",
                             init_method=f"tcp://{lr.endpoint}",
                             world_size=world,
                             rank=0 if lr.fleet else lr.rank)
    out_json = os.path.join(cfg["dir"], f"out_{tag}.json")
    rec = {"tag": tag, "rank": lr.rank, "world": world,
           "restart": lr.restart, "backend": tdist.get_backend(),
           "losses": {}, "step_ms": {}, "checkpoint_s": {},
           "barrier_s": {}, "micro_steps": 0, "process_start_t": t_start}
    waited = {"barrier_s": 0.0}
    if lr.barrier is not None:
        barrier = lr.barrier

        def timed_barrier():
            t0 = time.perf_counter()
            try:
                return barrier()
            finally:
                waited["barrier_s"] += time.perf_counter() - t0
        lr.barrier = timed_barrier

    def report(**kw):
        rec.update(kw)
        with open(out_json + ".tmp", "w") as f:
            json.dump(rec, f)
        os.replace(out_json + ".tmp", out_json)

    mark("imports_and_group")
    try:
        main, startup, loss_name, meta = el_load_program(cfg["program"])
        mark("program")
        init, _, _ = startup_weights(torch, static, rnd, startup,
                                     cfg["seed"])
        mark("startup")
        exe, scope = static.Executor(), scope_of(static, init)
        del init
        mgr = lr.checkpoint_manager(os.path.join(cfg["dir"], "ckpt"),
                                    EL_KEEP, cls=el_timed_manager)
        counters = dp_counters(attn, dr, fx, rnd)
        step = {"ms": 0.0, "ck": 0.0, "barrier": 0.0}

        def run(mf):
            kc.reset_comm_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if "first_step_t" not in rec:
                rec["first_step_t"] = time.time()
            out = exe.run(cp, feed=mf, fetch_list=[meta["loss_avg"]])
            torch.cuda.synchronize()
            step["ms"] += (time.perf_counter() - t0) * 1e3
            rec["micro_steps"] += 1
            rec["fold_calls"] = kc.COMM_STATS["calls_by_op"].get(
                "c_elastic_fold", 0)
            rec["fold_gathered_bytes"] = kc.COMM_STATS["bytes"] * world \
                if rec["fold_calls"] else 0
            return out

        def step_done(gi, loss_value):
            ck = mgr.seconds - step["ck"]
            wait = waited["barrier_s"] - step["barrier"]
            rec["losses"][gi] = loss_value
            rec["step_ms"][gi] = step["ms"] - (ck + wait) * 1e3
            rec["checkpoint_s"][gi] = ck
            rec["barrier_s"][gi] = wait
            step.update(ms=0.0, ck=mgr.seconds, barrier=waited["barrier_s"])
            launches, by_dtype = dp_read(counters)
            report(launches=launches, by_dtype=by_dtype,
                   wide=read_wide(attn),
                   save_s=monitor.hist_snapshot("checkpoint.save_seconds"))

        with static.scope_guard(scope):
            cp = static.CompiledProgram(main).with_data_parallel(
                loss_name=loss_name)
            t0 = time.perf_counter()
            g = lr.resume(exe, mgr, main, scope, restore_program=cp)
            torch.cuda.synchronize()
            rec["restore_s"] = time.perf_counter() - t0
            mark("restore")
            rec["setup_s"] = setup
            report(resumed_global=g)
            dp_zero(counters)
            zero_wide(attn)
            feeds = el_feeds(cfg["seed"])[:cfg.get("steps", EL_STEPS)]
            lr.train(run, feeds, EL_LOGICAL, start=g,
                     on_global_step=step_done)
            mgr.wait()
            if lr.rank == 0:
                torch.save(el_params(main, scope), os.path.join(
                    cfg["dir"], f"final_{tag}.pt"))
        mgr.close()
        report(done=True, save_s=monitor.hist_snapshot(
            "checkpoint.save_seconds"),
            checkpoint_bytes=monitor.stat_get("checkpoint.bytes_written"))
    finally:
        tdist.destroy_process_group()
    return 0


def el_launch(cfg, args, chaos=None, timeout=300, wait=True):
    """`python -m paddle_tpu_torch.distributed.launch <args> chip_smoke.py
    --elastic-rank <cfg>` from this checkout, journals under cfg["dir"]:
    its Popen, waited for (`timeout` seconds) unless not `wait`, then
    with the launcher's stderr as `stderr_text`."""
    tmp = cfg["dir"]
    os.makedirs(tmp, exist_ok=True)
    path = os.path.join(tmp, f"cfg_{cfg['tag']}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    env = dict(os.environ)
    env.pop("PADDLE_TPU_CHAOS", None)
    env.pop("PADDLE_TPU_FLEET_DIR", None)
    if chaos:
        env["PADDLE_TPU_CHAOS"] = chaos
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch"] + \
        list(args) + ["--journal_dir", os.path.join(tmp, "journal"),
                      "--term_grace", str(EL_GRACE), "--log_dir",
                      os.path.join(tmp, "logs_" + cfg["tag"]),
                      os.path.abspath(__file__), "--elastic-rank", path]
    # its stderr to <dir>/launcher_<tag>.err; a session of its own, so
    # that a failed phase stops the launcher and its trainers together
    # (el_stop)
    err_path = os.path.join(tmp, f"launcher_{cfg['tag']}.err")
    with open(err_path, "w") as err:
        pr = subprocess.Popen(cmd, cwd=here, env=env, stderr=err,
                              start_new_session=True)
    if not wait:
        return pr
    try:
        pr.wait(timeout)
    finally:
        el_stop([pr])
    with open(err_path) as f:
        pr.stderr_text = f.read()
    return pr


def el_stop(procs):
    """SIGKILL each still-running launcher's session (it and its
    trainers)."""
    import signal
    for pr in procs:
        if pr.poll() is None:
            try:
                os.killpg(pr.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            pr.wait()


def el_out(tmp, tag):
    with open(os.path.join(tmp, f"out_{tag}.json")) as f:
        return json.load(f)


def el_check_rank(rec, layers, want_steps):
    """A launched rank's launches: phase 6's a micro-step in bf16, nothing
    for head dims above 128, over the micro-steps it ran."""
    n = rec["micro_steps"]
    check_equal(f"{rec['tag']} global steps run", sorted(
        int(g) for g in rec["losses"]), want_steps)
    want = {k: v * n for k, v in el_want(layers).items()}
    dp_check_launches(f"{rec['tag']} ({n} micro-steps)", rec["launches"],
                      rec["by_dtype"], want)


def el_phase(torch, seed):
    """(16) elastic training, the checkpoint tier and the launcher's
    re-form, on bench.py's BERT-base AMP step elasticized at logical dp
    EL_LOGICAL, at EL_LAYERS layers.  (a) here, under NCCL at world 1:
    EL_STEPS global steps eagerly, then again through run_steps one window
    a call (bitwise equal); the same at DIST_LAYERS layers for (c).  (b) launch --elastic
    with 2 gloo ranks on the card, rank 1 SIGKILLed, the pod re-formed at
    world 1 under NCCL and SIGTERM'd mid-window, then a fresh 2-rank
    launch finishing: every global step's loss and every final parameter
    bitwise (a)'s.  (c) two --fleet_dir launchers at DIST_LAYERS layers,
    host 1 lost, host 0 re-forming alone from the newest mutual checkpoint
    and finishing bitwise (a)'s reference at that depth; they start with
    (b)'s regrow launch and run beside it, after the kill and the shrink
    ran alone.  The launched ranks parse the program the parent
    serialized, so the recovery seconds leave out the program build
    (~10 s on the card's host) that a relaunched trainer which builds
    its program pays."""
    import torch.distributed as tdist
    from paddle_tpu_torch.distributed.fleet_control import read_commit
    from paddle_tpu_torch.distributed.spawn import get_free_ports
    from paddle_tpu_torch.observability import read_rank_journals
    t_phase = time.perf_counter()
    port = get_free_ports(1)[0]
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=1, rank=0)
    from paddle_tpu_torch.ops import fused_xent as fx
    fx.enable_fused_xent(True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    d_b, d_c = os.path.join(tmp, "b"), os.path.join(tmp, "c")
    try:
        program = el_program(EL_LAYERS)
        program_b = el_save_program(d_b, program)
        ref, ref_params, graph_params = el_reference(torch, seed, program,
                                                     graph=True)
        program = el_program(DIST_LAYERS)
        program_c = el_save_program(d_c, program)
        fref, fref_params, _ = el_reference(torch, seed, program,
                                            steps=EL_FLEET_STEPS)
        del program
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    finally:
        fx.enable_fused_xent(False)
        tdist.destroy_process_group()
    el_compare("(a) run_steps against eager", ref["graph_losses"],
               graph_params, ref["losses"], ref_params)
    del graph_params
    record_wide("elastic_eager", ref["wide"])
    record_wide("elastic_graph", ref["graph_wide"])
    record_wide("elastic_fleet_reference", fref["wide"])
    t_a = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    procs = []
    try:
        base = dict(dir=d_b, seed=seed, layers=EL_LAYERS,
                    program=program_b)
        # (b) kill at world 2, shrink to world 1, SIGTERM mid-window: alone
        # on the card and the host, so its step, checkpoint, restore and
        # recovery seconds are the path's own
        t0 = time.perf_counter()
        p = el_launch(dict(base, tag="b1"),
                      ["--elastic", "--max_restarts", "1",
                       "--nproc_per_node", "2", "--selected_gpus", "0,0"],
                      chaos=f"kill@{EL_KILL_AT}:rank=1;"
                            f"kill@{EL_TERM_AT}:rank=0:signal=term")
        b1_s = time.perf_counter() - t0
        if p.returncode != 1 or "re-forming pod 2 -> 1" not in \
                p.stderr_text or "{0: 143}" not in p.stderr_text:
            raise AssertionError(f"(b) elastic launch: rc {p.returncode}, "
                                 f"{p.stderr_text[-3000:]}")
        # (c) the fleet: two hosts, host 1 lost.  Its launchers run beside
        # (b)'s regrow launch (the phase keeps to its time), so the regrow's
        # and the fleet's seconds are taken with the other on the card
        t_c = time.perf_counter()
        fbase = dict(base, dir=d_c, layers=DIST_LAYERS,
                     program=program_c, steps=EL_FLEET_STEPS)
        procs = [el_launch(dict(fbase, tag=f"c{h}"),
                           ["--elastic", "--ips", "127.0.0.1,127.0.0.1",
                            "--host_rank", str(h), "--nproc_per_node", "1",
                            "--selected_gpus", "0", "--fleet_dir",
                            os.path.join(d_c, "fleet"), "--member_timeout",
                            str(EL_MEMBER_TIMEOUT)],
                           chaos=f"lose_host@{EL_LOSE_AT}:host=1",
                           wait=False) for h in (0, 1)]
        # a fresh two-rank launch regrows and finishes
        t0 = time.perf_counter()
        p = el_launch(dict(base, tag="b2"),
                      ["--nproc_per_node", "2", "--selected_gpus", "0,0"])
        b2_s = time.perf_counter() - t0
        if p.returncode != 0:
            raise AssertionError(f"(b) regrow launch: rc {p.returncode}, "
                                 f"{p.stderr_text[-3000:]}")
        w2 = [el_out(d_b, f"b1_rank{r}_r0") for r in range(2)]
        w1 = el_out(d_b, "b1_rank0_r1")
        rg = [el_out(d_b, f"b2_rank{r}_r0") for r in range(2)]
        check_equal("(b) world 2 backend", w2[0]["backend"], "gloo")
        check_equal("(b) re-formed backend and world",
                    (w1["backend"], w1["world"]), ("nccl", 1))
        el_check_rank(w2[0], EL_LAYERS, [0, 1])
        el_check_rank(w2[1], EL_LAYERS, [0])
        el_check_rank(w1, EL_LAYERS, [2])
        # the re-formed pod's last report is global step 2's (2
        # micro-steps); its 3rd micro-step ended in the SIGTERM, whose
        # preemption save the regrown pod resumes from, rounded down to
        # global step 3 (the partial window replays)
        check_equal("(b) re-formed micro-steps reported", w1["micro_steps"],
                    2)
        for r in rg:
            check_equal(f"(b) {r['tag']} resumed at", r["resumed_global"],
                        3)
            el_check_rank(r, EL_LAYERS, [3])
        losses = [w2[0]["losses"]["0"], w2[0]["losses"]["1"],
                  w1["losses"]["2"], rg[0]["losses"]["3"]]
        final = torch.load(os.path.join(d_b, "final_b2_rank0_r0.pt"))
        el_compare("(b) kill / shrink / regrow against (a)", losses, final,
                   ref["losses"], ref_params)
        del final
        journals = read_rank_journals(os.path.join(d_b, "journal"))
        kill_t = next(e["t"] for e in journals[1]
                      if e["kind"] == "chaos")
        recovery_s = w1["first_step_t"] - kill_t
        kinds = [e["kind"] for e in journals[0]]
        for want in ("restore_merged", "reanchor", "checkpoint_commit"):
            if want not in kinds:
                raise AssertionError(f"(b) rank 0's journal lacks {want}")
        for w in w2 + [w1] + rg:
            record_wide(f"elastic_{w['tag']}", w["wide"])
        # readings of the kill and the shrink (b1: alone) and of the regrow
        # (beside (c)) under names of their own
        b = {"recovery_s": recovery_s, "elastic_launch_s": b1_s,
             "regrow_launch_s": b2_s,
             "world2_global_step_ms": [w2[0]["step_ms"][g]
                                        for g in ("0", "1")],
             "world1_global_step_ms": w1["step_ms"]["2"],
             "regrown_world2_global_step_ms": rg[0]["step_ms"]["3"],
             "checkpoint_barrier_s": {w["tag"]: w["barrier_s"]
                                      for w in w2 + [w1] + rg},
             # each rank's staged bytes a save, from the journals
             "checkpoint_bytes": {r: sorted({e["bytes"] for e in evs
                                             if e["kind"] ==
                                             "checkpoint_save"})
                                  for r, evs in journals.items()},
             "checkpoint_train_side_s": {w["tag"]: w["checkpoint_s"]
                                         for w in w2 + [w1] + rg},
             "checkpoint_save_s": {w["tag"]: w.get("save_s")
                                   for w in w2 + [w1] + rg},
             "restore_s": {w["tag"]: w["restore_s"] for w in [w1] + rg},
             "process_setup_s": {w["tag"]: w.get("setup_s")
                                 for w in w2 + [w1] + rg},
             "fold_calls_per_micro_step": w2[0]["fold_calls"],
             "fold_gathered_bytes_per_micro_step":
                 w2[0]["fold_gathered_bytes"],
             "resumed_global": {"reformed": w1["resumed_global"],
                                "regrown": rg[0]["resumed_global"]},
             "losses": losses, "bitwise_equal": True}
        # (c), started beside (b)'s regrow: wait for the fleet
        try:
            rc0 = procs[0].wait(300)
            rc1 = procs[1].wait(60)
        finally:
            el_stop(procs)
        with open(os.path.join(d_c, "launcher_c0.err")) as f:
            err0 = f.read()
        c_s = time.perf_counter() - t_c
        if rc0 != 0 or rc1 != -9 or "host(s) lost [1]" not in err0:
            raise AssertionError(f"(c) fleet: host 0 rc {rc0}, host 1 rc "
                                 f"{rc1}: {err0[-3000:]}")
        commit = read_commit(os.path.join(d_c, "fleet"), 1)
        check_equal("(c) the re-formed fleet", (commit.members,
                                                commit.world), ([0], 1))
        h0 = el_out(d_c, "host0_e0")
        h1 = el_out(d_c, "host1_e0")
        hr = el_out(d_c, "host0_e1")
        # host 1 went down inside its 4th micro-step: it reported global
        # step 0
        el_check_rank(h1, DIST_LAYERS, [0])
        el_check_rank(hr, DIST_LAYERS, list(range(hr["resumed_global"],
                                                  EL_FLEET_STEPS)))
        check_equal("(c) restored global step", hr["resumed_global"], 2)
        fl_losses = [h0["losses"][str(g)] for g in range(2)] + \
            [hr["losses"][str(g)] for g in range(2, EL_FLEET_STEPS)]
        final = torch.load(os.path.join(d_c, "final_host0_e1.pt"))
        el_compare("(c) fleet re-form against its reference", fl_losses,
                   final, fref["losses"], fref_params)
        del final
        journals = read_rank_journals(os.path.join(d_c, "journal"))
        from paddle_tpu_torch.distributed.fleet_control import \
            CONTROLLER_RANK_BASE
        reforms = [e for e in journals[CONTROLLER_RANK_BASE]
                   if e["kind"] == "reform"]
        lose_t = next(e["t"] for e in journals.get(1, [])
                      if e["kind"] == "chaos")
        agreed_t = next(e["t"] for e in reforms if e["epoch"] == 1)
        for w in (h0, h1, hr):
            record_wide(f"elastic_fleet_{w['tag']}", w["wide"])
        c = {"agreement_s": agreed_t - lose_t, "epoch": commit.epoch,
             "restore_step": commit.restore_step,
             "restored_global": hr["resumed_global"],
             "recovery_s": hr["first_step_t"] - lose_t,
             "fleet_launch_s": c_s, "losses": fl_losses,
             "process_setup_s": {w["tag"]: w.get("setup_s")
                                 for w in (h0, h1, hr)},
             "bitwise_equal": True}
    finally:
        el_stop(procs)
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {
        "elastic_eager_micro_step": {"launches": ref["launches"][-1],
                                     "by_dtype": ref["by_dtype"][-1],
                                     "philox_at_start": 0},
        "elastic_graph_capturing_call": {
            "launches": ref["capturing_launches"],
            "by_dtype": ref["capturing_by_dtype"], "philox_at_start": 0}}
    for w, tag in ((w2[0], "gloo_world2_rank0"),
                   (w1, "nccl_reformed_world1"),
                   (rg[0], "gloo_regrown_world2_rank0"),
                   (hr, "fleet_reformed_host0")):
        n = max(1, w["micro_steps"])
        launches[f"elastic_{tag}_micro_step"] = {
            "launches": {k: v // n for k, v in w["launches"].items()},
            "by_dtype": {k: {d: c // n for d, c in v.items()}
                         for k, v in w["by_dtype"].items()},
            "philox_at_start": 0}
    seconds = time.perf_counter() - t_phase
    res = {"config": f"bench.py's BERT-base AMP step ({EL_LAYERS} layers, "
                     "hidden 768, 12 heads, seq 512, vocab 30522, global batch "
                     f"{TRAIN_BATCH}), flash + fused CE, elasticized at "
                     f"logical dp {EL_LOGICAL} (micro-batch "
                     f"{TRAIN_BATCH // EL_LOGICAL}), a checkpoint every "
                     f"global step; (c) at {DIST_LAYERS} layers",
           "a": {"losses": ref["losses"],
                 "global_step_ms_eager": ref["global_step_ms"],
                 "global_step_ms_replayed": ref["replayed_global_step_ms"],
                 "phase6_replayed_amp_step_ms": GRAPH_STEP_MS.get("amp"),
                 "folds_per_micro_step": ref["folds_per_micro_step"],
                 "cache_stats": ref["cache_stats"],
                 "bitwise_equal": True, "seconds": t_a},
           "b": b, "c": c, "seconds": seconds}
    log({"phase": "elastic", **res})
    return {**res, "launches": launches}


# ---------------------------------------------------------------------------
# phase 17: pipeline parallelism and the parameter-server tier
# ---------------------------------------------------------------------------
PP_STAGES = 2
PP_M = 4                # micro-batches a step
PP_STEPS = 2
# the pipelined step against the plain one on the same batch (one 2 x 512
# block tiled 4 times: every micro-batch the same, so the mean of the
# micro-batch gradients is the batch's): each step's loss within 1e-2
# relative (bf16 GEMMs of 2 and 8 rows a token block round apart), and
# the update gap ||update - update_plain|| / ||update_plain|| over
# PP_STEPS Adam steps under PP_UPDATE_TOL, set between the sound run's
# reading and the planted fault's (stage 1's gradient of the boundary
# activation zeroed before stage 0's backward: stage 0's parameters get
# no gradient), which every run measures and requires above it
PP_LOSS_RTOL = 1e-2
PP_UPDATE_TOL = 0.3
# (b) PaddleRec models/rank/dnn on Criteo: 26 sparse slots of one id into
# one [1000001, 9] table, 13 dense features, fc 512-256-128-32 with relu,
# a 2-way softmax and cross-entropy; synthetic ids and features from
# --seed; SGD; a trainer's batch 512
PS_SLOTS, PS_VOCAB, PS_EMB, PS_DENSE = 26, 1000001, 9, 13
PS_FC = (512, 256, 128, 32)
PS_BATCH = 512
PS_STEPS = 3
PS_SERVERS = PS_TRAINERS = 2
PS_LR = 0.05
# the trainers' parameters against one process of plain SGD on the
# concatenated batch, fp32 both (the servers apply the mean of the two
# trainers' gradients: the batch's gradient up to the order of the sums):
# the update gap under 1e-4 and every element within 1e-5
PS_UPDATE_TOL = 1e-4
PS_ELEM_TOL = 1e-5


def pp_counters():
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import fused_xent as fx
    from paddle_tpu_torch.ops import random as rnd
    return dp_counters(attn, dr, fx, rnd)


def pp_stage_counts(pp, counters):
    """Wrap every phase of the pipeline `pp` to add its kernels' launches
    to its stage's counter; returns {stage: {kernel: launches}}."""
    import collections
    import torch
    pp._build(torch.device("cuda", 0))  # the executor's device
    per = {s: collections.Counter() for s in range(pp._n_stages)}
    for phases in pp._phases.values():
        for s, ph in enumerate(phases):
            def run(env, seed, _orig=ph.run, _s=s):
                before = {k: c.launches for k, c in counters.items()}
                out = _orig(env, seed)
                for k, c in counters.items():
                    per[_s][k] += c.launches - before[k]
                return out
            ph.run = run
    return per


def pp_plant_fault(pp):
    """The planted fault: stage 0's backward sees zeros for the gradient
    of the boundary activation that stage 1's backward hands it."""
    import torch
    pp._build(torch.device("cuda", 0))  # the executor's device
    bwd0, bwd1 = pp._phases["bwd"][0], pp._phases["bwd"][1]
    cut = [n for n in bwd0.in_names if n in set(bwd1.out_names)]
    if not cut:
        raise AssertionError("no gradient crosses the pipeline's cut")

    def run(env, seed, _orig=bwd0.run):
        for n in cut:
            env[n] = torch.zeros_like(env[n])
        return _orig(env, seed)
    bwd0.run = run
    return cut


def pp_run(torch, static, program, loss, init, feed, steps):
    """`steps` exe.run calls of `program` (a Program or the pipeline)
    from a copy of `init`: (losses, scope, step ms, peak bytes)."""
    exe = static.Executor()
    scope = scope_of(static, init)
    losses, ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with static.scope_guard(scope):
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = exe.run(program, feed=feed, fetch_list=[loss])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
    return losses, scope, ms, torch.cuda.max_memory_allocated()


def pp_part(torch, seed):
    """(a) bench.py's BERT-base AMP step (flash, fused CE) cut into 2
    stages under device_guard (gpu:0: the embeddings and layers 0-5;
    gpu:1: layers 6-11, the MLM head and the loss), trained by
    PipelineOptimizer(Adam(1e-4), M = 4) on a batch of 8 (one 2 x 512
    block tiled 4 times); both stages wrap onto the card.  PP_STEPS steps
    against PP_STEPS plain Executor.run steps of the unstaged program
    from the same startup weights, then the planted fault's run."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import fused_xent as fx
    from paddle_tpu_torch.ops import random as rnd
    from paddle_tpu_torch.pipeline import PipelineOptimizer
    block = {k: v[:2] for k, v in train_feed(seed).items()}
    feed = {k: np.concatenate([v] * PP_M) for k, v in block.items()}
    main, startup, loss, _ = bench_program(lambda s: s.Adam(1e-4))
    init, _, _ = startup_weights(torch, static, rnd, startup, seed)
    pmain, _, ploss, popt = bench_program(
        lambda s: s.Adam(1e-4), stages=PP_STAGES,
        outer=lambda s, opt: PipelineOptimizer(opt, num_microbatches=PP_M))
    pp = pmain._pipeline_compiled
    check_equal("pipeline persistables",
                sorted(v.name for v in pmain.list_vars() if v.persistable),
                sorted(v.name for v in main.list_vars() if v.persistable))
    params = [p.name for p in main.all_parameters()]
    counters = pp_counters()
    fx.enable_fused_xent(True)
    try:
        plain_losses, pscope, plain_ms, plain_peak = pp_run(
            torch, static, main, loss, init, feed, PP_STEPS)
        want = {n: pscope.vars[n] for n in params}
        counts = pp_stage_counts(pp, counters)
        dp_zero(counters)
        zero_wide(attn)
        losses, scope, ms, peak = pp_run(torch, static, pp, ploss, init,
                                         feed, PP_STEPS)
        launches, by_dtype = dp_read(counters)
        record_wide("pp_pipeline", read_wide(attn))
        got = {n: scope.vars[n] for n in params}
        stages = {s: dict(c) for s, c in counts.items()}
        # the planted fault, on a pipeline of its own
        fmain, _, floss, _ = bench_program(
            lambda s: s.Adam(1e-4), stages=PP_STAGES,
            outer=lambda s, opt: PipelineOptimizer(opt,
                                                   num_microbatches=PP_M))
        cut = pp_plant_fault(fmain._pipeline_compiled)
        f_losses, fscope, _, _ = pp_run(torch, static,
                                        fmain._pipeline_compiled, floss,
                                        init, feed, PP_STEPS)
        fault = {n: fscope.vars[n] for n in params}
    finally:
        fx.enable_fused_xent(False)
    before = {n: init[n] for n in params}
    gap, worst = dp_update_gap(torch, before, got, want)
    f_gap, _ = dp_update_gap(torch, before, fault, want)
    same_losses("pipeline vs plain", losses, plain_losses, PP_LOSS_RTOL)
    if not gap < PP_UPDATE_TOL < f_gap:
        raise AssertionError(
            f"pipeline update gap {gap} (fault {f_gap}) against "
            f"{PP_UPDATE_TOL}")
    # a step's launches: M micro-batches of the plain step's (phase 5b:
    # 24 forward, the vjp replay included, 12 dQ, 12 dK/dV, 2 fused CE),
    # the layers split evenly, the loss on stage 1
    n = BERT["layers_n"] // PP_STAGES
    want_stage = {0: dict(zip(DP_COUNTED, (2 * n * PP_M, n * PP_M,
                                           n * PP_M, 0, 0, 0))),
                  1: dict(zip(DP_COUNTED, (2 * n * PP_M, n * PP_M,
                                           n * PP_M, 2 * PP_M, 0, 0)))}
    for s in range(PP_STAGES):
        check_equal(f"pipeline stage {s} launches a step",
                    {k: v // PP_STEPS for k, v in stages[s].items()},
                    want_stage[s])
    per_step = {k: v // PP_STEPS for k, v in launches.items()}
    dp_check_launches("pipeline step", per_step,
                      {k: {d: c // PP_STEPS for d, c in v.items()}
                       for k, v in by_dtype.items()},
                      {k: want_stage[0][k] + want_stage[1][k]
                       for k in DP_COUNTED})
    out = {"config": "bert-base AMP bf16, flash + fused CE, 2 stages "
                     "(embeddings + layers 0-5 | layers 6-11 + head), "
                     f"M={PP_M}, batch {TRAIN_BATCH}",
           "losses": losses, "plain_losses": plain_losses,
           "update_gap": gap, "max_abs_diff": worst,
           "fault_update_gap": f_gap, "fault_losses": f_losses,
           "fault_cut": cut, "update_tol": PP_UPDATE_TOL,
           "step_ms": ms, "plain_step_ms": plain_ms,
           "peak_bytes": peak, "plain_peak_bytes": plain_peak,
           "stage_launches": stages, "launches": per_step,
           "by_dtype": {k: {d: c // PP_STEPS for d, c in v.items()}
                        for k, v in by_dtype.items()}}
    log({"phase": "pipeline", **out})
    return out


def ps_program(distributed, lr=PS_LR):
    """The CTR-DNN program (PS_* widths) with the table `is_distributed`
    (row-sharded over the servers) or local; (main, startup, loss,
    the boundary var: the slots' embeddings flattened [B, 26 x 9])."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.static import layers
    _reset_unique_names()
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        ids = layers.data("ids", [-1, PS_SLOTS], dtype="int64")
        dense = layers.data("dense", [-1, PS_DENSE])
        label = layers.data("label", [-1, 1], dtype="int64")
        emb = layers.embedding(ids, size=[PS_VOCAB, PS_EMB], is_sparse=True,
                               is_distributed=distributed,
                               param_attr=static.ParamAttr(name="ctr_emb"))
        flat = layers.reshape(emb, [-1, PS_SLOTS * PS_EMB])
        h = layers.concat([flat, dense], axis=1)
        for width in PS_FC:
            h = layers.fc(h, width, act="relu")
        pred = layers.fc(h, 2, act="softmax")
        loss = layers.mean(layers.cross_entropy(pred, label))
        static.SGD(learning_rate=lr).minimize(loss)
    return main, startup, loss, flat


def ps_batch(seed, step, rows):
    """A global batch of the synthetic Criteo-shaped data: ids uniform
    over the table, features in [0, 1), a label from both."""
    rng = np.random.RandomState(seed * 1000 + step)
    ids = rng.randint(0, PS_VOCAB, (rows, PS_SLOTS)).astype(np.int64)
    dense = rng.rand(rows, PS_DENSE).astype(np.float32)
    label = ((ids[:, 0] % 2) ^ (dense[:, 0] > 0.5)).astype(np.int64)
    return {"ids": ids, "dense": dense, "label": label[:, None]}


def ps_kv_stats():
    """The KV-plane counters of this process's clients, summed."""
    from paddle_tpu_torch.ops.kernels import distributed_ops as dops
    tot = {"calls": 0, "bytes_sent": 0, "bytes_recv": 0, "seconds": 0.0}
    for c in dops.clients().values():
        for k in tot:
            tot[k] += c.stats[k]
    return tot


def ps_rank(cfg_path):
    """One launched process of phase 17 (b) (`python3 chip_smoke.py
    --ps-rank <cfg.json>`, started by `paddle_tpu_torch.distributed.launch
    --run_mode ps`): fleet's role maker reads the launcher's env; a server
    serves its shard of the KV store until trainer 0 shuts the servers
    down; a trainer transpiles ps_program (graph ops, sync, the table
    row-sharded) and trains PS_STEPS steps on its half of each global
    batch on the card, timing each step and its KV traffic, and writes
    its losses, timings and final parameters (the table pulled whole
    from the servers) to trainer<i>.npz."""
    with open(cfg_path) as f:
        cfg = json.load(f)
    import paddle_tpu_torch.distributed.fleet as fleet
    fleet.init()
    if fleet.is_server():
        fleet.init_server()
        fleet.run_server()
        return 0
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import static
    from paddle_tpu_torch.distributed.ps.ps_optimizer import (
        DistributeTranspiler, DistributeTranspilerConfig)
    i, n = fleet.worker_index(), fleet.worker_num()
    main, startup, loss, _ = ps_program(True)
    startup.random_seed = cfg["seed"]
    fleet.init_worker()
    tc = DistributeTranspilerConfig()
    tc.use_graph_ops = True
    tc.sync_mode = True
    t = DistributeTranspiler(tc)
    t.transpile(trainer_id=i, program=main,
                pservers=fleet.server_endpoints(to_string=True),
                trainers=n, startup_program=startup)
    prog = t.get_trainer_program()
    exe = static.Executor()
    scope = static.Scope()
    losses, ms, kv = [], [], []
    with static.scope_guard(scope):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exe.run(startup)
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0
        for step in range(cfg["steps"]):
            full = ps_batch(cfg["seed"], step, PS_BATCH * n)
            mine = {k: v[i * PS_BATCH:(i + 1) * PS_BATCH]
                    for k, v in full.items()}
            s0 = ps_kv_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (lv,) = exe.run(prog, feed=mine, fetch_list=[loss])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            s1 = ps_kv_stats()
            kv.append({k: s1[k] - s0[k] for k in s0})
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
    client = fleet._fleet_singleton._ps_client
    out = {"losses": np.asarray(losses), "step_ms": np.asarray(ms),
           "kv_bytes_sent": np.asarray([k["bytes_sent"] for k in kv]),
           "kv_bytes_recv": np.asarray([k["bytes_recv"] for k in kv]),
           "kv_seconds": np.asarray([k["seconds"] for k in kv]),
           "kv_calls": np.asarray([k["calls"] for k in kv]),
           "startup_s": np.asarray(startup_s),
           "ctr_emb": client.pull_sparse("ctr_emb", np.arange(PS_VOCAB))}
    for p in main.all_parameters():
        if p.name != "ctr_emb":
            out[p.name] = static.as_numpy(scope.get(p.name))
    np.savez(os.path.join(cfg["out_dir"], f"trainer{i}.npz"), **out)
    client.barrier()  # every trainer has read its parameters
    if i == 0:
        fleet.stop_worker()
    return 0


def ps_reference(torch, static, seed, batches):
    """One process of plain SGD (the table local) on the card, fp32, over
    `batches`: (losses, {parameter: tensor}, startup weights)."""
    main, startup, loss, _ = ps_program(False)
    startup.random_seed = seed
    exe = static.Executor()
    scope = static.Scope()
    losses = []
    with static.scope_guard(scope):
        exe.run(startup)
        init = {p.name: scope.vars[p.name].clone()
                for p in main.all_parameters()}
        for b in batches:
            (lv,) = exe.run(main, feed=b, fetch_list=[loss])
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
    return losses, {p.name: scope.vars[p.name]
                    for p in main.all_parameters()}, init


def ps_start(seed, tmp):
    """(b) Start `python -m paddle_tpu_torch.distributed.launch --run_mode
    ps --server_num 2 --worker_num 2 chip_smoke.py --ps-rank <cfg>`: sync
    PS training of the CTR-DNN program at its published widths, the
    [1000001, 9] table row-sharded over the two servers, the dense tower
    on the card in each trainer.  Returns (its Popen, its start time)."""
    cfg = {"seed": seed, "steps": PS_STEPS, "out_dir": tmp}
    path = os.path.join(tmp, "ps_cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--run_mode", "ps", "--server_num", str(PS_SERVERS),
           "--worker_num", str(PS_TRAINERS), "--term_grace", "5",
           "--log_dir", os.path.join(tmp, "ps_logs"),
           os.path.abspath(__file__), "--ps-rank", path]
    return subprocess.Popen(cmd, cwd=here, start_new_session=True), \
        time.perf_counter()


def ps_finish(torch, seed, tmp, pr, t0):
    """(b) Wait for the PS job ps_start began and hold its trainers'
    parameters against ps_reference on the concatenated batches.  The
    trainers share the card and the host with each other, the servers
    and phase 17 (c): their step times are contended."""
    from paddle_tpu_torch import static
    try:
        rc = pr.wait(300)
    finally:
        el_stop([pr])
    job_s = time.perf_counter() - t0
    if rc != 0:
        logs = os.path.join(tmp, "ps_logs")
        tails = {n: open(os.path.join(logs, n)).read()[-2000:]
                 for n in sorted(os.listdir(logs))}
        raise AssertionError(f"the PS job exited {rc}: {tails}")
    ranks = [dict(np.load(os.path.join(tmp, f"trainer{i}.npz")))
             for i in range(PS_TRAINERS)]
    batches = [ps_batch(seed, s, PS_BATCH * PS_TRAINERS)
               for s in range(PS_STEPS)]
    want_losses, want, init = ps_reference(torch, static, seed, batches)
    res = {}
    for i, r in enumerate(ranks):
        got = {n: torch.from_numpy(r[n]) for n in want}
        gap, worst = dp_update_gap(torch, init, got, want)
        if not (gap < PS_UPDATE_TOL and worst < PS_ELEM_TOL):
            raise AssertionError(
                f"PS trainer {i}: update gap {gap}, largest difference "
                f"{worst} against one process (tolerances "
                f"{PS_UPDATE_TOL}, {PS_ELEM_TOL})")
        res[f"trainer{i}"] = {
            "update_gap": gap, "max_abs_diff": worst,
            "losses": r["losses"].tolist(), "step_ms": r["step_ms"].tolist(),
            "kv_bytes_sent_per_step": r["kv_bytes_sent"].tolist(),
            "kv_bytes_recv_per_step": r["kv_bytes_recv"].tolist(),
            "kv_calls_per_step": r["kv_calls"].tolist(),
            "kv_share_of_step": (r["kv_seconds"] * 1e3
                                 / r["step_ms"]).tolist(),
            "startup_s": float(r["startup_s"])}
    mean_loss = np.mean([r["losses"] for r in ranks], axis=0)
    out = {"config": "PaddleRec rank/dnn widths (26 x [1000001, 9] table, "
                     "13 dense, fc 512-256-128-32, softmax CE), SGD, sync, "
                     f"{PS_SERVERS} servers x {PS_TRAINERS} trainers, batch "
                     f"{PS_BATCH} a trainer",
           "job_seconds": job_s, "reference_losses": want_losses,
           "trainers_mean_losses": mean_loss.tolist(),
           "update_tol": PS_UPDATE_TOL, "elem_tol": PS_ELEM_TOL,
           "contended": "trainers, servers and launcher share the card "
                        "and host with each other and with (c)", **res}
    log({"phase": "parameter_server", **out})
    return out


def heter_cpu(spec_path):
    """The CPU section of phase 17 (c) (`python3 chip_smoke.py --heter-cpu
    <spec.json>`): the startup program and PS_STEPS steps of the section
    on the host (CPUPlace) against the KV tier."""
    with open(spec_path) as f:
        spec = json.load(f)
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core.program import Program
    startup = Program.from_dict(spec["startup"])
    cpu = Program.from_dict(spec["cpu_program"])
    exe = static.Executor(static.CPUPlace())
    with static.scope_guard(static.Scope()):
        exe.run(startup)
        for step in range(spec["steps"]):
            b = ps_batch(spec["seed"], step, PS_BATCH)
            exe.run(cpu, feed={"ids": b["ids"]}, fetch_list=[])
    return 0


def heter_part(torch, seed, tmp):
    """(c) The CTR-DNN program transpiled in heter mode and cut by
    split_heter_program at the slots' flattened embeddings: the CPU
    section (lookup, the table's gradient and sparse push) in a launched
    CPU process, the device section (the dense tower, its backward and
    SGD) here on the card, bridged by heter_send / heter_recv over a
    KVServer of this process; PS_STEPS steps against the unsplit program
    (the table local) on the card from the same weights and batches."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.distributed.heter import split_heter_program
    from paddle_tpu_torch.distributed.ps.kv_server import KVClient, KVServer
    from paddle_tpu_torch.distributed.ps.ps_optimizer import (
        DistributeTranspiler, DistributeTranspilerConfig)
    from paddle_tpu_torch.ops.kernels import distributed_ops as dops
    batches = [ps_batch(seed, s, PS_BATCH) for s in range(PS_STEPS)]
    want_losses, want, init = ps_reference(torch, static, seed, batches)
    srv = KVServer("127.0.0.1:0", num_trainers=1)
    srv.serve_in_thread()
    proc = None
    try:
        seed_client = KVClient([srv.endpoint])
        # the table's weights first (the init push is first-writer-wins)
        seed_client.init_sparse_table("ctr_emb",
                                      init["ctr_emb"].cpu().numpy())
        main, startup, loss, flat = ps_program(True)
        startup.random_seed = seed
        tc = DistributeTranspilerConfig()
        tc.use_graph_ops = tc.heter_mode = tc.sync_mode = True
        t = DistributeTranspiler(tc)
        t.transpile(trainer_id=0, program=main, pservers=srv.endpoint,
                    trainers=1, startup_program=startup)
        cpu, dev = split_heter_program(t.get_trainer_program(), [flat],
                                       [srv.endpoint], batch_size=PS_BATCH,
                                       timeout=300.0)
        check_equal("heter feeds", (cpu.feeds, sorted(dev.feeds)),
                    (["ids"], ["dense", "label"]))
        spec = {"startup": t.get_startup_program().to_dict(),
                "cpu_program": cpu.program.to_dict(), "seed": seed,
                "steps": PS_STEPS}
        path = os.path.join(tmp, "heter_spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        here = os.path.dirname(os.path.abspath(__file__))
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--heter-cpu",
             path], cwd=here, env=dict(os.environ, PADDLE_TRAINER_ID="0",
                                       CUDA_VISIBLE_DEVICES=""),
            start_new_session=True)
        exe = static.Executor()
        scope = static.Scope()
        losses, ms = [], []
        with static.scope_guard(scope):
            exe.run(t.get_startup_program())
            for n, v in init.items():
                if n != "ctr_emb":
                    scope.set(n, v.clone())
            for step in range(PS_STEPS):
                b = batches[step]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                (lv,) = exe.run(dev.program, feed={"dense": b["dense"],
                                                   "label": b["label"]},
                                fetch_list=[loss])
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(np.asarray(lv).reshape(-1)[0]))
        if proc.wait(300) != 0:
            raise AssertionError("the heter CPU section's process failed")
        got = {n: scope.vars[n] for n in want if n != "ctr_emb"}
        # the table: wait until the CPU section's last push is applied
        got["ctr_emb"] = torch.from_numpy(seed_client.pull_sparse(
            "ctr_emb", np.arange(PS_VOCAB)))
        seed_client.close()
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        dops._reset_clients()
        srv.stop()
    gap, worst = dp_update_gap(torch, init, got, want)
    same_losses("heter vs unsplit", losses, want_losses, 1e-5)
    if not (gap < PS_UPDATE_TOL and worst < PS_ELEM_TOL):
        raise AssertionError(f"heter: update gap {gap}, largest difference "
                             f"{worst} against the unsplit program")
    out = {"losses": losses, "unsplit_losses": want_losses,
           "update_gap": gap, "max_abs_diff": worst,
           "device_step_ms": ms,
           "contended": "the CPU section's process shares the host, the "
                        "card and the host with (b)'s job"}
    log({"phase": "heter", **out})
    return out


def pp_ps_phase(torch, seed):
    """(17) The pipeline (a) alone, then the parameter-server job (b) and
    heter (c) side by side."""
    out = {}
    t0 = time.perf_counter()
    out["pipeline"] = pp_part(torch, seed)
    out["pipeline"]["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ps_")
    pr = None
    try:
        t0 = time.perf_counter()
        pr, t_ps = ps_start(seed, tmp)
        out["heter"] = heter_part(torch, seed, tmp)
        out["heter"]["seconds"] = time.perf_counter() - t0
        out["ps"] = ps_finish(torch, seed, tmp, pr, t_ps)
        out["ps"]["seconds"] = time.perf_counter() - t0
    finally:
        if pr is not None:
            el_stop([pr])
        shutil.rmtree(tmp, ignore_errors=True)
    log({"phase": "pp_ps_seconds", **{k: v["seconds"]
                                       for k, v in out.items()}})
    return out


# phase 18: the analysis and planner tiers on the card (static/verifier.py,
# layout_analysis.py, memory_analysis.py, flops_analysis.py, planner.py,
# PADDLE_TPU_VERIFY, FLAGS_recompute="auto", kv_pool="auto" and the
# executor's telemetry) on bench.py's BERT-base AMP step at full width
AN_STEPS = 20            # (b) replayed steps the MFU gauge is read over
AN_MFU_TOL = 0.01        # the gauge against its own arithmetic
AN_FLOPS_TOL = 0.10      # walked against analytic FLOPs (the JAX bench's)
AN_REPLAYS = 2           # (c) replayed steps of "auto" against "always"
AN_PLAN_KNOBS = {"batch": (8, 16, 32), "remat": (False, True),
                 "grad_merge": (1, 2)}
AN_PLAN_STEPS = 3        # (e) replayed steps of the plan and the runner-up
AN_RECORDED_MFU = "7.1-7.7% (PERF.md section 5: phase 6's replayed AMP step)"


def an_build(recompute=""):
    """build_pretrain(flash, AMP) under FLAGS_recompute=`recompute`, the
    auto walk's -1 dims bound to the training batch."""
    from paddle_tpu_torch.core.flags import set_flags
    set_flags({"recompute": recompute, "hbm_assume_batch": TRAIN_BATCH})
    try:
        return build_pretrain(True, True)
    finally:
        set_flags({"recompute": "", "hbm_assume_batch": 0})


def an_scope(static, startup, init):
    """A scope from `startup` (the persistables a rewrite added: merge
    accumulators, step counters) holding copies of `init`'s weights."""
    scope = static.Scope()
    with static.scope_guard(scope):
        static.Executor().run(startup)
    for n, t in init.items():
        scope.set(n, t.clone())
    return scope


def an_feed(torch, seed, batch, k=None):
    """The training feed at `batch` rows (k stacked steps), on the card."""
    rng = np.random.RandomState(seed)
    seq, vocab = BERT["seq"], BERT["vocab"]
    feed = {"ids": rng.randint(0, vocab, (batch, seq)).astype(np.int64),
            "pos": np.tile(np.arange(seq, dtype=np.int64), (batch, 1)),
            "labels": rng.randint(0, vocab, (batch, seq, 1))
            .astype(np.int64)}
    if k is not None:
        feed = {n: np.stack([v] * k) for n, v in feed.items()}
    return {n: torch.as_tensor(v, device="cuda") for n, v in feed.items()}


def an_held_bytes(torch, scope):
    """Bytes of `scope`'s tensors on the card: the persistables a walk's
    peak counts."""
    return sum(t.numel() * t.element_size() for t in scope.vars.values()
               if isinstance(t, torch.Tensor) and t.is_cuda)


def an_peak(torch, scope, fn):
    """The peak bytes of `fn()` as the walk counts them: the allocator's
    peak over the call above what was allocated when it started, plus
    `scope`'s tensors; tensors of earlier work that are freed meanwhile
    (a collected cycle) cannot lower it."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - held + \
        an_held_bytes(torch, scope), out


def an_small_sharded(static):
    """tools/verify_smoke.py's small ZeRO-1 program (dp 8), in the port."""
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.distributed.sharding import shard_optimizer_states
    layers = static.layers
    _reset_unique_names()
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = layers.data("x", [-1, 16])
        y = layers.data("y", [-1, 1])
        pred = layers.fc(layers.fc(x, 32, act="relu"), 1)
        loss = layers.mean(layers.square(layers.elementwise_sub(pred, y)))
        static.Adam(learning_rate=1e-3).minimize(loss)
    shard_optimizer_states(main, startup, dp_degree=8)
    return main, startup, loss


def an_planted(torch, static, code):
    """The program with its fault planted (a collective in a sub-block:
    V205; a forward-role read of a parameter after its commit: V302), run
    once: the executor's first-run verification must raise, naming
    `code`."""
    from paddle_tpu_torch.core.program import OpDesc, OpRole
    from paddle_tpu_torch.static.verifier import ProgramVerificationError
    main, startup, loss = an_small_sharded(static)
    blk = main.global_block()
    if code == "V205":
        sub = main.create_block()
        main.rollback()
        sub.ops.append(OpDesc("c_allreduce_sum", {"X": ["x"]},
                              {"Out": ["x"]},
                              {"ring_id": 0, "op_uid": main._next_uid()}))
    else:
        param = main.all_parameters()[0]
        blk.create_var(name="post_commit_read", shape=param.shape,
                       dtype=param.dtype, stop_gradient=True)
        blk.ops.append(OpDesc(
            "scale", {"X": [param.name]}, {"Out": ["post_commit_read"]},
            {"scale": 2.0, OpRole.KEY: OpRole.Forward,
             "op_uid": main._next_uid()}))
    main._fingerprint_cache = None
    feed = {"x": np.zeros((8, 16), np.float32),
            "y": np.zeros((8, 1), np.float32)}
    try:
        with static.scope_guard(static.Scope()):
            static.Executor().run(main, feed=feed, fetch_list=[loss])
    except ProgramVerificationError as e:
        codes = e.report.codes()
        if code not in codes:
            raise AssertionError(f"planted {code}: raised {codes}")
        return codes
    raise AssertionError(f"planted {code}: the first run did not raise")


def an_verify(torch, static, amp, tmp):
    """(a) 0 diagnostics on the clean programs; the planted faults raise."""
    from paddle_tpu_torch.inference import Config, create_predictor
    t0 = time.perf_counter()
    main, startup, loss = amp
    fm, fs, fl = build_pretrain(True, False)
    # the Predictor self-checks its post-pipeline program at load (strict)
    pred = create_predictor(Config(os.path.join(tmp, "bert_flash")))
    zm, zs, zl, _ = zt_program(1, 1)
    checks = {
        "amp_main": (main, dict(startup=startup, fetch_list=[loss])),
        "amp_startup": (startup, {}),
        "fp32_main": (fm, dict(startup=fs, fetch_list=[fl])),
        "predictor_post_pipeline": (pred._program,
                                    dict(fetch_list=pred._fetch_names)),
        f"zero1_world{DP_RANKS}_{DIST_LAYERS}_layers": (
            zm, dict(startup=zs, fetch_list=[zl]))}
    found = {}
    for tag, (prog, kw) in checks.items():
        rep = static.check_program(prog, level="all", **kw)
        found[tag] = len(rep.diagnostics)
        if rep.diagnostics:
            raise AssertionError(f"verify {tag}: {rep.render()}")
    clean_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    planted = {code: an_planted(torch, static, code)
               for code in ("V205", "V302")}
    return {"diagnostics": found, "planted_raised": planted,
            "clean_checks_s": clean_s,
            "planted_s": time.perf_counter() - t0}


def an_mfu(torch, static, amp, init, seed):
    """(b) the walked FLOPs against the analytic count; the MFU gauge of
    AN_STEPS replayed steps against its own arithmetic.  Returns (record,
    the replayed step's measured peak bytes: its capturing call's)."""
    from paddle_tpu_torch.core.monitor import gauge_get
    from paddle_tpu_torch.static.flops_analysis import peak_flops_per_chip
    main, startup, loss = amp
    walked = static.analyze_flops(main, batch=TRAIN_BATCH)["total_flops"]
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    tokens = TRAIN_BATCH * BERT["seq"]
    analytic = 6 * n_params * tokens + 12 * BERT["layers_n"] * \
        BERT["seq"] * BERT["hidden"] * tokens
    drift = walked / analytic - 1.0
    if abs(drift) >= AN_FLOPS_TOL:
        raise AssertionError(f"walked FLOPs {walked} against analytic "
                             f"{analytic}: {drift:+.4f}")
    stacked = an_feed(torch, seed, TRAIN_BATCH, AN_STEPS)
    exe = static.Executor()
    scope = scope_of(static, init)
    with static.scope_guard(scope):
        capture_peak, _ = an_peak(torch, scope, lambda: exe.run_steps(
            main, feed=stacked, fetch_list=[loss]))  # captures
        t0 = time.perf_counter()
        (lv,) = exe.run_steps(main, feed=stacked, fetch_list=[loss])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    gauge = gauge_get("train.mfu")
    want = walked * AN_STEPS / dt / peak_flops_per_chip()
    if not abs(gauge / want - 1.0) <= AN_MFU_TOL:
        raise AssertionError(f"train.mfu gauge {gauge} against walked "
                             f"FLOPs / measured s / peak {want}")
    lv = np.asarray(lv, np.float32).reshape(-1)
    if not np.isfinite(lv).all():
        raise AssertionError(f"replayed losses {lv}")
    check_equal("(b) captures", exe.cache_stats()["traces"], 1)
    exe.close()
    return {"walked_flops": walked, "analytic_flops": analytic,
            "drift": drift, "mfu_gauge": gauge,
            "mfu_from_walked_flops_and_measured_s": want,
            "tokens_per_sec_gauge": gauge_get("train.tokens_per_sec"),
            "replayed_step_ms": dt * 1e3 / AN_STEPS,
            "peak_flops_per_s": peak_flops_per_chip(),
            "recorded_mfu": AN_RECORDED_MFU}, capture_peak


def an_memory(torch, static, amp, init, seed, replayed_peak, counters):
    """(c) predicted against measured peak bytes; FLAGS_recompute="auto"
    at the card's budget and at the midpoint budget.  The eager AMP step
    (memory_report's measured step) launches 2 flash forwards a layer
    (one replayed by the vjp), a dQ, a dK/dV and 2 fused CE, all bf16."""
    from paddle_tpu_torch.core.pass_framework import has_applied
    from paddle_tpu_torch.static.memory_analysis import (DEVICE_SLACK,
                                                        HBM_BUDGET_ENV)
    main, startup, loss = amp
    feed = an_feed(torch, seed, TRAIN_BATCH)
    always = an_build("always")
    predicted = {
        tag: static.analyze_program(m, batch=TRAIN_BATCH)["peak_bytes"]
        for tag, m in (("plain", main), ("always", always[0]))}
    # the eager step: memory_report's measured step (its own scratch
    # scope over this one), above what was allocated when it started,
    # plus the persistables
    import gc
    gc.collect()
    exe = static.Executor()
    scope = scope_of(static, init)
    before = dp_read(counters)
    report = exe.memory_report(main, feed=feed, scope=scope)
    after = dp_read(counters)
    eager = report["device"]["max_memory_allocated"] - \
        report["device"]["allocated_before_step"] + \
        an_held_bytes(torch, scope)
    del scope
    n = BERT["layers_n"]
    step = {k: after[0][k] - before[0][k] for k in DP_KERNELS}
    step_bf16 = {k: after[1][k].get("bfloat16", 0) -
                 before[1][k].get("bfloat16", 0) for k in DP_KERNELS}
    want = dict(zip(DP_KERNELS, (2 * n, n, n, 2)))
    check_equal("(c) eager AMP step launches", step, want)
    check_equal("(c) eager AMP step bf16 launches", step_bf16, want)
    scope = scope_of(static, init)
    with static.scope_guard(scope):
        always_peak, _ = an_peak(torch, scope, lambda: exe.run(
            always[0], feed=feed, fetch_list=[always[2]]))
    del scope
    measured = {"eager": eager, "replayed_capture": replayed_peak,
                "always_eager": always_peak}
    slack = {"eager": eager / predicted["plain"],
             "replayed_capture": replayed_peak / predicted["plain"],
             "always_eager": always_peak / predicted["always"]}
    # "auto" at the card's budget: the plain program
    auto = an_build("auto")
    card_budget = static.hbm_budget_bytes()
    if auto[0].to_dict() != main.to_dict() or \
            auto[1].to_dict() != startup.to_dict():
        raise AssertionError("auto at the card's budget is not the plain "
                             "program")
    # "auto" at the midpoint of the walked peaks: the "always" program
    mid = (predicted["plain"] + predicted["always"]) // 2
    prev = os.environ.get(HBM_BUDGET_ENV)
    os.environ[HBM_BUDGET_ENV] = str(mid)
    try:
        tight = an_build("auto")
    finally:
        if prev is None:
            del os.environ[HBM_BUDGET_ENV]
        else:
            os.environ[HBM_BUDGET_ENV] = prev
    if not has_applied(tight[0], "recompute") or \
            tight[0].to_dict() != always[0].to_dict():
        raise AssertionError("auto at the midpoint budget is not the "
                             "\"always\" program")
    losses = {}
    for tag, (m, s, l) in (("auto", tight), ("always", always)):
        scope = scope_of(static, init)
        rexe = static.Executor()
        with static.scope_guard(scope):
            (lv,) = rexe.run_steps(
                m, feed=an_feed(torch, seed, TRAIN_BATCH, AN_REPLAYS),
                fetch_list=[l])
        losses[tag] = np.asarray(lv, np.float32).reshape(-1).tolist()
        rexe.close()
        del scope
    if losses["auto"] != losses["always"]:
        raise AssertionError(f"auto {losses['auto']} against always "
                             f"{losses['always']}")
    return {"predicted_peak_bytes": predicted, "measured_peak_bytes":
            measured, "measured_over_predicted": slack,
            "device_slack_in_code": DEVICE_SLACK,
            "memory_report_device": report["device"],
            "memory_report_fits": report["fits"],
            "card_budget_bytes": card_budget, "midpoint_budget_bytes": mid,
            "always_measured_over_midpoint": always_peak / mid,
            "auto_losses": losses["auto"], "eager_step_launches": step}


def an_kv_pool(torch, gen):
    """(d) kv_pool="auto" against the explicit pool on phase 7's first
    PX_POSTS posts."""
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          budget_drift)
    model, bodies = gen["model"], gen["bodies"][:PX_POSTS]
    outs = {}
    plan = None
    for tag, kv in (("explicit", dict(GEN_PLAN)), ("auto", "auto")):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        eng = ContinuousBatchingEngine(
            model, max_slots=GEN_PLAN["max_slots"], kv_pool=kv,
            prefix_cache="auto").start()
        try:
            futs = [eng.submit(
                np.asarray(b["input_ids"], np.int64), max_length=PX_NEW,
                decode_strategy=b.get("decode_strategy", "greedy_search"),
                top_k=b.get("top_k", 0),
                temperature=b.get("temperature", 1.0),
                seed=b.get("seed", 0)) for b in bodies]
            outs[tag] = [np.asarray(f.result(timeout=600)) for f in futs]
        finally:
            eng.stop()
        if tag == "auto":
            pool = eng.kv_pool
            plan = dict(pool.plan)
            drift = budget_drift(pool, model)
            if drift:
                raise AssertionError(f"kv_pool auto drift: {drift}")
            pool_bytes = pool.pool_bytes
        eng.kv_pool.assert_drained()
        del eng
    torch.cuda.empty_cache()
    diverged = spec_divergences(torch, model, bodies, outs["auto"],
                                outs["explicit"], "kv_pool auto")
    return {"posts": len(bodies), "new_tokens": PX_NEW,
            "posts_equal": len(bodies) - len(diverged),
            "divergences": diverged, "pages": plan["pages"],
            "kv_bytes": plan["kv_bytes"], "pool_bytes": pool_bytes,
            "max_slots": plan["max_slots"],
            "budget_bytes": plan["hbm_bytes"],
            "explicit_pages": GEN_PLAN["pages"]}


def an_plan(torch, static, amp, init, seed):
    """(e) plan_program on the AMP program at world 1; the argmax applied,
    verified, replayed beside the runner-up; its first loss bitwise a
    hand-applied build's."""
    from paddle_tpu_torch.distributed.scan_window import mark_scan_hoist
    from paddle_tpu_torch.static import planner
    main, startup, loss = amp
    t0 = time.perf_counter()
    plan = static.plan_program(main, startup, world=1,
                               knobs=dict(AN_PLAN_KNOBS))
    plan_s = time.perf_counter() - t0
    if plan.predicted_calibrated:
        raise AssertionError("the plan passed through a calibration")
    ranked = sorted((c for c in plan.trace if c["fits"]
                     and c["verdict"].startswith("verified")),
                    key=lambda c: -c["samples_per_sec"])
    knob_keys = ("batch", "remat", "grad_merge", "scan_hoist")
    chosen = {k: plan.knobs[k] for k in knob_keys}
    runner = next(c for c in ranked
                  if {k: c[k] for k in knob_keys} != chosen)
    out = {"plan_s": plan_s, "n_candidates": len(plan.trace),
           "chosen": plan.knobs,
           "runner_up_knobs": {k: runner[k] for k in knob_keys},
           "trace": [{k: c[k] for k in knob_keys + (
               "peak_bytes", "fits", "step_ms", "samples_per_sec",
               "verdict")} for c in plan.trace]}
    first = None
    runner_knobs = {k: runner[k] for k in planner.KNOB_KEYS}
    for tag, knobs in (("plan", plan), ("runner_up", runner_knobs)):
        m, s = main.clone(), startup.clone()
        static.apply_plan(m, s, knobs)
        rep = static.check_program(m, level="collective", startup=s,
                                   fetch_list=[loss])
        if tag == "plan" and rep.diagnostics:
            raise AssertionError(f"the plan: {rep.render()}")
        rec = runner
        batch = int(plan.batch if tag == "plan" else knobs["batch"])
        feed = an_feed(torch, seed, batch, AN_PLAN_STEPS)
        scope = an_scope(static, s, init)
        exe = static.Executor()
        with static.scope_guard(scope):
            (lv,) = exe.run_steps(m, feed=feed, fetch_list=[loss])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            exe.run_steps(m, feed=feed, fetch_list=[loss])
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / AN_PLAN_STEPS
        exe.close()
        del scope
        lv = np.asarray(lv, np.float32).reshape(-1)
        if not np.isfinite(lv).all():
            raise AssertionError(f"{tag}: losses {lv}")
        if tag == "plan":
            first = float(lv[0])
            pm, ps = m, s
        out[tag] = {
            "predicted_step_ms": plan.predicted_step_ms
            if tag == "plan" else rec["step_ms"],
            "measured_step_ms": step_ms,
            "tokens_per_s": batch * BERT["seq"] / (step_ms / 1e3),
            "predicted_peak_bytes": plan.predicted_peak_bytes
            if tag == "plan" else rec["peak_bytes"],
            "losses": lv.tolist()}
    # the same knobs by hand on a build of the plain program
    hm, hs = main.clone(), startup.clone()
    if plan.knobs["remat"]:
        static.apply_recompute(hm)
    if plan.knobs["grad_merge"] > 1:
        static.gradient_merge(hm, plan.knobs["grad_merge"], hs)
    if plan.knobs["scan_hoist"]:
        mark_scan_hoist(hm)
    if hm.to_dict() != pm.to_dict() or hs.to_dict() != ps.to_dict():
        raise AssertionError("the hand-applied knobs give another program")
    scope = an_scope(static, hs, init)
    with static.scope_guard(scope):
        (hl,) = static.Executor().run(
            hm, feed=an_feed(torch, seed, int(plan.knobs["batch"])),
            fetch_list=[loss])
    del scope
    hand = float(np.asarray(hl, np.float32).reshape(-1)[0])
    if np.float32(hand).tobytes() != np.float32(first).tobytes():
        raise AssertionError(f"plan first loss {first} against the "
                             f"hand-applied build's {hand}")
    out["first_loss_bitwise_hand_applied"] = True
    out["measured_ranking_agrees"] = (
        out["plan"]["measured_step_ms"] / plan.knobs["batch"] <=
        out["runner_up"]["measured_step_ms"] / runner["batch"])
    return out


def analysis_phase(torch, seed, tmp, gen):
    """(18) the analysis and planner tiers on the bench step, under
    PADDLE_TPU_VERIFY=strict.  Returns the record with the launches of
    the eager AMP step and of the whole phase."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import fused_xent as fx
    from paddle_tpu_torch.ops import random as rnd
    from paddle_tpu_torch.static.verifier import VERIFY_ENV
    t_phase = time.perf_counter()
    prev = os.environ.get(VERIFY_ENV)
    os.environ[VERIFY_ENV] = "strict"
    counters = dp_counters(attn, dr, fx, rnd)
    fx.enable_fused_xent(True)
    out = {"seconds": {}}
    try:
        # ---- phase 18's path: counts from 0 just before, read after
        dp_zero(counters)
        zero_wide(attn)
        t0 = time.perf_counter()
        out["kv_pool_auto"] = an_kv_pool(torch, gen)
        out["seconds"]["d_kv_pool"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        amp = an_build()
        amp[1].random_seed = seed
        init_scope = static.Scope()
        with static.scope_guard(init_scope):
            static.Executor().run(amp[1])
        init = {n: t for n, t in init_scope.vars.items() if t is not None}
        out["seconds"]["build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["verify"] = an_verify(torch, static, amp, tmp)
        out["seconds"]["a_verify"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["flops_mfu"], replayed_peak = an_mfu(torch, static, amp, init,
                                                 seed)
        out["seconds"]["b_flops_mfu"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["memory"] = an_memory(torch, static, amp, init, seed,
                                  replayed_peak, counters)
        out["seconds"]["c_memory"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["plan"] = an_plan(torch, static, amp, init, seed)
        out["seconds"]["e_plan"] = time.perf_counter() - t0
        launches, by_dtype = dp_read(counters)
        record_wide("analysis", read_wide(attn))
        # ---- end of phase 18's path
    finally:
        fx.enable_fused_xent(False)
        if prev is None:
            os.environ.pop(VERIFY_ENV, None)
        else:
            os.environ[VERIFY_ENV] = prev
        torch.cuda.empty_cache()
    out["launches"] = {"phase": {"launches": launches, "by_dtype": by_dtype},
                       "eager_amp_step": out["memory"]["eager_step_launches"]}
    out["seconds"]["total"] = time.perf_counter() - t_phase
    log({"phase": "analysis", "config": "bench.py's BERT-base AMP step "
         "(vocab 30522, seq 512, hidden 768, 12 layers, 12 heads, batch "
         "8, flash, fused CE), PADDLE_TPU_VERIFY=strict; kv_pool auto "
         "on phase 7's GPT-2 small", **out})
    return out



# phase 19: the 2.0 high-level path: hapi Model.fit / evaluate / predict /
# save / load over io.DataLoader, metric and the callbacks, prepare(use_jit
# =True) over jit.to_static, and dy2static control flow on the card
HL_FIT_BATCHES = 6      # (a) fit batches of TRAIN_BATCH; eval 2, predict 1
HL_EVAL_BATCHES = 2
HL_PREDICT_BATCHES = 1
HL_RESNET = dict(batch=32, img=224, classes=1000, batches=4, workers=2)
# (b)'s gates, written before the chip run that first read them.  Each
# jit fit step against a use_jit=False step of a copy of the state it
# started from (weights, batch-norm statistics, Momentum velocities) on
# the same batch: the loss within HL_JIT_RTOL relative, and every leaf of
# the state after the step (each parameter, buffer and velocity) within
# HL_STATE_TOL of the jit step's, as max |a - b| / max |b| over the leaf.
# Two planted faults must read above HL_STATE_TOL: the step with its
# gradients zeroed, and the state with the batch-norm write-back left
# out.  Free-running, a use_jit=False fit of a weight copy is held to
# both tolerances over all 4 steps with torch.backends.cudnn.deterministic
# on; in cuDNN's default mode the two fits are recorded, not gated: its
# weight-gradient sums are not reproducible run to run, and on random
# labels Momentum amplifies them (NVIDIA H100 80GB HBM3, 700 W: the
# default-mode losses part by 0 / 3.0e-6 / 9.4e-4 / 2.5e-3 relative over
# the 4 steps, the deterministic ones agree to the bit; a lockstep state
# reads 1.9e-5 to 4.1e-5, the planted faults 0.56 and above)
HL_JIT_RTOL = 1e-5
HL_STATE_TOL = 1e-3
HL_SAVE_TOL = 1e-5      # (b) TranslatedLayer / Predictor vs eval forward
HL_PATHS = ("hl_bert_fit", "hl_resnet_jit_fit")


class HLBertData:
    """(a)'s map-style dataset: sample i is row i % TRAIN_BATCH of one
    fixed pretraining batch (ids and MLM labels [512], the NSP label), so
    every batch of 8 is that batch (the memorization of phase 9)."""

    def __init__(self, seed, n):
        rng = np.random.RandomState(seed)
        b, seq, vocab = TRAIN_BATCH, BERT["seq"], BERT["vocab"]
        self.ids = rng.randint(0, vocab, (b, seq)).astype(np.int64)
        self.labels = rng.randint(0, vocab, (b, seq)).astype(np.int64)
        self.nsp = rng.randint(0, 2, (b,)).astype(np.int64)
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        r = i % TRAIN_BATCH
        return self.ids[r], self.labels[r], self.nsp[r]


class HLImages:
    """(b)'s map-style dataset: image i [3, 224, 224] fp32 and its label
    [1], drawn from (seed, i) in the worker that loads it."""

    def __init__(self, seed, n, img, classes):
        self.seed, self.n, self.img, self.classes = seed, n, img, classes

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(self.seed * 100003 + i)
        return (rng.rand(3, self.img, self.img).astype(np.float32),
                np.asarray([rng.randint(self.classes)], np.int64))


def hl_callbacks(base, counters=None):
    """A callback recording each train batch's loss (fit's `logs`), its
    host ms from the batch's begin to its end (train_batch reads the loss
    on the host, so its kernels have finished; the first begins after
    the loader's first batch), and with `counters` the hand kernels'
    launches between the two ({kernel: n} and {kernel: {dtype: n}})."""
    class Recording(base):
        def __init__(self):
            super().__init__()
            self.losses = []
            self.step_ms = []
            self.step_launches = []
            self.step_by_dtype = []
            self.epochs = 0
            self._t0 = None

        def on_train_batch_begin(self, step, logs=None):
            if counters is not None:
                self._n0 = dp_read(counters)
            self._t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"]))
            self.step_ms.append((time.perf_counter() - self._t0) * 1e3)
            if counters is not None:
                (l0, d0), (l1, d1) = self._n0, dp_read(counters)
                self.step_launches.append({k: l1[k] - l0[k] for k in l1})
                self.step_by_dtype.append({
                    k: {dt: n - d0[k].get(dt, 0) for dt, n in d1[k].items()
                        if n != d0[k].get(dt, 0)} for k in d1})

        def on_epoch_end(self, epoch, logs=None):
            self.epochs += 1
    return Recording()


def hl_state(model):
    """A copy on the card of a hapi Model's state: ({name: tensor} of its
    network's parameters and buffers, {name: tensor} of its optimizer's
    accumulators)."""
    return ({k: v.detach().clone()
             for k, v in model.network.state_dict().items()},
            {k: v.detach().clone()
             for k, v in model._optimizer.state_dict().items()
             if hasattr(v, "detach")})


def hl_state_err(torch, got, want, keys=None):
    """{leaf: max |got - want| / max |want|} over the leaves of two
    hl_state results (both halves, or the names in `keys`); fails unless
    both hold the same names."""
    pairs = []
    for g, w in zip(got, want):
        names = sorted(w) if keys is None else sorted(keys & set(w))
        if sorted(g if keys is None else keys & set(g)) != names:
            raise AssertionError(f"hl (b) state names differ: "
                                 f"{sorted(set(g) ^ set(w))[:8]}")
        pairs += [(k, g[k], w[k]) for k in names]
    if not pairs:
        return {}
    diff = torch.stack([(a.to(b.dtype) - b).abs().max().float()
                        for _, a, b in pairs])
    scale = torch.stack([b.abs().max().float() for _, _, b in pairs])
    err = torch.where(scale > 0, diff / scale, diff).tolist()
    return {k: e for (k, _, _), e in zip(pairs, err)}


def hl_bert_model(seed):
    """phase 9's BERT-base (attention dropout 0, so attention takes
    flash; hidden dropout 0.1) in a hapi Model, AdamW at lr 1e-4, auto_cast
    O2."""
    from paddle_tpu_torch import hapi
    net, crit = dygraph_model(seed, 0.0)
    model = hapi.Model(net, inputs=[hapi.Input(
        [TRAIN_BATCH, BERT["seq"]], "int64", "input_ids")])
    model.prepare(dygraph_optimizer(net, lr=1e-4), crit,
                  amp_configs={"level": "O2"})
    return model


def hl_bert(torch, attn, dr, fx, rnd, seed):
    """(a) Model.fit of BERT-base pretraining, AMP O2 bf16, flash and fused
    CE forced on, over io.DataLoader of 6 batches of 8, with ProgBarLogger
    and a recording callback; evaluate over 2 batches, predict over 1.
    Gates: the fit's 6 losses bitwise 6 train_batch calls of an identical
    model on the same batches from the same draw state; a step launches
    12 / 12 / 12 flash forward / dQ / dK/dV and 2 fused CE, all bf16; the
    losses finite and the last below the first; save(training=True) ->
    load into a fresh model -> the next train_batch loss bitwise the
    unreloaded model's."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.core.generator import get_rng_state, set_rng_state
    from paddle_tpu_torch.hapi.callbacks import Callback, ProgBarLogger
    counters = dp_counters(attn, dr, fx, rnd)
    out = {}
    n_fit = HL_FIT_BATCHES * TRAIN_BATCH
    data = HLBertData(seed, n_fit)
    loader = io.DataLoader(data, batch_size=TRAIN_BATCH, shuffle=False)
    model = hl_bert_model(seed)
    rng0 = get_rng_state()
    rec = hl_callbacks(Callback, counters)
    torch.cuda.synchronize()
    # ---- (a)'s path: counts from 0 just before, read after
    dp_zero(counters)
    zero_wide(attn)
    t0 = time.perf_counter()
    hist = model.fit(loader, epochs=1, verbose=2, log_freq=1,
                     callbacks=[ProgBarLogger(log_freq=1, verbose=2), rec])
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - t0
    launches, by_dtype = dp_read(counters)
    record_wide("hl_bert_fit", read_wide(attn))
    # ---- end of (a)'s path
    losses = rec.losses
    out["fit_losses"] = losses
    out["fit_step_ms"] = rec.step_ms
    n = BERT["layers_n"]
    want = {"flash_attn_fwd": n, "flash_attn_bwd_dq": n,
            "flash_attn_bwd_dkv": n, "fused_xent_fwd": 2,
            "dropout_philox": DYGRAPH_HIDDEN_DROPOUTS, "philox_random": 0}
    check_equal("hl (a) fit launches", launches,
                {k: v * HL_FIT_BATCHES for k, v in want.items()})
    check_equal("hl (a) fit launches a step", rec.step_launches,
                [want] * HL_FIT_BATCHES)
    check_equal("hl (a) fit launches by dtype a step", rec.step_by_dtype,
                [{k: {"bfloat16": want[k]} for k in DP_KERNELS}]
                * HL_FIT_BATCHES)
    if len(losses) != HL_FIT_BATCHES or hist[-1]["loss"] != losses[-1] or \
            not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"hl (a) fit losses {losses} (history "
                             f"{hist}): not 6, finite and falling")
    # evaluate over 2 batches, predict over 1 (eval mode: flash forward
    # and fused CE only)
    dp_zero(counters)
    t0 = time.perf_counter()
    ev = model.evaluate(io.DataLoader(HLBertData(seed, HL_EVAL_BATCHES *
                                                 TRAIN_BATCH),
                                      batch_size=TRAIN_BATCH), verbose=0)
    pred = model.predict(io.DataLoader(
        HLBertData(seed, HL_PREDICT_BATCHES * TRAIN_BATCH),
        batch_size=TRAIN_BATCH), stack_outputs=True)
    torch.cuda.synchronize()
    out["eval_predict_s"] = time.perf_counter() - t0
    out["eval_predict_launches"], _ = dp_read(counters)
    if not np.isfinite(ev["loss"]) or pred[0].shape != (
            TRAIN_BATCH, BERT["seq"], BERT["vocab"]) or \
            not np.isfinite(pred[0]).all():
        raise AssertionError(f"hl (a) evaluate {ev} / predict "
                             f"{[p.shape for p in pred]}: bad")
    out["eval_loss"] = ev["loss"]
    # save -> load -> the next train_batch, against the unreloaded model
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hl_")
    try:
        path = os.path.join(tmp, "bert")
        t0 = time.perf_counter()
        model.save(path, training=True)
        out["save_s"] = time.perf_counter() - t0
        rng1 = get_rng_state()
        batch = ([data.ids], [data.labels, data.nsp])
        after = model.train_batch(*batch)[0]
        del model
        torch.cuda.empty_cache()
        fresh = hl_bert_model(seed + 1)  # other weights until the load
        t0 = time.perf_counter()
        fresh.load(path)
        out["load_s"] = time.perf_counter() - t0
        set_rng_state(rng1)
        reloaded = fresh.train_batch(*batch)[0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if reloaded != after:
        raise AssertionError(f"hl (a) save/load: next loss {reloaded} != "
                             f"the unreloaded model's {after}")
    out["after_save_loss"] = after
    del fresh
    torch.cuda.empty_cache()
    # the same 6 batches through train_batch on an identical model
    twin = hl_bert_model(seed)
    set_rng_state(rng0)
    direct = [twin.train_batch([data.ids], [data.labels, data.nsp])[0]
              for _ in range(HL_FIT_BATCHES)]
    if direct != losses:
        raise AssertionError(f"hl (a) fit losses {losses} != train_batch "
                             f"losses {direct}")
    del twin
    torch.cuda.empty_cache()
    out.update(launches=launches, by_dtype=by_dtype,
               step_launches=rec.step_launches,
               step_by_dtype=rec.step_by_dtype)
    return out


def hl_resnet(torch, attn, dr, fx, rnd, seed):
    """(b) prepare(use_jit=True) on vision ResNet-50 (224 x 224, 1000
    classes, fp32, batch 32), fused CE on, io.DataLoader(num_workers=2)
    over 4 batches, metric.Accuracy(topk=(1, 5)).  Gates: each jit fit
    step against a use_jit=False step from a copy of the state it started
    from, its loss (HL_JIT_RTOL) and the state after it (HL_STATE_TOL),
    with a planted fault of each kind above HL_STATE_TOL; a use_jit=False
    fit of a weight copy against a jit fit, both with cuDNN deterministic
    (both tolerances); fp32 fused CE launches measured a step: 2 in the
    first (the trace runs each kernel once, then the program is
    replayed, as the JAX package's first call traces and then runs its
    jit), 1 in each later one; the Accuracy values equal a numpy
    recomputation from the logits the metric saw, under the fit's random
    labels and under labels placed in each row's own ranking (top 1, 3rd,
    outside the top 5: both accuracies strictly between 0 and 1);
    jit.save -> jit.load -> TranslatedLayer in eval, and a port Predictor
    over the same files, equal the network's eval forward (HL_SAVE_TOL,
    normalised max error)."""
    from paddle_tpu_torch import hapi, io, jit, metric, nn, optimizer
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.vision.models import resnet50
    from paddle_tpu_torch.core.program import _reset_unique_names
    import paddle_tpu_torch as paddle
    r = HL_RESNET
    counters = dp_counters(attn, dr, fx, rnd)
    out = {}

    class SeenAccuracy(metric.Accuracy):
        """Accuracy that keeps the logits and labels it computed from."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.seen = []

        def compute(self, pred, label):
            self.seen.append((np.array(pred), np.array(label)))
            return super().compute(pred, label)

    def build(use_jit, params=None):
        _reset_unique_names()
        paddle.seed(seed)
        net = resnet50(num_classes=r["classes"])
        if params is not None:
            net.set_state_dict(params)
        model = hapi.Model(net)
        acc = SeenAccuracy(topk=(1, 5))
        model.prepare(optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                         parameters=net.parameters()),
                      nn.CrossEntropyLoss(), acc, use_jit=use_jit)
        return model, acc

    data = HLImages(seed, r["batch"] * r["batches"], r["img"], r["classes"])

    def loader(workers):
        return io.DataLoader(data, batch_size=r["batch"], shuffle=False,
                             num_workers=workers)

    jm, jacc = build(True)
    buffers = {k for k, v in jm.network.state_dict().items()
               if not v.requires_grad}

    class Snapshots(Callback):
        """The state each jit step starts from, copied on the card."""

        def __init__(self):
            super().__init__()
            self.states = []

        def on_train_batch_begin(self, step, logs=None):
            self.states.append(hl_state(jm))

    snaps = Snapshots()
    rec = hl_callbacks(Callback, counters)
    ld = loader(r["workers"])
    torch.cuda.synchronize()
    # ---- (b)'s path: counts from 0 just before, read after
    dp_zero(counters)
    zero_wide(attn)
    t0 = time.perf_counter()
    hist = jm.fit(ld, epochs=1, verbose=0, callbacks=[snaps, rec])
    torch.cuda.synchronize()
    out["jit_fit_s"] = time.perf_counter() - t0
    launches, by_dtype = dp_read(counters)
    record_wide("hl_resnet_jit_fit", read_wide(attn))
    # ---- end of (b)'s path
    states = snaps.states + [hl_state(jm)]
    # fused CE only: 2 in the first step (its trace, then its replay), 1
    # in each later one
    want = [dict(dict.fromkeys(DP_COUNTED, 0), fused_xent_fwd=n)
            for n in [2] + [1] * (r["batches"] - 1)]
    check_equal("hl (b) jit fit launches a step", rec.step_launches, want)
    check_equal("hl (b) jit fit launches by dtype a step",
                rec.step_by_dtype,
                [dict(dict.fromkeys(DP_KERNELS, {}),
                      fused_xent_fwd={"float32": w["fused_xent_fwd"]})
                 for w in want])
    check_equal("hl (b) jit fit launches", launches,
                {k: sum(w[k] for w in want) for k in DP_COUNTED})
    jit_losses = rec.losses
    cp = next(iter(jm._jit_fns[1]._cache.values()))
    types = [op.type for op in cp.program.global_block().ops]
    out["recorded_ops"] = {t: types.count(t) for t in sorted(set(types))}

    def batch(step):
        rows = [data[i] for i in range(step * r["batch"],
                                       (step + 1) * r["batch"])]
        return ([np.stack([a for a, _ in rows])],
                [np.stack([b for _, b in rows])])

    # each jit step again without jit, from a copy of the state it
    # started from, on the same batch: its loss and the state after it
    em, _ = build(False)

    def eager_step(step, zero_grads=False):
        params, opt = states[step]
        em.network.set_state_dict(params)
        em._optimizer.set_state_dict({k: v.clone() for k, v in opt.items()})
        hooks = [p.register_hook(torch.zeros_like)
                 for p in em.network.parameters()] if zero_grads else []
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = em.train_batch(*batch(step))[0]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        finally:
            for h in hooks:
                h.remove()
        return loss, ms, hl_state(em)

    eager_losses, eager_ms, state_err, planted_bn = [], [], [], []
    for step in range(r["batches"]):
        loss, ms, after = eager_step(step)
        eager_losses.append(loss)
        eager_ms.append(ms)
        err = hl_state_err(torch, after, states[step + 1])
        state_err.append(max(err.values()))
        # the jit state had its batch-norm write-back been left out: the
        # statistics the step started from
        planted_bn.append(max(hl_state_err(
            torch, after, states[step], keys=buffers).values()))
    # a jit step whose gradients never reached the parameters: step 1
    # (velocities already made) with its gradients zeroed
    _, _, zeroed = eager_step(1, zero_grads=True)
    planted_zero = max(hl_state_err(torch, zeroed, states[2]).values())
    rel = [abs(a - b) / abs(b) for a, b in zip(jit_losses, eager_losses)]
    out.update(loss_rel_diff=rel, state_err=state_err,
               planted_bn_writeback_err=planted_bn,
               planted_zero_grad_err=planted_zero)
    if len(jit_losses) != r["batches"] or \
            not all(np.isfinite(jit_losses)) or max(rel) > HL_JIT_RTOL or \
            max(state_err) > HL_STATE_TOL:
        raise AssertionError(f"hl (b) jit losses {jit_losses} vs eager "
                             f"steps from the same states {eager_losses}: "
                             f"relative {rel}; state after each step "
                             f"{state_err} (tolerance {HL_STATE_TOL})")
    if not min(planted_bn) > HL_STATE_TOL or \
            not planted_zero > HL_STATE_TOL:
        raise AssertionError(f"hl (b) the state gate misses a planted "
                             f"fault: batch-norm write-back left out "
                             f"{planted_bn}, gradients zeroed "
                             f"{planted_zero} (tolerance {HL_STATE_TOL})")
    # free-running: in cuDNN's default mode the eager fit of a weight
    # copy beside the jit fit above (recorded), then with cuDNN
    # deterministic a jit fit and a use_jit=False fit of weight copies
    # (gated)
    del em
    em, _ = build(False, states[0][0])
    free = hl_callbacks(Callback)
    em.fit(loader(0), epochs=1, verbose=0, callbacks=[free])
    out["free_default_loss_rel"] = [abs(a - b) / abs(b) for a, b in
                                    zip(jit_losses, free.losses)]
    out["free_default_state_err"] = max(hl_state_err(
        torch, hl_state(em), states[-1]).values())
    del em
    det = {}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for use_jit in (True, False):
            m, _ = build(use_jit, states[0][0])
            free = hl_callbacks(Callback)
            m.fit(loader(0), epochs=1, verbose=0, callbacks=[free])
            det[use_jit] = (free.losses, hl_state(m))
            del m
    finally:
        torch.backends.cudnn.deterministic = prev
    det_rel = [abs(a - b) / abs(b) for a, b in zip(det[True][0],
                                                    det[False][0])]
    det_err = max(hl_state_err(torch, det[False][1], det[True][1]).values())
    out.update(free_deterministic_loss_rel=det_rel,
               free_deterministic_state_err=det_err)
    if len(det_rel) != r["batches"] or max(det_rel) > HL_JIT_RTOL or \
            det_err > HL_STATE_TOL:
        raise AssertionError(f"hl (b) cuDNN deterministic: use_jit=False "
                             f"fit losses {det[False][0]} vs jit fit "
                             f"{det[True][0]}: relative {det_rel}, final "
                             f"state {det_err}")
    del det
    # Accuracy against numpy over the logits the metric saw, under the
    # fit's labels and under labels from each row's own ranking
    preds = np.concatenate([p for p, _ in jacc.seen])
    labels = np.concatenate([l for _, l in jacc.seen]).reshape(-1)
    order = np.argsort(-preds, axis=1, kind="stable")

    def numpy_acc(lab):
        return [float((order[:, :k] == lab[:, None]).any(1).sum())
                / len(lab) for k in (1, 5)]

    got_acc = [hist[-1][n] for n in jacc.name()]
    ranked = order[np.arange(len(order)),
                   np.array([0, 2, 10])[np.arange(len(order)) % 3]]
    acc2 = metric.Accuracy(topk=(1, 5))
    acc2.update(acc2.compute(torch.from_numpy(preds).cuda(),
                             torch.from_numpy(ranked[:, None]).cuda()))
    got_ranked = acc2.accumulate()
    want_ranked = numpy_acc(ranked)
    if got_acc != numpy_acc(labels) or got_ranked != want_ranked or \
            not all(0 < a < 1 for a in got_ranked) or \
            len(labels) != r["batch"] * r["batches"]:
        raise AssertionError(f"hl (b) Accuracy {got_acc} / {got_ranked} "
                             f"!= numpy {numpy_acc(labels)} / "
                             f"{want_ranked}")
    out.update(jit_losses=jit_losses, eager_losses=eager_losses,
               accuracy=dict(zip(jacc.name(), got_acc)),
               accuracy_ranked_labels=dict(zip(jacc.name(), got_ranked)),
               launches=launches, by_dtype=by_dtype,
               step_launches=rec.step_launches,
               step_by_dtype=rec.step_by_dtype,
               jit_step_ms=rec.step_ms, eager_step_ms=eager_ms)
    del states, snaps
    # jit.save -> jit.load, and a Predictor over the same files
    net = jm.network
    net.eval()
    first = HLImages(seed, r["batch"], r["img"], r["classes"])
    x = torch.from_numpy(np.stack([first[i][0]
                                   for i in range(r["batch"])])).cuda()
    with torch.no_grad():
        ref = net(x)
    scale = float(ref.abs().max())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hl_")
    try:
        path = os.path.join(tmp, "resnet50")
        t0 = time.perf_counter()
        jit.save(net, path, input_spec=[jit.InputSpec(
            [r["batch"], 3, r["img"], r["img"]], "float32")])
        out["jit_save_s"] = time.perf_counter() - t0
        loaded = jit.load(path)
        loaded.eval()
        with torch.no_grad():
            got = loaded(x)
        cfg = Config(prog_file=path + ".pdmodel",
                     params_file=path + ".pdiparams")
        cfg.switch_ir_optim(False)  # the program as saved: no BN fold
        pred = create_predictor(cfg)
        h = pred.get_input_handle(pred.get_input_names()[0])
        h.copy_from_cpu(x.cpu().numpy())
        pred.run()
        served = pred.get_output_handle(
            pred.get_output_names()[0]).copy_to_cpu()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    err_tl = float((got - ref).abs().max()) / scale
    err_pred = float(np.abs(served - ref.cpu().numpy()).max()) / scale
    if not err_tl <= HL_SAVE_TOL or not err_pred <= HL_SAVE_TOL:
        raise AssertionError(f"hl (b) TranslatedLayer {err_tl} / Predictor "
                             f"{err_pred} against the eval forward > "
                             f"{HL_SAVE_TOL}")
    out.update(translated_layer_err=err_tl, predictor_err=err_pred)
    del jm, net, loaded, pred
    torch.cuda.empty_cache()
    return out


def hl_decode(seed, buf, i, x, w):
    """(c)'s function: a tensor `if` on x * w and phase 19's decode loop
    (tests/test_jit.py's), a bounded `while` with `break`."""
    h = x * w
    if h.mean() > 0:
        y = h * 2.0
    else:
        y = h * 0.5
    while i.sum() < 6:
        tok = (seed + i).sum() % 5.0
        if tok > 3.0:
            break
        buf = buf + tok
        i = i + 1
    return y, buf, i


def hl_control_flow(torch, seed):
    """(c) dy2static control flow on CUDA tensors: hl_decode's recorded
    program holds `cond` and `while` ops; its outputs and the gradient of
    w equal the same Python run eagerly (exact); a run_steps call over a
    static program holding `while` runs step by step (no capture)."""
    from paddle_tpu_torch import jit, static
    from paddle_tpu_torch.static import layers
    out = {}
    rng = np.random.RandomState(seed)
    xv = rng.rand(4, 8).astype(np.float32) - 0.3
    sf = jit.to_static(hl_decode)
    for s in (1.0, 2.0):
        def args():
            w = torch.nn.Parameter(torch.full((8,), 0.5, device="cuda"))
            return (torch.tensor([s], device="cuda"),
                    torch.zeros(4, device="cuda"),
                    torch.zeros(1, device="cuda"),
                    torch.from_numpy(xv).cuda(), w), w
        a, wa = args()
        got = sf(*a)
        got[0].sum().backward()
        b, wb = args()
        want = hl_decode(*b)
        want[0].sum().backward()
        for g, e in zip(got, want):
            if g.device.type != "cuda" or not torch.equal(g, e):
                raise AssertionError(f"hl (c) seed {s}: {g} != eager {e}")
        if not torch.equal(wa.grad, wb.grad):
            raise AssertionError(f"hl (c) grad {wa.grad} != eager "
                                 f"{wb.grad}")
    cp = next(iter(sf._cache.values()))
    types = [op.type for bl in cp.program.blocks for op in bl.ops]
    if "cond" not in types or "while" not in types or len(sf._cache) != 1:
        raise AssertionError(f"hl (c) program ops {types}")
    out["program_ops"] = {t: types.count(t) for t in sorted(set(types))}
    # run_steps over a program holding `while`: step by step, no capture
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = layers.data("x", [-1, 4])
        i = layers.fill_constant([1], "int64", 0)
        n = layers.fill_constant([1], "int64", 3)
        h = layers.elementwise_add(x, layers.fill_constant([1], "float32",
                                                           0.0))
        cond = layers.less_than(i, n)
        wl = layers.While(cond)
        with wl.block():
            layers.assign(layers.scale(h, scale=2.0), output=h)
            layers.increment(i, value=1)
            layers.less_than(i, n, cond=cond)
    exe = static.Executor()
    scope = static.Scope()
    feed = rng.rand(3, 2, 4).astype(np.float32)
    with static.scope_guard(scope):
        exe.run(startup)
        res = exe.run_steps(main, feed={"x": feed}, fetch_list=[h])
    stats = exe.cache_stats()
    exe.close()
    if not np.allclose(res[0], feed * 8.0, rtol=1e-6) or stats["traces"]:
        raise AssertionError(f"hl (c) run_steps over while: {stats}, "
                             f"max err {np.abs(res[0] - feed * 8).max()}")
    out["run_steps_cache_stats"] = stats
    return out


def hl_phase(torch, seed):
    """(19) the 2.0 high-level path on the card: (a) hl_bert, (b)
    hl_resnet, (c) hl_control_flow.  Returns the record with each path's
    launches."""
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import fused_xent as fx
    from paddle_tpu_torch.ops import random as rnd
    out = {"seconds": {}}
    t_phase = time.perf_counter()
    try:
        attn.enable_flash_attention(True)
        fx.enable_fused_xent(True)
        t0 = time.perf_counter()
        out["a_bert_fit"] = hl_bert(torch, attn, dr, fx, rnd, seed)
        out["seconds"]["a"] = time.perf_counter() - t0
        attn._FLASH_STATE["mode"] = "auto"
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["b_resnet_jit"] = hl_resnet(torch, attn, dr, fx, rnd, seed)
        out["seconds"]["b"] = time.perf_counter() - t0
    finally:
        attn._FLASH_STATE["mode"] = "auto"
        fx.enable_fused_xent(False)
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["c_control_flow"] = hl_control_flow(torch, seed)
    out["seconds"]["c"] = time.perf_counter() - t0
    out["seconds"]["total"] = time.perf_counter() - t_phase
    log({"phase": "high_level", "config": "(a) hapi Model.fit of "
         "BertForPretraining (bert-base, hidden dropout 0.1, attention 0), "
         "AdamW lr 1e-4, auto_cast O2, flash + fused CE, io.DataLoader 6 x "
         "8; (b) prepare(use_jit=True) vision resnet50 224/1000 fp32 batch "
         "32, Momentum 0.01/0.9, fused CE, DataLoader(num_workers=2) 4 "
         "batches, Accuracy(topk=(1, 5)); (c) dy2static cond + while",
         **out})
    return out


# ---------------------------------------------------------------------------
# phase 20: the paddle.tensor functions on the card
# ---------------------------------------------------------------------------
PH20_STEPS = 4            # (a) AdamW steps of each run (kernels, plain)
PH20_MASK_P = 0.15        # (a) the MLM selection probability
PH20_LOSS_RTOL = TOL["bfloat16"]  # (a) kernels against plain versions, O2
PH20_JIT_LAYERS = 4       # (b) BERT-base cut to 4 layers, widths unchanged
PH20_JIT_STEPS = 3        # (b) to_static steps, each against an eager step
PH20_JIT_RTOL = 1e-5      # (b) each step's loss against the eager step's
PH20_LR = 0.01            # (b) Momentum's learning rate (momentum 0.9)
PH20_STATE_TOL = 1e-3     # (b) the state after it, a leaf (phase 19 (b))
PH20_OP_TOL = 1e-5        # (c) CUDA against CPU, normalised max error
PH20_RANDOM = (("philox_trunc_normal", (30522, 768)),
               ("philox_randint", (8, 512)),
               ("philox_bernoulli", (8, 512)))
PH20_KERNELS = tuple(name for name, _ in PH20_RANDOM)
PH20_PATHS = ("ph20_bert_o2", "ph20_jit")


def ph20_counters(attn, dr, fx, rnd):
    """Every hand kernel a phase 20 path may launch: phase 13's six and the
    three new Philox distributions (the truncated normal is the random
    kernel's dist 2; `philox_random` counts its uniform and normal
    launches only)."""
    c = dp_counters(attn, dr, fx, rnd)

    class ByDist:
        def __init__(self, dists):
            self.dists = dists

        @property
        def launches(self):
            return sum(rnd.random_cuda.launches_by_dist[d]
                       for d in self.dists)

    c["philox_random"] = ByDist((rnd.UNIFORM, rnd.NORMAL))
    c["philox_trunc_normal"] = ByDist((rnd.TRUNC_NORMAL,))
    c["philox_randint"] = rnd.randint_cuda
    c["philox_bernoulli"] = rnd.bernoulli_cuda
    return c


def ph20_zero(attn, counters, rnd):
    dp_zero({k: c for k, c in counters.items()
             if k not in ("philox_random", "philox_trunc_normal")})
    for d in rnd.random_cuda.launches_by_dist:
        rnd.random_cuda.launches_by_dist[d] = 0
    rnd.random_cuda.launches = 0
    zero_wide(attn)


def ph20_read(counters):
    return ({n: c.launches for n, c in counters.items()},
            {n: dict(counters[n].dtype_launches) for n in DP_KERNELS})


def ph20_batch(torch, seed):
    """ids [8, 512] (every position a real token, as the bench's batch),
    position and token-type ids [1, 512], the padding mask [8, 512] (all
    ones), on the card."""
    rng = np.random.RandomState(seed + 20)
    b, s = TRAIN_BATCH, BERT["seq"]
    ids = torch.from_numpy(rng.randint(0, BERT["vocab"], (b, s))
                           .astype(np.int64)).cuda()
    pos = torch.arange(s, dtype=torch.int64, device="cuda").reshape(1, s)
    return ids, pos, torch.zeros_like(pos), torch.ones(b, s, device="cuda")


def ph20_masks(T, ids):
    """The MLM masking, all ported tensor functions: a 0.15 Bernoulli draw
    picks the positions, randint draws their replacement ids, where
    applies them; nonzero gives the picked [N, 2] coordinates, and
    index_select the original ids there (the labels)."""
    b, s = ids.shape
    sel = T.cast(T.bernoulli(T.full([b, s], PH20_MASK_P)), "bool")
    repl = T.randint(0, BERT["vocab"], [b, s])
    masked = T.where(sel, repl, ids)
    where_at = T.nonzero(sel)
    stride = T.to_tensor(np.array([s, 1], np.int64))
    flat = T.sum(T.multiply(where_at, stride), axis=1)
    labels = T.index_select(T.reshape(ids, [-1]), flat, 0)
    return sel, repl, masked, where_at, labels


def ph20_forward(T, F, net, masked, pos, types, pad, where_at, labels):
    """The encoder and the MLM head over the picked rows: the padding mask
    unsqueezed to [8, 1, 1, 512]; a mask that keeps every key (this
    batch has no padding) is dropped, so the flash route runs; gather_nd
    takes the picked rows, F.cross_entropy (fused CE) the loss."""
    am = T.unsqueeze(pad, [1, 2])
    mask = None if bool(T.all(am)) else T.scale(am, 1e4, -1e4)
    h = net.bert.encoder(net.bert.embeddings(masked, types, pos),
                         src_mask=mask)
    logits = net.cls(T.gather_nd(h, where_at))
    return F.cross_entropy(logits, labels), logits


def ph20_accuracy(T, logits, labels):
    """top-1 and top-5 accuracy: topk / argmax / equal / cast / mean."""
    top5 = T.topk(logits, 5)[1]
    acc1 = T.mean(T.cast(T.equal(T.argmax(logits, 1), labels), "float32"))
    acc5 = T.mean(T.cast(T.any(T.equal(top5, T.unsqueeze(labels, 1)), 1),
                         "float32"))
    return float(acc1), float(acc5)


def ph20_bert(torch, attn, dr, fx, rnd, seed):
    """(a) BERT-base (12 layers, 768, 12 heads, vocab 30522, seq 512,
    batch 8), dygraph, auto_cast O2 + GradScaler, AdamW, flash forced on,
    fused CE: the word embedding drawn anew as BERT's TruncatedNormal(0.02)
    (google-research/bert's initializer), then PH20_STEPS steps of the
    masking and head above.  The same run with every hand kernel swapped
    for its plain version (flash and fused CE off: the score-matrix and
    torch routes; the Philox draws through their plain versions on the
    card).  Gates: the masks and the drawn embedding's replacement ids
    equal bit for bit, the embedding within RANDOM_ULPS, each loss within
    PH20_LOSS_RTOL; launches a step (flash forward, dQ, dK/dV 12 each,
    fused CE 1, bf16; Bernoulli and randint 1 each; the truncated normal
    1 over the path; dropout and uniform / normal 0) and none of them in
    the plain run."""
    import paddle_tpu_torch.nn.functional as F
    import paddle_tpu_torch.tensor as T
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core.generator import get_rng_state, set_rng_state
    from paddle_tpu_torch.ops.kernels import random as krandom
    from paddle_tpu_torch.tensor._dispatch import dispatch
    counters = ph20_counters(attn, dr, fx, rnd)
    ids, pos, types, pad = ph20_batch(torch, seed)
    net, _ = dygraph_model(seed, 0.0, hidden_dropout=0.0)
    base = {k: v.detach().clone() for k, v in net.state_dict().items()}
    emb = net.bert.embeddings.word_embeddings.weight
    rng0 = get_rng_state()
    runs = {}
    for tag in ("kernels", "plain"):
        kernels = tag == "kernels"
        net.set_state_dict(base)
        set_rng_state(rng0)
        attn.enable_flash_attention(kernels)
        fx.enable_fused_xent(kernels)
        if not kernels:  # the plain versions of the Philox draws, on the card
            krandom.bernoulli_draw = rnd.bernoulli_plain
            krandom.randint_draw = rnd.randint_plain
            krandom.truncated_normal = lambda *a: rnd.random_plain(
                *a[:2], rnd.TRUNC_NORMAL, *a[2:])
        try:
            torch.cuda.synchronize()
            # ---- (a)'s path: counts from 0 just before, read after
            ph20_zero(attn, counters, rnd)
            t0 = time.perf_counter()
            draw = dispatch("truncated_gaussian_random", {},
                            {"shape": list(emb.shape), "dtype": "float32",
                             "mean": 0.0, "std": 0.02})
            if kernels:
                init = draw
            with torch.no_grad():
                emb.copy_(init)  # both runs train from the kernel's draw
            opt = dygraph_optimizer(net)
            scaler = amp.GradScaler()
            net.train()
            rec = {"losses": [], "acc": [], "masks": [], "step_ms": [],
                   "picked": []}
            steps = []
            for _ in range(PH20_STEPS):
                ts = time.perf_counter()
                before = ph20_read(counters)
                sel, repl, masked, where_at, labels = ph20_masks(T, ids)
                with amp.auto_cast(level="O2"):
                    loss, logits = ph20_forward(T, F, net, masked, pos,
                                                types, pad, where_at,
                                                labels)
                scaler.scale(loss).backward()
                scaler.minimize(opt, loss)
                opt.clear_grad()
                opt._learning_rate.step()
                rec["acc"].append(ph20_accuracy(T, logits, labels))
                torch.cuda.synchronize()
                rec["step_ms"].append((time.perf_counter() - ts) * 1e3)
                rec["losses"].append(float(loss.detach()))
                rec["masks"].append((sel.clone(), repl.clone()))
                rec["picked"].append(int(where_at.shape[0]))
                after = ph20_read(counters)
                steps.append(({k: after[0][k] - before[0][k]
                               for k in after[0]},
                              {k: {d: n - before[1][k].get(d, 0)
                                   for d, n in after[1][k].items()}
                               for k in DP_KERNELS}))
            rec["seconds"] = time.perf_counter() - t0
            rec["launches"], rec["by_dtype"] = ph20_read(counters)
            if kernels:
                record_wide("ph20_bert_o2", read_wide(attn))
            # ---- end of (a)'s path
        finally:
            attn._FLASH_STATE["mode"] = "auto"
            fx.enable_fused_xent(False)
            krandom.bernoulli_draw = rnd.bernoulli_draw
            krandom.randint_draw = rnd.randint_draw
            krandom.truncated_normal = rnd.truncated_normal
        rec["step_launches"] = [s[0] for s in steps]
        rec["step_by_dtype"] = [s[1] for s in steps]
        rec["draw"] = draw
        runs[tag] = rec
        del opt, scaler
        torch.cuda.empty_cache()
    k, p = runs["kernels"], runs["plain"]
    n = BERT["layers_n"]
    want_step = dict(dict.fromkeys(counters, 0), flash_attn_fwd=n,
                     flash_attn_bwd_dq=n, flash_attn_bwd_dkv=n,
                     fused_xent_fwd=1, philox_randint=1, philox_bernoulli=1)
    check_equal("ph20 (a) launches a step", k["step_launches"],
                [want_step] * PH20_STEPS)
    check_equal("ph20 (a) launches by dtype a step", k["step_by_dtype"],
                [{kk: ({"bfloat16": want_step[kk]} if want_step[kk] else {})
                  for kk in DP_KERNELS}] * PH20_STEPS)
    check_equal("ph20 (a) launches", k["launches"],
                {kk: v * PH20_STEPS + (kk == "philox_trunc_normal")
                 for kk, v in want_step.items()})
    check_equal("ph20 (a) plain-run launches", p["launches"],
                dict.fromkeys(counters, 0))
    for i, ((ks, kr), (ps, pr)) in enumerate(zip(k["masks"], p["masks"])):
        if not (torch.equal(ks, ps) and torch.equal(kr, pr)):
            raise AssertionError(f"ph20 (a) step {i}: the kernels' masks "
                                 "differ from the plain versions'")
    scale = torch.finfo(torch.float32).eps * torch.clamp(
        p["draw"].abs(), min=0.02)
    init_ulps = float(((k["draw"] - p["draw"]).abs() / scale).max())
    if not init_ulps <= RANDOM_ULPS:
        raise AssertionError(f"ph20 (a) truncated normal: {init_ulps} ulps "
                             "from its plain version")
    loss_err = [abs(a - b) / abs(b) for a, b in zip(k["losses"],
                                                     p["losses"])]
    if not all(np.isfinite(k["losses"])) or max(loss_err) > PH20_LOSS_RTOL:
        raise AssertionError(f"ph20 (a) losses {k['losses']} against plain "
                             f"{p['losses']}")
    out = {"losses": k["losses"], "plain_losses": p["losses"],
           "loss_rel_err": loss_err, "accuracy_top1_top5": k["acc"],
           "picked_rows": k["picked"], "trunc_normal_init_ulps": init_ulps,
           "step_ms": k["step_ms"], "plain_step_ms": p["step_ms"],
           "seconds": k["seconds"], "plain_seconds": p["seconds"],
           "launches": k["launches"],
           "step_launches": k["step_launches"],
           "step_by_dtype": k["step_by_dtype"]}
    log({"phase": "ph20_bert", **out})
    del net, runs, base
    torch.cuda.empty_cache()
    return out


def ph20_jit(torch, attn, dr, fx, rnd, seed):
    """(b) the same step's encoder and head under jit.to_static, fp32,
    BERT-base cut to PH20_JIT_LAYERS layers (widths unchanged), flash off
    (a recorder refuses it, in both packages), fused CE on, Momentum
    (PH20_LR, 0.9: Adam would turn the rounding noise of near-zero
    gradients into steps of +-lr); the masks drawn once outside the traced function (each step
    the same batch: one trace, then replays).  Gates: each step's loss
    within PH20_JIT_RTOL of an eager step from a copy of the state it
    started from, and the state after it (weights and velocities) within
    PH20_STATE_TOL a leaf, the attention key biases within 2 lr
    absolute; a planted fault (the eager step's gradients zeroed) reads
    above the gate."""
    import paddle_tpu_torch.nn.functional as F
    import paddle_tpu_torch.tensor as T
    from paddle_tpu_torch import jit, nn, optimizer
    counters = ph20_counters(attn, dr, fx, rnd)
    ids, pos, types, pad = ph20_batch(torch, seed)
    net, _ = dygraph_model(seed, 0.0, hidden_dropout=0.0,
                           layers=PH20_JIT_LAYERS)
    net.train()

    class Step(nn.Layer):
        def __init__(self, net):
            super().__init__()
            self.net = net

        def forward(self, masked, pos, types, pad, where_at, labels):
            return ph20_forward(T, F, self.net, masked, pos, types, pad,
                                where_at, labels)[0]

    step = Step(net)
    eager_fn = step.forward
    sf = jit.StaticFunction(eager_fn, layer=step)
    # the jit run's optimizer, and the eager steps' (each loaded with the
    # state its jit step started from; a fresh one for the planted fault)
    def momentum():
        return optimizer.Momentum(learning_rate=PH20_LR, momentum=0.9,
                                  parameters=net.parameters())

    opt_j, opt_e = momentum(), momentum()
    # the attention key biases: their gradient is 0 in exact arithmetic
    # (softmax ignores a per-row constant), so the rounding noise of each
    # run is all there is: held to 2 lr absolute, and left out of the
    # relative gate with their velocities
    key_bias = [f"bert.encoder.layers.{i}.self_attn.k_proj.bias"
                for i in range(PH20_JIT_LAYERS)]
    kb_pnames = [layer.self_attn.k_proj.bias.paddle_name
                 for layer in net.bert.encoder.layers]

    def is_key_bias(k):
        return k in key_bias or any(k.startswith(n + "_")
                                    for n in kb_pnames)
    _, _, masked, where_at, labels = ph20_masks(T, ids)
    args = (masked, pos, types, pad, where_at, labels)

    def state(opt):
        return ({k: v.detach().clone() for k, v in net.state_dict().items()},
                {k: v.detach().clone() for k, v in opt.state_dict().items()
                 if hasattr(v, "detach")})

    def one(fn, opt, zero_grads=False):
        hooks = [p.register_hook(torch.zeros_like)
                 for p in net.parameters()] if zero_grads else []
        try:
            loss = fn(*args)
            loss.backward()
            opt.step()
            opt.clear_grad()
        finally:
            for h in hooks:
                h.remove()
        torch.cuda.synchronize()
        return float(loss.detach())

    out = {"jit_losses": [], "eager_losses": [], "state_err": [],
           "jit_step_ms": []}
    torch.cuda.synchronize()
    # ---- (b)'s path (the jit steps): counts from 0 just before
    ph20_zero(attn, counters, rnd)
    step_launches = []
    for i in range(PH20_JIT_STEPS):
        st0 = state(opt_j)
        before = ph20_read(counters)[0]
        t0 = time.perf_counter()
        jl = one(sf, opt_j)
        out["jit_step_ms"].append((time.perf_counter() - t0) * 1e3)
        after = ph20_read(counters)[0]
        step_launches.append({k: after[k] - before[k] for k in after})
        st_j = state(opt_j)
        net.set_state_dict(st0[0])
        opt_e.set_state_dict({k: v.clone() for k, v in st0[1].items()})
        el = one(eager_fn, opt_e)
        st_e = state(opt_e)
        err = hl_state_err(torch, st_e, st_j)
        kb_err = max(float((st_e[0][k] - st_j[0][k]).abs().max())
                     for k in key_bias)
        out["jit_losses"].append(jl)
        out["eager_losses"].append(el)
        out["state_err"].append(max(e for k, e in err.items()
                                    if not is_key_bias(k)))
        out["key_bias_abs_err"] = max(out.get("key_bias_abs_err", 0.0),
                                      kb_err)
        if abs(jl - el) > PH20_JIT_RTOL * abs(el) or \
                not out["state_err"][-1] <= PH20_STATE_TOL or \
                not kb_err <= 2 * PH20_LR:
            raise AssertionError(f"ph20 (b) step {i}: jit loss {jl} vs "
                                 f"eager {el}, state error "
                                 f"{out['state_err'][-1]}, key bias "
                                 f"{kb_err}")
        if i == 0:  # the planted fault, from the same start
            net.set_state_dict(st0[0])
            opt_f = momentum()
            one(eager_fn, opt_f, zero_grads=True)
            out["planted_fault_state_err"] = max(
                e for k, e in hl_state_err(torch, state(opt_f),
                                           st_j).items()
                if not is_key_bias(k))
            del opt_f
            if not out["planted_fault_state_err"] > PH20_STATE_TOL:
                raise AssertionError("ph20 (b): the planted fault reads "
                                     f"{out['planted_fault_state_err']}, "
                                     "inside the gate")
        net.set_state_dict(st_j[0])
    record_wide("ph20_jit", read_wide(attn))
    out["step_launches"] = step_launches
    cp = next(iter(sf._cache.values()))
    types_ = [op.type for op in cp.program.global_block().ops]
    out["recorded_ops"] = {t: types_.count(t) for t in sorted(set(types_))}
    # a fused CE (fp32) and the recorded dropout ops (hidden dropout 0:
    # recorded and run all the same, as in the JAX package) a replay,
    # twice in the first step (its trace, then its replay); no flash
    # under a recorder, no other hand kernel
    per = dict(dict.fromkeys(counters, 0), fused_xent_fwd=1,
               dropout_philox=out["recorded_ops"].get("dropout", 0))
    check_equal("ph20 (b) launches a jit step", step_launches,
                [{k: v * (2 if i == 0 else 1) for k, v in per.items()}
                 for i in range(PH20_JIT_STEPS)])
    for op in ("unsqueeze2", "gather_nd", "reduce_all"):
        if op not in out["recorded_ops"]:
            raise AssertionError(f"ph20 (b): {op} not recorded")
    log({"phase": "ph20_jit", **out})
    del net, opt_j, opt_e, sf, step
    torch.cuda.empty_cache()
    return out


def ph20_op_cases(rng):
    """(c) {op: (ins, attrs)} of every op this slice registers, numpy
    inputs; ties and NaNs for top_k_v2 / argsort / arg_max / unique."""
    f = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)  # noqa: E731
    pos = lambda *s: rng.uniform(0.2, 2.0, s).astype(np.float32)  # noqa
    i64 = lambda hi, *s: rng.randint(0, hi, s).astype(np.int64)  # noqa
    nan = np.nan
    ties = np.array([[1.0, nan, 3.0, 3.0, 2.0, -nan, 0.0, -0.0],
                     [2.0, 2.0, 2.0, 1.0, 1.0, 5.0, 5.0, 0.0]], np.float32)
    many_ties = rng.randint(0, 4, (64, 300)).astype(np.float32)
    spd = rng.rand(8, 8)
    spd = (spd @ spd.T + 8 * np.eye(8)).astype(np.float32)
    x = f(64, 300)
    cases = {
        **{op: ({"X": pos(64, 300) * (0.45 if op in ("asin", "acos")
                                      else 1.0)}, {})
           for op in ("exp", "rsqrt", "ceil", "floor", "round", "sin", "cos",
                      "tan", "asin", "acos", "atan", "sinh", "cosh",
                      "reciprocal", "erf", "log2", "log10", "log1p",
                      "sign")},
        "pow": ({"X": pos(64, 300)}, {"factor": 3.0}),
        "stanh": ({"X": x}, {"scale_a": 0.67, "scale_b": 1.7159}),
        "elementwise_min": ({"X": x, "Y": f(300)}, {"axis": -1}),
        **{op: ({"X": pos(16, 30, 4)}, {"dim": [1], "keep_dim": False})
           for op in ("reduce_prod",)},
        **{op: ({"X": f(16, 30) > 0}, {"dim": [0, 1], "keep_dim": True})
           for op in ("reduce_all", "reduce_any")},
        "squeeze2": ({"X": f(4, 1, 30, 1)}, {"axes": []}),
        "unsqueeze2": ({"X": x}, {"axes": [0, 3]}),
        "split": ({"X": x}, {"axis": 1, "num": 0, "sections": [100, -1]}),
        "stack": ({"X": [x, x]}, {"axis": 1}),
        "unstack": ({"X": f(3, 40)}, {"axis": 0, "num": 3}),
        "unbind": ({"X": f(3, 40)}, {"axis": 1}),
        "gather_nd": ({"X": f(8, 512, 16),
                       "Index": np.stack([i64(8, 600), i64(512, 600)], 1)},
                      {}),
        "scatter": ({"X": f(64, 30), "Ids": i64(64, 64),
                     "Updates": f(64, 30)}, {"overwrite": False}),
        "scatter_nd_add": ({"X": f(8, 512), "Index": np.stack(
            [i64(8, 900), i64(512, 900)], 1), "Updates": f(900)}, {}),
        "strided_slice": ({"Input": x}, {"axes": [0, 1], "starts": [1, 299],
                                         "ends": [60, 0],
                                         "strides": [3, -2]}),
        "index_select": ({"X": x, "Index": i64(300, 77)}, {"dim": 1}),
        "index_sample": ({"X": x, "Index": i64(300, 64, 5)}, {}),
        "masked_select": ({"X": x, "Mask": f(64, 300) > 0}, {}),
        "where_index": ({"Condition": f(64, 300) > 0.5}, {}),
        "expand_v2": ({"X": f(1, 300)}, {"shape": [4, 64, -1]}),
        "expand_as_v2": ({"X": f(1, 300)}, {"target_shape": [64, 300]}),
        "tile": ({"X": f(8, 30)}, {"repeat_times": [2, 3, 1]}),
        "flip": ({"X": x}, {"axis": [0, 1]}),
        "reverse": ({"X": x}, {"axis": [1]}),
        "roll": ({"X": x}, {"shifts": [5, -7], "axis": [0, 1]}),
        "eye": ({}, {"num_rows": 64, "num_columns": 96,
                     "dtype": "float32"}),
        "linspace": ({}, {"start": -3.0, "stop": 5.0, "num": 1001,
                          "dtype": "float32"}),
        "range": ({}, {"start": 3, "end": 30522, "step": 7,
                       "dtype": "int64"}),
        "arg_max": ({"X": many_ties}, {"axis": 1, "dtype": "int64"}),
        "arg_min": ({"X": ties}, {"axis": 1, "dtype": "int64"}),
        "argsort": ({"X": many_ties}, {"axis": -1, "descending": True}),
        "top_k_v2": ({"X": many_ties}, {"k": 5, "axis": -1,
                                        "largest": True}),
        "unique": ({"X": many_ties}, {"dtype": "int64"}),
        "shape": ({"Input": x}, {}),
        "size": ({"Input": x}, {}),
        "is_empty": ({"X": x}, {}),
        "diag_v2": ({"X": f(300)}, {"offset": 1, "padding_value": 2.0}),
        "diag_embed": ({"Input": f(8, 30)}, {"offset": -1}),
        "meshgrid": ({"X": [f(30), f(40)]}, {}),
        "multiplex": ({"X": [f(64, 30), f(64, 30)],
                       "Ids": i64(2, 64, 1)}, {}),
        "shard_index": ({"X": i64(30522, 64, 1)},
                        {"index_num": 30522, "nshards": 4, "shard_id": 1,
                         "ignore_value": -1}),
        "assign_value": ({}, {"shape": [2, 3], "dtype": "float32",
                              "values": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]}),
        "bmm": ({"X": f(8, 64, 32), "Y": f(8, 32, 48)}, {}),
        "mv": ({"X": f(64, 300), "Vec": f(300)}, {}),
        "dot": ({"X": x, "Y": f(64, 300)}, {}),
        "kron": ({"X": f(8, 6), "Y": f(5, 7)}, {}),
        "cumsum": ({"X": x}, {"axis": 1, "exclusive": True,
                              "reverse": True}),
        "logsumexp": ({"X": x}, {"axis": [1], "keepdim": False}),
        "trace": ({"Input": f(4, 30, 30)}, {"offset": 1, "axis1": 1,
                                            "axis2": 2}),
        "tril_triu": ({"X": x}, {"diagonal": 2, "lower": False}),
        "cross": ({"X": f(64, 3), "Y": f(64, 3)}, {"dim": 1}),
        "p_norm": ({"X": x}, {"porder": 3.0, "axis": 1, "keepdim": True}),
        "frobenius_norm": ({"X": x}, {"dim": [0, 1], "keep_dim": False}),
        "dist": ({"X": x, "Y": f(64, 300)}, {"p": 2.0}),
        "cholesky": ({"X": spd}, {"upper": True}),
        "inverse": ({"Input": spd}, {}),
        "histogram": ({"X": x}, {"bins": 50, "min": -1, "max": 1}),
        "allclose": ({"Input": x, "Other": x + 1e-9}, {"rtol": "1e-5",
                                                       "atol": "1e-8"}),
        "isfinite_v2": ({"X": np.array([1.0, np.inf, nan, -np.inf],
                                       np.float32)}, {}),
        "isinf_v2": ({"X": np.array([1.0, np.inf, nan, -np.inf],
                                    np.float32)}, {}),
        "isnan_v2": ({"X": np.array([1.0, np.inf, nan, -np.inf],
                                    np.float32)}, {}),
        "einsum": ({"Operands": [f(8, 30, 16), f(8, 16, 20)]},
                   {"equation": "bij,bjk->bik"}),
        "addmm": ({"Input": f(64, 48), "X": f(64, 30), "Y": f(30, 48)},
                  {"Alpha": 2.0, "Beta": 0.5}),
        "crop_tensor": ({"X": x}, {"shape": [30, -1], "offsets": [5, 20]}),
        "get_tensor_from_selected_rows": ({"X": x}, {}),
        # draws: the card's kernels against the plain versions on the CPU
        "truncated_gaussian_random": ({}, {"shape": [64, 300], "mean": 0.0,
                                           "std": 0.02, "seed": 5,
                                           "op_uid": 3}),
        "randint": ({}, {"shape": [64, 300], "low": -3, "high": 30522,
                         "seed": 5, "op_uid": 4}),
        "bernoulli": ({"X": rng.rand(64, 300).astype(np.float32)},
                      {"seed": 5, "op_uid": 5}),
        "randperm": ({}, {"n": 30522, "seed": 5, "op_uid": 6}),
        "multinomial": ({"X": rng.rand(16, 50).astype(np.float32)},
                        {"num_samples": 8, "seed": 5, "op_uid": 7}),
        "sampling_id": ({"X": rng.rand(16, 50).astype(np.float32)},
                        {"seed": 5, "op_uid": 8}),
    }
    cases["argsort_nan"] = ("argsort", {"X": ties},
                            {"axis": -1, "descending": True})
    cases["top_k_v2_nan"] = ("top_k_v2", {"X": ties},
                             {"k": 6, "axis": -1, "largest": False})
    cases["arg_max_nan"] = ("arg_max", {"X": ties}, {"axis": 1})
    cases["unique_nan"] = ("unique", {"X": ties}, {"dtype": "int64"})
    return cases


def ph20_ops(torch):
    """(c) every op this slice registers, through its registry kernel on
    CUDA tensors and on CPU tensors from the same numpy inputs: integers
    and booleans equal, floats within PH20_OP_TOL (normalised max error),
    NaNs at the same places; the draws' kernels against their plain
    versions (the truncated normal within RANDOM_ULPS)."""
    from paddle_tpu_torch.ops.registry import OpContext, run_kernel
    rng = np.random.RandomState(20)
    cases = ph20_op_cases(rng)
    worst, n_ops = {}, set()

    def to(v, dev):
        if isinstance(v, list):
            return [to(x, dev) for x in v]
        return torch.from_numpy(np.ascontiguousarray(v)).to(dev)

    def flat(o):
        out = []
        for slot in sorted(o):
            v = o[slot]
            out += list(v) if isinstance(v, list) else [v]
        return out

    for tag, case in cases.items():
        op, ins, attrs = (tag, *case) if len(case) == 2 else case
        n_ops.add(op)
        got = run_kernel(op, {k: to(v, "cuda") for k, v in ins.items()},
                         dict(attrs), OpContext(seed=0, device="cuda"))
        want = run_kernel(op, {k: to(v, "cpu") for k, v in ins.items()},
                          dict(attrs), OpContext(seed=0, device="cpu"))
        err = 0.0
        for g, w in zip(flat(got), flat(want)):
            g = g.cpu()
            if tuple(g.shape) != tuple(w.shape) or g.dtype != w.dtype:
                raise AssertionError(f"ph20 (c) {tag}: {tuple(g.shape)} "
                                     f"{g.dtype} vs {tuple(w.shape)} "
                                     f"{w.dtype}")
            if not w.is_floating_point():
                if not torch.equal(g, w):
                    raise AssertionError(f"ph20 (c) {tag}: integers differ")
                continue
            if not torch.equal(torch.isnan(g), torch.isnan(w)):
                raise AssertionError(f"ph20 (c) {tag}: NaNs differ")
            g, w = g.double().nan_to_num(), w.double().nan_to_num()
            scale = float(w.abs().max()) if w.numel() else 0.0
            e = float((g - w).abs().max()) if w.numel() else 0.0
            if op == "truncated_gaussian_random":
                e = float(((g - w).abs() / (torch.finfo(torch.float32).eps
                                            * w.abs().clamp(min=0.02)))
                          .max())
                if not e <= RANDOM_ULPS:
                    raise AssertionError(f"ph20 (c) {tag}: {e} ulps")
            else:
                e = e / scale if scale > 0 else e
                if not e <= PH20_OP_TOL:
                    raise AssertionError(f"ph20 (c) {tag}: normalised max "
                                         f"error {e}")
            err = max(err, e)
        worst[tag] = err
    out = {"ops": len(n_ops), "cases": len(cases), "max_err": worst}
    log({"phase": "ph20_ops", **out})
    return out


def ph20_random(torch, rnd, seed):
    """(d) each new Philox distribution against its plain version (on the
    card) at [30522, 768] (the truncated normal: a TruncatedNormal(0.02)
    init of the word embedding) and [8, 512] (randint over the vocabulary,
    Bernoulli at p = 0.15): the integers and the Bernoulli draw equal bit
    for bit, the truncated normal within RANDOM_ULPS; times: kernel (device
    ms), plain version, the library call (torch.nn.init.trunc_normal_,
    torch.randint, torch.bernoulli), bound = bytes moved over 3.35 TB/s."""
    seed_t = torch.tensor([seed + 2026], dtype=torch.int64, device="cuda")
    out = {}
    for name, shape in PH20_RANDOM:
        n = int(np.prod(shape))
        if name == "philox_trunc_normal":
            buf = torch.empty(shape, device="cuda")

            def kernel():
                return rnd.truncated_normal(shape, torch.float32, 0.0, 0.02,
                                            seed_t, 11, "cuda")

            def plain():
                return rnd.random_plain(shape, torch.float32,
                                        rnd.TRUNC_NORMAL, 0.0, 0.02, seed_t,
                                        11, "cuda")

            def lib():
                return torch.nn.init.trunc_normal_(buf, 0.0, 0.02, -0.04,
                                                   0.04)
            nbytes = n * 4
        elif name == "philox_randint":
            def kernel():
                return rnd.randint_cuda(shape, torch.int64, 0,
                                        BERT["vocab"], seed_t, 12, "cuda")

            def plain():
                return rnd.randint_plain(shape, torch.int64, 0,
                                         BERT["vocab"], seed_t, 12, "cuda")

            def lib():
                return torch.randint(0, BERT["vocab"], shape,
                                     device="cuda")
            nbytes = n * 8
        else:
            p = torch.full(shape, PH20_MASK_P, device="cuda")

            def kernel():
                return rnd.bernoulli_cuda(p, seed_t, 13)

            def plain():
                return rnd.bernoulli_plain(p, seed_t, 13)

            def lib():
                return torch.bernoulli(p)
            nbytes = n * 4 * 2
        got, want = kernel(), plain()
        if name == "philox_trunc_normal":
            scale = torch.finfo(torch.float32).eps * torch.clamp(
                want.abs(), min=0.02)
            ulps = float(((got - want).abs() / scale).max())
            if not ulps <= RANDOM_ULPS or float(got.abs().max()) > 0.04:
                raise AssertionError(f"ph20 (d) {name}: {ulps} ulps, "
                                     f"max {float(got.abs().max())}")
            x = got.double()
            var = 0.02 ** 2 * (1.0 - 4.0 * np.exp(-2.0) / np.sqrt(
                2.0 * np.pi) / 0.9544997361036416)
            if abs(float(x.var()) - var) > 5 * var * np.sqrt(2.0 / n):
                raise AssertionError(f"ph20 (d) {name}: variance "
                                     f"{float(x.var())} vs {var}")
        else:
            if not torch.equal(got, want):
                raise AssertionError(f"ph20 (d) {name}: kernel differs "
                                     "from its plain version")
            ulps = 0.0
        out[name] = {"shape": list(shape), "max_abs_err": float(
            (got.double() - want.double()).abs().max()), "max_ulps": ulps,
            "mean": float(got.double().mean()),
            "kernel_ms": device_ms(torch, kernel, 20),
            "plain_ms": cuda_time_ms(plain, 2),
            "library_ms": device_ms(torch, lib, 20),
            "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes"}
        del got, want
    log({"phase": "ph20_random", **out})
    return out


def tensor_phase(torch, seed):
    """(20) the paddle.tensor functions on the card: (a) ph20_bert, (b)
    ph20_jit, (c) ph20_ops, (d) ph20_random.  Returns the record with each
    path's launches and the new kernels' times."""
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import fused_xent as fx
    from paddle_tpu_torch.ops import random as rnd
    out = {"seconds": {}}
    t_phase = time.perf_counter()
    for part, fn, args in (("a", ph20_bert, (torch, attn, dr, fx, rnd,
                                             seed)),
                           ("b", ph20_jit, (torch, attn, dr, fx, rnd, seed)),
                           ("c", ph20_ops, (torch,)),
                           ("d", ph20_random, (torch, rnd, seed))):
        t0 = time.perf_counter()
        if part == "b":
            fx.enable_fused_xent(True)
            attn.enable_flash_attention(False)
        try:
            out[part] = fn(*args)
        finally:
            attn._FLASH_STATE["mode"] = "auto"
            fx.enable_fused_xent(False)
        out["seconds"][part] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["seconds"]["total"] = time.perf_counter() - t_phase
    log({"phase": "tensor", "seconds": out["seconds"]})
    return out


# ---------------------------------------------------------------------------
# phase 21: vision and seq2seq
# ---------------------------------------------------------------------------
PH21_STEPS = 3            # (a) 1 and (b): timed steps after one warm-up
PH21_LOSS_RTOL = 1e-4     # (a) 2: the kernels' loss against the plain one
# (a) 2: the SGD update gap (dp_update_gap) of the kernels' step against
# the plain versions' step, over nn.Transformer's parameters and over each
# q / k / v projection weight of the flash attentions (the leaves the dQ
# and dK/dV kernels' outputs feed).  Both steps are deterministic: 1.115e-3
# and 2.58e-3 at the largest leaf (NVIDIA H100 80GB HBM3, 700 W; each fp32
# step is ~1.7e-3 from a float64 step), against 2.9e-3 / 1 with one dQ
# launch's output zeroed and 5.4e-3 / 1.005e-2 with one dK/dV launch's
# outputs scaled by 1.01
PH21_UPDATE_TOL = 2e-3
PH21_LEAF_TOL = 5e-3
PH21_LEAF = re.compile(r"^transformer\.(encoder\.layers\.\d+\.self_attn|"
                       r"decoder\.layers\.\d+\.cross_attn)\."
                       r"[qkv]_proj\.weight$")
PH21_LR = 0.1             # (a) 2's SGD learning rate
PH21_BEAM = dict(beam=4, rows=2, tokens=16)
PH21_VISION = dict(batch=32, img=224, classes=1000, lr=0.01)
PH21_FWD_RTOL = 1e-4      # (b) a batch-2 forward on the card vs the CPU
PH21_OP_TOL = 1e-5        # (c) fp32, CUDA against CPU, normalised max error
PH21_BF16_TOL = 2e-2      # (c) bf16 (the AMP-white convolutions)
PH21_PATHS = ("ph21_transformer_big", "ph21_transformer_flash",
              "ph21_beam_search", "ph21_vgg16", "ph21_mobilenet_v2")
# every hand kernel a phase 21 path may launch: phase 20's nine
PH21_COUNTED = DP_COUNTED + PH20_KERNELS
# dropouts of one transformer_big forward in training: the two positional
# encodings; a layer's attention-weight dropouts (1 in the encoder, 2 in
# the decoder) and its residual and activation ones (3 / 4)
PH21_TRANSFORMER_DROPOUTS = 2 + TRANSFORMER_BIG["n_layers"] * (4 + 6)


def ph21_zero(counters):
    """Every phase 21 count (ph20_counters) set to 0."""
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import random as rnd
    ph20_zero(attn, counters, rnd)


def ph21_path(attn, counters, path, fn):
    """fn() as one main path: every count set to 0 just before, read
    just after; the path's launches and the head-dim-above-128 ones."""
    ph21_zero(counters)
    out = fn()
    launches, by_dtype = dp_read(counters)
    record_wide(path, read_wide(attn))
    return out, {"launches": launches, "by_dtype": by_dtype}


def ph21_timed(torch, step, counters):
    """PH21_STEPS calls of step(), each timed to the card's end: (ms,
    losses, the hand-kernel launches of each)."""
    ms, losses, per_step = [], [], []
    for _ in range(PH21_STEPS):
        before = dp_read(counters)[0]
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        after = dp_read(counters)[0]
        per_step.append({k: after[k] - before[k] for k in after})
    return ms, losses, per_step


def ph21_transformer_batch(torch, seed):
    rng = np.random.RandomState(seed)
    b, v = TRANSFORMER_BATCH, TRANSFORMER_BIG["vocab"]
    return tuple(torch.from_numpy(a).cuda() for a in (
        rng.randint(2, v, (b, TRANSFORMER_BIG["src_len"])).astype(np.int64),
        rng.randint(2, v, (b, TRANSFORMER_BIG["trg_len"])).astype(np.int64),
        rng.randint(2, v, (b, TRANSFORMER_BIG["trg_len"])).astype(np.int64)))


def ph21_transformer_model(seed, dropout=None):
    """models.transformer.transformer_big at its published widths (d_model
    1024, 16 heads, 6 + 6 layers, d_inner 4096, dropout 0.3, one shared
    32000 vocabulary), weights from `seed`, on the card."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.models import transformer as tr
    _reset_unique_names()
    paddle.seed(seed)
    kw = {} if dropout is None else {"dropout": dropout}
    model = tr.transformer_big(src_vocab_size=TRANSFORMER_BIG["vocab"],
                               trg_vocab_size=TRANSFORMER_BIG["vocab"],
                               max_length=max(TRANSFORMER_BIG["src_len"],
                                              TRANSFORMER_BIG["trg_len"]),
                               **kw)
    cfg = model.config
    if (cfg.d_model, cfg.n_head, cfg.num_encoder_layers, cfg.d_inner_hid) \
            != (TRANSFORMER_BIG["d_model"], TRANSFORMER_BIG["heads"],
                TRANSFORMER_BIG["n_layers"], TRANSFORMER_BIG["d_inner"]):
        raise AssertionError("transformer_big is not Transformer-big")
    return model, tr.CrossEntropyCriterion(0.1)


def ph21_published(torch, attn, counters, seed):
    """(a) 1: transformer_big as published (dropout 0.3, attention dropout
    on, so every attention takes the score matrix), Adam 1e-4, one
    warm-up step then PH21_STEPS timed: ms a step, target tokens/s, peak
    memory; launches a step: no flash, PH21_TRANSFORMER_DROPOUTS dropout
    kernels."""
    from paddle_tpu_torch import optimizer
    model, crit = ph21_transformer_model(seed)
    src, trg, lbl = ph21_transformer_batch(torch, seed)
    opt = optimizer.Adam(1e-4, parameters=model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    model.train()

    def step():
        loss = crit(model(src, trg), lbl)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return float(loss.detach())

    losses = [step()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    (ms, more, per_step), launches = ph21_path(
        attn, counters, "ph21_transformer_big",
        lambda: ph21_timed(torch, step, counters))
    losses += more
    want = dict.fromkeys(PH21_COUNTED, 0)
    want["dropout_philox"] = PH21_TRANSFORMER_DROPOUTS
    check_equal("ph21 (a) 1 launches a step", per_step, [want] * PH21_STEPS)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"ph21 (a) 1 losses {losses}")
    tokens = TRANSFORMER_BATCH * TRANSFORMER_BIG["trg_len"]
    med = float(np.median(ms))
    out = {"losses": losses, "step_ms": ms, "median_step_ms": med,
           "target_tokens_per_s": tokens / med * 1e3,
           "peak_gpu_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "params": int(n_params), "launches_per_step": per_step,
           **launches}
    log({"phase": "ph21_transformer_big", **{k: v for k, v in out.items()
                                             if k != "by_dtype"}})
    del model, opt
    torch.cuda.empty_cache()
    return out


def ph21_flash_step(torch, attn, counters, seed):
    """(a) 2: dropout 0, flash forced on (the encoder self-attention and
    the decoder cross-attention take the flash forward, dQ and dK/dV
    kernels; the decoder self-attention its causal mask's score matrix),
    one SGD step with the kernels, the same step from the same weights
    through the plain versions (flash off: the score matrix), the plain
    step in float64 (a yardstick for both fp32 steps), and three planted
    faults in the kernels' step: the encoder's gradients zeroed, the first
    dQ launch's output zeroed and the first dK/dV launch's outputs scaled
    by 1.01 (kernel faults in one layer).  Gates: 12 / 12 / 12 launches,
    fp32, the loss within PH21_LOSS_RTOL; the update gap of
    nn.Transformer's parameters (the tied embedding's update, which the
    logits' gradient dominates, left out) within PH21_UPDATE_TOL and the
    largest update gap of a PH21_LEAF projection within PH21_LEAF_TOL,
    each fault's above both; the gaps in float64 on the card."""
    from paddle_tpu_torch import optimizer
    model, crit = ph21_transformer_model(seed, dropout=0.0)
    src, trg, lbl = ph21_transformer_batch(torch, seed)
    base = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.train()
    real_bwd = attn.flash_attention_bwd

    def first_bwd(fault):
        """flash_attention_bwd with `fault` applied to the first call's
        (dq, dk, dv): the kernels still launch, one layer's output is
        wrong."""
        calls = []

        def bwd(*a, **k):
            out = real_bwd(*a, **k)
            calls.append(1)
            return fault(*out) if len(calls) == 1 else out
        return bwd

    def one_step(flash, fault=None, net=model):
        net.set_state_dict(base)
        opt = optimizer.SGD(PH21_LR, parameters=net.parameters())
        attn.enable_flash_attention(flash)
        if fault not in (None, "encoder"):
            attn.flash_attention_bwd = first_bwd(fault)
        try:
            loss = crit(net(src, trg), lbl)
            loss.backward()
            if fault == "encoder":
                for p in net.transformer.encoder.parameters():
                    p.grad.zero_()
            opt.step()
            opt.clear_grad()
            torch.cuda.synchronize()
        finally:
            attn._FLASH_STATE["mode"] = "auto"
            attn.flash_attention_bwd = real_bwd
        return float(loss.detach()), {k: v.detach().clone()
                                      for k, v in net.state_dict().items()}

    (k_loss, k_state), launches = ph21_path(
        attn, counters, "ph21_transformer_flash", lambda: one_step(True))
    ph21_zero(counters)
    p_loss, p_state = one_step(False)
    plain_launches = dp_read(counters)[0]
    faults = {
        "encoder_grads_zeroed": one_step(True, "encoder")[1],
        "first_dq_zeroed": one_step(
            True, lambda dq, dk, dv: (torch.zeros_like(dq), dk, dv))[1],
        "first_dkv_scaled_1.01": one_step(
            True, lambda dq, dk, dv: (dq, dk * 1.01, dv * 1.01))[1]}
    net64 = copy.deepcopy(model).double()
    d_loss, d_state = one_step(False, net=net64)
    del net64
    torch.cuda.empty_cache()
    n = TRANSFORMER_BIG["n_layers"]
    want = dict.fromkeys(PH21_COUNTED, 0)
    want.update(flash_attn_fwd=2 * n, flash_attn_bwd_dq=2 * n,
                flash_attn_bwd_dkv=2 * n)
    check_equal("ph21 (a) 2 launches a step", launches["launches"], want)
    check_equal("ph21 (a) 2 launches by dtype", launches["by_dtype"],
                {k: ({"float32": want[k]} if want[k] else {})
                 for k in DP_KERNELS})
    check_equal("ph21 (a) 2 plain launches", plain_launches,
                dict.fromkeys(PH21_COUNTED, 0))
    loss_err = abs(k_loss - p_loss) / abs(p_loss)
    want_state = {k: v for k, v in p_state.items()
                  if k.startswith("transformer.")}
    leaves = [k for k in want_state if PH21_LEAF.match(k)]
    if len(leaves) != 3 * 2 * n:
        raise AssertionError(f"ph21 (a) 2: {len(leaves)} projection leaves")

    def gaps(state):
        """`state`'s update gap over want_state against the plain step,
        its largest elementwise difference, and the largest gap of a
        PH21_LEAF projection."""
        by_leaf = {k: dp_update_gap(torch, {k: base[k]}, {k: state[k]},
                                    {k: want_state[k]}, "cuda")[0]
                   for k in leaves}
        top = max(by_leaf, key=by_leaf.get)
        gap, worst = dp_update_gap(torch, base, state, want_state, "cuda")
        return {"update_gap": gap, "update_max_abs_diff": worst,
                "leaf_gap": by_leaf[top], "leaf": top}

    sound = gaps(k_state)
    gap, leaf_gap = sound["update_gap"], sound["leaf_gap"]
    fault_gaps = {tag: gaps(st) for tag, st in faults.items()}
    f64_state = {k: v for k, v in d_state.items() if k in want_state}
    f64_gaps = {tag: dp_update_gap(torch, base, st, f64_state, "cuda")[0]
                for tag, st in (("kernels", k_state), ("plain", p_state))}
    if not loss_err <= PH21_LOSS_RTOL:
        raise AssertionError(f"ph21 (a) 2 loss {k_loss} vs plain {p_loss}")
    if not (gap <= PH21_UPDATE_TOL and leaf_gap <= PH21_LEAF_TOL):
        raise AssertionError(f"ph21 (a) 2 update gap {gap}, leaf gap "
                             f"{leaf_gap} ({sound['leaf']}); gates "
                             f"{PH21_UPDATE_TOL} / {PH21_LEAF_TOL}")
    for tag, f in fault_gaps.items():
        if not (f["update_gap"] > PH21_UPDATE_TOL
                and f["leaf_gap"] > PH21_LEAF_TOL):
            raise AssertionError(f"ph21 (a) 2 planted fault {tag} within a "
                                 f"gate: {f}")
    out = {"loss": k_loss, "plain_loss": p_loss, "loss_rel_err": loss_err,
           **sound, "faults": fault_gaps,
           "float64_loss": d_loss, "update_gap_to_float64": f64_gaps,
           **launches}
    log({"phase": "ph21_transformer_flash", **{
        k: v for k, v in out.items() if k != "by_dtype"}})
    del model, base, k_state, p_state, faults, d_state
    torch.cuda.empty_cache()
    return out


def ph21_beam(torch, attn, counters, seed):
    """(a) 3: beam_search (beam 4, 2 source rows of 256 tokens, 16 target
    tokens) with flash forced on (the kernels' forward on the
    encoder and each step's cross-attention: Sq = 1..16 against Sk =
    256), and again with flash off (the plain versions).  The tokens must
    be equal, or part only where the step's fp32 beam choice had a margin
    under NEAR_TIE (the kernels' run recorded by the beam_search op's
    inputs)."""
    from paddle_tpu_torch.ops import registry
    model, _ = ph21_transformer_model(seed, dropout=0.0)
    model.eval()
    src = ph21_transformer_batch(torch, seed + 1)[0][:PH21_BEAM["rows"]]
    real_run = registry.run_kernel

    def run(flash):
        seen = []

        def spy(op, ins, attrs, ctx):
            if op == "beam_search":
                seen.append((ins["pre_scores"].clone(),
                             ins["scores"].clone()))
            return real_run(op, ins, attrs, ctx)

        attn.enable_flash_attention(flash)
        registry.run_kernel = spy
        try:
            t0 = time.perf_counter()
            toks = model.beam_search(src, beam_size=PH21_BEAM["beam"],
                                     max_len=PH21_BEAM["tokens"] + 1)
            secs = time.perf_counter() - t0
        finally:
            registry.run_kernel = real_run
            attn._FLASH_STATE["mode"] = "auto"
        return toks, seen, secs

    (k_toks, k_seen, k_s), launches = ph21_path(
        attn, counters, "ph21_beam_search", lambda: run(True))
    ph21_zero(counters)
    p_toks, p_seen, p_s = run(False)
    plain_launches = dp_read(counters)[0]
    steps = len(k_seen)
    n = TRANSFORMER_BIG["n_layers"]
    # the encoder once, then each step's decoder: one forward a layer
    want = dict.fromkeys(PH21_COUNTED, 0)
    want["flash_attn_fwd"] = n + n * steps
    check_equal("ph21 (a) 3 launches", launches["launches"], want)
    check_equal("ph21 (a) 3 plain launches", plain_launches,
                dict.fromkeys(PH21_COUNTED, 0))
    diverged = []
    if not np.array_equal(k_toks, p_toks):
        W = PH21_BEAM["beam"]
        for step, ((pre, sc), (_, psc)) in enumerate(zip(k_seen, p_seen)):
            if torch.equal(sc, psc):
                continue
            cand = (pre + sc).float().reshape(PH21_BEAM["rows"], -1) \
                if step else sc.float().reshape(PH21_BEAM["rows"], W,
                                                -1)[:, 0]
            top = torch.topk(cand, W + 1, dim=-1).values
            margin = float((top[:, :-1] - top[:, 1:]).min())
            diverged.append({"step": step, "fp32_margin": margin})
            break
        if not diverged or diverged[0]["fp32_margin"] >= NEAR_TIE:
            raise AssertionError(f"ph21 (a) 3 tokens differ from the plain "
                                 f"run's: {k_toks.tolist()} vs "
                                 f"{p_toks.tolist()} ({diverged})")
    out = {"tokens": k_toks.tolist(), "plain_tokens": p_toks.tolist(),
           "steps": steps, "seconds": k_s, "plain_seconds": p_s,
           "diverged": diverged, **launches}
    log({"phase": "ph21_beam_search", **{k: v for k, v in out.items()
                                         if k != "by_dtype"}})
    del model
    torch.cuda.empty_cache()
    return out


def ph21_vision(torch, attn, counters, seed, name):
    """(b) vision.models.<name>() at 224 x 224, 1000 classes, batch 32,
    fp32, Momentum(0.01, 0.9), F.cross_entropy: one warm-up step, then
    PH21_STEPS timed (ms, images/s, peak memory); a batch-2 eval forward
    on the card against the same model's on the CPU (normalised max
    error within PH21_FWD_RTOL).  Launches a step: the classifier's
    dropouts only."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import dygraph, nn, optimizer, vision
    from paddle_tpu_torch.core.place import CPUPlace
    from paddle_tpu_torch.core.program import _reset_unique_names
    v = PH21_VISION
    ctor = getattr(vision.models, name)
    _reset_unique_names()
    paddle.seed(seed)
    net = ctor(num_classes=v["classes"])
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.rand(v["batch"], 3, v["img"], v["img"])
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, v["classes"], (v["batch"], 1))
                         .astype(np.int64)).cuda()
    # the forward against the CPU first, from the initial weights
    net.eval()
    with torch.no_grad():
        card = net(x[:2]).cpu()
    cpu_net = copy.deepcopy(net).to("cpu")  # no CPU initializer run
    with dygraph.guard(CPUPlace()), torch.no_grad():
        ref = cpu_net(x[:2].cpu())
    fwd_err = float((card - ref).abs().max() / ref.abs().max())
    if not fwd_err <= PH21_FWD_RTOL:
        raise AssertionError(f"ph21 (b) {name}: card forward {fwd_err} off "
                             "the CPU's")
    del cpu_net
    net.train()
    opt = optimizer.Momentum(v["lr"], 0.9, parameters=net.parameters())

    def step():
        loss = nn.functional.cross_entropy(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return float(loss.detach())

    losses = [step()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    (ms, more, per_step), launches = ph21_path(
        attn, counters, f"ph21_{name}",
        lambda: ph21_timed(torch, step, counters))
    losses += more
    want = dict.fromkeys(PH21_COUNTED, 0)
    want["dropout_philox"] = sum(isinstance(m, nn.Dropout) and m.p > 0
                                 for m in net.sublayers())
    check_equal(f"ph21 (b) {name} launches a step", per_step,
                [want] * PH21_STEPS)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"ph21 (b) {name} losses {losses}")
    med = float(np.median(ms))
    out = {"losses": losses, "step_ms": ms, "median_step_ms": med,
           "images_per_s": v["batch"] / med * 1e3,
           "peak_gpu_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "params": int(sum(p.numel() for p in net.parameters())),
           "fwd_vs_cpu_err": fwd_err, "launches_per_step": per_step,
           **launches}
    log({"phase": f"ph21_{name}", **{k: v for k, v in out.items()
                                     if k != "by_dtype"}})
    del net, opt
    torch.cuda.empty_cache()
    return out


def ph21_op_cases(rng):
    """(c) {tag: (op, ins, attrs, cotangent slots)} of every op type this
    slice registers, numpy inputs at small shapes; "_bf16" cases of the
    AMP-white convolutions."""
    f = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)  # noqa: E731
    pos = lambda *s: rng.uniform(0.5, 2.0, s).astype(np.float32)  # noqa
    idx = np.stack([np.stack([rng.permutation(64)[:16].reshape(4, 4)
                              for _ in range(3)]) for _ in range(2)])
    conv = lambda op, x, w, **a: (op, {"Input": x, "Filter": w}, a,  # noqa
                                  ["Output"])
    bn = {"Scale": f(8), "Bias": f(8), "Mean": f(8), "Variance": pos(8)}
    cases = {
        "conv3d": conv("conv3d", f(2, 4, 8, 9, 8), f(8, 4, 3, 3, 3),
                       strides=[2, 1, 2], paddings=[1, 1, 1]),
        "depthwise_conv2d": conv("depthwise_conv2d", f(2, 8, 16, 16),
                                 f(8, 1, 3, 3), paddings=[1, 1]),
        "conv2d_transpose": conv("conv2d_transpose", f(2, 8, 9, 9),
                                 f(8, 4, 3, 3), strides=[2, 2],
                                 paddings=[1, 1], output_size=[18, 18]),
        "conv3d_transpose": conv("conv3d_transpose", f(2, 4, 5, 5, 5),
                                 f(4, 4, 2, 2, 2), strides=[2, 2, 2]),
        "depthwise_conv2d_transpose": conv(
            "depthwise_conv2d_transpose", f(2, 8, 9, 9), f(8, 1, 3, 3),
            strides=[2, 2], paddings=[0, 1, 1, 0]),
        "pool3d": ("pool3d", {"X": f(2, 4, 8, 8, 8)},
                   {"pooling_type": "avg", "ksize": [3, 3, 3],
                    "strides": [2, 2, 2], "paddings": [1, 1, 1]}, ["Out"]),
        "max_pool2d_with_index": ("max_pool2d_with_index",
                                  {"X": f(2, 4, 16, 16)},
                                  {"ksize": [2, 2], "strides": [2, 2]},
                                  ["Out"]),
        "max_pool3d_with_index": ("max_pool3d_with_index",
                                  {"X": f(2, 4, 8, 8, 8)},
                                  {"ksize": [2, 2, 2], "strides": [2, 2, 2],
                                   "paddings": [1, 1, 1]}, ["Out"]),
        "spp": ("spp", {"X": f(2, 4, 16, 16)}, {"pyramid_height": 3},
                ["Out"]),
        "unpool": ("unpool", {"X": f(2, 3, 4, 4), "Indices": idx}, {},
                   ["Out"]),
        "sync_batch_norm": ("sync_batch_norm", {"X": f(4, 8, 6, 6), **bn},
                            {"momentum": 0.9}, ["Y"]),
        "instance_norm": ("instance_norm", {"X": f(2, 8, 6, 6),
                                            "Scale": f(8), "Bias": f(8)},
                          {}, ["Y"]),
        "group_norm": ("group_norm", {"X": f(2, 8, 6, 6), "Scale": f(8),
                                      "Bias": f(8)}, {"groups": 4}, ["Y"]),
        "lrn": ("lrn", {"X": f(2, 8, 6, 6)}, {"n": 5}, ["Out"]),
        "data_norm": ("data_norm", {"X": f(16, 8), "BatchSize": pos(8) * 8,
                                    "BatchSum": f(8),
                                    "BatchSquareSum": pos(8) * 8}, {},
                      ["Y"]),
        "spectral_norm": ("spectral_norm", {"Weight": f(16, 24),
                                            "U": f(16), "V": f(24)},
                          {"power_iters": 2}, ["Out"]),
        "embedding": ("embedding", {"W": f(100, 16), "Ids": rng.randint(
            0, 100, (4, 8)).astype(np.int64)}, {"padding_idx": 3}, ["Out"]),
        "add_position_encoding": ("add_position_encoding",
                                  {"X": f(2, 16, 32)}, {"alpha": 0.5},
                                  ["Out"]),
        "pixel_shuffle": ("pixel_shuffle", {"X": f(2, 16, 6, 6)},
                          {"upscale_factor": 2}, ["Out"]),
        "space_to_depth": ("space_to_depth", {"X": f(2, 4, 8, 8)},
                           {"blocksize": 2}, ["Out"]),
        "temporal_shift": ("temporal_shift", {"X": f(8, 8, 4, 4)},
                           {"seg_num": 4}, ["Out"]),
        "shuffle_channel": ("shuffle_channel", {"X": f(2, 8, 4, 4)},
                            {"group": 2}, ["Out"]),
        "unfold": ("unfold", {"X": f(2, 4, 9, 9)},
                   {"kernel_sizes": [3, 3], "strides": [2, 2],
                    "paddings": [1, 1, 1, 1]}, ["Y"]),
        "im2sequence": ("im2sequence", {"X": f(2, 4, 9, 9)},
                        {"kernels": [3, 3], "strides": [2, 2]}, ["Out"]),
        "pad2d": ("pad2d", {"X": f(2, 4, 6, 6)},
                  {"paddings": [1, 2, 2, 1], "mode": "reflect"}, ["Out"]),
        "pad3d": ("pad3d", {"X": f(2, 4, 5, 5, 5)},
                  {"paddings": [1, 1, 2, 0, 0, 2], "mode": "replicate"},
                  ["Out"]),
        "bilinear_tensor_product": ("bilinear_tensor_product",
                                    {"X": f(8, 6), "Y": f(8, 5),
                                     "Weight": f(4, 6, 5), "Bias": f(1, 4)},
                                    {}, ["Out"]),
        "affine_channel": ("affine_channel", {"X": f(2, 8, 5, 5),
                                              "Scale": f(8), "Bias": f(8)},
                           {}, ["Out"]),
        "affine_grid": ("affine_grid", {"Theta": f(2, 2, 3)},
                        {"output_shape": [2, 3, 8, 9]}, ["Output"]),
        "grid_sampler": ("grid_sampler", {"X": f(2, 4, 8, 8),
                                          "Grid": f(2, 6, 7, 2)}, {},
                         ["Output"]),
        "norm": ("norm", {"X": f(4, 16, 8)}, {"axis": 1}, ["Out"]),
        "relu6": ("relu6", {"X": 8 * f(16, 32)}, {}, ["Out"]),
    }
    for m in ("bilinear", "nearest", "bicubic"):
        for v in ("", "_v2"):
            for ac in (True, False):
                cases[f"{m}_interp{v}_ac{int(ac)}"] = (
                    f"{m}_interp{v}", {"X": f(2, 4, 12, 10)},
                    {"out_h": 7 if v else 17, "out_w": 15 if v else 6,
                     "align_corners": ac}, ["Out"])
    for v in ("", "_v2"):
        cases["linear_interp" + v] = ("linear_interp" + v,
                                      {"X": f(2, 4, 20)}, {"out_w": 9},
                                      ["Out"])
        cases["trilinear_interp" + v] = ("trilinear_interp" + v,
                                         {"X": f(2, 4, 6, 5, 7)},
                                         {"out_d": 9, "out_h": 3,
                                          "out_w": 7}, ["Out"])
    for tag in ("conv3d", "depthwise_conv2d", "conv2d_transpose",
                "conv3d_transpose", "depthwise_conv2d_transpose"):
        op, ins, attrs, ct = cases[tag]
        cases[tag + "_bf16"] = (op, {k: (v, "bfloat16")
                                     for k, v in ins.items()}, attrs, ct)
    return cases


def ph21_compare(torch, tag, got, want, tol, scale_of=None):
    """Every output of `got` (card) against `want` (CPU): integers equal,
    floats within `tol` (normalised max error: over the slot's largest
    magnitude, or `scale_of(slot)` where it gives one); the largest
    error."""
    err = 0.0
    for slot in sorted(want):
        w, g = want[slot], got.get(slot)
        if w is None:
            continue
        ws = w if isinstance(w, list) else [w]
        gs = g if isinstance(g, list) else [g]
        for a, b in zip(gs, ws):
            a = a.detach().cpu()
            b = b.detach()
            if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
                raise AssertionError(f"ph21 (c) {tag} {slot}: "
                                     f"{tuple(a.shape)} {a.dtype} vs "
                                     f"{tuple(b.shape)} {b.dtype}")
            if not b.is_floating_point():
                if not torch.equal(a, b):
                    raise AssertionError(f"ph21 (c) {tag} {slot}: "
                                         "integers differ")
                continue
            scale = float(b.double().abs().max()) if b.numel() else 0.0
            if scale_of is not None and scale_of(slot) is not None:
                scale = scale_of(slot)
            e = float((a.double() - b.double()).abs().max()) \
                if b.numel() else 0.0
            e = e / scale if scale > 0 else e
            if not e <= tol:
                raise AssertionError(f"ph21 (c) {tag} {slot}: normalised "
                                     f"max error {e} (gate {tol})")
            err = max(err, e)
    return err


def ph21_ops(torch):
    """(c) every op type of the slice through its registry kernel on CUDA
    tensors and on CPU tensors from the same numpy inputs, then its grad
    op fed the same cotangents: fp32 within PH21_OP_TOL, the bf16 cases
    of the AMP-white convolutions within PH21_BF16_TOL."""
    from paddle_tpu_torch.ops.registry import OpContext, get_op_info, \
        run_kernel
    rng = np.random.RandomState(21)
    cases = ph21_op_cases(rng)
    worst, ops = {}, set()

    def to(v, dev):
        if isinstance(v, tuple):
            return torch.from_numpy(v[0]).to(dev, torch.bfloat16)
        return torch.from_numpy(np.ascontiguousarray(v)).to(dev)

    for tag, (op, ins, attrs, ct_slots) in cases.items():
        ops.add(op)
        tol = PH21_BF16_TOL if tag.endswith("_bf16") else PH21_OP_TOL
        runs = {}
        for dev in ("cuda", "cpu"):
            t_ins = {k: to(v, dev) for k, v in ins.items()}
            fwd = run_kernel(op, t_ins, dict(attrs),
                             OpContext(seed=0, device=dev))
            gins = dict(t_ins, **{k: v for k, v in fwd.items()
                                  if v is not None})
            crng = np.random.RandomState(1)
            for slot in ct_slots:
                ct = crng.uniform(-1, 1, tuple(fwd[slot].shape)) \
                    .astype(np.float32)
                gins[slot + "@GRAD"] = torch.from_numpy(ct).to(
                    dev, fwd[slot].dtype)
            grads = get_op_info(op + "_grad").kernel(
                gins, dict(attrs), OpContext(seed=0, device=dev))
            runs[dev] = (fwd, grads)
        e_fwd = ph21_compare(torch, tag, runs["cuda"][0], runs["cpu"][0],
                             tol)
        e_grad = ph21_compare(torch, tag + "_grad", runs["cuda"][1],
                              runs["cpu"][1], tol)
        if not any(v is not None for v in runs["cpu"][1].values()):
            raise AssertionError(f"ph21 (c) {tag}: no gradient")
        worst[tag] = max(e_fwd, e_grad)
    out = {"ops": len(ops), "cases": len(cases), "max_err": worst}
    log({"phase": "ph21_ops", **out})
    return out


def ph21_layer_cases():
    """(c) {name: (make(nn), input shapes)} of every new dygraph layer."""
    return {
        "Conv1D": (lambda nn: nn.Conv1D(8, 16, 3, padding=1), [(4, 8, 32)]),
        "Conv3D": (lambda nn: nn.Conv3D(4, 8, 3, padding=1),
                   [(2, 4, 8, 8, 8)]),
        "Conv2DTranspose": (lambda nn: nn.Conv2DTranspose(8, 4, 3, stride=2,
                                                          padding=1),
                            [(2, 8, 9, 9)]),
        "Conv3DTranspose": (lambda nn: nn.Conv3DTranspose(4, 4, 2, stride=2),
                            [(2, 4, 4, 4, 4)]),
        "BatchNorm1D": (lambda nn: nn.BatchNorm1D(16), [(32, 16)]),
        "BatchNorm3D": (lambda nn: nn.BatchNorm3D(4), [(2, 4, 4, 4, 4)]),
        "SyncBatchNorm": (lambda nn: nn.SyncBatchNorm(8), [(4, 8, 6, 6)]),
        "GroupNorm": (lambda nn: nn.GroupNorm(4, 8), [(2, 8, 6, 6)]),
        "InstanceNorm1D": (lambda nn: nn.InstanceNorm1D(8), [(2, 8, 16)]),
        "InstanceNorm2D": (lambda nn: nn.InstanceNorm2D(8), [(2, 8, 6, 6)]),
        "InstanceNorm3D": (lambda nn: nn.InstanceNorm3D(4),
                           [(2, 4, 4, 4, 4)]),
        "LocalResponseNorm": (lambda nn: nn.LocalResponseNorm(5),
                              [(2, 8, 6, 6)]),
        "SpectralNorm": (lambda nn: nn.SpectralNorm([16, 24]), [(16, 24)]),
        "MaxPool2D_mask": (lambda nn: nn.MaxPool2D(2, return_mask=True),
                           [(2, 4, 16, 16)]),
        "AdaptiveMaxPool2D": (lambda nn: nn.AdaptiveMaxPool2D(4),
                              [(2, 4, 16, 16)]),
        "MaxPool1D": (lambda nn: nn.MaxPool1D(2), [(2, 8, 32)]),
        "AvgPool1D": (lambda nn: nn.AvgPool1D(3, 2, 1), [(2, 8, 32)]),
        "Dropout2D": (lambda nn: nn.Dropout2D(0.5), [(2, 8, 6, 6)]),
        "Flatten": (lambda nn: nn.Flatten(), [(2, 8, 6, 6)]),
        "Pad2D": (lambda nn: nn.Pad2D([1, 2, 0, 1]), [(2, 8, 6, 6)]),
        "Upsample": (lambda nn: nn.Upsample(size=[11, 13], mode="bicubic"),
                     [(2, 4, 6, 6)]),
        "UpsamplingBilinear2D": (lambda nn: nn.UpsamplingBilinear2D(
            scale_factor=2), [(2, 4, 6, 6)]),
        "UpsamplingNearest2D": (lambda nn: nn.UpsamplingNearest2D(
            size=[9, 9]), [(2, 4, 6, 6)]),
        "PixelShuffle": (lambda nn: nn.PixelShuffle(2), [(2, 16, 6, 6)]),
        "CosineSimilarity": (lambda nn: nn.CosineSimilarity(axis=1),
                             [(8, 32), (8, 32)]),
        "Bilinear": (lambda nn: nn.Bilinear(6, 5, 4), [(8, 6), (8, 5)]),
        "ReLU6": (lambda nn: nn.ReLU6(), [(16, 32)]),
        "TransformerDecoderLayer": (
            lambda nn: nn.TransformerDecoderLayer(64, 4, 128, dropout=0.0),
            [(2, 9, 64), (2, 12, 64)]),
        "TransformerDecoder": (
            lambda nn: nn.TransformerDecoder(nn.TransformerDecoderLayer(
                64, 4, 128, dropout=0.0), 2), [(2, 9, 64), (2, 12, 64)]),
        "Transformer": (lambda nn: nn.Transformer(64, 4, 2, 2, 128,
                                                  dropout=0.0),
                        [(2, 12, 64), (2, 9, 64)]),
    }


def ph21_layers(torch, seed):
    """(c) every new dygraph layer built on the card (weights from
    `seed`), copied to a CPU twin with set_state_dict: the forward in eval
    mode (Dropout2D's identity; the batch norms' running statistics) and
    the gradients of sum(out * ct) for the inputs and parameters, card
    against CPU within PH21_OP_TOL (normalised max error).  An attention
    key projection's bias has a gradient of 0 in exact arithmetic (the
    softmax ignores a constant a row), so both sides hold rounding noise
    there: it is normalised by the layer's largest gradient instead."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import dygraph, nn
    from paddle_tpu_torch.core.place import CPUPlace
    rng = np.random.RandomState(seed + 21)
    worst = {}
    for name, (make, shapes) in ph21_layer_cases().items():
        paddle.seed(seed)
        card = make(nn)
        with dygraph.guard(CPUPlace()):
            cpu = make(nn)
        cpu.set_state_dict({k: v.detach().cpu()
                            for k, v in card.state_dict().items()})
        card.eval()
        cpu.eval()
        arrays = [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]
        res = {}
        for dev, layer in (("cuda", card), ("cpu", cpu)):
            xs = [torch.from_numpy(a).to(dev).requires_grad_(True)
                  for a in arrays]
            out = layer(*xs)
            out = out[0] if isinstance(out, tuple) else out
            ct = torch.from_numpy(np.random.RandomState(2).uniform(
                -1, 1, tuple(out.shape)).astype(np.float32)).to(dev)
            (out * ct).sum().backward()
            res[dev] = {"out": out}
            res[dev].update({f"x{i}@GRAD": x.grad
                             for i, x in enumerate(xs)})
            res[dev].update({k + "@GRAD": p.grad
                             for k, p in layer.named_parameters()
                             if p.grad is not None})
        if set(res["cuda"]) != set(res["cpu"]):
            raise AssertionError(f"ph21 (c) {name}: gradients on "
                                 f"{sorted(res['cuda'])} vs "
                                 f"{sorted(res['cpu'])}")
        top = max(float(v.double().abs().max())
                  for k, v in res["cpu"].items() if k.endswith("@GRAD"))
        worst[name] = ph21_compare(
            torch, name, res["cuda"], res["cpu"], PH21_OP_TOL,
            lambda slot, top=top: top if slot.endswith("k_proj.bias@GRAD")
            else None)
    out = {"layers": len(worst), "max_err": worst}
    log({"phase": "ph21_layers", **out})
    return out


def vs_phase(torch, seed):
    """(21) vision and seq2seq: (a) Transformer-big in dygraph (1 the
    published recipe, 2 the flash step against its plain versions, 3
    beam_search), (b) VGG-16 and MobileNet-V2 training, (c) every new op
    and layer on the card against the CPU.  (d) runs inside phase 13's
    ranks (dp_sync_bn_rank) and its NCCL world (dp_nccl_sync_bn).
    Returns the records with each path's launches."""
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import fused_xent as fx
    from paddle_tpu_torch.ops import random as rnd
    counters = ph20_counters(attn, dr, fx, rnd)  # phase 20's nine
    out = {"seconds": {}}
    t_phase = time.perf_counter()
    for part, fn, args in (
            ("a1", ph21_published, (torch, attn, counters, seed)),
            ("a2", ph21_flash_step, (torch, attn, counters, seed)),
            ("a3", ph21_beam, (torch, attn, counters, seed)),
            ("b_vgg16", ph21_vision, (torch, attn, counters, seed,
                                      "vgg16")),
            ("b_mobilenet_v2", ph21_vision, (torch, attn, counters, seed,
                                             "mobilenet_v2")),
            ("c_ops", ph21_ops, (torch,)),
            ("c_layers", ph21_layers, (torch, seed))):
        t0 = time.perf_counter()
        out[part] = fn(*args)
        out["seconds"][part] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["seconds"]["total"] = time.perf_counter() - t_phase
    out["launches"] = {
        path: out[part] for path, part in zip(
            PH21_PATHS, ("a1", "a2", "a3", "b_vgg16", "b_mobilenet_v2"))}
    log({"phase": "vision_seq2seq", "seconds": out["seconds"]})
    return out


# ---------------------------------------------------------------------------
# phase 21 (d): SyncBatchNorm and BuildStrategy.sync_batch_norm, run by
# phase 13's gloo ranks and its NCCL world of 1
# ---------------------------------------------------------------------------
SBN = dict(batch=8, channels=64, hw=28, conv=32, lr=0.5)
SBN_TOL = 1e-5            # normalised max error against one process


def sbn_data(seed):
    """The global batch (split over the ranks by rows) and the weights of
    (d)'s layer and program."""
    rng = np.random.RandomState(seed + 21)
    b, c, hw, k = SBN["batch"], SBN["channels"], SBN["hw"], SBN["conv"]
    return {"x": rng.randn(b, c, hw, hw).astype(np.float32) + 0.5,
            "ct": rng.randn(b, c, hw, hw).astype(np.float32),
            "ct_conv": rng.randn(b, k, hw, hw).astype(np.float32),
            "weight": rng.randn(c).astype(np.float32),
            "bias": rng.randn(c).astype(np.float32),
            "mean": rng.randn(c).astype(np.float32) * 0.1,
            "var": rng.rand(c).astype(np.float32) + 0.5,
            "filter": (rng.randn(k, c, 3, 3) * 0.05).astype(np.float32)}


def sbn_program():
    """conv2d (no bias) -> batch_norm -> mean(y * ct), SGD: the static
    program of (d)."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core.program import _reset_unique_names
    _reset_unique_names()
    layers = static.layers
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = layers.data("x", [-1, SBN["channels"], SBN["hw"], SBN["hw"]])
        ct = layers.data("ct", [-1, SBN["conv"], SBN["hw"], SBN["hw"]])
        h = layers.conv2d(x, SBN["conv"], 3, padding=1, bias_attr=False)
        y = layers.batch_norm(h, momentum=0.9)
        loss = layers.mean(layers.elementwise_mul(y, ct))
        static.SGD(learning_rate=SBN["lr"]).minimize(loss)
    return main, startup, loss, y


def sbn_weights(main, data):
    """The program's persistables from (d)'s data: the filter, the batch
    norm's scale / bias / running stats, the learning rate."""
    conv = [op for op in main.global_block().ops if op.type == "conv2d"][0]
    bn = [op for op in main.global_block().ops if op.type == "batch_norm"][0]
    w = {conv.inputs["Filter"][0]: data["filter"]}
    for slot, key in (("Scale", "weight"), ("Bias", "bias"),
                      ("Mean", "mean"), ("Variance", "var")):
        w[bn.inputs[slot][0]] = data[key][:SBN["conv"]]
    for v in main.global_block().vars.values():
        if v.name.startswith("learning_rate"):
            w[v.name] = np.array([SBN["lr"]], np.float32)
    return w


def sbn_dygraph(torch, layer_cls, data, x_np, ct_np):
    """(Y, dX, dWeight, running mean, running var) of one train-mode call
    of `layer_cls` over x_np on the card."""
    layer = layer_cls(SBN["channels"], momentum=0.9)
    layer.set_state_dict({"weight": data["weight"], "bias": data["bias"],
                          "_mean": data["mean"], "_variance": data["var"]})
    layer.train()
    x = torch.from_numpy(x_np).cuda().requires_grad_(True)
    y = layer(x)
    (y * torch.from_numpy(ct_np).cuda()).sum().backward()
    torch.cuda.synchronize()
    return {k: v.detach().cpu().numpy() for k, v in (
        ("y", y), ("x_grad", x.grad), ("weight_grad", layer.weight.grad),
        ("mean", layer._mean), ("var", layer._variance))}


def sbn_static(torch, data, x_np, ct_np, sync):
    """(fetched Y, the persistables after one SGD step, the op types) of
    sbn_program over x_np: under a CompiledProgram with
    BuildStrategy.sync_batch_norm when `sync` (the ranks feed the global
    batch and keep their rows; Y concatenated over the ranks), else the
    plain program."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.io import load_params_from_numpy
    main, _, loss, y = sbn_program()
    weights = sbn_weights(main, data)
    scope = static.Scope()
    load_params_from_numpy(scope, weights, static.CUDAPlace(0))
    prog = main
    if sync:
        bs = static.BuildStrategy()
        bs.sync_batch_norm = True
        bs.fetch_aggregation = "concat"
        prog = static.CompiledProgram(main, build_strategy=bs) \
            .with_data_parallel(loss_name=loss.name)
    exe = static.Executor(static.CUDAPlace(0))
    with static.scope_guard(scope):
        (yo,) = exe.run(prog, feed={"x": x_np, "ct": ct_np},
                        fetch_list=[y.name])
    ops = prog._get_program().global_block().ops if sync \
        else main.global_block().ops
    state = {n: scope.vars[n].cpu().numpy() for n in weights}
    return np.asarray(yo), state, [op.type for op in ops]


def dp_sync_bn_rank(torch, seed, rank, world, out_dir):
    """(21 d) on one gloo rank of phase 13: its rows of the global batch
    through nn.SyncBatchNorm and through sbn_program under
    BuildStrategy.sync_batch_norm; saved for dp_sync_bn_check."""
    from paddle_tpu_torch import nn
    data = sbn_data(seed)
    n = SBN["batch"] // world
    rows = slice(rank * n, (rank + 1) * n)
    t0 = time.perf_counter()
    dy = sbn_dygraph(torch, nn.SyncBatchNorm, data, data["x"][rows],
                     data["ct"][rows])
    y, state, ops = sbn_static(torch, data, data["x"], data["ct_conv"],
                               sync=True)
    np.savez(os.path.join(out_dir, f"sbn_rank{rank}.npz"),
             **{"dygraph/" + k: v for k, v in dy.items()},
             **{"static/var/" + k: v for k, v in state.items()},
             **{"static/y": y, "static/ops": np.array(ops)})
    return {"seconds": time.perf_counter() - t0,
            "ops": sorted(set(ops) & {"sync_batch_norm",
                                      "sync_batch_norm_grad", "batch_norm",
                                      "batch_norm_grad"})}


def sbn_err(got, want):
    return float(np.abs(got.astype(np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def dp_sync_bn_check(torch, seed, tmp):
    """(21 d) gated: each gloo rank's SyncBatchNorm Y, dX and running
    stats against one process's BatchNorm2D over the global batch (its
    rows), the ranks' dWeight summing to the global one, the running
    stats bitwise equal across ranks; the static program rewritten to
    sync_batch_norm / sync_batch_norm_grad and, after one step, its Y and
    every persistable equal to the plain program's over the global batch.
    Normalised max errors within SBN_TOL."""
    from paddle_tpu_torch import nn
    data = sbn_data(seed)
    ranks = [dict(np.load(os.path.join(tmp, f"sbn_rank{r}.npz")))
             for r in range(DP_RANKS)]
    ref = sbn_dygraph(torch, nn.BatchNorm2D, data, data["x"], data["ct"])
    n = SBN["batch"] // DP_RANKS
    errs = {}
    for r, got in enumerate(ranks):
        rows = slice(r * n, (r + 1) * n)
        for k, want in (("y", ref["y"][rows]),
                        ("x_grad", ref["x_grad"][rows]),
                        ("mean", ref["mean"]), ("var", ref["var"])):
            errs[f"rank{r}/{k}"] = sbn_err(got["dygraph/" + k], want)
    errs["weight_grad_sum"] = sbn_err(
        sum(g["dygraph/weight_grad"] for g in ranks), ref["weight_grad"])
    for k in ("mean", "var"):
        if not np.array_equal(ranks[0]["dygraph/" + k],
                              ranks[1]["dygraph/" + k]):
            raise AssertionError(f"ph21 (d) SyncBatchNorm running {k} "
                                 "differs across ranks")
    y, state, _ = sbn_static(torch, data, data["x"], data["ct_conv"],
                             sync=False)
    for r, got in enumerate(ranks):
        ops = list(got["static/ops"])
        if "sync_batch_norm_grad" not in ops or "batch_norm_grad" in ops:
            raise AssertionError(f"ph21 (d) rank {r}: the pass left "
                                 f"{sorted(set(ops))}")
        errs[f"rank{r}/static_y"] = sbn_err(got["static/y"], y)
        for name, want in state.items():
            errs[f"rank{r}/static/{name}"] = sbn_err(
                got["static/var/" + name], want)
    for name in state:
        if not np.array_equal(ranks[0]["static/var/" + name],
                              ranks[1]["static/var/" + name]):
            raise AssertionError(f"ph21 (d) static {name} differs across "
                                 "ranks")
    bad = {k: e for k, e in errs.items() if not e <= SBN_TOL}
    if bad:
        raise AssertionError(f"ph21 (d) gloo ranks against one process: "
                             f"{bad}")
    out = {"max_err": max(errs.values()), "errors": errs}
    log({"phase": "ph21_sync_bn_gloo", "ranks": DP_RANKS, **out})
    return out


def dp_nccl_sync_bn(torch, seed):
    """(21 d) under NCCL at world 1 (inside dp_nccl's process group): the
    SyncBatchNorm layer over the global batch equals BatchNorm2D's (its
    statistics and their gradient sums go through NCCL allreduces: 4
    counted), and the sync_batch_norm op likewise."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.ops.kernels import collective as kc
    data = sbn_data(seed)
    before = kc.COMM_STATS["calls_by_kind"].get("all_reduce", 0)
    got = sbn_dygraph(torch, nn.SyncBatchNorm, data, data["x"], data["ct"])
    calls = kc.COMM_STATS["calls_by_kind"].get("all_reduce", 0) - before
    ref = sbn_dygraph(torch, nn.BatchNorm2D, data, data["x"], data["ct"])
    check_equal("ph21 (d) NCCL allreduces of a SyncBatchNorm step", calls, 4)
    errs = {k: sbn_err(got[k], ref[k]) for k in ref}
    if not max(errs.values()) <= SBN_TOL:
        raise AssertionError(f"ph21 (d) NCCL world 1: {errs}")
    out = {"allreduces": calls, "max_err": max(errs.values()),
           "errors": errs}
    log({"phase": "ph21_sync_bn_nccl", **out})
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one served batch and one training "
                    "step")
    ap.add_argument("--elastic-rank", metavar="CFG", default=None,
                    help="run one launched rank of phase 16 (internal: "
                    "the phase starts these through the launcher)")
    ap.add_argument("--ps-rank", metavar="CFG", default=None,
                    help="run one launched server or trainer of phase 17 "
                    "(b) (internal: started by launch --run_mode ps)")
    ap.add_argument("--heter-cpu", metavar="SPEC", default=None,
                    help="run phase 17 (c)'s CPU section (internal)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.elastic_rank:
        return el_rank(args.elastic_rank)
    if args.ps_rank:
        return ps_rank(args.ps_rank)
    if args.heter_cpu:
        return heter_cpu(args.heter_cpu)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from paddle_tpu_torch.core import kernel_build
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import dropout as dr
    from paddle_tpu_torch.ops import fused_xent as fx
    # fp32 means fp32 here: no TF32 in the plain versions or the
    # score-matrix program
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    log({"phase": "device", "python": sys.version.split()[0],
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "kind": torch.cuda.get_device_name(0),
         "count": torch.cuda.device_count()})

    t_run = time.perf_counter()

    def timed(name, fn, *a):
        """fn(*a), its seconds printed on a line of their own."""
        t = time.perf_counter()
        out = fn(*a)
        log({"phase_seconds": name, "seconds": time.perf_counter() - t})
        return out

    t0 = time.perf_counter()
    kernel_build.build_libraries(KERNEL_SOURCES)  # one nvcc each, at once
    for name in KERNEL_SOURCES:
        kernel_build.load_library(name)
        secs, out = kernel_build.build_log(name)
        log({"phase": "build", "kernel": name, "nvcc_s": secs,
             "ptxas": [ln.strip() for ln in out.splitlines()
                       if "entry function" in ln or "registers" in ln
                       or "spill" in ln or "warning" in ln.lower()
                       or "Performance" in ln]})
    log({"phase": "build", "build_and_load_s": time.perf_counter() - t0})
    log({"phase_seconds": "build", "seconds": time.perf_counter() - t0})

    fwd = timed("kernel_fwd", kernel_phase, torch, attn)
    bwd = timed("kernel_bwd", bwd_kernel_phase, torch, attn)
    # the redesigned kernels against their library yardsticks at the
    # training / serving shape (PERF.md: bf16 forward <= 2x SDPA, dQ <=
    # 0.75x and dK/dV <= 1x the whole SDPA backward, fp32 forward <= 1x
    # SDPA fp32, fp32 dQ <= 0.5x and dK/dV <= 0.65x the whole SDPA fp32
    # backward), and the wide-head-dim tensor-core kernels at
    # [8, 8, 512, 256], [8, 4, 512, 512] and [8, 4, 512, 768] (the
    # backward ones beside the whole SDPA backward); recorded, not gated
    log({"phase": "kernel_vs_library", **{
        tag: r["kernel_ms"] / r["library_ms"] for tag, r in (
            ("flash_fwd_bf16", fwd["slice_bf16"]),
            ("flash_bwd_dq_bf16", bwd["slice_bf16"]["dq"]),
            ("flash_bwd_dkv_bf16", bwd["slice_bf16"]["dkv"]),
            ("flash_fwd_fp32", fwd["slice_fp32"]),
            ("flash_bwd_dq_fp32", bwd["slice_fp32"]["dq"]),
            ("flash_bwd_dkv_fp32", bwd["slice_fp32"]["dkv"]),
            ("flash_fwd_wgmma256_bf16", fwd["d256_bf16"]),
            ("flash_bwd_dq_wgmma256_bf16", bwd["d256_bf16"]["dq"]),
            ("flash_bwd_dkv_wgmma256_bf16", bwd["d256_bf16"]["dkv"]),
            ("flash_fwd_wgmma_split_d_bf16", fwd["d512_bf16"]),
            ("flash_fwd_wgmma_split_d_fp16", fwd["d512_fp16"]),
            ("flash_fwd_tf32_split_d_fp32", fwd["d512_fp32"]),
            ("flash_bwd_dkv_tf32_split_d_fp32", bwd["d512_fp32"]["dkv"]),
            ("flash_fwd_tf32_split_d_fp32_d768", fwd["d768_fp32"]),
            ("flash_bwd_dkv_tf32_split_d_fp32_d768",
             bwd["d768_fp32"]["dkv"]),
            ("flash_bwd_dq_tf32_split_d_fp32", bwd["d512_fp32"]["dq"]),
            ("flash_bwd_dq_tf32_split_d_fp32_d768", bwd["d768_fp32"]["dq"]),
            ("flash_bwd_dkv_wgmma_split_d_bf16", bwd["d512_bf16"]["dkv"]),
            ("flash_bwd_dkv_wgmma_split_d_fp16", bwd["d512_fp16"]["dkv"]),
            ("flash_bwd_dkv_wgmma_split_d_bf16_d768",
             bwd["d768_bf16"]["dkv"]),
            ("flash_bwd_dq_wgmma_split_d_bf16", bwd["d512_bf16"]["dq"]),
            ("flash_bwd_dq_wgmma_split_d_fp16", bwd["d512_fp16"]["dq"]),
            ("flash_bwd_dq_wgmma_split_d_bf16_d768", bwd["d768_bf16"]["dq"]),
            ("flash_fwd_tf32_split_d_fp32_d256", fwd["d256_fp32"]),
            ("flash_bwd_dq_tf32_split_d_fp32_d256", bwd["d256_fp32"]["dq"]),
            ("flash_bwd_dkv_tf32_split_d_fp32_d256",
             bwd["d256_fp32"]["dkv"]))}})
    xent = timed("kernel_xent", xent_kernel_phase, torch, fx)
    drop = timed("kernel_dropout", dropout_kernel_phase, torch, dr)
    timed("kernel_device_names", device_names_phase, torch, attn)
    timed("kernel_view_copy", view_copy_phase, torch, attn)
    mha_launches = timed("mha_flash_route", mha_route_phase, torch, attn,
                         args.seed)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        serve_launches = timed("4_slice", slice_phase, torch, args.seed,
                               tmp, args.profile)
        amp, fp32 = timed("5_train", train_phase, torch, args.seed,
                          args.profile)
        graph = timed("6_train_graph", train_graph_phase, torch, args.seed)
        recipe = timed("8_recipe", recipe_phase, torch, args.seed)
        # phase 7 serves /predict from phase 4's model beside /generate
        gen = timed("7_generate", generate_phase, torch, args.seed,
                    os.path.join(tmp, "bert_flash"), args.profile)
        # phase 11 reads phase 4's model dir and phase 7's replies
        remainders = timed("11_remainders", remainders_phase, torch, attn,
                           args.seed, tmp, gen)
        # phase 18 reads phase 4's model dir and phase 7's model and posts
        analysis = timed("18_analysis", analysis_phase, torch, args.seed,
                         tmp, gen)
        del gen
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dygraph = timed("9_dygraph", dygraph_phase, torch, args.seed)
    baseline = timed("10_baseline", baseline_phase, torch, args.seed)
    breadth = timed("12_breadth", breadth_phase, torch, args.seed)
    dp = timed("13_data_parallel", dp_phase, torch, args.seed)
    zt = timed("14_zero_tp", zt_phase, torch, args.seed)
    px = timed("15_parallel_axes", px_phase, torch, args.seed)
    el = timed("16_elastic", el_phase, torch, args.seed)
    pps = timed("17_pipeline_ps", pp_ps_phase, torch, args.seed)
    hl = timed("19_high_level", hl_phase, torch, args.seed)
    ph20 = timed("20_tensor", tensor_phase, torch, args.seed)
    ph21 = timed("21_vision_seq2seq", vs_phase, torch, args.seed)

    # each kernel at the shape of the path that runs it, [8, 12, 512, 64]
    # attention on the head-split views: the four bf16 kernels of the AMP
    # step ([4096, 30522] bf16 logits), launches over its eager steps; the
    # fp32 forward at the serving shape (a batch of 8 rows), launches over
    # the served burst; the fp32 dQ, dK/dV and fused cross-entropy of the
    # fp32 training step, launches over its eager steps; beside them the
    # launches per step of the graph-replayed steps (profiler).  The fp16
    # instances run on no path yet (no fp16 configuration): their
    # launches are 0 and their numbers come from the kernel cases.
    per_fp32_step = {k: n // FP32_TRAIN_STEPS for k, n in fp32.items()}

    def graph_step(config, name):
        return {"launches_per_graph_replayed_step": graph[config][name]}

    no_path = {"path": "none (kernel cases only: no fp16 configuration)"}
    # phase 11: the bf16 forward's launches a bf16 /predict run (a), the
    # fp32 forward's a PTQ-int8 /predict run (b); 0 on (c)-(e)
    remainder_runs = {
        "bfloat16": remainders["bf16_predict"]["flash_launches_by_dtype"],
        "float32": remainders["int8_predict"]["flash_launches_by_dtype"]}
    rows = [("flash_attn_fwd", fwd["slice_bf16"], amp["flash_attn_fwd"],
             {**graph_step("amp", "flash_attn_fwd"),
              "launches_per_bf16_predict_run":
                  remainder_runs["bfloat16"].get("bfloat16", 0)}),
            ("flash_attn_bwd_dq", bwd["slice_bf16"]["dq"],
             amp["flash_attn_bwd_dq"], graph_step("amp",
                                                  "flash_attn_bwd_dq")),
            ("flash_attn_bwd_dkv", bwd["slice_bf16"]["dkv"],
             amp["flash_attn_bwd_dkv"], graph_step("amp",
                                                   "flash_attn_bwd_dkv")),
            ("fused_xent_fwd", xent["train_bf16"], amp["fused_xent_fwd"],
             graph_step("amp", "fused_xent_fwd")),
            ("flash_attn_fwd_fp32", fwd["slice_fp32"], serve_launches,
             {"launches_per_served_batch": BERT["layers_n"],
              "launches_per_int8_predict_run":
                  remainder_runs["float32"].get("float32", 0),
              "launches_mha_flash_route": mha_launches,
              "launches_per_fp32_train_step":
                  per_fp32_step["flash_attn_fwd"],
              **graph_step("fp32", "flash_attn_fwd")}),
            ("flash_attn_bwd_dq_fp32", bwd["slice_fp32"]["dq"],
             fp32["flash_attn_bwd_dq"],
             {"launches_per_fp32_train_step":
                  per_fp32_step["flash_attn_bwd_dq"],
              **graph_step("fp32", "flash_attn_bwd_dq")}),
            ("flash_attn_bwd_dkv_fp32", bwd["slice_fp32"]["dkv"],
             fp32["flash_attn_bwd_dkv"],
             {"launches_per_fp32_train_step":
                  per_fp32_step["flash_attn_bwd_dkv"],
              **graph_step("fp32", "flash_attn_bwd_dkv")}),
            ("fused_xent_fwd_fp32", xent["train_fp32"],
             fp32["fused_xent_fwd"],
             {"launches_per_fp32_train_step":
                  per_fp32_step["fused_xent_fwd"],
              **graph_step("fp32", "fused_xent_fwd")}),
            ("flash_attn_fwd_fp16", fwd["slice_fp16"], 0, no_path),
            ("flash_attn_bwd_dq_fp16", bwd["slice_fp16"]["dq"], 0, no_path),
            ("flash_attn_bwd_dkv_fp16", bwd["slice_fp16"]["dkv"], 0,
             no_path),
            ("fused_xent_fwd_fp16", xent["train_fp16"], 0, no_path)]
    # launches per dygraph step (phase 9) of each row's kernel in its dtype
    row_dtype = {"": "bfloat16", "_fp32": "float32", "_fp16": "float16"}
    rows = [(name, r, n, dict(extra)) for name, r, n, extra in rows]
    for name, _, _, extra in rows:
        base = name.rsplit("_fp", 1)[0]
        dt = row_dtype[name[len(base):]]
        extra["launches_per_dygraph_step"] = {
            v: r["launches_by_dtype"][base].get(dt, 0) / DYGRAPH_STEPS
            for v, r in dygraph.items()}
        extra["launches_on_baseline_paths"] = {
            v: r["hand_kernel_launches"][base] for v, r in baseline.items()}
    # the kernels for head dims above 128: launches measured on every
    # main path (the wrappers count per route and kernel, over all dtypes;
    # 0, gated in each path, since no configuration has a head dim above
    # 128), times from the kernel cases
    paths = ("serve", "train_amp", "train_fp32", "train_graph_amp",
             "train_graph_fp32", "generate", "predict_bf16", "predict_int8",
             "resnet50_infer", "generate_spec", "generate_spec_own_draft",
             "generate_int8") + tuple(
                 f"recipe{g}_{v}" for g in ("", "_graph")
                 for v, _ in RECIPE_VARIANTS) + tuple(
                 f"dygraph_{v[0]}" for v in DYGRAPH_VARIANTS) + tuple(
                 f"baseline_{v}" for v in baseline) + (
                     "breadth", "dp_static", "dp_dygraph", "dp_nccl") + tuple(
                 f"zero_{tag}_rank{r}" for tag, _, _ in ZT_STAGES
                 for r in range(DP_RANKS)) + tuple(
                 f"tp_rank{r}" for r in range(DP_RANKS)) + ("zero_nccl",) + \
        tuple(f"px_tp_{v}" for v, _, _ in PX_TP_VARIANTS) + tuple(
            f"px_sp_{tag}_{run}_rank{r}" for tag, _, runs in PX_SP_PROGRAMS
            for run in runs for r in range(PX_RANKS)) + (
            "px_hoist_hoisted", "px_hoist_unhoisted") + EL_PATHS + (
            "pp_pipeline", "analysis") + HL_PATHS + PH20_PATHS + \
        PH21_PATHS
    if set(WIDE_LAUNCHES) != set(paths):
        raise AssertionError(f"head-dim-above-128 launches read on "
                             f"{sorted(WIDE_LAUNCHES)}, expected "
                             f"{sorted(paths)}")
    for name, route, kind, case in WIDE_KERNELS:
        r = fwd[case] if kind == "fwd" else \
            bwd[case]["dq" if kind == "bwd_dq" else "dkv"]
        by_path = {p: WIDE_LAUNCHES[p][f"{route}/{kind}"] for p in paths}
        rows.append((name, r, sum(by_path.values()),
                     {"launches_by_path_all_dtypes": by_path,
                      "case": case}))
    # the dropout kernel (no TPU kernel: the JAX package draws its mask
    # under XLA): times at [8, 12, 512, 512] bf16, the attention weights;
    # launches over the eager steps of the attention-dropout variant
    rows.append(("dropout_philox", drop["attn_weights_bfloat16"],
                 recipe["attn_dropout"]["launches"]["dropout"],
                 {"case": "attn_weights_bfloat16",
                  "hidden_bfloat16": {
                      k: drop["hidden_bfloat16"][k] for k in (
                          "kernel_ms", "plain_ms", "library_ms",
                          "bound_ms")},
                  "launches_per_step": {
                      v: recipe[v]["launches_per_step"]["dropout"]
                      for v, _ in RECIPE_VARIANTS},
                  "launches_per_replayed_step": {
                      v: recipe[v]["launches_per_replayed_step"]["dropout"]
                      for v, _ in RECIPE_VARIANTS},
                  "launches_per_dygraph_step": {
                      v: r["launches_per_step"]["dropout"]
                      for v, r in dygraph.items()},
                  "launches_on_baseline_paths": {
                      v: r["hand_kernel_launches"]["dropout"]
                      for v, r in baseline.items()}}))
    # the random kernel (no TPU kernel: the JAX package draws under XLA):
    # times at [30522, 768] fp32 uniform (the word embedding's
    # initializer shape), launches on each phase 12 path
    philox = breadth["philox_launches_by_path"]
    rows.append(("philox_random",
                 breadth["random"]["cases"]["word_embedding_float32_uniform"],
                 sum(philox.values()),
                 {"case": "word_embedding_float32_uniform",
                  "launches_by_phase12_path": philox,
                  "other_cases": {
                      k: {m: c[m] for m in ("kernel_ms", "plain_ms",
                                            "library_ms", "bound_ms",
                                            "max_abs_err", "max_ulps")}
                      for k, c in breadth["random"]["cases"].items()}}))
    # phase 13: every row's launches on each data-parallel path, as
    # counted there: a rank-step of each run of (a) and (c), an eager step
    # and the capturing call of (b), in the row's dtype; the dropout and
    # random kernels' too, the random kernel's also at each path's start
    # (the startup program, the dygraph model's build)
    dp_paths = dp["launches"]
    for name, _, _, extra in rows:
        base = name.rsplit("_fp", 1)[0]
        if base in DP_KERNELS:
            dt = row_dtype[name[len(base):]]
            got = {p: r["by_dtype"][base].get(dt, 0)
                   for p, r in dp_paths.items()}
        elif name == "dropout_philox":
            got = {p: r["launches"][name] for p, r in dp_paths.items()}
        elif name == "philox_random":
            got = {p: {"per_step": r["launches"][name],
                       "at_start": r["philox_at_start"]}
                   for p, r in dp_paths.items()}
        else:  # head dims above 128: over each whole path, all dtypes
            got = {p: extra["launches_by_path_all_dtypes"][p]
                   for p in ("dp_static", "dp_dygraph", "dp_nccl")}
        extra["phase13_launches"] = got
    # phase 14: the same on its paths: a rank-step of each ZeRO run
    # (sound and faulted) and of the tp = 2 run, an eager step and the
    # capturing call of the stage-3 NCCL run
    zt_paths = zt["launches"]
    wide_zt = tuple(p for p in paths if p.startswith(("zero_", "tp_rank")))
    for name, _, _, extra in rows:
        base = name.rsplit("_fp", 1)[0]
        if base in DP_KERNELS:
            dt = row_dtype[name[len(base):]]
            got = {p: r["by_dtype"][base].get(dt, 0)
                   for p, r in zt_paths.items()}
        elif name == "dropout_philox":
            got = {p: r["launches"][name] for p, r in zt_paths.items()}
        elif name == "philox_random":
            got = {p: {"per_step": r["launches"][name],
                       "at_start": r["philox_at_start"]}
                   for p, r in zt_paths.items()}
        else:  # head dims above 128: over each whole path, all dtypes
            got = {p: extra["launches_by_path_all_dtypes"][p]
                   for p in wide_zt}
        extra["phase14_launches"] = got
    # phase 15: the same on its paths: the leader's burst of each (a) run
    # (the score-matrix decode program: 0, gated), a rank-step of (b)'s sp
    # runs and of (c)'s ep run, a dense MoE step, the capturing calls of
    # (d)
    px_paths = px["launches"]
    wide_px = tuple(p for p in paths if p.startswith("px_"))
    for name, _, _, extra in rows:
        base = name.rsplit("_fp", 1)[0]
        if base in DP_KERNELS:
            dt = row_dtype[name[len(base):]]
            got = {p: r["by_dtype"][base].get(dt, 0)
                   for p, r in px_paths.items()}
        elif name in ("dropout_philox", "philox_random"):
            got = {p: r["launches"][name] for p, r in px_paths.items()}
        else:  # head dims above 128: over each whole path, all dtypes
            got = {p: extra["launches_by_path_all_dtypes"][p]
                   for p in wide_px}
        extra["phase15_launches"] = got
    # phase 16: the same on its paths: a micro-step of (a)'s eager run
    # and (a)'s capturing call, a micro-step of each launched rank (2
    # gloo ranks, the re-formed NCCL world 1, the regrown ranks, the
    # fleet's re-formed host)
    el_paths = el["launches"]
    for name, _, _, extra in rows:
        base = name.rsplit("_fp", 1)[0]
        if base in DP_KERNELS:
            dt = row_dtype[name[len(base):]]
            got = {p: r["by_dtype"][base].get(dt, 0)
                   for p, r in el_paths.items()}
        elif name in ("dropout_philox", "philox_random"):
            got = {p: r["launches"][name] for p, r in el_paths.items()}
        else:  # head dims above 128: over each whole path, all dtypes
            got = {p: extra["launches_by_path_all_dtypes"][p]
                   for p in EL_PATHS}
        extra["phase16_launches"] = got
    # phase 17: a pipelined step of (a) (M = 4 micro-batches, both
    # stages; by stage in `pipeline_stage_launches`); (b) and (c) run no
    # hand kernel (the CTR tower is cuBLAS, the KV plane host code)
    pipe = pps["pipeline"]
    for name, _, _, extra in rows:
        base = name.rsplit("_fp", 1)[0]
        if base in DP_KERNELS:
            dt = row_dtype[name[len(base):]]
            got = {"pp_step": pipe["by_dtype"][base].get(dt, 0)}
            if dt == "bfloat16":
                got["pp_stage_step"] = {
                    s: c[base] // PP_STEPS
                    for s, c in pipe["stage_launches"].items()}
        elif name in ("dropout_philox", "philox_random"):
            got = {"pp_step": pipe["launches"][name]}
        else:  # head dims above 128: over the whole pipelined run
            got = {"pp_pipeline":
                   extra["launches_by_path_all_dtypes"]["pp_pipeline"]}
        extra["phase17_launches"] = got
    # phase 18: the eager AMP step of (c) and the whole phase (its steps,
    # captures and planned runs; the startups' random draws), in the
    # row's dtype
    an_paths = analysis["launches"]
    for name, _, _, extra in rows:
        base = name.rsplit("_fp", 1)[0]
        if base in DP_KERNELS:
            dt = row_dtype[name[len(base):]]
            got = {"phase": an_paths["phase"]["by_dtype"][base].get(dt, 0)}
            if dt == "bfloat16":
                got["eager_amp_step"] = an_paths["eager_amp_step"][base]
        elif name in ("dropout_philox", "philox_random"):
            got = {"phase": an_paths["phase"]["launches"][name]}
        else:  # head dims above 128: over the whole phase
            got = {"analysis": extra["launches_by_path_all_dtypes"][
                "analysis"]}
        extra["phase18_launches"] = got
    # phase 19: each fit step of (a) (BERT-base, O2) and each jit fit
    # step of (b) (ResNet-50, fp32; the first traces), measured, in the
    # row's dtype
    hl_runs = {"bert_fit_steps": hl["a_bert_fit"],
               "resnet50_jit_fit_steps": hl["b_resnet_jit"]}
    for name, _, _, extra in rows:
        base = name.rsplit("_fp", 1)[0]
        if base in DP_KERNELS:
            dt = row_dtype[name[len(base):]]
            got = {p: [st[base].get(dt, 0) for st in r["step_by_dtype"]]
                   for p, r in hl_runs.items()}
        elif name in ("dropout_philox", "philox_random"):
            got = {p: [st[name] for st in r["step_launches"]]
                   for p, r in hl_runs.items()}
        else:  # head dims above 128: over each whole path, all dtypes
            got = {p: extra["launches_by_path_all_dtypes"][p]
                   for p in HL_PATHS}
        extra["phase19_launches"] = got
    # phase 20: each step of (a) (BERT-base, O2) and each jit step of (b)
    # (4 layers, fp32; the first traces), in the row's dtype
    ph20_runs = {"bert_o2_steps": (ph20["a"]["step_launches"],
                                   ph20["a"]["step_by_dtype"]),
                 "jit_steps": (ph20["b"]["step_launches"], None)}
    for name, _, _, extra in rows:
        base = name.rsplit("_fp", 1)[0]
        if base in DP_KERNELS:
            dt = row_dtype[name[len(base):]]
            got = {"bert_o2_steps": [st[base].get(dt, 0) for st in
                                     ph20_runs["bert_o2_steps"][1]],
                   "jit_steps": [st[base] if dt == "float32" else 0
                                 for st in ph20_runs["jit_steps"][0]]}
        elif name in ("dropout_philox", "philox_random"):
            got = {p: [st[name] for st in r[0]]
                   for p, r in ph20_runs.items()}
        else:  # head dims above 128: over each whole path, all dtypes
            got = {p: extra["launches_by_path_all_dtypes"][p]
                   for p in PH20_PATHS}
        extra["phase20_launches"] = got
    # phase 21: a step of (a) 1, the step of (a) 2, (a) 3's beam search,
    # a step of each (b) model, in the row's dtype
    ph21_runs = {"transformer_big_step": ("ph21_transformer_big",
                                          PH21_STEPS),
                 "transformer_flash_step": ("ph21_transformer_flash", 1),
                 "beam_search": ("ph21_beam_search", 1),
                 "vgg16_step": ("ph21_vgg16", PH21_STEPS),
                 "mobilenet_v2_step": ("ph21_mobilenet_v2", PH21_STEPS)}

    def ph21_column(name, extra):
        base = name.rsplit("_fp", 1)[0]
        if base in DP_KERNELS:
            dt = row_dtype[name[len(base):]]
            return {k: ph21["launches"][p]["by_dtype"][base].get(dt, 0) / n
                    for k, (p, n) in ph21_runs.items()}
        if name in ("dropout_philox", "philox_random") + PH20_KERNELS:
            return {k: ph21["launches"][p]["launches"][name] / n
                    for k, (p, n) in ph21_runs.items()}
        # head dims above 128: over each whole path, all dtypes
        return {p: extra["launches_by_path_all_dtypes"][p]
                for p in PH21_PATHS}

    for name, _, _, extra in rows:
        extra["phase21_launches"] = ph21_column(name, extra)
    # the three new Philox distributions: times from phase 20 (d),
    # launches over phase 20 (a)'s path (the truncated normal: the word
    # embedding's draw; randint and Bernoulli: one each a step)
    for name, shape in PH20_RANDOM:
        rows.append((name, ph20["d"][name], ph20["a"]["launches"][name],
                     {"case": f"{list(shape)}",
                      "phase20_launches": {
                          p: [st[name] for st in r[0]]
                          for p, r in ph20_runs.items()},
                      "phase21_launches": ph21_column(name, {}),
                      "max_ulps": ph20["d"][name]["max_ulps"]}))
    summary = []
    for name, r, launches, extra in rows:
        source, replaces = KERNELS[name]
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **extra})
        if "kernel_ms_cold" in r:
            summary[-1]["ms_cold"] = r["kernel_ms_cold"]
        if "fma_bound_ms" in r:
            summary[-1]["fma_bound_ms"] = r["fma_bound_ms"]
    log({"kernels": summary})
    log({"phase_seconds": "total", "seconds": time.perf_counter() - t_run})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
