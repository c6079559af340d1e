"""Compile-time HBM accounting: predict a program's peak device memory
WITHOUT running it on the card.

A configuration's fate (fits or runs out of memory) is answered at
program-build time:

  * `estimate_peak_bytes(program, batch=...)` — an op-IR liveness walker
    over the Program: var sizes from shape×dtype (symbolic -1 batch dims
    bound to `batch`), a forward+backward live-set sweep over the op
    list, per-phase (forward / backward / optimize) peaks.
  * `Executor.memory_report(program, feed)` — the estimate plus, on a
    CUDA device, one measured step's ``torch.cuda.max_memory_allocated``
    (static/executor.py).
  * `PADDLE_TPU_HBM_BYTES` — the per-card budget the fits/OOM verdict is
    judged against.  Default: the current CUDA device's total memory
    (``torch.cuda.get_device_properties(...).total_memory``); with no
    card and no env there is no budget, and asking for one raises.

The walker models the three XLA behaviours that dominate the gap between
"sum of every var ever created" and the real footprint; each is a
module-level table so the model stays inspectable and tunable:

  * `_ALIAS_OPS` — pure layout ops (reshape/squeeze/...) alias their
    input buffer: zero cost.
  * `_FUSABLE_OPS` — cheap elementwise ops (cast/scale/gelu/transpose/
    add/...) are fused into their consumers by XLA and rematerialized
    for free in backward, so their outputs never occupy standalone HBM;
    their *inputs* stay live instead (the sweep keeps them live because
    the grad ops reference them).
  * `_GRAD_RELEASED_INPUTS` — grad ops formally reference every forward
    input/output (registry slot convention), but under whole-block jit
    the auto-vjp's forward replay is CSE'd with the original forward, so
    the real residual set is smaller: softmax backward needs only its
    OUTPUT (the pre-softmax logits die at the softmax), cross-entropy
    backward needs the saved softmax, not the logits, dropout recomputes
    its mask from the counter PRNG.  Uses listed here do not extend a
    var's live range into the backward sweep.

Remat composes for free: `recompute_rewrite` produces a program whose
backward replays segments through `optimization_barrier` + @RC aliases,
so the same sweep over the rewritten op list shows the reduced peak —
no special-casing.

`select_layer_checkpoints` picks remat checkpoint vars at transformer
LAYER boundaries (the same boundaries a user hands RecomputeOptimizer):
for each attention core op (softmax over scores / flash_attention /
ring_attention / multihead_matmul) it walks back to the nearest
preceding layer_norm output — one checkpoint per layer, at the layer's
entry.  `FLAGS_recompute=auto` (static/backward.py) uses this selection
and applies the rewrite only when the estimator predicts the budget is
exceeded; `FLAGS_recompute=always` applies it unconditionally.

Port notes (paddle_tpu_torch): a copy of
paddle_tpu/static/memory_analysis.py.  The walk, its tables and its byte
counts are the JAX package's, byte for byte on the same program; the
XLA behaviours they model (fusion, buffer reuse) are kept as the model,
and the ratio of the card's measured peak to the walked one is
`DEVICE_SLACK`.  The budget comes from the card, not from a constant.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Set

from ..core.program import Program, OpRole

__all__ = ["estimate_peak_bytes", "analyze_program", "hbm_budget_bytes",
           "select_layer_checkpoints", "mp_sharded_vars", "DEVICE_SLACK"]

HBM_BUDGET_ENV = "PADDLE_TPU_HBM_BYTES"

# measured / walked peak bytes of a step on the card: eager PyTorch
# materializes what the walk models as fused (casts, activations), and the
# caching allocator, cuBLAS workspaces and kernels' scratch come on top.
# `fits` holds peak_bytes * DEVICE_SLACK to the budget.  chip_smoke.py
# phase 18 on bench.py's BERT-base AMP step (batch 8), NVIDIA H100 80GB
# HBM3, 700 W, two runs: 1.891 / 1.910 eager, 1.599 / 1.941 the replayed
# step's capture, 1.645 / 1.675 under recompute; the largest, rounded up
# (PERF.md section 5).
DEVICE_SLACK = 2.0


def hbm_budget_bytes() -> int:
    """Per-card memory budget the fits/OOM verdict is judged against:
    ``PADDLE_TPU_HBM_BYTES`` when set, else the current CUDA device's
    total memory.  Raises when there is neither (no default constant)."""
    raw = os.environ.get(HBM_BUDGET_ENV, "")
    if raw:
        try:
            return int(float(raw))
        except ValueError:
            pass
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"hbm_budget_bytes: no CUDA device and {HBM_BUDGET_ENV} is "
            f"unset, so there is no memory budget to judge a program "
            f"against (set {HBM_BUDGET_ENV}=<bytes>, or pass "
            f"budget_bytes=)")
    return int(torch.cuda.get_device_properties(
        torch.cuda.current_device()).total_memory)


# pure layout / view ops: output aliases the input buffer (zero HBM
# cost; uses of the output count as uses of the input's root buffer)
_ALIAS_OPS = frozenset((
    "reshape", "reshape2", "squeeze", "squeeze2", "unsqueeze",
    "unsqueeze2", "flatten", "flatten2", "flatten_contiguous_range",
    "assign", "share_data", "optimization_barrier",
))

# cheap (near-)elementwise ops XLA fuses into their consumers and freely
# rematerializes in backward: the output never occupies standalone HBM —
# a later use of it is a use of its ROOT buffer(s) instead (rep
# propagation).  Binary arithmetic (add/mul/...) is deliberately NOT
# here: its output is a genuinely new value that XLA materializes.
_FUSABLE_OPS = frozenset((
    "cast", "scale", "transpose", "transpose2", "fill_constant",
    "fill_any_like", "fill_zeros_like",
    "gelu", "relu", "relu6", "sigmoid", "tanh", "dropout",
    "sqrt", "rsqrt", "square", "abs", "exp", "log", "clip",
    "increment",
))

# (grad op type, input slot) pairs whose formal dependency the real vjp
# never materializes (residual-set model; see module docstring).  A use
# listed here does not extend the var's live range.
_GRAD_RELEASED_INPUTS = frozenset((
    ("softmax_grad", "X"),                         # residual = Out
    ("softmax_with_cross_entropy_grad", "Logits"),  # residual = Softmax
    ("log_softmax_grad", "X"),                     # residual = Out
    ("dropout_grad", "X"),                         # mask replays from PRNG
    ("dropout_grad", "Out"),
    ("mean_grad", "X"),                            # vjp needs only shape
    # relu/gelu are _FUSABLE_OPS (cost-0 outputs); releasing the grad's
    # Out use stops the rep chain from pinning roots the vjp never
    # reads.  Do NOT also list them in _GRAD_KEPT_OUTPUTS — the release
    # table is checked first and owns these ops.
    ("relu_grad", "Out"),
    ("gelu_grad", "Out"),
    ("tanh_grad", "X"),                            # residual = Out
    ("sigmoid_grad", "X"),                         # residual = Out
    # pass-through gradients: d(add)/dX is the cotangent itself (plus a
    # shape-only broadcast reduce), so the operand VALUES are never read
    ("elementwise_add_grad", "X"),
    ("elementwise_add_grad", "Y"),
    ("elementwise_sub_grad", "X"),
    ("elementwise_sub_grad", "Y"),
    ("scale_grad", "X"),
    ("cast_grad", "X"),
    ("transpose2_grad", "X"),
    ("transpose_grad", "X"),
    ("reshape2_grad", "X"),
    ("reshape_grad", "X"),
    ("concat_grad", "X"),                          # slice of cotangent
    ("split_grad", "X"),
))

# Grad ops also reference every forward OUTPUT slot (registry slot
# convention), but almost no vjp reads the output VALUE — the default
# here is to release those uses.  Exceptions: ops whose vjp residual IS
# the output (y = f(x) with dy/dx expressible in y), listed as
# (forward op type, output slot) pairs that stay live into backward.
_GRAD_KEPT_OUTPUTS = frozenset((
    ("softmax", "Out"),
    ("log_softmax", "Out"),
    ("softmax_with_cross_entropy", "Softmax"),
    ("tanh", "Out"),
    ("sigmoid", "Out"),
    ("exp", "Out"),
    ("sqrt", "Out"),
    ("rsqrt", "Out"),
    ("layer_norm", "Mean"),
    ("layer_norm", "Variance"),
    ("batch_norm", "SavedMean"),
    ("batch_norm", "SavedVariance"),
    ("flash_attention", "Out"),      # custom bwd consumes out (+lse)
))


def _use_released(op_type: str, slot: str) -> bool:
    """True when this (grad op, input slot) use never materializes the
    var (residual-set model): explicit release table for forward-input
    slots, default-release for forward-output value slots."""
    if (op_type, slot) in _GRAD_RELEASED_INPUTS:
        return True
    if not op_type.endswith("_grad") or slot.endswith("@GRAD"):
        return False
    from ..ops.registry import get_op_info
    fwd_type = op_type[: -len("_grad")]
    finfo = get_op_info(fwd_type)
    if finfo is None:
        return False
    if any(s.name == slot for s in finfo.outputs):
        return (fwd_type, slot) not in _GRAD_KEPT_OUTPUTS
    return False

# attention-core op types that mark "one transformer layer" for
# checkpoint selection
_ATTENTION_CORE_OPS = ("flash_attention", "ring_attention",
                       "multihead_matmul")


def _op_internal_bytes(op, sizer) -> int:
    """HBM a kernel materializes INSIDE the op, invisible to the var-
    level walk.  ring_attention on a single device (no "sp" mesh axis)
    degrades to plain attention and materializes the full fp32 [B, H,
    S, S] scores, retained as the vjp residual — the walker must charge
    it or a single-chip long-seq 'fits' verdict is fiction.  Under a
    real sp mesh of degree n the true footprint is n² smaller, so this
    is the conservative (single-chip, the only hardware we have) bound;
    flash_attention's whole point is that it has no such tensor."""
    if op.type != "ring_attention":
        return 0
    q = op.inputs.get("Q", [])
    if not q or not q[0]:
        return 0
    # resolve @RCB/@RC replay aliases to the base var: the remat replay
    # of a ring op materializes the same degraded-kernel scores
    var = sizer.var_of(q[0])
    shape = var.shape if var is not None else None
    if shape is None or len(shape) < 2:
        return 0
    b = sizer.batch if shape[0] in (-1, None) else int(shape[0])
    s = sizer.batch if shape[1] in (-1, None) else int(shape[1])
    h = int(op.attrs.get("num_heads", 1))
    return b * h * s * s * 4  # fp32 score accumulation

# name suffixes minted by the backward/remat/AMP/sharding rewrites; a var
# whose shape was never inferred (grad pieces, @RC replay aliases) borrows
# the base var's shape/dtype by stripping these
_DERIVED_MARKERS = ("@GRAD", "@RC", "@RCB", "@SUM", "@MASKED",
                    "@UNSCALED", "@GUARDED", "@ALLREDUCE", "@SCALED",
                    "@GradientMerge", "@GM_AVG", "@ZERO",
                    "@Z1FLAT", "@Z1SEG")


def _strip_derived(name: str) -> Optional[str]:
    """``x@GRAD_3`` -> ``x``; None when the name has no derived marker."""
    base = name
    # unique_name suffix: trailing _<digits>
    head, _, tail = base.rpartition("_")
    if head and tail.isdigit():
        base = head
    hit = False
    while True:
        for mark in _DERIVED_MARKERS:
            if base.endswith(mark):
                base = base[: -len(mark)]
                hit = True
                break
        else:
            break
    return base if hit else None


class _Sizer:
    """name -> bytes, binding symbolic -1 dims to `batch` and resolving
    derived names (@GRAD/@RC/...) to their base var's shape/dtype.

    `tp_sharded`/`tp_degree`: vars the sharding-propagation analyzer
    proved mp-sharded are charged 1/degree per chip — each rank
    materializes only its feature shard (weights, their grads and
    residual activations between a column- and row-parallel layer).
    Derived names divide through their BASE var's verdict: the grad of
    a sharded weight is the same local shard."""

    def __init__(self, block, batch: int, tp_sharded=None,
                 tp_degree: int = 0):
        self.block = block
        self.batch = max(1, int(batch))
        self.tp_sharded = tp_sharded or frozenset()
        self.tp_degree = max(0, int(tp_degree))
        self.cache: Dict[str, int] = {}
        self.unknown: List[str] = []

    def var_of(self, name: str):
        """Resolve `name` to a shaped VarDesc, falling back to the base
        var for derived names (@GRAD/@RC/... aliases carry no shape)."""
        var = self.block.vars.get(name)
        if var is not None and var.shape is not None:
            return var
        base = _strip_derived(name)
        if base is not None and self.block.has_var(base):
            return self.block.var(base)
        return var

    def _var_bytes(self, var) -> Optional[int]:
        if var is None or var.shape is None or var.dtype is None:
            return None
        from ..core.dtype import torch_dtype
        n = 1
        for d in var.shape:
            n *= self.batch if d in (-1, None) else int(d)
        try:
            return int(n) * torch_dtype(var.dtype).itemsize
        except (TypeError, ValueError, KeyError):
            return None

    def __call__(self, name: str) -> int:
        if name in self.cache:
            return self.cache[name]
        var = self.var_of(name)
        size = self._var_bytes(var)
        if size is None:
            self.unknown.append(name)
            size = 0
        elif self.tp_degree > 1 and var is not None and \
                var.name in self.tp_sharded:
            size = -(-size // self.tp_degree)
        self.cache[name] = size
        return size


def _phase_of(op) -> str:
    role = op.attrs.get(OpRole.KEY, OpRole.Forward)
    try:
        role = int(role)
    except (TypeError, ValueError):
        return "forward"
    if role & OpRole.Backward:
        return "backward"
    if role & (OpRole.Optimize | OpRole.LRSched) or role == OpRole.Dist:
        return "optimize"
    return "forward"


def mp_sharded_vars(program: Program, tp_degree: int) -> Set[str]:
    """The vars a `tp_degree` tensor-parallel mesh holds at 1/tp per
    chip: everything the sharding-propagation analyzer proves
    mp-sharded (annotated weights, their grads' base vars, and the
    feature-sharded activations between a column- and row-parallel
    layer), plus their ``accum_of``-linked optimizer accumulators.
    Batch-independent — callers pricing many batch buckets of one
    program (the planner's `_RewritePoint`) compute it once and pass it
    to `analyze_program(tp_sharded=)`."""
    from .layout_analysis import propagate_shardings
    layout = propagate_shardings(program,
                                 mesh_shape={"mp": int(tp_degree)})
    out = {n for n, s in layout.specs.items() if "mp" in s.axes()}
    for b in program.blocks:
        for v in b.vars.values():
            owner = v.attrs.get("accum_of")
            if owner and owner in out:
                out.add(v.name)
    return out


def analyze_program(program: Program, batch: Optional[int] = None,
                    budget_bytes: Optional[int] = None,
                    dp_shard: Optional[int] = None,
                    zero_stage: Optional[int] = None,
                    tp_degree: Optional[int] = None,
                    tp_sharded: Optional[Set[str]] = None) -> Dict:
    """Full liveness report for `program`'s global block.

    Returns a dict with ``peak_bytes`` (persistables + peak live
    activations), ``persistable_bytes``, ``optimizer_slot_bytes``
    (accumulator / sharded-bucket persistables after sharding division),
    per-phase peaks (``phase_peaks``), the op index/type at the peak,
    the largest live vars at the peak (``top_live``), unknown-shape var
    count, and the ``fits``/``budget_bytes`` verdict.

    `batch` binds symbolic -1 dims; defaults to ``FLAGS_hbm_assume_batch``
    when set, else 1 (which makes batch-dynamic programs a lower bound —
    pass the real batch for a fits/OOM verdict that means anything).

    World-size-aware accounting (ZeRO stages 1-3,
    distributed/sharding.py): a persistable marked ``dp_shard`` (a
    sharded bucket — optimizer slots, stage-2 gradient accumulators, or
    a stage-3 param bucket — declared at the GLOBAL padded shape) is
    charged 1/degree per chip — the walker reports per-chip footprints.
    An APPLIED program therefore needs no stage argument: the stamps on
    its vars carry the whole story (stage-3 params additionally show up
    as gathered ACTIVATIONS with forward/backward-bounded liveness,
    which the live-set sweep prices for free).

    `dp_shard` (argument; defaults to ``FLAGS_hbm_dp_shard``)
    additionally PREDICTS sharding an unsharded program: per-param
    optimizer accumulators (``accum_of``-linked vars) are charged 1/N,
    answering "would ERNIE-large-b24 fit under ZeRO-1?" before the
    rewrite is ever applied.  `zero_stage` (defaults to
    ``FLAGS_hbm_zero_stage``) extends the prediction up the ladder:
    stage >= 3 also divides the parameters the pass would pack
    (`predicted_shardable_params`).  Stage-3 prediction is a LOWER
    bound — it does not model the transient gathered copies — so the
    applied program's walk is the authority (the planner prices applied
    clones, never predictions).

    `tp_degree` prices a TENSOR-PARALLEL mesh: the sharding-propagation
    analyzer (`static.propagate_shardings` over an {"mp": tp} mesh)
    decides which vars are mp-sharded — annotated weights, their
    optimizer accumulators (``accum_of``), and the feature-sharded
    activations between a column- and row-parallel layer — and each is
    charged 1/tp per chip.  Everything propagation can't prove sharded
    (replicated embeddings, partial sums, tainted vars) stays
    full-size, so the verdict is conservative.  `tp_sharded` takes the
    precomputed set (`mp_sharded_vars` — batch-independent) so repeated
    batch-bucket pricing skips the propagation re-run.
    """
    from ..core.flags import flag
    if batch is None:
        batch = int(flag("hbm_assume_batch", 0)) or 1
    if dp_shard is None:
        dp_shard = int(flag("hbm_dp_shard", 0)) or None
    if zero_stage is None:
        zero_stage = int(flag("hbm_zero_stage", 0)) or 1
    pred_shard = int(dp_shard) if dp_shard and int(dp_shard) > 1 else 0
    pred_stage = max(1, int(zero_stage)) if pred_shard else 0
    budget = hbm_budget_bytes() if budget_bytes is None else int(budget_bytes)
    block = program.global_block()
    tp = int(tp_degree) if tp_degree and int(tp_degree) > 1 else 0
    mp_sharded: Set[str] = set()
    if tp:
        # tp_sharded: the precomputed (batch-independent) set, so
        # callers pricing many batch buckets don't re-run propagation
        mp_sharded = (set(tp_sharded) if tp_sharded is not None
                      else mp_sharded_vars(program, tp))
    sizer = _Sizer(block, batch, mp_sharded, tp)

    var_desc = {}
    persistable: Set[str] = set()
    for b in program.blocks:
        for v in b.vars.values():
            if v.persistable:
                persistable.add(v.name)
                var_desc.setdefault(v.name, v)
    # prediction mode only divides state the sharding pass would ACTUALLY
    # partition — an Adamax moment or a MasterParam-carrying op's slots
    # stay replicated, so the verdict never claims memory the rewrite
    # cannot deliver
    shardable: Set[str] = set()
    shardable_params: Set[str] = set()
    if pred_shard:
        from ..distributed.sharding import predicted_shardable_slots
        shardable = predicted_shardable_slots(program)
        if pred_stage >= 3:
            from ..distributed.sharding import predicted_shardable_params
            shardable_params = predicted_shardable_params(program)
    persistable_bytes = 0
    slot_bytes = 0
    param_bytes = 0
    for n in sorted(persistable):
        raw = sizer(n)
        v = var_desc.get(n)
        marked = int((v.attrs.get("dp_shard") or 0) if v is not None else 0)
        is_slot = v is not None and bool(
            (marked and not v.attrs.get("zero_param_bucket"))
            or v.attrs.get("accum_of"))
        is_param = v is not None and bool(
            v.is_parameter or v.attrs.get("zero_param_bucket"))
        if marked > 1:
            cost = -(-raw // marked)          # per-chip slice of the bucket
        elif pred_shard and n in shardable:
            cost = -(-raw // pred_shard)      # predicted ZeRO slot share
        elif pred_shard and n in shardable_params:
            cost = -(-raw // pred_shard)      # predicted ZeRO-3 param share
        else:
            cost = raw
        persistable_bytes += cost
        if is_slot:
            slot_bytes += cost
        if is_param:
            param_bytes += cost

    ops = [op for op in block.ops if op.type not in ("feed", "fetch")]

    # Pass 1: rep propagation + last-use.  A fusable/alias op's output is
    # a view of its ROOT buffer(s); a use of the view is a use of every
    # root.  Defs precede uses in block order, so one pass suffices.
    reps: Dict[str, frozenset] = {}
    last_use: Dict[str, int] = {}
    for i, op in enumerate(ops):
        for slot, names in op.inputs.items():
            released = _use_released(op.type, slot)
            for n in names:
                if not n:
                    continue
                if not released:
                    last_use[n] = i
                    for r in reps.get(n, ()):
                        last_use[r] = i
        if op.type == "optimization_barrier":
            # positional aliasing: Out[i] IS X[i] (jax.lax.
            # optimization_barrier returns its operand tuple unchanged).
            # The union rule below would merge every operand pair into
            # one root set — a multi-operand barrier (the ZeRO-3 gather
            # prefetch pins bucket k+1's gather to bucket k's reads)
            # would then chain ALL gathered buckets into a single
            # lifetime and the walker would charge the whole parameter
            # set as simultaneously live.
            xs = op.inputs.get("X", [])
            outs = op.outputs.get("Out", [])
            for xn, on in zip(xs, outs):
                if not on:
                    continue
                reps[on] = (reps.get(xn) or frozenset((xn,))) \
                    if xn and xn not in persistable else frozenset()
        elif op.type in _ALIAS_OPS or op.type in _FUSABLE_OPS:
            roots = frozenset(
                r
                for n in op.input_names() if n and n not in persistable
                for r in (reps.get(n) or frozenset((n,))))
            for n in op.output_names():
                if n:
                    reps[n] = roots

    # Pass 2: live-set sweep.  Outputs of alias/fusable ops cost 0 (rep
    # accounting keeps their roots alive); other outputs may REUSE the
    # buffer of a same-size input dying at this very op (XLA buffer
    # assignment's in-place reuse — softmax writing over its logits, a
    # grad writing over the activation it consumes).
    cost_of: Dict[str, int] = {}
    live: Set[str] = set()
    cur = 0
    for v in block.vars.values():
        if v.is_data and not v.persistable:
            c = sizer(v.name)
            cost_of[v.name] = c
            live.add(v.name)
            cur += c

    peak = cur
    peak_idx, peak_type = -1, "feed"
    peak_live: Set[str] = set(live)
    phase_peaks = {"forward": cur, "backward": 0, "optimize": 0}

    for i, op in enumerate(ops):
        free_output = op.type in _ALIAS_OPS or op.type in _FUSABLE_OPS
        dying = [n for n in set(op.input_names())
                 if n in live and last_use.get(n, -1) <= i
                 and cost_of.get(n, 0) > 0]
        internal = _op_internal_bytes(op, sizer)
        for n in op.output_names():
            if not n or n in persistable or n in live:
                continue
            c = (0 if free_output else sizer(n)) + internal
            internal = 0  # charge kernel-internal scratch once
            if c > 0:
                for j, d in enumerate(dying):
                    if cost_of[d] == c:
                        # take over the dying input's buffer
                        cost_of[d] = 0
                        dying.pop(j)
                        break
                else:
                    cur += c
                    cost_of[n] = c
                    live.add(n)
                    continue
            cost_of[n] = c
            live.add(n)
        phase = _phase_of(op)
        if cur > phase_peaks[phase]:
            phase_peaks[phase] = cur
        if cur > peak:
            peak, peak_idx, peak_type = cur, i, op.type
            peak_live = set(live)
        # inputs AND outputs whose last use is behind us die here — and
        # so do the ROOT buffers of any alias among them: a buffer that
        # is only ever read through alias views (ZeRO-3's slice → seg →
        # reshape-to-param gather chains) never reappears by name in a
        # later op, so sweeping only the op's own names would leak it
        # forever.  (Backward ops formally mention every forward input,
        # which is why ordinary residual roots never hit this path.)
        mentioned = set(op.input_names()) | set(op.output_names())
        for n in list(mentioned):
            mentioned |= reps.get(n, frozenset())
        for n in mentioned:
            if n in live and last_use.get(n, -1) <= i:
                cur -= cost_of.get(n, 0)
                live.discard(n)

    top_live = sorted(((cost_of.get(n, 0), n) for n in peak_live),
                      reverse=True)[:12]
    return {
        "batch": int(batch),
        "dp_shard": int(pred_shard) if pred_shard else None,
        "tp_degree": tp or None,
        "persistable_bytes": int(persistable_bytes),
        "optimizer_slot_bytes": int(slot_bytes),
        # per-chip PARAMETER state (replicated params, or the 1/degree
        # slice of ZeRO-3 dp_shard param buckets) — the stage-3 claim
        # the shard smoke and docs tables report
        "parameter_bytes": int(param_bytes),
        "activation_peak_bytes": int(peak),
        "peak_bytes": int(persistable_bytes + peak),
        "phase_peaks": {k: int(v + persistable_bytes)
                        for k, v in phase_peaks.items()},
        "peak_op_index": peak_idx,
        "peak_op_type": peak_type,
        "top_live": [(n, int(c)) for c, n in top_live],
        "n_ops": len(ops),
        "n_unknown_vars": len(set(sizer.unknown)),
        "budget_bytes": int(budget),
        # fits holds the walked peak times the card's measured slack
        # (DEVICE_SLACK) to the budget
        "fits_budget_bytes": int(budget / DEVICE_SLACK),
        "fits": bool((persistable_bytes + peak) * DEVICE_SLACK <= budget),
    }


def estimate_peak_bytes(program: Program, batch: Optional[int] = None) -> int:
    """Predicted peak HBM bytes of one training step of `program`
    (persistable state + peak live activations; see `analyze_program`
    for the full report).  Runs entirely at build time — no device, and
    no budget (the fits verdict is not asked for)."""
    return analyze_program(program, batch=batch, budget_bytes=0)[
        "peak_bytes"]


# ---------------------------------------------------------------------------
# checkpoint selection (auto-remat)
# ---------------------------------------------------------------------------
def _is_score_softmax(block, op) -> bool:
    """A softmax over an attention score tensor (rank >= 3): the one
    softmax per transformer layer that is not the loss head."""
    if op.type != "softmax":
        return False
    names = op.inputs.get("X", [])
    if not names or not block.has_var(names[0]):
        return False
    shape = block.var(names[0]).shape
    return shape is not None and len(shape) >= 3


def select_layer_checkpoints(program: Program) -> List[str]:
    """Checkpoint vars at transformer LAYER boundaries — the same
    boundaries a user hands `RecomputeOptimizer` (`recompute_configs
    {"checkpoints": [...]}`).

    For each attention core in the forward ops (softmax over a rank>=3
    score tensor, flash_attention, ring_attention, multihead_matmul) the
    nearest PRECEDING layer_norm output is selected — one checkpoint per
    layer, at the layer's entry, so backward replays one layer at a time
    from O(L) boundary activations instead of retaining every
    intermediate.  Falls back to every layer_norm output when the
    program has norms but no recognizable attention (conv stacks etc.
    return [] — no remat)."""
    block = program.global_block()
    fwd_ops = [op for op in block.ops
               if _phase_of(op) == "forward" and op.type != "feed"]
    ln_outs: List[str] = []   # layer_norm outputs in program order
    picks: List[str] = []
    seen: Set[str] = set()
    for op in fwd_ops:
        if op.type == "layer_norm":
            outs = op.outputs.get("Y") or op.outputs.get("Out") or []
            if outs and outs[0]:
                ln_outs.append(outs[0])
        elif op.type in _ATTENTION_CORE_OPS or _is_score_softmax(block, op):
            if ln_outs and ln_outs[-1] not in seen:
                picks.append(ln_outs[-1])
                seen.add(ln_outs[-1])
    if picks:
        return picks
    return list(dict.fromkeys(ln_outs))
