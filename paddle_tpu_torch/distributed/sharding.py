"""ZeRO sharded data parallelism over the dp axis — stages 1, 2 and 3.

Counterpart of paddle_tpu/distributed/sharding.py: the same rewrite, op
for op (the serialized programs and `ShardingPlan.to_dict()` are equal).
The JAX package runs the rewritten program under `shard_map`; the port
runs it on one process a rank (distributed/compiled_program.py), where
ring 0 is the dp group: a `dp_shard` var in a rank's scope is its dp
slice of dim 0, `c_reducescatter` / `c_allgather` / `c_split` are the
group's collectives (ops/kernels/collective.py), and
`optimization_barrier` (the stage-3 prefetch pin) is the identity.  The
text below is the JAX package's and speaks of its mesh; "rank" reads the
same in both.

Reference: Rajbhandari et al., "ZeRO: Memory Optimizations Toward Training
Trillion Parameter Models" (arXiv:1910.02054) — optimizer states (stage 1),
gradients (stage 2), and parameters (stage 3/FSDP) partitioned across the
DP world; and the reference fleet sharding meta-optimizer
(meta_optimizers/sharding_optimizer.py), which cuts the program into
per-rank shards with broadcast/allreduce glue.

TPU-native redesign.  The reference emits *per-rank* programs (each rank
holds different vars).  Under `shard_map` every rank traces the SAME
program, so rank-ness must live in the data, not the op list:

  * Per-param gradients are flattened and coalesced into dtype/optimizer-
    grouped flat BUCKETS (configurable bucket bytes), zero-padded so the
    bucket length divides the dp world size (world sizes are powers of two
    on TPU meshes, so this is the pow2 padding of the classic recipe).
  * One `c_reducescatter` per bucket replaces N per-param
    `c_allreduce_sum` ops: rank r receives the r-th 1/world slice of the
    summed gradient bucket — same wire bytes as allreduce's reduce half,
    and the only gradient collective before the update.
  * The optimizer update runs on the SHARD: slot variables (Adam moments,
    momentum velocity) are persistable vars declared at the GLOBAL padded
    bucket shape but marked ``dp_shard``; CompiledProgram feeds them into
    `shard_map` with `PartitionSpec("dp")`, so each rank sees (and
    donates, and updates) only its [padded/world] slice — 1/world of the
    optimizer memory per chip.

Stage ladder (``stage=`` argument; the surface each stage shards is
DECLARED by `distributed/partition_spec.zero_stage_rules`, regex rules
over qualified var names — a model that wants e.g. its embedding
replicated under stage 3 prepends a rule instead of patching this pass):

  * **stage 1** — as above, plus one `c_allgather` per bucket publishing
    the updated param shards back into the full (replicated) parameter
    buffers, un-padded and reshaped to each param's shape.
  * **stage 2** — stage 1, with the bucket reduce-scatter output marked
    for SHARDED gradient accumulation: `static.gradient_merge` applied
    after this pass accumulates the 1/N grad shard into a ``dp_shard``
    persistable accumulator instead of full-size per-param buffers —
    grad-accumulation HBM drops N×, and no merged gradient is ever
    re-gathered (the V201 "deferred counterpart" contract).
  * **stage 3** — the parameters themselves live sharded: each bucket's
    params are packed into ONE ``dp_shard`` persistable flat bucket
    (1/N per chip), forward/backward read them through just-in-time
    per-bucket `c_allgather` + slice + reshape chains (the gathered full
    copy is a plain temp, freed by liveness immediately after its last
    use in that phase — backward re-gathers instead of pinning the
    forward copy), the sharded update writes the bucket in place, and
    the stage-1 publish allgather disappears — the next step's forward
    gather IS the publish.

Off-mesh (single chip) every collective in the chain degrades to identity
and the shard IS the full bucket, so the rewritten program runs unchanged
on one device and is numerically the plain update over the flat params —
the same graceful degradation every collective kernel here has.

Composition contracts:
  * `insert_grad_allreduce` (CompiledProgram) skips gradients whose
    producer chain already contains a reduction, so wrapping a sharded
    program in `with_data_parallel` does not double-reduce.
  * `static.gradient_merge(program, k)` applied AFTER this pass
    accumulates gradients and commits the sharded update through its
    step mask.  Stage 1 keeps the classic full-size per-param
    accumulators; stages 2/3 accumulate the reduce-scattered bucket
    shard at 1/N (the gm pass reads the recorded plan's stage and the
    ``zero_role`` op stamps to find the boundary).
  * Checkpointing: sharded buckets (slots AND stage-3 param buckets) are
    persistable global-shape arrays; `Executor.checkpoint_snapshot`
    device_gets them WHOLE (the snapshot is rank-complete), and restore
    re-shards on the next step's `shard_map` placement.  `unshard_state`
    / `reshard_state` convert between bucket and per-param layouts for
    ANY stage pair, so a zero3 checkpoint can resume a zero1 or plain
    program and vice versa (static/executor.py `_convert_topology_shift`
    chains them).

AMP: `amp.decorate` keeps parameters fp32 (bf16 lives in forward casts),
so the fp32 params the buckets update ARE the master weights.  Optimizer
ops carrying an explicit ``MasterParam`` slot are left unsharded (the
per-param allreduce path still covers them) with a warning.
"""
from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.program import (Program, OpDesc, OpRole, unique_name)

__all__ = ["shard_optimizer_states", "ShardingPlan", "unshard_state",
           "reshard_state", "predicted_shardable_slots",
           "predicted_shardable_params", "DEFAULT_BUCKET_BYTES"]

# Bucket granularity: big enough to amortize collective launch overhead,
# small enough that the transient flat bucket + gathered bucket don't
# dominate activation memory.  Matches the reference DistributedStrategy's
# fuse_grad_size_in_MB default.
DEFAULT_BUCKET_BYTES = 32 * 2 ** 20
BUCKET_ENV = "PADDLE_TPU_SHARD_BUCKET_MB"

# optimizer op types the pass knows how to partition: slot input/output
# pairs (bucket-shaped, init 0) and scalar slot pairs (shape [1], init
# from an attr — Adam beta powers).  `per_param` forces one bucket per
# parameter (LAMB's trust ratio is a per-param norm ratio); `norms` adds
# the cross-shard norm reduction attr so the sharded update still sees
# GLOBAL parameter/update norms.
_SHARDABLE = {
    "sgd": dict(slots=(), scalars=()),
    "momentum": dict(slots=(("Velocity", "VelocityOut"),), scalars=()),
    "adam": dict(slots=(("Moment1", "Moment1Out"),
                        ("Moment2", "Moment2Out")),
                 scalars=(("Beta1Pow", "Beta1PowOut", "beta1", 0.9),
                          ("Beta2Pow", "Beta2PowOut", "beta2", 0.999))),
    "adamw": dict(slots=(("Moment1", "Moment1Out"),
                         ("Moment2", "Moment2Out")),
                  scalars=(("Beta1Pow", "Beta1PowOut", "beta1", 0.9),
                           ("Beta2Pow", "Beta2PowOut", "beta2", 0.999))),
    "lamb": dict(slots=(("Moment1", "Moment1Out"),
                        ("Moment2", "Moment2Out")),
                 scalars=(("Beta1Pow", "Beta1PowOut", "beta1", 0.9),
                          ("Beta2Pow", "Beta2PowOut", "beta2", 0.999)),
                 per_param=True, norms=True),
}

# attrs that identify an op instance, not its mathematics — excluded from
# the grouping key so same-hyperparameter params coalesce.  The zero_*
# stamps ride emitted ops only, but live here so a re-grouping of an
# already-stamped op can never split on them.
_INSTANCE_ATTRS = ("op_uid", OpRole.KEY, OpRole.VAR_KEY, "op_device",
                   "op_namescope", "fwd_uid", "zero_stage", "zero_bucket",
                   "zero_role")


class ShardingPlan:
    """What `shard_optimizer_states` did: stage + bucket layout + slot
    naming.

    Plain data (JSON-able via `to_dict`) so it deepcopies with the
    program and can ride a checkpoint's `extra` sidecar."""

    def __init__(self, dp_degree: int, buckets: List[dict],
                 stage: int = 1):
        self.dp_degree = int(dp_degree)
        self.buckets = buckets
        self.stage = int(stage)

    def to_dict(self):
        return {"dp_degree": self.dp_degree, "stage": self.stage,
                "buckets": self.buckets}

    @staticmethod
    def from_dict(d):
        return ShardingPlan(d["dp_degree"], list(d["buckets"]),
                            d.get("stage", 1))

    @property
    def n_buckets(self):
        return len(self.buckets)

    def slot_var_names(self) -> List[str]:
        out = []
        for b in self.buckets:
            out.extend(b["slots"].values())
            out.extend(b["scalars"].values())
        return out

    def param_bucket_names(self) -> List[str]:
        return [b["param_bucket"] for b in self.buckets
                if b.get("param_bucket")]

    def __repr__(self):
        return (f"ShardingPlan(dp={self.dp_degree}, stage={self.stage}, "
                f"buckets={len(self.buckets)})")


def default_bucket_bytes() -> int:
    raw = os.environ.get(BUCKET_ENV, "")
    if raw:
        try:
            return int(float(raw) * 2 ** 20)
        except ValueError:
            pass
    return DEFAULT_BUCKET_BYTES


def _default_world() -> int:
    """The dp world a program is sharded for when the caller names none:
    the process group's size, else the local device count (the JAX
    package's default)."""
    import torch
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return max(1, torch.cuda.device_count())


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return int(n)


def _dtype_bytes(dtype: str) -> int:
    from ..core.dtype import torch_dtype
    return int(torch_dtype(dtype).itemsize)


def _np_dtype(dtype: str):
    """The numpy dtype a host-side state array of `dtype` takes (numpy
    has no bfloat16: such state is held as its exact float32 upcast, as
    the executor's fetches are)."""
    from ..core.dtype import convert_dtype
    name = convert_dtype(dtype)
    return np.dtype("float32" if name == "bfloat16" else name)


def _mk_op(program, type, ins, outs, attrs=None):
    d = OpDesc(type, ins, outs, dict(attrs or {}))
    d.attrs.setdefault("op_uid", program._next_uid())
    d.attrs.setdefault(OpRole.KEY, OpRole.Optimize)
    return d


def _tmp(block, name_hint, shape, dtype):
    name = unique_name(name_hint)
    block.create_var(name=name, shape=shape, dtype=dtype,
                     stop_gradient=True)
    return name


def _collect_candidates(block, warn: bool) -> List[Tuple[int, "OpDesc"]]:
    """Optimizer ops `shard_optimizer_states` can actually partition:
    supported type, single static-shaped Param, dense gradient, no
    explicit MasterParam slot.  Shared with `predicted_shardable_slots`
    and the partition-spec engine (`build_sharding_specs`) so the
    estimator's prediction mode, the rule engine, and the pass agree
    op-for-op."""
    cands = []
    for i, op in enumerate(block.ops):
        if op.type not in _SHARDABLE:
            continue
        if op.attrs.get(OpRole.KEY) != OpRole.Optimize:
            continue
        # idempotency: a bucket-level op emitted by a previous
        # shard_optimizer_states run (stamped zero_sharded; its slot
        # inputs carry dp_shard) must not be re-sharded — that would
        # reduce-scatter the already-scattered shard across ranks
        # (summing unrelated slices) and 1/N-scale twice, silently on
        # the degenerate single-device path
        if op.attrs.get("zero_sharded") or any(
                block.vars.get(n) is not None
                and block.vars[n].attrs.get("dp_shard")
                for n in op.input_names()):
            continue
        if op.inputs.get("MasterParam"):
            if warn:
                warnings.warn(
                    f"shard_optimizer_states: op {op.type!r} for "
                    f"{op.inputs['Param']} carries an explicit MasterParam "
                    f"slot — left unsharded (the per-param allreduce path "
                    f"still covers it)", RuntimeWarning, stacklevel=3)
            continue
        pnames = op.inputs.get("Param", [])
        gnames = op.inputs.get("Grad", [])
        if len(pnames) != 1 or len(gnames) != 1:
            continue
        try:
            pvar = block.var(pnames[0])
        except KeyError:
            continue
        if pvar.shape is None or any(d is None or int(d) < 0
                                     for d in pvar.shape):
            continue  # dynamic-shaped param: cannot compute static offsets
        if pvar.attrs.get("dist_attr"):
            # tensor-parallel weight shard (tensor_parallel.shard_param):
            # under a dp×tp mesh each rank's runtime value is a LOCAL
            # shard whose length differs from the declared global shape,
            # so the flat dp bucket's static offsets would misalign —
            # and its grads must reduce over dp only, which the
            # per-param allreduce path (ring 0 → "dp") already does.
            # Its slots inherit the tp sharding through state_partition_
            # specs instead: tp divides that memory, ZeRO covers the
            # replicated remainder.
            continue
        gvar = block.vars.get(gnames[0])
        if gvar is not None and gvar.attrs.get("var_type") == \
                "SELECTED_ROWS":
            continue  # sparse gradient: dense flat bucket would densify it
        cands.append((i, op))
    return cands


def predicted_shardable_slots(program: Program) -> set:
    """Slot-variable names ZeRO sharding WOULD partition in `program` —
    exactly the accumulators of the ops `shard_optimizer_states` accepts.
    The HBM estimator's prediction mode (`analyze_program(...,
    dp_shard=N)`) divides only these: a slot belonging to an unsupported
    optimizer (Adamax, RMSProp, ...) or a skipped op (MasterParam,
    sparse grad) stays fully replicated, so the predicted verdict never
    claims memory the rewrite cannot deliver."""
    out = set()
    for _, op in _collect_candidates(program.global_block(), warn=False):
        spec = _SHARDABLE[op.type]
        for in_slot, _out in spec["slots"]:
            out.update(n for n in op.inputs.get(in_slot, []) if n)
        for in_slot, _out, _k, _d in spec["scalars"]:
            out.update(n for n in op.inputs.get(in_slot, []) if n)
    return out


def predicted_shardable_params(program: Program) -> set:
    """Parameter names ZeRO-3 WOULD pack into sharded buckets — the
    params of the candidate ops, same walk as the pass.  The estimator's
    stage-3 prediction mode divides only these (a MasterParam-carrying
    or sparse-grad param stays replicated)."""
    return {op.inputs["Param"][0]
            for _, op in _collect_candidates(program.global_block(),
                                             warn=False)}


def _first_reader_index(ops, names, role_mask=None) -> Optional[int]:
    """Index of the first op reading any of `names` (optionally only ops
    whose role has `role_mask` bits)."""
    names = set(names)
    for i, op in enumerate(ops):
        if role_mask is not None:
            role = int(op.attrs.get(OpRole.KEY, OpRole.Forward))
            if not (role & role_mask):
                continue
        if any(n in names for n in op.input_names()):
            return i
    return None


def shard_optimizer_states(program: Program, startup: Program,
                           dp_degree: Optional[int] = None,
                           bucket_bytes: Optional[int] = None,
                           scale: bool = True,
                           fp16_allreduce: Optional[bool] = None,
                           stage: int = 1,
                           rules: Tuple = (),
                           prefetch_gathers: bool = True) -> ShardingPlan:
    """Rewrite an already-minimized `program` for ZeRO sharded DP at
    `stage` 1 (optimizer slots), 2 (+ sharded gradient accumulation
    under gradient_merge), or 3 (+ the parameters themselves, with
    just-in-time forward/backward allgather).  See the module docstring
    for the per-stage op chains.  `startup` gains the sharded bucket
    initializers and loses the replaced per-param ones.  Mutates both
    programs in place (the `static.gradient_merge` contract) and returns
    the `ShardingPlan`, also recorded as ``program._zero_shard_plan``.

    dp_degree: the data-parallel world size the bucket padding targets
    (default: local device count).  Any mesh whose "dp" axis divides the
    padded length runs the same program; the recorded degree is stamped
    on the collectives so programs sharded for different worlds
    fingerprint differently (checkpoint mismatch warnings fire).

    bucket_bytes: flat-bucket coalescing granularity (default
    ``PADDLE_TPU_SHARD_BUCKET_MB`` MB, else 32 MB).

    fp16_allreduce: wrap the bucket reduce-scatter in bf16 casts, halving
    its ICI bytes (the fp16_allreduce meta-optimizer contract — defaults
    to the ``program._fp16_allreduce`` flag that optimizer sets, so
    strategy.fp16_allreduce keeps its meaning under sharding; the param
    allgather stays in the parameter dtype).

    rules: extra `partition_spec` rules PREPENDED to the stage's default
    rule list (first match wins) — e.g. ``[("^param:embedding", ())]``
    keeps an embedding replicated under stage 3.  Strict user rules that
    claim a var the pass cannot shard are refused (over-match refusal,
    `build_sharding_specs`).

    prefetch_gathers: stage-3 double-buffering — reorder each backward
    param gather one bucket ahead of its use so bucket k+1's
    ``c_allgather`` is in flight during bucket k's grad compute, pinned
    with an ``optimization_barrier`` so XLA's scheduler cannot sink it
    back to the consumer (`_prefetch_backward_gathers`).  Identity
    numerics; default on.
    """
    stage = int(stage)
    if stage not in (1, 2, 3):
        raise ValueError(f"ZeRO stage must be 1, 2 or 3, got {stage}")
    if fp16_allreduce is None:
        fp16_allreduce = bool(getattr(program, "_fp16_allreduce", False))
    world = int(dp_degree) if dp_degree else _default_world()
    if world < 1:
        raise ValueError(f"dp_degree must be >= 1, got {world}")
    bucket_bytes = int(bucket_bytes) if bucket_bytes else \
        default_bucket_bytes()
    if bucket_bytes < 1:
        raise ValueError("bucket_bytes must be positive")
    block = program.global_block()
    sblock = startup.global_block()

    # the declarative layer: which of the program's vars shard at this
    # stage (regex rules over qualified names; over-match refusal for
    # strict user rules happens inside)
    from .partition_spec import build_sharding_specs
    assignment = build_sharding_specs(program, stage, extra_rules=rules)

    def _participates(op) -> bool:
        """An op whose slot surface the rules keep REPLICATED (a user
        rule overriding the stage default) drops out of the candidate
        set — its per-param optimizer op survives and the per-param
        allreduce path covers it.  Slot-less optimizers (SGD) always
        participate: their bucketing is pure wire restructuring with no
        persistent surface for a rule to veto."""
        spec = _SHARDABLE[op.type]
        slot_names = [n for in_slot, _ in spec["slots"]
                      for n in op.inputs.get(in_slot, []) if n]
        if not slot_names:
            return True
        return any(assignment.sharded(f"slot:{n}") for n in slot_names)

    cands = [(i, op) for i, op in _collect_candidates(block, warn=True)
             if _participates(op)]
    if not cands or world == 1:
        # nothing to do (no shardable ops — possibly because a previous
        # application already rewrote them — or a world of one).  Never
        # clobber a previous application's plan: checkpoint-layout
        # conversion still needs it after an idempotent re-apply.  The
        # returned (empty) plan reports the stage the program ACTUALLY
        # carries — returning the requested stage would let a caller
        # stamp a checkpoint sidecar with a rewrite that never happened.
        prev = getattr(program, "_zero_shard_plan", None)
        if prev is not None and prev.buckets:
            if prev.stage != stage:
                warnings.warn(
                    f"shard_optimizer_states: program is already sharded "
                    f"at stage {prev.stage}; the stage={stage} re-apply "
                    f"is a no-op (the recorded stage-{prev.stage} plan "
                    f"stays authoritative — build a fresh program to "
                    f"change stages)", RuntimeWarning, stacklevel=2)
            return ShardingPlan(world, [], prev.stage)
        plan = ShardingPlan(world, [], stage)
        program._zero_shard_plan = plan
        return plan

    # -- group by (op type, hyperparams, lr var, dtypes, param-sharded) -----
    groups: Dict[tuple, List[Tuple[int, OpDesc]]] = {}
    for i, op in cands:
        pname = op.inputs["Param"][0]
        pvar = block.var(pname)
        gvar = block.vars.get(op.inputs["Grad"][0])
        gdtype = (gvar.dtype if gvar is not None and gvar.dtype
                  else pvar.dtype)
        hyper = tuple(sorted((k, repr(v)) for k, v in op.attrs.items()
                             if k not in _INSTANCE_ATTRS))
        lr = tuple(op.inputs.get("LearningRate", []))
        # a stage-3 program may keep SOME params replicated (rules):
        # those buckets take the stage-1 chain, so the flag is part of
        # the grouping key — a bucket is either fully packed or not
        p_sharded = stage >= 3 and assignment.sharded(f"param:{pname}")
        key = (op.type, lr, pvar.dtype, gdtype, hyper, p_sharded)
        groups.setdefault(key, []).append((i, op))

    # -- split groups into byte-bounded buckets -----------------------------
    buckets = []  # list of (key, [(idx, op), ...])
    for key, ops in groups.items():
        per_param = _SHARDABLE[key[0]].get("per_param", False)
        cur, cur_bytes = [], 0
        for i, op in ops:
            pvar = block.var(op.inputs["Param"][0])
            nbytes = _numel(pvar.shape) * _dtype_bytes(key[3])
            if cur and (per_param or cur_bytes + nbytes > bucket_bytes):
                buckets.append((key, cur))
                cur, cur_bytes = [], 0
            cur.append((i, op))
            cur_bytes += nbytes
        if cur:
            buckets.append((key, cur))

    removed_ids = {id(op) for _, ops in buckets for _, op in ops}
    first_idx = min(i for _, ops in buckets for i, _ in ops)

    def _stamp(bname, role):
        return {"zero_stage": stage, "zero_bucket": bname,
                "zero_role": role}

    # -- emit bucket machinery ----------------------------------------------
    new_ops: List[OpDesc] = []
    plan_buckets: List[dict] = []
    startup_drop: set = set()  # per-param slot vars to strip from startup
    # stage-3 gather chains, spliced AFTER the optimizer tail is rebuilt:
    # (bucket plan dict, pbucket name) for every param-packed bucket
    packed: List[dict] = []
    # stage>=2: each bucket's gradient chain (flatten → concat → pad →
    # reduce-scatter → scale) is INTERLEAVED into backward, right after
    # the bucket's last gradient producer, instead of pooling in the
    # optimizer tail — the full-size grads die bucket-by-bucket at their
    # reduce-scatter, so per-chip gradient HBM is one bucket in flight
    # (≈bucket_bytes) instead of the whole model (the stage-2 "grads ÷
    # N" claim, walker-visible).  Stage 1 keeps the tail placement.
    deferred_grad_chains: List[Tuple[List[str], List[OpDesc]]] = []
    for bi, (key, ops) in enumerate(buckets):
        op_type, lr_names, pdtype, gdtype, _hyper, p_sharded = key
        spec = _SHARDABLE[op_type]
        proto = ops[0][1]  # hyperparameters are identical across the group
        params, offset = [], 0
        for _, op in ops:
            pname = op.inputs["Param"][0]
            pvar = block.var(pname)
            n = _numel(pvar.shape)
            params.append({"param": pname, "grad": op.inputs["Grad"][0],
                           "offset": offset, "numel": n,
                           "shape": [int(d) for d in pvar.shape]})
            offset += n
        raw_len = offset
        padded = -(-raw_len // world) * world
        shard = padded // world
        bname = unique_name(f"zero{stage}/b{bi}_{op_type}")

        # flatten + concat + pad the GRAD bucket
        gops: List[OpDesc] = []
        flat_g = []
        for p in params:
            fg = _tmp(block, p["grad"] + "@Z1FLAT", [p["numel"]], gdtype)
            gops.append(_mk_op(program, "reshape",
                               {"X": [p["grad"]]}, {"Out": [fg]},
                               {"shape": [-1],
                                **_stamp(bname, "plumb")}))
            flat_g.append(fg)
        gcat = _tmp(block, bname + "@GCAT", [raw_len], gdtype)
        gops.append(_mk_op(program, "concat", {"X": flat_g},
                           {"Out": [gcat]},
                           {"axis": 0, **_stamp(bname, "plumb")}))
        if padded != raw_len:
            gpad = _tmp(block, bname + "@GPAD", [padded], gdtype)
            gops.append(_mk_op(program, "pad", {"X": [gcat]},
                               {"Out": [gpad]},
                               {"paddings": [0, padded - raw_len],
                                "pad_value": 0.0,
                                **_stamp(bname, "plumb")}))
            gcat = gpad
        # reduce-scatter: rank r gets the summed r-th slice.  dp_degree
        # rides the attrs so programs sharded for different worlds
        # fingerprint differently.  Under fp16_allreduce the wire leg is
        # bf16 (half the ICI bytes, fp32-range exponents), cast back
        # before the update.
        rs_dtype = "bfloat16" if fp16_allreduce else gdtype
        if fp16_allreduce:
            glow = _tmp(block, bname + "@GBF16", [padded], "bfloat16")
            gops.append(_mk_op(program, "cast", {"X": [gcat]},
                               {"Out": [glow]},
                               {"in_dtype": gdtype,
                                "out_dtype": "bfloat16",
                                **_stamp(bname, "plumb")}))
            gcat = glow
        gshard = _tmp(block, bname + "@GSHARD", [shard], rs_dtype)
        gops.append(_mk_op(program, "c_reducescatter", {"X": [gcat]},
                           {"Out": [gshard]},
                           {"ring_id": 0, "dp_degree": world,
                            **_stamp(bname, "reduce")}))
        if fp16_allreduce:
            gback = _tmp(block, bname + "@GFP32", [shard], gdtype)
            gops.append(_mk_op(program, "cast", {"X": [gshard]},
                               {"Out": [gback]},
                               {"in_dtype": "bfloat16",
                                "out_dtype": gdtype,
                                **_stamp(bname, "plumb")}))
            gshard = gback
        if scale:
            gsc = _tmp(block, bname + "@GSCALED", [shard], gdtype)
            gops.append(_mk_op(program, "scale_by_world_size",
                               {"X": [gshard]}, {"Out": [gsc]},
                               {"ring_id": 0,
                                **_stamp(bname, "plumb")}))
            gshard = gsc
        if stage >= 2:
            # interleave into backward (after the bucket's last grad
            # producer — placement resolved post-splice); stamped
            # Backward so gradient_merge's optimizer-tail split never
            # swallows them and the HBM walker phases them correctly
            for g in gops:
                g.attrs[OpRole.KEY] = OpRole.Backward
            deferred_grad_chains.append(
                ([p["grad"] for p in params], gops))
        else:
            new_ops.extend(gops)

        if p_sharded:
            # stage 3: the param bucket IS persistable sharded state —
            # no flatten/split chain, the update reads/writes it in
            # place, and forward gathers it just in time (below)
            pbucket = unique_name(f"{bname}@PBUCKET")
            for b in (block, sblock):
                v = b.create_var(name=pbucket, shape=[padded],
                                 dtype=pdtype, persistable=True,
                                 stop_gradient=True)
                v.attrs["dp_shard"] = world
                v.attrs["zero_param_bucket"] = True
            pshard = pbucket
        else:
            # stages 1-2: params stay replicated; flatten + concat +
            # pad + rank-slice a transient shard for the update
            pbucket = None
            flat_p = []
            for p in params:
                fp = _tmp(block, p["param"] + "@Z1FLAT", [p["numel"]],
                          pdtype)
                new_ops.append(_mk_op(program, "reshape",
                                      {"X": [p["param"]]}, {"Out": [fp]},
                                      {"shape": [-1],
                                       **_stamp(bname, "pshard")}))
                flat_p.append(fp)
            pcat = _tmp(block, bname + "@PCAT", [raw_len], pdtype)
            new_ops.append(_mk_op(program, "concat", {"X": flat_p},
                                  {"Out": [pcat]},
                                  {"axis": 0, **_stamp(bname, "pshard")}))
            if padded != raw_len:
                ppad = _tmp(block, bname + "@PPAD", [padded], pdtype)
                new_ops.append(_mk_op(program, "pad", {"X": [pcat]},
                                      {"Out": [ppad]},
                                      {"paddings": [0, padded - raw_len],
                                       "pad_value": 0.0,
                                       **_stamp(bname, "pshard")}))
                pcat = ppad
            pshard = _tmp(block, bname + "@PSHARD", [shard], pdtype)
            new_ops.append(_mk_op(program, "c_split", {"X": [pcat]},
                                  {"Out": [pshard]},
                                  {"ring_id": 0,
                                   **_stamp(bname, "pshard")}))

        # sharded persistable slots: declared at the GLOBAL padded shape,
        # marked dp_shard so CompiledProgram feeds them P("dp") — each
        # rank materializes only its [shard] slice
        slots, scalars, orig_slots = {}, {}, {}
        for in_slot, _out in spec["slots"]:
            sname = unique_name(f"{bname}@{in_slot.lower()}")
            for b in (block, sblock):
                v = b.create_var(name=sname, shape=[padded],
                                 dtype="float32", persistable=True,
                                 stop_gradient=True)
                v.attrs["dp_shard"] = world
            sblock.ops.append(OpDesc(
                "fill_constant", {}, {"Out": [sname]},
                {"shape": [padded], "value": 0.0, "dtype": "float32",
                 "op_uid": startup._next_uid()}))
            slots[in_slot] = sname
        for in_slot, _out, attr_key, attr_default in spec["scalars"]:
            sname = unique_name(f"{bname}@{in_slot.lower()}")
            val = float(proto.attrs.get(attr_key, attr_default))
            for b in (block, sblock):
                b.create_var(name=sname, shape=[1], dtype="float32",
                             persistable=True, stop_gradient=True)
            sblock.ops.append(OpDesc(
                "fill_constant", {}, {"Out": [sname]},
                {"shape": [1], "value": val, "dtype": "float32",
                 "op_uid": startup._next_uid()}))
            scalars[in_slot] = sname

        # the bucket-level optimizer op (the partitioned update)
        upd_ins = {"Param": [pshard], "Grad": [gshard]}
        if lr_names:
            upd_ins["LearningRate"] = list(lr_names)
        for in_slot, _out in spec["slots"]:
            upd_ins[in_slot] = [slots[in_slot]]
        for in_slot, _out, _k, _d in spec["scalars"]:
            upd_ins[in_slot] = [scalars[in_slot]]
        if p_sharded:
            pout = pbucket  # in-place persistable write, like the slots
        else:
            pout = _tmp(block, bname + "@POUT", [shard], pdtype)
        upd_outs = {"ParamOut": [pout]}
        for in_slot, out_slot in spec["slots"]:
            upd_outs[out_slot] = [slots[in_slot]]
        for in_slot, out_slot, _k, _d in spec["scalars"]:
            upd_outs[out_slot] = [scalars[in_slot]]
        upd_attrs = {k: v for k, v in proto.attrs.items()
                     if k not in _INSTANCE_ATTRS}
        upd_attrs["zero_sharded"] = True  # idempotency marker
        upd_attrs.update(_stamp(bname, "update"))
        if spec.get("norms"):
            # LAMB trust ratio needs GLOBAL ‖p‖/‖r‖ — the kernel psums
            # the squared norms over the ring when this attr is present
            upd_attrs["reduce_norms_ring_id"] = 0
        new_ops.append(_mk_op(program, op_type, upd_ins, upd_outs,
                              upd_attrs))

        if not p_sharded:
            # stages 1-2 publish: allgather the updated shards, slice +
            # reshape back into the full (replicated) parameter buffers.
            # Stage 3 has no publish — the next step's forward gather
            # reads the bucket the update just wrote.
            pfull = _tmp(block, bname + "@PFULL", [padded], pdtype)
            new_ops.append(_mk_op(program, "c_allgather", {"X": [pout]},
                                  {"Out": [pfull]},
                                  {"ring_id": 0, "dp_degree": world,
                                   **_stamp(bname, "publish")}))
            for p in params:
                seg = _tmp(block, p["param"] + "@Z1SEG", [p["numel"]],
                           pdtype)
                new_ops.append(_mk_op(program, "slice",
                                      {"Input": [pfull]}, {"Out": [seg]},
                                      {"axes": [0],
                                       "starts": [p["offset"]],
                                       "ends": [p["offset"] + p["numel"]],
                                       **_stamp(bname, "publish")}))
                new_ops.append(_mk_op(program, "reshape", {"X": [seg]},
                                      {"Out": [p["param"]]},
                                      {"shape": list(p["shape"]),
                                       **_stamp(bname, "publish")}))

        # strip the replaced per-param slot vars (and their startup
        # initializers): full-shape moments must neither occupy the scope
        # nor count as persistable state
        for _, op in ops:
            per_param_slots = {}
            for in_slot, _out in spec["slots"]:
                for n in op.inputs.get(in_slot, []):
                    per_param_slots[in_slot.lower()] = n
                    startup_drop.add(n)
            for in_slot, _out, _k, _d in spec["scalars"]:
                for n in op.inputs.get(in_slot, []):
                    per_param_slots[in_slot.lower()] = n
                    startup_drop.add(n)
            if per_param_slots:
                orig_slots[op.inputs["Param"][0]] = per_param_slots

        bucket_plan = {
            "name": bname, "op_type": op_type, "dtype": pdtype,
            "grad_dtype": gdtype, "raw_len": raw_len,
            "padded_len": padded, "shard_len": shard,
            "params": params,
            "slots": {k.lower(): v for k, v in slots.items()},
            "scalars": {k.lower(): v for k, v in scalars.items()},
            "orig_slots": orig_slots,
            # gradient_merge's stage>=2 boundary: accumulate THIS var
            # (the post-scale 1/N shard) into a dp_shard accumulator
            "grad_shard": gshard,
            "param_bucket": pbucket,
        }
        plan_buckets.append(bucket_plan)
        if p_sharded:
            packed.append(bucket_plan)

    # -- splice: machinery replaces the first removed op's position ---------
    head = [op for op in block.ops[:first_idx]]
    tail = [op for op in block.ops[first_idx:]
            if id(op) not in removed_ids]
    block.ops = head + new_ops + tail

    # stage>=2: drop each bucket's gradient chain right after the
    # bucket's last gradient producer (a backward op — or, under AMP,
    # the unscale op — all of which live BEFORE the spliced tail, so
    # the indices are stable).  Descending order keeps earlier insertion
    # points valid.
    if deferred_grad_chains:
        placements = []
        for gnames, gops in deferred_grad_chains:
            gset = set(gnames)
            last = -1
            for i, op in enumerate(block.ops):
                if any(n in gset for n in op.output_names()):
                    last = i
            if last < 0:  # no producer found: fall back to the tail head
                last = len(head) - 1
            placements.append((last + 1, gops))
        for idx, gops in sorted(placements, key=lambda t: -t[0]):
            block.ops[idx:idx] = gops

    # drop replaced per-param slot vars everywhere
    for name in startup_drop:
        block.vars.pop(name, None)
        sblock.vars.pop(name, None)
    sblock.ops = [op for op in sblock.ops
                  if not any(n in startup_drop for n in op.output_names())]

    # -- stage 3: just-in-time parameter gathers + startup pack -------------
    if packed:
        _emit_stage3_param_machinery(program, startup, packed, world)
        if prefetch_gathers:
            _prefetch_backward_gathers(program)
    program._fingerprint_cache = None
    startup._fingerprint_cache = None

    plan = ShardingPlan(world, plan_buckets, stage)
    program._zero_shard_plan = plan
    # applied-passes registry + env-gated post-rewrite self-check
    # (static/verifier.py: the rs↔ag pairing and dp_shard-consistency
    # diagnostics were built for this pass family)
    from ..core.pass_framework import finish_pass
    finish_pass(program, "zero1_sharding", startup=startup,
                dp_degree=world, stage=stage, buckets=len(plan_buckets),
                bucket_bytes=int(bucket_bytes))
    return plan


def _emit_stage3_param_machinery(program: Program, startup: Program,
                                 packed: List[dict], world: int):
    """The ZeRO-3 half of the rewrite, run after the optimizer tail is
    rebuilt:

      * main: per-bucket just-in-time ``c_allgather → slice → reshape``
        chains producing the ORIGINAL param names right before their
        first forward reader, and a second chain producing ``@Z3BWD``
        aliases right before the first backward reader (backward op
        inputs are renamed onto the aliases, so the forward copy's
        liveness ends at its last forward use — "gather, use, free");
      * the original param vars flip to non-persistable in main AND
        startup (they are produced, not state);
      * startup: pack ops appended after the existing initializers —
        the randomly-initialized full params flatten/concat/pad into
        the persistable ``@PBUCKET`` the scope actually keeps.
    """
    block = program.global_block()
    sblock = startup.global_block()

    for b in packed:
        bname, pbucket = b["name"], b["param_bucket"]
        pdtype = b["dtype"]
        padded, raw_len = b["padded_len"], b["raw_len"]
        pnames = [p["param"] for p in b["params"]]

        # params are produced by the gather now — not persistable state
        for blk in (block, sblock):
            for n in pnames:
                v = blk.vars.get(n)
                if v is not None:
                    v.persistable = False

        def _gather_chain(role, suffix, stamp_role):
            """Build (ops, produced names) for one JIT gather chain."""
            ops = []
            pfull = _tmp(block, f"{bname}@PFULL{suffix}", [padded], pdtype)
            g = _mk_op(program, "c_allgather", {"X": [pbucket]},
                       {"Out": [pfull]},
                       {"ring_id": 0, "dp_degree": world,
                        "zero_stage": 3, "zero_bucket": bname,
                        "zero_role": stamp_role})
            g.attrs[OpRole.KEY] = role
            ops.append(g)
            produced = {}
            for p in b["params"]:
                out_name = p["param"] + suffix
                if suffix:
                    block.create_var(name=out_name, shape=p["shape"],
                                     dtype=pdtype, stop_gradient=True)
                seg = _tmp(block, p["param"] + "@Z3SEG", [p["numel"]],
                           pdtype)
                for op_type, ins, outs, attrs in (
                        ("slice", {"Input": [pfull]}, {"Out": [seg]},
                         {"axes": [0], "starts": [p["offset"]],
                          "ends": [p["offset"] + p["numel"]]}),
                        ("reshape", {"X": [seg]}, {"Out": [out_name]},
                         {"shape": list(p["shape"])})):
                    attrs.update({"zero_stage": 3, "zero_bucket": bname,
                                  "zero_role": stamp_role})
                    o = _mk_op(program, op_type, ins, outs, attrs)
                    o.attrs[OpRole.KEY] = role
                    ops.append(o)
                produced[p["param"]] = out_name
            return ops, produced

        # backward readers are renamed onto the @Z3BWD aliases FIRST so
        # the forward-reader scan below only sees true forward uses
        bwd_idx = _first_reader_index(block.ops, pnames,
                                      role_mask=OpRole.Backward)
        if bwd_idx is not None:
            bwd_ops, bwd_names = _gather_chain(OpRole.Backward, "@Z3BWD",
                                               "gather_bwd")
            for op in block.ops:
                role = int(op.attrs.get(OpRole.KEY, OpRole.Forward))
                if not (role & OpRole.Backward):
                    continue
                for slot, names in op.inputs.items():
                    op.inputs[slot] = [bwd_names.get(n, n) for n in names]
            block.ops[bwd_idx:bwd_idx] = bwd_ops

        fwd_idx = _first_reader_index(block.ops, pnames)
        fwd_ops, _ = _gather_chain(OpRole.Forward, "", "gather_fwd")
        if fwd_idx is None:
            fwd_idx = 0
        block.ops[fwd_idx:fwd_idx] = fwd_ops

        # startup pack: full inits → flat bucket (runs eagerly once; the
        # write-back keeps only persistables, so the raw full params
        # never reach the scope)
        flat = []
        for p in b["params"]:
            fp = unique_name(p["param"] + "@Z3PACK")
            sblock.create_var(name=fp, shape=[p["numel"]], dtype=pdtype,
                              stop_gradient=True)
            sblock.ops.append(OpDesc(
                "reshape", {"X": [p["param"]]}, {"Out": [fp]},
                {"shape": [-1], "op_uid": startup._next_uid()}))
            flat.append(fp)
        if padded != raw_len:
            pcat = unique_name(bname + "@Z3CAT")
            sblock.create_var(name=pcat, shape=[raw_len], dtype=pdtype,
                              stop_gradient=True)
            sblock.ops.append(OpDesc(
                "concat", {"X": flat}, {"Out": [pcat]},
                {"axis": 0, "op_uid": startup._next_uid()}))
            sblock.ops.append(OpDesc(
                "pad", {"X": [pcat]}, {"Out": [pbucket]},
                {"paddings": [0, padded - raw_len], "pad_value": 0.0,
                 "op_uid": startup._next_uid()}))
        else:
            sblock.ops.append(OpDesc(
                "concat", {"X": flat}, {"Out": [pbucket]},
                {"axis": 0, "op_uid": startup._next_uid()}))


def _prefetch_backward_gathers(program: Program) -> int:
    """Double-buffer the ZeRO-3 backward param gathers.

    `_emit_stage3_param_machinery` places each bucket's ``gather_bwd``
    ``c_allgather`` right before its first backward reader, so gather
    latency serializes with the grad compute it feeds.  This post-pass
    reorders each gather (the allgather only — the local slice/reshape
    ops stay at the use site) one bucket EARLIER: gather j is issued
    immediately before bucket j-1's first slice, and an
    ``optimization_barrier`` over (gather j's output, bucket j-1's
    gathered buffer) pins the issue order — bucket j-1's consumers now
    depend on gather j having been scheduled, so XLA's latency-hiding
    scheduler overlaps gather j with bucket j-1's grad compute instead
    of sinking it back down to bucket j's slices.  At most two gathered
    buckets are live at once (the double-buffer bound).  The barrier is
    an identity: numerics are bit-identical.

    Returns the number of gathers prefetched (0 or 1 bucket: nothing to
    overlap).
    """
    block = program.global_block()

    def _bwd_gathers():
        return [op for op in block.ops
                if op.type == "c_allgather"
                and op.attrs.get("zero_role") == "gather_bwd"
                and not op.attrs.get("zero_prefetched")]

    gathers = _bwd_gathers()
    if len(gathers) < 2:
        return 0
    # the name bucket j's slice ops currently read (updated as barriers
    # re-route them through their @PIN outputs)
    reads = [op.outputs["Out"][0] for op in gathers]
    moved = 0
    for j in range(1, len(gathers)):
        g = gathers[j]
        prev_read = reads[j - 1]
        # bucket j-1's first consumer: the earliest slice reading its
        # gathered buffer
        pos = next((i for i, op in enumerate(block.ops)
                    if op.type == "slice"
                    and op.attrs.get("zero_role") == "gather_bwd"
                    and prev_read in op.inputs.get("Input", [])), None)
        if pos is None:
            continue
        gi = block.ops.index(g)
        if gi < pos:
            continue  # already ahead of the consumer it should overlap
        pfull = g.outputs["Out"][0]
        pvar = block.var(pfull)
        prev_var = block.var(prev_read)
        pf_pre = _tmp(block, pfull + "@PREFETCH", list(pvar.shape),
                      pvar.dtype)
        pin = _tmp(block, prev_read + "@PIN", list(prev_var.shape),
                   prev_var.dtype)
        g.outputs["Out"] = [pf_pre]
        g.attrs["zero_prefetched"] = True
        bar = _mk_op(program, "optimization_barrier",
                     {"X": [pf_pre, prev_read]},
                     {"Out": [pfull, pin]},
                     {"zero_stage": 3,
                      "zero_bucket": g.attrs.get("zero_bucket"),
                      "zero_role": "gather_prefetch"})
        bar.attrs[OpRole.KEY] = OpRole.Backward
        for op in block.ops:
            if op.type == "slice" and \
                    op.attrs.get("zero_role") == "gather_bwd" and \
                    prev_read in op.inputs.get("Input", []):
                op.inputs["Input"] = [pin if n == prev_read else n
                                      for n in op.inputs["Input"]]
        del block.ops[gi]
        block.ops[pos:pos] = [g, bar]
        reads[j - 1] = pin
        moved += 1
    if moved:
        program._fingerprint_cache = None
    return moved


# ---------------------------------------------------------------------------
# checkpoint layout conversion (any ZeRO stage <-> plain resume)
# ---------------------------------------------------------------------------
def unshard_state(state: Dict[str, object], plan: ShardingPlan) \
        -> Dict[str, object]:
    """Convert a ZeRO checkpoint state dict to the PLAIN layout: bucket
    slot arrays are sliced at each param's offset and renamed to the
    original accumulator names, and (stage 3) param buckets unpack into
    the original full-shape parameters — so the result restores into an
    unsharded program.  Bucket-only keys are dropped; everything else
    passes through."""
    plan = plan if isinstance(plan, ShardingPlan) else \
        ShardingPlan.from_dict(plan)
    bucket_keys = set(plan.slot_var_names()) | set(plan.param_bucket_names())
    out = {k: v for k, v in state.items() if k not in bucket_keys}
    for b in plan.buckets:
        for slot_key, bucket_name in b["slots"].items():
            arr = state.get(bucket_name)
            if arr is None:
                continue
            flat = np.asarray(arr).reshape(-1)
            for p in b["params"]:
                orig = b["orig_slots"].get(p["param"], {}).get(slot_key)
                if orig is None:
                    continue
                seg = flat[p["offset"]: p["offset"] + p["numel"]]
                out[orig] = seg.reshape(p["shape"]).copy()
        for slot_key, name in b["scalars"].items():
            arr = state.get(name)
            if arr is None:
                continue
            for p in b["params"]:
                orig = b["orig_slots"].get(p["param"], {}).get(slot_key)
                if orig is not None:
                    out[orig] = np.asarray(arr).copy()
        pbucket = b.get("param_bucket")
        if pbucket and pbucket in state:
            flat = np.asarray(state[pbucket]).reshape(-1)
            for p in b["params"]:
                seg = flat[p["offset"]: p["offset"] + p["numel"]]
                out[p["param"]] = seg.reshape(p["shape"]).copy()
    return out


def reshard_state(state: Dict[str, object], plan: ShardingPlan) \
        -> Dict[str, object]:
    """Inverse of `unshard_state`: concatenate a plain checkpoint's
    per-param arrays into the bucket layout so it restores into a ZeRO
    program of `plan`'s stage.  Missing per-param SLOTS default to zeros
    (fresh accumulators), matching the startup initializer; a missing
    PARAMETER for a stage-3 bucket raises ``KeyError`` — silently
    zeroing model weights is never a valid conversion."""
    plan = plan if isinstance(plan, ShardingPlan) else \
        ShardingPlan.from_dict(plan)
    dropped = set()
    for b in plan.buckets:
        for slots in b["orig_slots"].values():
            dropped.update(slots.values())
        if b.get("param_bucket"):
            dropped.update(p["param"] for p in b["params"])
    out = {k: v for k, v in state.items() if k not in dropped}
    for b in plan.buckets:
        for slot_key, bucket_name in b["slots"].items():
            flat = np.zeros(b["padded_len"], np.float32)
            for p in b["params"]:
                orig = b["orig_slots"].get(p["param"], {}).get(slot_key)
                if orig is not None and orig in state:
                    flat[p["offset"]: p["offset"] + p["numel"]] = \
                        np.asarray(state[orig]).reshape(-1)
            out[bucket_name] = flat
        for slot_key, name in b["scalars"].items():
            val = None
            for p in b["params"]:
                orig = b["orig_slots"].get(p["param"], {}).get(slot_key)
                if orig is not None and orig in state:
                    val = np.asarray(state[orig],
                                     np.float32).reshape([1])
                    break
            if val is not None:
                out[name] = val
        pbucket = b.get("param_bucket")
        if pbucket:
            flat = np.zeros(b["padded_len"], _np_dtype(b["dtype"]))
            for p in b["params"]:
                if p["param"] not in state:
                    raise KeyError(
                        f"reshard_state: parameter {p['param']!r} is "
                        f"missing from the checkpoint — cannot pack "
                        f"stage-3 bucket {pbucket!r} (zero-filling model "
                        f"weights would silently corrupt the restore)")
                flat[p["offset"]: p["offset"] + p["numel"]] = \
                    np.asarray(state[p["param"]]).reshape(-1)
            out[pbucket] = flat
    return out
