"""Elastic data parallelism: one logical schedule, any physical world size.

Counterpart of paddle_tpu/distributed/elastic.py; the rewrite is the
same, op for op (a rewritten program serializes equal in both packages).
A job that loses ranks mid-run must CONTINUE the same training run on
the ranks that come back — same global batch schedule, same loss trace —
not start a subtly different one.  Three facts make that hard:

  1. the data-parallel world size is baked into the gradient reduction
     (an allreduce over however many ranks exist), so the same global
     batch summed over 4 or 2 ranks differs in floating-point order;
  2. gradient-merge counters, RNG streams and sampler positions are all
     denominated in *micro-steps*, whose meaning changes with the world;
  3. ZeRO-sharded optimizer state is laid out for a specific shard count.

This module solves (1) and (2) by fixing the LOGICAL topology and making
the reduction order a property of the program, not of the world:

``elasticize(program, startup, logical_dp=N)`` rewrites an
already-minimized program so that

  * a global step is ``K = N / M`` micro-steps on a world of M ranks
    (``K`` is resolved when the op runs, from ring 0's group — the op
    list is identical for every M, so the program fingerprint, the
    persistable state layout, and the checkpoint format are world-size
    invariant);
  * gradients are reduced by ``c_elastic_fold`` — an all-gather followed
    by an explicit, unrolled left-fold continued from a persistable
    accumulator.  Micro-step j folds logical ranks ``jM .. jM+M-1`` in
    order, so after K micro-steps the accumulator holds exactly
    ``(((g0+g1)+g2)+...)+g_{N-1}`` — the same adds in the same order for
    EVERY factorization of N, hence bitwise-identical updates across
    world changes;
  * the optimizer commits through a mask derived from a persistable
    micro-step counter (the gradient-merge masking machinery), scaled by
    the exact power-of-two ``1/N``;
  * the per-rank loss is folded the same way, so the committed
    ``<loss>@ELASTIC_AVG`` value reproduces the full-world loss trace
    bitwise.

Wire-cost note: the fold gathers every rank's gradient instead of
allreducing it — (M-1)·|g| bytes vs allreduce's 2(M-1)/M·|g|.  Elastic
mode trades up to ~M/2× gradient wire volume for topology invariance;
the plain (non-elastic) path is untouched.

(3) — ZeRO — composes with stage 1: each bucket's reduce-scattered 1/N
gradient SHARD is folded into a ``dp_shard`` window accumulator
(``c_elastic_fold`` with ``pre_reduced=True`` — no full-size gather),
the per-micro-step 1/M scale is replaced by one exact pow2 1/N at
commit, and the masked optimizer commit covers the bucket update +
publish.  The reduce-scatter's summation order is the backend's, so
THIS composition's cross-topology contract is allclose (1e-6), not
bitwise; same-world kill/resume stays bitwise.  Checkpoint layout
conversion across shard counts is handled at restore by
``Executor.restore_from_checkpoint`` routing state through
``sharding.unshard_state`` → ``sharding.reshard_state``.  Stages 2/3
refuse (their chains interleave into backward).

One process a rank: a live process cannot change its world (its process
group is fixed at `init_process_group`).  `reanchor_topology` re-derives
the schedule for the world the caller's process group has; a world
change goes through a relaunch (``launch --elastic`` re-forms the pod)
and ``Executor.restore_from_checkpoint(..., world=M)``.

run_steps: ``Executor.run_steps(CompiledProgram(...),
feed=stacked_micro_feeds)`` runs K micro-steps a call, bitwise-equal to
the looped form (distributed/compiled_program.py).
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional

import numpy as np

from ..core.program import OpDesc, OpRole, Program, unique_name
from .fleet.meta_optimizers.rewrite_utils import (
    _op, new_tmp_var, retarget_op_outputs_masked)

__all__ = ["elasticize", "rebucket_feeds", "rederive_schedule",
           "elastic_meta", "micro_steps_per_global", "LaunchedRank"]


def elastic_meta(program) -> Optional[dict]:
    """The elastic rewrite's metadata dict, or None for plain programs."""
    return getattr(program, "_elastic_meta", None)


def micro_steps_per_global(program, world: int) -> int:
    """K for `program` on a `world`-device mesh (1 for plain programs)."""
    meta = elastic_meta(program)
    if meta is None:
        return 1
    n = int(meta["logical_dp"])
    if world < 1 or n % world != 0:
        raise ValueError(
            f"elastic logical_dp={n} is not divisible by the physical "
            f"world size {world}; an elastic mesh must be a power-of-two "
            f"divisor of the logical world")
    return n // world


def elasticize(program: Program, startup: Program, logical_dp: int,
               loss_name=None, params_grads=None) -> dict:
    """Rewrite an already-minimized `program` for the elastic schedule.

    Must run BEFORE the startup program executes (it appends accumulator
    initializers, like ``static.gradient_merge``).  `logical_dp` is the
    job's logical data-parallel degree — the reduction order and the
    commit cadence are defined against it forever; any mesh whose size
    divides it runs the same program.  `loss_name` (var or name)
    additionally folds the loss so the committed ``<loss>@ELASTIC_AVG``
    fetch is world-size invariant.  Mutates `program`/`startup` in place
    and returns the recorded meta dict (also at
    ``program._elastic_meta``)."""
    n = int(logical_dp)
    if n < 1 or (n & (n - 1)):
        raise ValueError(f"logical_dp must be a power of two, got {n}")
    from ..core.pass_framework import has_applied
    if elastic_meta(program) is not None or has_applied(program, "elastic"):
        raise ValueError("elasticize already applied to this program")
    plan = getattr(program, "_zero_shard_plan", None)
    if plan is not None and not getattr(plan, "buckets", None):
        plan = None
    if plan is None and has_applied(program, "zero1_sharding"):
        raise ValueError(
            "elasticize: program carries a zero1_sharding registry "
            "entry but no recorded ShardingPlan — cannot locate the "
            "bucket chains to fold")
    if plan is not None and int(getattr(plan, "stage", 1)) >= 2:
        raise NotImplementedError(
            "elasticize composes with ZeRO stage 1 only: stages 2/3 "
            "interleave their bucket chains into backward, where the "
            "elastic window accumulation is not defined yet "
            "(docs/elastic.md)")
    if getattr(program, "_gm_meta", None) is not None or \
            has_applied(program, "gradient_merge"):
        raise NotImplementedError(
            "elasticize does not stack on static.gradient_merge: the "
            "elastic schedule IS a masked accumulation window (K = "
            "logical_dp / world); apply only one of the two")
    pgs = params_grads or getattr(program, "_ps_params_grads", None)
    if not pgs:
        raise ValueError(
            "elasticize: run optimizer.minimize(loss) on the program "
            "first (it records the param/grad pairs), or pass "
            "params_grads= explicitly")

    block = program.global_block()
    sblock = startup.global_block()
    opt_start = next((i for i, op in enumerate(block.ops)
                      if op.op_role == OpRole.Optimize), len(block.ops))
    opt_ops = block.ops[opt_start:]
    block.ops = block.ops[:opt_start]

    def _persistable(name, shape, dtype, value):
        for b in (block, sblock):
            b.create_var(name=name, shape=shape, dtype=dtype,
                         persistable=True, stop_gradient=True)
        sblock.ops.append(OpDesc(
            "fill_constant", {}, {"Out": [name]},
            {"shape": list(shape), "value": value, "dtype": dtype,
             "op_uid": startup._next_uid()}))

    # micro-step counter; (counter % K == 0) AFTER the increment marks the
    # commit micro-step.  K = logical_dp / mesh-size is resolved inside
    # the elastic_commit_mask kernel at trace time, so this same op list
    # serves every world size.
    counter = unique_name("@elastic_step")
    _persistable(counter, (1,), "int32", 0)
    _op(program, block, "increment", {"X": [counter]}, {"Out": [counter]},
        {"step": 1})
    mask = new_tmp_var(block, name_hint="@elastic_mask", dtype="bool")
    _op(program, block, "elastic_commit_mask", {"X": [counter]},
        {"Out": [mask]}, {"ring_id": 0, "logical_dp": n})

    acc_names: List[str] = []
    # (acc, folded, sharded) triples to reset on commit
    resets: List[tuple] = []

    def _fold(src_name, like_var, hint, dist_attr=None):
        """acc += ordered cross-rank fold of `src_name` (over the dp
        axis — ring 0 binds to the dp sub-axis on a dp×tp mesh, leaving
        the tp leg intact); returns the folded (pre-reset) temp and
        registers the reset.  `dist_attr` (the owning param's tp
        annotation) makes the accumulator shard over tp like the grad
        it folds — a tp-sharded grad is a LOCAL shard at runtime, so a
        replicated global-shape accumulator would shape-mismatch inside
        the trace."""
        acc = unique_name(hint + "@ELASTIC_ACC")
        shape = list(like_var.shape or [1])
        _persistable(acc, shape, like_var.dtype or "float32", 0.0)
        if dist_attr:
            for blk in (block, sblock):
                blk.var(acc).attrs["dist_attr"] = list(dist_attr)
        folded = new_tmp_var(block, like=block.var(acc),
                             name_hint=hint + "@ELASTIC_FOLD")
        _op(program, block, "c_elastic_fold",
            {"X": [src_name], "Acc": [acc]}, {"Out": [folded]},
            {"ring_id": 0, "logical_dp": n})
        acc_names.append(acc)
        # tp-sharded accumulators reset through fill_zeros_like so the
        # zeros follow the runtime (local-shard) shape, like dp_shard
        resets.append((acc, folded, bool(dist_attr)))
        return folded

    # -- ZeRO-1 composition (stage-1 plans only, gated above) ---------------
    # The bucket chain (flatten → concat → pad → c_reducescatter) runs
    # every micro-step and the window accumulates the 1/N reduce-
    # scattered SHARD into a dp_shard persistable accumulator — 1/world
    # of the gradient window memory per chip, and no full-size gather.
    # The chain's per-micro-step `scale_by_world_size` (1/M, a function
    # of the MESH) is dropped; the commit applies the exact pow2 1/N
    # once.  The reduce-scatter's cross-rank summation order is
    # implementation-defined, so this composition's topology-invariance
    # contract is allclose, not bitwise (docs/elastic.md); same-world
    # kill/resume stays bitwise.
    bucket_grads: set = set()
    drop_scale_ids: set = set()
    fold_at: Dict[int, tuple] = {}  # anchor op id -> (ops, replaced, committed)
    if plan is not None:
        bucket_grads = {p["grad"] for b in plan.buckets
                        for p in b["params"]}
        by_bucket: Dict[str, List[OpDesc]] = {}
        for op in opt_ops:
            bn = op.attrs.get("zero_bucket")
            if bn:
                by_bucket.setdefault(bn, []).append(op)
        for b in plan.buckets:
            chain = by_bucket.get(b["name"], [])
            if not chain:
                raise ValueError(
                    f"elasticize: recorded ZeRO bucket {b['name']!r} "
                    "has no ops in the optimizer tail — plan and "
                    "program drifted apart")
            scale_op = next((o for o in chain
                             if o.type == "scale_by_world_size"), None)
            if scale_op is not None:
                drop_scale_ids.add(id(scale_op))
                fold_src = scale_op.inputs["X"][0]
                replaced = scale_op.outputs["Out"][0]
                anchor = scale_op
            else:
                fold_src = b["grad_shard"]
                replaced = b["grad_shard"]
                anchor = next(o for o in chain
                              if fold_src in o.output_names())
            acc = unique_name(b["name"] + "@ELASTIC_ACC")
            for blk in (block, sblock):
                v = blk.create_var(name=acc, shape=[b["padded_len"]],
                                   dtype=b["grad_dtype"],
                                   persistable=True, stop_gradient=True)
                v.attrs["dp_shard"] = int(plan.dp_degree)
            sblock.ops.append(OpDesc(
                "fill_constant", {}, {"Out": [acc]},
                {"shape": [b["padded_len"]], "value": 0.0,
                 "dtype": b["grad_dtype"],
                 "op_uid": startup._next_uid()}))
            folded = new_tmp_var(block, like=block.var(acc),
                                 name_hint=b["name"] + "@ELASTIC_FOLD")
            committed = new_tmp_var(block, like=block.var(acc),
                                    name_hint=b["name"] + "@ELASTIC_AVG")
            emit = [
                OpDesc("c_elastic_fold",
                       {"X": [fold_src], "Acc": [acc]},
                       {"Out": [folded]},
                       {"ring_id": 0, "logical_dp": n,
                        "pre_reduced": True,
                        "op_uid": program._next_uid(),
                        OpRole.KEY: OpRole.Optimize}),
                OpDesc("scale", {"X": [folded]}, {"Out": [committed]},
                       {"scale": 1.0 / n, "bias": 0.0,
                        "op_uid": program._next_uid(),
                        OpRole.KEY: OpRole.Optimize}),
            ]
            fold_at[id(anchor)] = (emit, replaced, committed)
            acc_names.append(acc)
            resets.append((acc, folded, True))

    grad_to_committed: Dict[str, str] = {}
    for p, g in pgs:
        gname = g.name if hasattr(g, "name") else str(g)
        if gname in grad_to_committed:
            continue
        if gname in bucket_grads:
            continue  # folded at the bucket-shard level instead
        gvar = block.var(gname)
        pvar = block.vars.get(p.name if hasattr(p, "name") else str(p))
        folded = _fold(gname, gvar, gname,
                       dist_attr=(pvar.attrs.get("dist_attr")
                                  if pvar is not None else None))
        committed = new_tmp_var(block, like=gvar,
                                name_hint=gname + "@ELASTIC_AVG")
        _op(program, block, "scale", {"X": [folded]}, {"Out": [committed]},
            {"scale": 1.0 / n, "bias": 0.0})
        grad_to_committed[gname] = committed

    loss_avg = None
    if loss_name is not None:
        lname = loss_name.name if hasattr(loss_name, "name") else \
            str(loss_name)
        lvar = block.var(lname)
        lfold = _fold(lname, lvar, lname)
        loss_avg = lname + "@ELASTIC_AVG"
        block.create_var(name=loss_avg, shape=list(lvar.shape or [1]),
                         dtype=lvar.dtype or "float32", stop_gradient=True)
        _op(program, block, "scale", {"X": [lfold]}, {"Out": [loss_avg]},
            {"scale": 1.0 / n, "bias": 0.0})

    # optimizer ops read the committed fold and commit through the mask;
    # `rename` keeps intra-group dataflow on the fresh @MASKED temps
    tail: List[OpDesc] = []
    rename: Dict[str, str] = {}

    def _emit_fold(entry):
        emit, replaced, committed = entry
        for fop in emit:
            # the fold's X is a chain temp the masking loop may have
            # renamed — read the fresh value, not the stale var
            for slot, names in fop.inputs.items():
                fop.inputs[slot] = [rename.get(nm, nm) for nm in names]
            block.ops.append(fop)
        rename[replaced] = committed

    for op in opt_ops:
        if id(op) in drop_scale_ids:
            # the per-micro-step 1/M scale is replaced by the window
            # fold + exact 1/N commit scale, emitted in its place
            _emit_fold(fold_at.pop(id(op)))
            continue
        entry = fold_at.pop(id(op), None)
        for slot, names in op.inputs.items():
            op.inputs[slot] = [
                rename.get(grad_to_committed.get(nm, nm),
                           grad_to_committed.get(nm, nm))
                for nm in names]
        retarget_op_outputs_masked(program, op, mask, tail, rename)
        block.ops.append(op)
        if entry is not None:  # scale-less chain: fold after the rs
            _emit_fold(entry)
    block.ops.extend(tail)

    # accumulators reset on commit so the next window folds from zero
    for acc, folded, sharded in resets:
        zeros = new_tmp_var(block, like=block.var(acc),
                            name_hint=acc + "@ZERO")
        if sharded:
            # dp_shard accumulators are declared at the GLOBAL padded
            # shape but trace their 1/world slice under shard_map —
            # the zeros must follow the runtime shape
            _op(program, block, "fill_zeros_like", {"X": [acc]},
                {"Out": [zeros]}, {"dtype": block.var(acc).dtype})
        else:
            _op(program, block, "fill_constant", {}, {"Out": [zeros]},
                {"shape": list(block.var(acc).shape or [1]), "value": 0.0,
                 "dtype": block.var(acc).dtype})
        _op(program, block, "where",
            {"Condition": [mask], "X": [zeros], "Y": [folded]},
            {"Out": [acc]})

    program._fingerprint_cache = None
    startup._fingerprint_cache = None
    meta = {"logical_dp": n, "counter": counter, "loss_avg": loss_avg,
            "accs": acc_names, "version": 1,
            # ZeRO-1 composition marker: sharded-bucket reductions trade
            # the bitwise cross-topology contract for allclose (verifier
            # V206 exempts the stamped reduce-scatters off this)
            "zero_stage1": plan is not None}
    program._elastic_meta = meta
    from ..core.pass_framework import finish_pass
    finish_pass(program, "elastic", startup=startup, logical_dp=n)
    return meta


def rebucket_feeds(feed: dict, logical_dp: int, world: int,
                   batch_rows: Optional[int] = None) -> List[dict]:
    """Split one GLOBAL-batch feed dict (N·b rows) into the K = N/M
    micro-step feeds an M-device mesh consumes: micro-step j carries the
    rows of logical ranks jM .. jM+M-1, which is simply the next M·b-row
    slice — the same row order every topology sees.

    Feeds carrying the batch axis are split; everything else (lr
    scalars, lookup tables, replicated vectors) rides every micro-step
    whole.  The batch axis is `batch_rows` when given; otherwise the
    leading dim SHARED BY MOST feeds (a lone big table must not hijack
    row detection), and an ambiguous tie raises — pass batch_rows=
    explicitly.  A non-divisible batch FAILS rather than being silently
    replicated K times (duplicated data, wrong loss scale)."""
    k = int(logical_dp) // int(world)
    if int(logical_dp) % int(world) != 0 or k < 1:
        raise ValueError(
            f"world {world} does not divide logical_dp {logical_dp}")
    if k == 1:
        return [dict(feed)]
    arrays = {name: np.asarray(arr) for name, arr in feed.items()}
    if batch_rows is not None:
        rows = int(batch_rows)
    else:
        counts: Dict[int, int] = {}
        for a in arrays.values():
            if a.ndim >= 1:
                counts[a.shape[0]] = counts.get(a.shape[0], 0) + 1
        if not counts:
            rows = 0
        else:
            best = max(counts.values())
            modes = sorted(d for d, c in counts.items() if c == best)
            if len(modes) > 1:
                raise ValueError(
                    f"ambiguous batch axis: leading dims {modes} are "
                    f"equally common across feeds — pass batch_rows= "
                    "to rebucket_feeds")
            rows = modes[0]
    micro = [dict() for _ in range(k)]
    for name, a in arrays.items():
        if a.ndim >= 1 and rows > 0 and a.shape[0] == rows:
            if rows % k != 0:
                raise ValueError(
                    f"feed {name!r} carries {rows} global-batch rows, "
                    f"not divisible into K={k} micro-steps — elastic "
                    f"global batches must be logical_dp·b rows "
                    f"(logical_dp={logical_dp})")
            for j, part in enumerate(np.split(a, k, axis=0)):
                micro[j][name] = part
        else:
            for j in range(k):
                micro[j][name] = a
    return micro


def _world_now() -> int:
    """The world of this process: its process group's size (1 off one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def reanchor_topology(executor, program, scope, world: Optional[int] = None
                      ) -> int:
    """Re-anchor an elastic program's schedule for the world this
    process's group has WITHOUT a checkpoint round-trip (a relaunched
    process gets the same treatment from
    ``Executor.restore_from_checkpoint``).

    Re-derives the executor micro-step and the persistable micro counter
    for the new K, and zeroes partially-folded accumulators when the
    position was mid-window (that window replays).  Returns the global
    step.  One process a rank: `world` (default: the process group's
    size) must be the world this process runs in — a process cannot
    change its world, so another `world` raises; a world change is a
    relaunch plus ``restore_from_checkpoint(..., world=M)``."""
    import torch
    meta = elastic_meta(program)
    if meta is None:
        raise ValueError("reanchor_topology needs an elasticized program")
    now = _world_now()
    if world is None:
        world = now
    if int(world) != now:
        raise ValueError(
            f"reanchor_topology: this process runs in a world of {now} "
            f"rank(s) and cannot re-anchor to {world}: one process is one "
            "rank, and a world change is a relaunch (launch --elastic) "
            "that restores with Executor.restore_from_checkpoint(..., "
            f"world={world})")
    k_old = max(1, int(getattr(executor, "_last_elastic_k", 1)))
    g, j = divmod(int(getattr(executor, "_elastic_steps",
                              executor._step)), k_old)
    if j:
        warnings.warn(
            f"elastic topology shift mid-window (micro {j}/{k_old}): "
            f"rounding down to global step {g}; the partial window "
            "replays", RuntimeWarning, stacklevel=2)
    k_new = micro_steps_per_global(program, world)
    executor._step = g * k_new
    executor._elastic_steps = g * k_new
    executor._last_elastic_k = k_new
    executor._last_elastic_world = int(world)
    cnt = scope.get(meta["counter"])
    scope.set(meta["counter"], torch.full(
        (1,), g * k_new, dtype=torch.int32,
        device=cnt.device if cnt is not None else None))
    if j:
        for acc in meta["accs"]:
            v = scope.get(acc)
            if v is not None:
                scope.set(acc, torch.zeros_like(v))
    if executor._ckpt is not None:
        # periodic-checkpoint cadence is denominated in micro-steps too
        executor._ckpt.last = executor._step
    from ..observability.journal import emit as _jemit
    _jemit("reanchor", world=int(world), k=int(k_new), global_step=int(g),
           replayed_micro=int(j))
    return g


def rederive_schedule(extra: dict, new_world: int) -> Optional[dict]:
    """Map a checkpoint's elastic schedule position onto `new_world`.

    The sidecar's ``extra["elastic"]`` records the logical world N and
    the micro-step denominator K_old the checkpoint was written under.
    Returns the re-derived positions (all denominated for K_new):

      * ``executor_step`` — micro-step count to restore into the
        executor so per-global-step derived RNG seeds replay;
      * ``counter_value`` — value for the persistable micro counter;
      * ``global_batches_consumed`` — how many GLOBAL batches the data
        pipeline should skip (feed re-bucketing happens on top with
        `rebucket_feeds`);
      * ``replayed_micro`` — nonzero when the checkpoint was taken
        mid-accumulation-window: the position is rounded DOWN to the
        window start and the partially-folded accumulators must be
        zeroed (the window replays; the committed trace is unaffected).

    Returns None when the checkpoint has no elastic sidecar."""
    el = (extra or {}).get("elastic")
    if not el:
        return None
    n = int(el["logical_dp"])
    k_old = max(1, int(el.get("k", 1)))
    if int(new_world) < 1 or n % int(new_world) != 0:
        raise ValueError(
            f"cannot resume an elastic logical_dp={n} job on "
            f"{new_world} devices (must divide the logical world)")
    k_new = n // int(new_world)
    # the program's own micro counter is authoritative (the executor step
    # also counts startup/eval runs); fall back for older sidecars
    step_old = int(el.get("counter_value",
                          extra.get("executor_step", 0)))
    g, j = divmod(step_old, k_old)
    if j:
        warnings.warn(
            f"elastic resume from a mid-window checkpoint (micro "
            f"{j}/{k_old}): rounding down to global step {g}; the "
            "partial window replays and its accumulators are reset",
            RuntimeWarning, stacklevel=3)
    return {"logical_dp": n, "k_new": k_new, "global_step": g,
            "executor_step": g * k_new, "counter_value": g * k_new,
            "global_batches_consumed": g, "replayed_micro": j}


# -- a launched trainer (port-only) -----------------------------------------
class LaunchedRank:
    """A trainer that ``launch --elastic`` or ``launch --fleet_dir``
    started: where it stands, read from the launcher's env contract, and
    the resume, checkpoint and train loop every such trainer runs.

    One process is one rank, so a world change is a relaunch: the new
    incarnation restores the newest checkpoint at its own world
    (``restore_from_checkpoint(..., world=)``, rank-merged where the
    writers' world differs) and goes on from that global step.

    * ``launch --elastic`` (no fleet env): rank PADDLE_TRAINER_ID of a
      world of PADDLE_TRAINERS_NUM ranks; the world's ranks write the
      checkpoints and meet at ``torch.distributed.barrier``;
      ``endpoint`` is the world's rendezvous.
    * ``launch --fleet_dir``: each host trains the whole schedule on its
      own rank (world 1) and the hosts write the checkpoints, meeting at
      the fleet barrier; the restore step is the one the fleet agreed
      on; ``endpoint`` is this rank's own (a group of one).

    ``tag`` names the incarnation: ``rank<r>_r<restart>`` or
    ``host<h>_e<epoch>``.  The caller forms its process group (the
    backend is its choice) before ``resume``."""

    def __init__(self, barrier_timeout_s: float = 120.0):
        import os
        from .fleet_control import fleet_env
        from .parallel_env import ParallelEnv
        penv = ParallelEnv()
        self.fleet = fleet_env()
        self.restart = int(os.environ.get("PADDLE_TPU_ELASTIC_RESTART", "0"))
        self.device_id = penv.device_id
        fl = self.fleet
        if fl is not None:
            self.rank, self.writers, self.world = fl.rank, fl.n_hosts, 1
            self.barrier = (fl.barrier(timeout_s=barrier_timeout_s)
                            if fl.n_hosts > 1 else None)
            self.restore_step = fl.restore_step
            self.tag = f"host{fl.host}_e{fl.epoch}"
            self.endpoint = penv.current_endpoint
        else:
            self.rank, self.world = penv.rank, penv.world_size
            self.writers = self.world
            self.barrier = _group_barrier if self.world > 1 else None
            self.restore_step = None
            self.tag = f"rank{self.rank}_r{self.restart}"
            self.endpoint = penv.trainer_endpoints[0]

    def checkpoint_manager(self, directory: str, keep_last_n: int,
                           cls=None):
        """A `cls` (default CheckpointManager) for this rank among the
        writers, saving a final checkpoint on SIGTERM / SIGINT."""
        if cls is None:
            from ..checkpoint import CheckpointManager as cls
        mgr = cls(directory, keep_last_n=keep_last_n, rank=self.rank,
                  world_size=self.writers)
        mgr.install_preemption_handler()
        return mgr

    def resume(self, executor, manager, program, scope,
               restore_program=None) -> int:
        """Checkpoint `program` (elasticized) every global step of this
        world through `manager`, restore the newest checkpoint (the fleet's
        agreed step under a fleet) into `scope` at this world, and return
        the global step to go on from (0 when there was none).
        `restore_program` (e.g. the CompiledProgram) defaults to
        `program`."""
        executor.enable_checkpointing(
            manager, program=program,
            every_n_steps=micro_steps_per_global(program, self.world),
            scope=scope, barrier=self.barrier)
        restored = executor.restore_from_checkpoint(
            manager, program=program if restore_program is None
            else restore_program, scope=scope, world=self.world,
            step=self.restore_step)
        if restored is None:
            return 0
        return int(executor.last_restored_extra.get("global_step", 0))

    def train(self, run, feeds: List[dict], logical_dp: int, start: int,
              on_global_step) -> None:
        """Global steps `start` .. len(feeds) - 1: each global batch cut
        into this rank's micro-batches (`rebucket_feeds`), each through
        `run(micro_feed)` (the executor's run, returning the fetches with
        the folded loss first); `on_global_step(g, loss)` after each."""
        for g in range(start, len(feeds)):
            for mf in rebucket_feeds(feeds[g], logical_dp, self.world):
                out = run(mf)
            on_global_step(g, float(np.asarray(out[0]).reshape(-1)[0]))


def _group_barrier():
    import torch.distributed as dist
    dist.barrier()
