"""Gradient merge (accumulation): `apply_gradient_merge`.

Counterpart of paddle_tpu/distributed/fleet/meta_optimizers/
gradient_merge_optimizer.py.  Gradients accumulate in persistable
buffers every step; the optimizer ops run every step into temps and a
`where(mask, ...)` commits their persistable outputs on the k-th step
(rewrite_utils), which also resets the accumulators.  The program stays
straight-line, so it runs the same eagerly and as the CUDA graph that
`Executor.run_steps` replays.

ZeRO-2/3 composition (distributed/sharding.py stage >= 2): instead of
full-size per-param accumulators, the bucket gradient is accumulated
after its reduce-scatter, in a ``dp_shard`` persistable that each rank
holds 1/N of; only the update/publish tail is masked.  Where an
interposed rewrite (grad clip, AMP unscale) renamed the raw gradients
the buckets read, it falls back to the full-size accumulators with a
warning, as the JAX package does.

`GradientMergeOptimizer` is fleet's strategy-driven wrapper
(strategy.gradient_merge, k_steps > 1).
"""
from __future__ import annotations

import warnings as _warnings

from ....core.program import OpDesc, OpRole, default_startup_program, \
    unique_name
from .meta_optimizer_base import MetaOptimizerBase
from .rewrite_utils import (append_masked_step_counter,
                            retarget_op_outputs_masked, new_tmp_var, _op)

__all__ = ["GradientMergeOptimizer", "apply_gradient_merge"]


def apply_gradient_merge(program, startup, params_grads, k_steps, avg=True):
    """Rewrite the already-minimized `program` for k-step accumulation."""
    from ....core.pass_framework import finish_pass, has_applied
    if getattr(program, "_gm_meta", None) is not None or \
            has_applied(program, "gradient_merge"):
        # a second application would stack a second counter/mask over the
        # first's @MASKED temps: accumulators of accumulators, committing
        # every k² steps — refuse instead of silently double-masking
        raise ValueError(
            "gradient_merge already applied to this program (see the "
            "applied-passes registry, core/pass_framework.py)")
    block = program.global_block()
    opt_start = next((i for i, op in enumerate(block.ops)
                      if op.op_role == OpRole.Optimize), len(block.ops))
    opt_ops = block.ops[opt_start:]
    block.ops = block.ops[:opt_start]

    # ZeRO-2/3: accumulate the reduce-scattered bucket shard at 1/N
    # instead of full-size per-param grads.  Only sound when the bucket
    # consumes the RAW backward gradients — an interposed rewrite (grad
    # clip, AMP unscale) between backward and the bucket means every
    # micro-step's value is a function of the partial average, and
    # accumulating downstream of it would change the math; fall back to
    # the classic full-size path there (stage 2 degrades to stage 1's
    # accumulation with a warning, numerics first).
    plan = getattr(program, "_zero_shard_plan", None)
    shard_acc = bool(plan is not None and getattr(plan, "stage", 1) >= 2
                     and getattr(plan, "buckets", None))
    bucket_grads = set()
    if shard_acc:
        bucket_grads = {p["grad"] for b in plan.buckets
                        for p in b["params"]}
        raw_grads = {g.name for _p, g in params_grads}
        if not bucket_grads <= raw_grads:
            _warnings.warn(
                "gradient_merge: ZeRO stage>=2 sharded accumulation "
                "needs the gradient buckets to consume raw backward "
                "gradients, but an interposed rewrite (grad clip / AMP "
                "unscale) renamed them — falling back to full-size "
                "per-param accumulators (stage-1 memory behaviour, "
                "identical numerics)", RuntimeWarning, stacklevel=3)
            shard_acc = False
            bucket_grads = set()

    mask = append_masked_step_counter(program, startup, k_steps, prefix="gm")

    grad_to_avg = {}   # grad name -> merged (avg) grad fed to optimizer ops
    grad_to_acc = {}   # grad name -> persistable accumulator
    for p, g in params_grads:
        if g.name in bucket_grads:
            continue  # accumulated post-reduce-scatter at 1/N instead
        acc = unique_name(g.name + "@GradientMerge")
        block.create_var(name=acc, shape=g.shape, dtype=g.dtype,
                         persistable=True, stop_gradient=True)
        sb = startup.global_block()
        sb.create_var(name=acc, shape=g.shape, dtype=g.dtype,
                      persistable=True, stop_gradient=True)
        sb.ops.append(OpDesc("fill_constant", {}, {"Out": [acc]},
                             {"shape": list(g.shape or [1]), "value": 0.0,
                              "dtype": g.dtype,
                              "op_uid": startup._next_uid()}))
        # acc += g   (every step — gm_role "accumulate" keeps it in the
        # scan BODY under the commit-tail hoist; the averaging scale is
        # commit work, only meaningful on the k-th step)
        _op(program, block, "elementwise_add", {"X": [acc], "Y": [g.name]},
            {"Out": [acc]}, {"gm_role": "accumulate"})
        if avg:
            avg_name = new_tmp_var(block, like=block.var(g.name),
                                   name_hint=g.name + "@GM_AVG")
            _op(program, block, "scale", {"X": [acc]}, {"Out": [avg_name]},
                {"scale": 1.0 / k_steps, "bias": 0.0, "gm_role": "tail"})
        else:
            avg_name = acc
        grad_to_avg[g.name] = avg_name
        grad_to_acc[g.name] = acc

    def _append_shard_accumulate(gshard, bucket):
        """sacc += grad_shard every step; the update reads sacc/k.  The
        accumulator is declared at the GLOBAL padded bucket shape and
        marked dp_shard — each rank holds (and donates) 1/N of it."""
        sacc = unique_name(bucket["name"] + "@GSHARD_ACC")
        sb = startup.global_block()
        for blk in (block, sb):
            v = blk.create_var(name=sacc, shape=[bucket["padded_len"]],
                               dtype=bucket["grad_dtype"],
                               persistable=True, stop_gradient=True)
            v.attrs["dp_shard"] = int(plan.dp_degree)
        sb.ops.append(OpDesc(
            "fill_constant", {}, {"Out": [sacc]},
            {"shape": [bucket["padded_len"]], "value": 0.0,
             "dtype": bucket["grad_dtype"],
             "op_uid": startup._next_uid()}))
        _op(program, block, "elementwise_add",
            {"X": [sacc], "Y": [gshard]}, {"Out": [sacc]},
            {"gm_role": "accumulate"})
        if avg:
            avg_name = new_tmp_var(block, like=block.var(sacc),
                                   name_hint=bucket["name"] + "@GM_AVG")
            _op(program, block, "scale", {"X": [sacc]},
                {"Out": [avg_name]}, {"scale": 1.0 / k_steps, "bias": 0.0,
                                      "gm_role": "tail"})
        else:
            avg_name = sacc
        return sacc, avg_name

    # optimizer ops: read merged grads, commit only on masked steps.
    # `rename` keeps intra-group dataflow intact: later ops read the fresh
    # @MASKED temps of earlier ops in the group, not the stale vars.
    tail = []
    rename = {}
    shard_accs = []
    if shard_acc:
        # stage>=2: the bucket reduce-scatters are interleaved in
        # BACKWARD (before the optimizer split), so the per-step shard
        # is already live here — accumulate it at the head of the
        # optimizer region and point the bucket update at the merged
        # shard instead of this step's
        for bucket in plan.buckets:
            gs = bucket.get("grad_shard")
            if not gs:
                continue
            sacc, avg_name = _append_shard_accumulate(gs, bucket)
            shard_accs.append(sacc)
            rename[gs] = avg_name
    for op in opt_ops:
        for slot, names in op.inputs.items():
            op.inputs[slot] = [rename.get(grad_to_avg.get(n, n),
                                          grad_to_avg.get(n, n))
                               for n in names]
        retarget_op_outputs_masked(program, op, mask, tail, rename)
        # the masked optimizer group only DOES anything on the k-th
        # step — the commit-tail hoist (distributed/scan_window.py)
        # moves it out of the scan body, so the update (and the
        # stage-1/2 publish allgather riding in it) runs once per
        # window instead of K times
        op.attrs.setdefault("gm_role", "tail")
        block.ops.append(op)
    for sel in tail:
        sel.attrs.setdefault("gm_role", "tail")
    block.ops.extend(tail)

    # record what a topology-shifted resume must re-derive: the counter
    # (re-denominated to the new k), and the accumulators (zeroed when a
    # partial window is rounded down) — static/executor.py
    # restore_from_checkpoint reads this meta from both sides
    program._gm_meta = {"counter": program._last_masked_counter,
                        "k": int(k_steps),
                        "accs": sorted(list(grad_to_acc.values()) +
                                       shard_accs)}

    # reset accumulators on masked steps: acc = where(mask, 0, acc).
    # fill_zeros_like, not fill_constant with the declared shape: a
    # dp_shard accumulator is declared at the GLOBAL padded shape but
    # each rank traces its 1/N slice under shard_map — the zeros must
    # follow the runtime shape
    for acc in list(grad_to_acc.values()) + shard_accs:
        zeros = new_tmp_var(block, like=block.var(acc),
                            name_hint=acc + "@ZERO")
        _op(program, block, "fill_zeros_like", {"X": [acc]},
            {"Out": [zeros]}, {"dtype": block.var(acc).dtype,
                               "gm_role": "tail"})
        _op(program, block, "where", {"Condition": [mask], "X": [zeros],
                                      "Y": [acc]}, {"Out": [acc]},
            {"gm_role": "tail"})
    program._fingerprint_cache = None
    finish_pass(program, "gradient_merge", startup=startup,
                k=int(k_steps), zero_stage=(getattr(plan, "stage", 0)
                                            if shard_acc else 0))
    return program, mask


class GradientMergeOptimizer(MetaOptimizerBase):
    def _can_apply(self):
        s = self.user_defined_strategy
        return bool(s.gradient_merge) and \
            s.gradient_merge_configs.get("k_steps", 1) > 1

    def _disable_strategy(self, dist_strategy):
        dist_strategy.gradient_merge = False

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        ops, params_grads = self.inner_opt.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        c = self.user_defined_strategy.gradient_merge_configs
        program = loss.block.program
        startup = startup_program or default_startup_program()
        apply_gradient_merge(program, startup, params_grads,
                             c.get("k_steps", 2), c.get("avg", True))
        return ops, params_grads
