"""Gradient merge (accumulation): `apply_gradient_merge`.

Counterpart of paddle_tpu/distributed/fleet/meta_optimizers/
gradient_merge_optimizer.py.  Gradients accumulate in persistable
buffers every step; the optimizer ops run every step into temps and a
`where(mask, ...)` commits their persistable outputs on the k-th step
(rewrite_utils), which also resets the accumulators.  The program stays
straight-line, so it runs the same eagerly and as the CUDA graph that
`Executor.run_steps` replays.

`GradientMergeOptimizer` is fleet's strategy-driven wrapper
(strategy.gradient_merge, k_steps > 1).  Not ported: the ZeRO-2/3
composition (accumulating the reduce-scattered bucket shard, which needs
the sharding rewrite; ROADMAP.md Queue 1, Distribution).
"""
from __future__ import annotations

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
    plan = getattr(program, "_zero_shard_plan", None)
    if plan is not None and getattr(plan, "stage", 1) >= 2:
        raise NotImplementedError(
            "gradient_merge over a ZeRO stage >= 2 program accumulates the "
            "reduce-scattered shards, which needs the sharding rewrite of "
            "the distribution slice (ROADMAP.md Queue 1, Distribution)")
    block = program.global_block()
    opt_start = next((i for i, op in enumerate(block.ops)
                      if op.op_role == OpRole.Optimize), len(block.ops))
    opt_ops = block.ops[opt_start:]
    block.ops = block.ops[:opt_start]

    mask = append_masked_step_counter(program, startup, k_steps, prefix="gm")

    grad_to_avg = {}   # grad name -> merged (avg) grad fed to optimizer ops
    grad_to_acc = {}   # grad name -> persistable accumulator
    for p, g in params_grads:
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
        # acc += g every step; the averaging scale is commit work
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

    # optimizer ops: read merged grads, commit only on masked steps.
    # `rename` keeps intra-group dataflow intact: later ops read the fresh
    # @MASKED temps of earlier ops in the group, not the stale vars.
    tail = []
    rename = {}
    for op in opt_ops:
        for slot, names in op.inputs.items():
            op.inputs[slot] = [rename.get(grad_to_avg.get(n, n),
                                          grad_to_avg.get(n, n))
                               for n in names]
        retarget_op_outputs_masked(program, op, mask, tail, rename)
        op.attrs.setdefault("gm_role", "tail")
        block.ops.append(op)
    for sel in tail:
        sel.attrs.setdefault("gm_role", "tail")
    block.ops.extend(tail)

    program._gm_meta = {"counter": program._last_masked_counter,
                        "k": int(k_steps),
                        "accs": sorted(grad_to_acc.values())}

    # reset accumulators on masked steps: acc = where(mask, 0, acc)
    for acc in grad_to_acc.values():
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
                k=int(k_steps), zero_stage=0)
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
