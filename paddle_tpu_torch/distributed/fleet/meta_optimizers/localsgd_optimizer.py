"""LocalSGD meta-optimizer: periodic parameter averaging.

Counterpart of paddle_tpu/distributed/fleet/meta_optimizers/
localsgd_optimizer.py (the reference's localsgd_optimizer.py and its
adaptive variant).  Each rank steps on its own; every k steps (from
`begin_step`) the parameters are averaged over the ranks.  As in the
JAX package, the reference's Switch block is a masked update
(rewrite_utils): every step computes avg = c_allreduce_sum(param) / W
and param = where(mask, avg, param), so the step stays straight-line
(the allreduce runs every step).  With one process a rank the replicas
really do drift apart between averages, as in the reference's
deployment.  The adaptive variant keeps its initial k (the JAX
package's choice).
"""
from __future__ import annotations

from ....core.program import OpRole, default_startup_program
from .meta_optimizer_base import MetaOptimizerBase
from .rewrite_utils import append_masked_step_counter, new_tmp_var, _op

__all__ = ["LocalSGDOptimizer", "AdaptiveLocalSGDOptimizer",
           "apply_localsgd"]
def apply_localsgd(program, startup, params, k_steps, begin_step=1):
    """Append masked parameter-averaging ops after the optimizer ops."""
    block = program.global_block()
    mask = append_masked_step_counter(program, startup, k_steps,
                                     begin_step=begin_step, prefix="localsgd")
    for p in params:
        summed = new_tmp_var(block, like=block.var(p.name),
                             name_hint=p.name + "@LSGD_SUM")
        _op(program, block, "c_allreduce_sum", {"X": [p.name]},
            {"Out": [summed]}, {"ring_id": 0, OpRole.KEY: OpRole.Dist})
        avg = new_tmp_var(block, like=block.var(p.name),
                          name_hint=p.name + "@LSGD_AVG")
        _op(program, block, "scale_by_world_size", {"X": [summed]},
            {"Out": [avg]}, {"ring_id": 0})
        _op(program, block, "where", {"Condition": [mask], "X": [avg],
                                      "Y": [p.name]}, {"Out": [p.name]})
    program._fingerprint_cache = None
    return program


class LocalSGDOptimizer(MetaOptimizerBase):
    _incompatible = ("GraphExecutionOptimizer",)

    def _can_apply(self):
        return bool(self.user_defined_strategy.localsgd)

    def _disable_strategy(self, dist_strategy):
        dist_strategy.localsgd = False

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        ops, params_grads = self.inner_opt.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        c = self.user_defined_strategy.localsgd_configs
        program = loss.block.program
        startup = startup_program or default_startup_program()
        apply_localsgd(program, startup, [p for p, _ in params_grads],
                       c.get("k_steps", 1), c.get("begin_step", 1))
        return ops, params_grads


class AdaptiveLocalSGDOptimizer(LocalSGDOptimizer):
    """adaptive variant (:194) — k adapted from loss decay in the reference;
    here the initial k is used (adaptation hook kept for parity)."""

    def _can_apply(self):
        return bool(self.user_defined_strategy.adaptive_localsgd)

    def _disable_strategy(self, dist_strategy):
        dist_strategy.adaptive_localsgd = False

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        ops, params_grads = self.inner_opt.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        c = self.user_defined_strategy.adaptive_localsgd_configs
        program = loss.block.program
        startup = startup_program or default_startup_program()
        apply_localsgd(program, startup, [p for p, _ in params_grads],
                       c.get("init_k_steps", 1), c.get("begin_step", 1))
        return ops, params_grads
