"""Recompute meta-optimizer: `static.RecomputeOptimizer` at the
strategy's checkpoints.  Counterpart of
paddle_tpu/distributed/fleet/meta_optimizers/recompute_optimizer.py."""
from __future__ import annotations

from .meta_optimizer_base import MetaOptimizerBase

__all__ = ["RecomputeOptimizer"]


class RecomputeOptimizer(MetaOptimizerBase):
    def _can_apply(self):
        s = self.user_defined_strategy
        return bool(s.recompute) and \
            len(s.recompute_configs.get("checkpoints", [])) > 0

    def _disable_strategy(self, dist_strategy):
        dist_strategy.recompute = False
        dist_strategy.recompute_configs = {"checkpoints": []}

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        from ....static.optimizer import RecomputeOptimizer as FluidRecompute
        wrapped = FluidRecompute(self.inner_opt)
        wrapped._set_checkpoints(
            list(self.user_defined_strategy.recompute_configs["checkpoints"]))
        return wrapped.minimize(loss, startup_program, parameter_list,
                                no_grad_set)
