"""LARS meta-optimizer: a Momentum optimizer becomes LarsMomentum with
the strategy's lars_configs.  Counterpart of
paddle_tpu/distributed/fleet/meta_optimizers/lars_optimizer.py."""
from __future__ import annotations

from .meta_optimizer_base import MetaOptimizerBase

__all__ = ["LarsOptimizer"]


class LarsOptimizer(MetaOptimizerBase):
    def _can_apply(self):
        if not self.user_defined_strategy.lars:
            return False
        from ....static.optimizer import MomentumOptimizer
        return isinstance(self.user_defined_optimizer, MomentumOptimizer)

    def _disable_strategy(self, dist_strategy):
        dist_strategy.lars = False

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        from ....static.optimizer import LarsMomentumOptimizer
        inner = self.user_defined_optimizer
        c = self.user_defined_strategy.lars_configs
        opt = LarsMomentumOptimizer(
            learning_rate=inner._learning_rate,
            momentum=getattr(inner, "_momentum", 0.9),
            lars_coeff=c.get("lars_coeff", 0.001),
            lars_weight_decay=c.get("lars_weight_decay", 0.0005),
            parameter_list=inner._parameter_list,
            regularization=inner._regularization,
            grad_clip=inner._grad_clip)
        return opt.minimize(loss, startup_program, parameter_list,
                            no_grad_set)
