"""LAMB meta-optimizer: an Adam optimizer becomes Lamb with the
strategy's lamb_configs.  Counterpart of
paddle_tpu/distributed/fleet/meta_optimizers/lamb_optimizer.py."""
from __future__ import annotations

from .meta_optimizer_base import MetaOptimizerBase

__all__ = ["LambOptimizer"]


class LambOptimizer(MetaOptimizerBase):
    def _can_apply(self):
        if not self.user_defined_strategy.lamb:
            return False
        from ....static.optimizer import AdamOptimizer
        return isinstance(self.user_defined_optimizer, AdamOptimizer)

    def _disable_strategy(self, dist_strategy):
        dist_strategy.lamb = False

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        from ....static.optimizer import LambOptimizer as FluidLamb
        inner = self.user_defined_optimizer
        c = self.user_defined_strategy.lamb_configs
        exclude = c.get("exclude_from_weight_decay", [])

        def exclude_fn(param_name):
            return any(e in param_name for e in exclude)

        opt = FluidLamb(
            learning_rate=inner._learning_rate,
            lamb_weight_decay=c.get("lamb_weight_decay", 0.01),
            beta1=getattr(inner, "_beta1", 0.9),
            beta2=getattr(inner, "_beta2", 0.999),
            epsilon=getattr(inner, "_epsilon", 1e-6),
            exclude_from_weight_decay_fn=exclude_fn if exclude else None,
            parameter_list=inner._parameter_list,
            regularization=inner._regularization,
            grad_clip=inner._grad_clip)
        return opt.minimize(loss, startup_program, parameter_list,
                            no_grad_set)
