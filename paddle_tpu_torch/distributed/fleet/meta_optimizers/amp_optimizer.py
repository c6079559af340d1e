"""AMP meta-optimizer: the inner optimizer under `amp.decorate` with the
strategy's amp_configs (bf16 by default).  Counterpart of
paddle_tpu/distributed/fleet/meta_optimizers/amp_optimizer.py."""
from __future__ import annotations

from .meta_optimizer_base import MetaOptimizerBase

__all__ = ["AMPOptimizer"]


class AMPOptimizer(MetaOptimizerBase):
    _incompatible = ("DGCOptimizer", "LambOptimizer", "LarsOptimizer")

    def _can_apply(self):
        return bool(self.user_defined_strategy.amp)

    def _disable_strategy(self, dist_strategy):
        dist_strategy.amp = False

    def _wrapped(self):
        from ....amp import decorate, AutoMixedPrecisionLists
        c = self.user_defined_strategy.amp_configs
        lists = AutoMixedPrecisionLists(
            c.get("custom_white_list") or None,
            c.get("custom_black_list") or None,
            c.get("custom_black_varnames") or None)
        return decorate(
            self.inner_opt, amp_lists=lists,
            init_loss_scaling=c.get("init_loss_scaling", 32768.0),
            incr_every_n_steps=c.get("incr_every_n_steps", 1000),
            decr_every_n_nan_or_inf=c.get("decr_every_n_nan_or_inf", 2),
            incr_ratio=c.get("incr_ratio", 2.0),
            decr_ratio=c.get("decr_ratio", 0.8),
            use_dynamic_loss_scaling=c.get("use_dynamic_loss_scaling", True),
            dest_dtype=c.get("dtype", "bfloat16"))

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        return self._wrapped().minimize(loss, startup_program,
                                        parameter_list, no_grad_set)
