"""ZeRO sharding meta-optimizer (strategy.sharding): not ported yet.

Counterpart of paddle_tpu/distributed/fleet/meta_optimizers/
sharding_optimizer.py, which rewrites the program with the JAX
package's distributed/sharding.py (bucketed reduce-scatter, sharded
update, all-gather).  That rewrite is the next distribution slice
(ROADMAP.md Queue 1, Distribution): with `strategy.sharding` set,
minimize raises.  Its place in the chain and its incompatibilities are
the JAX package's, so the other strategies resolve as there.
"""
from __future__ import annotations

from .meta_optimizer_base import MetaOptimizerBase

__all__ = ["ShardingOptimizer"]


class ShardingOptimizer(MetaOptimizerBase):
    _incompatible = ("LocalSGDOptimizer", "AdaptiveLocalSGDOptimizer",
                     "DGCOptimizer")

    def _can_apply(self):
        return bool(getattr(self.user_defined_strategy, "sharding", False))

    def _disable_strategy(self, dist_strategy):
        dist_strategy.sharding = False

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        raise NotImplementedError(
            "DistributedStrategy.sharding (ZeRO) is not ported yet "
            "(ROADMAP.md Queue 1, Distribution)")
