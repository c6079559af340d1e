"""Meta-optimizer registry and selection order.

Counterpart of paddle_tpu/distributed/fleet/base/meta_optimizer_factory.py,
the same chain, inner to outer: the optimizer-replacing ones (lars,
lamb, dgc) innermost, then the program rewrites (recompute, amp,
fp16_allreduce), the ZeRO sharding (which raises: not ported), the
post-minimize rewrites (gradient_merge, localsgd) and
GraphExecutionOptimizer outermost.
"""
from __future__ import annotations

from ..meta_optimizers import (
    AMPOptimizer, RecomputeOptimizer, GradientMergeOptimizer,
    LocalSGDOptimizer, AdaptiveLocalSGDOptimizer, LarsOptimizer,
    LambOptimizer, DGCOptimizer, FP16AllReduceOptimizer,
    ShardingOptimizer, GraphExecutionOptimizer,
)

__all__ = ["MetaOptimizerFactory", "meta_optimizer_names"]

# inner -> outer application order
_META_OPTIMIZERS = [
    LarsOptimizer,
    LambOptimizer,
    DGCOptimizer,
    RecomputeOptimizer,
    AMPOptimizer,
    FP16AllReduceOptimizer,
    ShardingOptimizer,
    GradientMergeOptimizer,
    LocalSGDOptimizer,
    AdaptiveLocalSGDOptimizer,
    GraphExecutionOptimizer,
]


def meta_optimizer_names():
    return [cls.__name__ for cls in _META_OPTIMIZERS]


class MetaOptimizerFactory:
    def _get_valid_meta_optimizers(self, user_defined_optimizer):
        return [cls(user_defined_optimizer) for cls in _META_OPTIMIZERS]
