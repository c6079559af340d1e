"""Meta-optimizers: the DistributedStrategy-driven program rewrites of
fleet (counterpart of paddle_tpu/distributed/fleet/meta_optimizers/),
chained by fleet/base/strategy_compiler.py; `apply_gradient_merge` and
`apply_localsgd` are also callable on their own."""
from .meta_optimizer_base import MetaOptimizerBase  # noqa: F401
from .amp_optimizer import AMPOptimizer  # noqa: F401
from .recompute_optimizer import RecomputeOptimizer  # noqa: F401
from .gradient_merge_optimizer import GradientMergeOptimizer  # noqa: F401
from .localsgd_optimizer import (  # noqa: F401
    LocalSGDOptimizer, AdaptiveLocalSGDOptimizer,
)
from .lars_optimizer import LarsOptimizer  # noqa: F401
from .lamb_optimizer import LambOptimizer  # noqa: F401
from .dgc_optimizer import DGCOptimizer, DGCMomentumOptimizer  # noqa: F401
from .fp16_allreduce_optimizer import FP16AllReduceOptimizer  # noqa: F401
from .sharding_optimizer import ShardingOptimizer  # noqa: F401
from .graph_execution_optimizer import GraphExecutionOptimizer  # noqa: F401
