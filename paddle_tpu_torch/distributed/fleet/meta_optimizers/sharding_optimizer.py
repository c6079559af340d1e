"""ZeRO sharding meta-optimizer (strategy.sharding).

Counterpart of paddle_tpu/distributed/fleet/meta_optimizers/
sharding_optimizer.py, with the same place in the chain and the same
incompatibilities; the rewrite is distributed/sharding.py, which the
port runs one process a rank.  The text below is the JAX package's.

Reference: meta_optimizers/sharding_optimizer.py — the fleet strategy knob
that partitions optimizer state across the DP world.  The reference emits
per-rank programs with broadcast/allreduce glue; here the rewrite is the
TPU-native `distributed/sharding.py` pass (bucketed reduce-scatter →
sharded update → allgather inside one shard_map-traced program — see that
module's docstring for the whole design).

Ordering: applied after the optimizer-replacing and AMP rewrites, BEFORE
GradientMergeOptimizer — gradient merge's masked-update rewrite then
accumulates the raw grads and commits the sharded update on the k-th
step.  GraphExecutionOptimizer's CompiledProgram wrapping composes via
`insert_grad_allreduce`'s idempotency: the already-reduce-scattered
gradients are skipped, unsharded stragglers still get their allreduce.

sharding_configs:
  * ``dp_degree`` — the DP world the bucket padding targets (default:
    local device count, the mesh CompiledProgram will build);
  * ``bucket_mb`` — flat-bucket coalescing granularity in MB (falls back
    to the reference's ``fuse_broadcast_MB`` key, default 32);
  * ``stage`` — ZeRO stage 1/2/3 (default 1; the reference key
    ``sharding_degree`` semantics stay with ``dp_degree``): 2 keeps the
    reduce-scattered grad buckets sharded through gradient_merge
    accumulation, 3 shards the parameters themselves with just-in-time
    per-bucket allgather (distributed/sharding.py).
"""
from __future__ import annotations

from .meta_optimizer_base import MetaOptimizerBase

__all__ = ["ShardingOptimizer"]


class ShardingOptimizer(MetaOptimizerBase):
    # LocalSGD averages full per-rank PARAMS every k steps — under ZeRO-1
    # each rank's optimizer state covers only its shard, the two schedules
    # contradict.  DGC rewrites grads into sparse encodings the dense
    # flat bucket would densify.
    _incompatible = ("LocalSGDOptimizer", "AdaptiveLocalSGDOptimizer",
                     "DGCOptimizer")

    def _can_apply(self):
        return bool(getattr(self.user_defined_strategy, "sharding", False))

    def _disable_strategy(self, dist_strategy):
        dist_strategy.sharding = False

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        from ....core.program import default_startup_program
        from ...sharding import shard_optimizer_states
        ops, params_grads = self.inner_opt.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        c = dict(getattr(self.user_defined_strategy, "sharding_configs",
                         None) or {})
        bucket_mb = c.get("bucket_mb", c.get("fuse_broadcast_MB", 0))
        program = loss.block.program
        startup = startup_program or default_startup_program()
        shard_optimizer_states(
            program, startup,
            dp_degree=c.get("dp_degree") or None,
            bucket_bytes=int(float(bucket_mb) * 2 ** 20) if bucket_mb
            else None,
            stage=int(c.get("stage", 1)))
        return ops, params_grads
