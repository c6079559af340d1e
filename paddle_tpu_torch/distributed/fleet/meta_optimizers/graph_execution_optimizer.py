"""Graph-execution meta-optimizer: the outermost, collective mode.

Counterpart of paddle_tpu/distributed/fleet/meta_optimizers/
graph_execution_optimizer.py: after the inner optimizers minimize, the
program is wrapped in `CompiledProgram.with_data_parallel` with the
role's trainer count, id and endpoints (fleet.main_program), which
inserts the gradient allreduce when it first runs.  There is no NCCL id
to hand out first: torch.distributed formed the communicators at
`init_parallel_env`.
"""
from __future__ import annotations

from .meta_optimizer_base import MetaOptimizerBase

__all__ = ["GraphExecutionOptimizer"]
class GraphExecutionOptimizer(MetaOptimizerBase):
    def _can_apply(self):
        # collective mode (fleet_base decides); a single worker runs it
        # too: the allreduce over one rank is a copy
        return True

    def _is_graph_out(self):
        return True

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        ops, params_grads = self.inner_opt.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        from ...compiled_program import CompiledProgram, BuildStrategy
        program = loss.block.program
        strategy = self.user_defined_strategy
        bs = (strategy.build_strategy if strategy and strategy.build_strategy
              else BuildStrategy())
        if self.role_maker is not None:
            bs.num_trainers = self.role_maker.worker_num()
            bs.trainer_id = self.role_maker.worker_index()
            bs.trainers_endpoints = self.role_maker.get_trainer_endpoints()
        # DistributedStrategy parallelism degrees flow into the
        # BuildStrategy; only a degree the user actually set (> 1)
        # overrides — a bare
        # flag with default configs must not clobber a degree already on
        # a user-supplied BuildStrategy
        if getattr(strategy, "sequence_parallel", False):
            deg = int(strategy.sequence_parallel_configs.get("degree", 1))
            if deg > 1:
                bs.sequence_parallel_degree = deg
        if getattr(strategy, "tensor_parallel", False):
            deg = int(strategy.tensor_parallel_configs.get(
                "tensor_parallel_degree", 1))
            if deg > 1:
                bs.tensor_parallel_degree = deg
        compiled = CompiledProgram(program, build_strategy=bs) \
            .with_data_parallel(loss_name=loss.name)
        program._compiled_for_fleet = compiled
        return ops, params_grads
