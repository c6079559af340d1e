"""PipelineOptimizer, the fluid wrapper and fleet's meta-optimizer.

Counterpart of paddle_tpu/pipeline/pipeline_optimizer.py (the reference's
fluid PipelineOptimizer, which cuts the program on its device_guard
annotations, and fleet's PipelineOptimizer reading
strategy.pipeline_configs).  `minimize` returns (ops, params_grads) as
the inner optimizer's does and leaves a PipelineCompiledProgram on the
program (`program._pipeline_compiled`); exe.run of it runs the GPipe
schedule.  Boundary tensors move between the stages' devices with
`.to(device)`, so no inter-stage send / recv ops are inserted.
"""
from __future__ import annotations

from .pipeline_program import PipelineCompiledProgram

__all__ = ["PipelineOptimizer", "FleetPipelineOptimizer"]


class PipelineOptimizer:
    """fluid-style: PipelineOptimizer(opt, num_microbatches=4)."""

    def __init__(self, optimizer, num_microbatches=1, start_cpu_core_id=0):
        self._optimizer = optimizer
        self._num_microbatches = num_microbatches

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return self._optimizer.backward(loss, startup_program,
                                        parameter_list, no_grad_set,
                                        callbacks)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        ops, params_grads = self._optimizer.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        program = loss.block.program
        compiled = PipelineCompiledProgram(
            program, self._num_microbatches, params_grads)
        program._pipeline_compiled = compiled
        return ops, params_grads

    def __getattr__(self, item):
        return getattr(self.__dict__["_optimizer"], item)


# fleet meta-optimizer form (inserted by fleet_base when strategy.pipeline)
from ..distributed.fleet.meta_optimizers.meta_optimizer_base import \
    MetaOptimizerBase


class FleetPipelineOptimizer(MetaOptimizerBase):
    # the pipeline owns the executor: data parallel (GraphExecution) and
    # the k-step rewrites do not compose with the staged schedule
    _incompatible = ("GradientMergeOptimizer", "LocalSGDOptimizer",
                     "GraphExecutionOptimizer")

    def _can_apply(self):
        return bool(self.user_defined_strategy.pipeline)

    def _disable_strategy(self, dist_strategy):
        dist_strategy.pipeline = False

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        c = self.user_defined_strategy.pipeline_configs
        m = c.get("accumulate_steps", c.get("micro_batch", 1))
        wrapped = PipelineOptimizer(self.inner_opt, num_microbatches=m)
        result = wrapped.minimize(loss, startup_program, parameter_list,
                                  no_grad_set)
        # expose the pipeline program as fleet.main_program
        program = loss.block.program
        program._compiled_for_fleet = program._pipeline_compiled
        return result
