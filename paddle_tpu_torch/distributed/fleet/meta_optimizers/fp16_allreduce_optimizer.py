"""FP16 allreduce meta-optimizer: the gradients are cast to bf16 for
their allreduce and back after it, half the bytes on the wire.  It marks
the program (`_fp16_allreduce`); CompiledProgram's
`insert_grad_allreduce` reads the mark and wraps each inserted
c_allreduce_sum in the casts.  Counterpart of
paddle_tpu/distributed/fleet/meta_optimizers/fp16_allreduce_optimizer.py.
"""
from __future__ import annotations

from .meta_optimizer_base import MetaOptimizerBase

__all__ = ["FP16AllReduceOptimizer"]
class FP16AllReduceOptimizer(MetaOptimizerBase):
    def _can_apply(self):
        return bool(self.user_defined_strategy.fp16_allreduce)

    def _disable_strategy(self, dist_strategy):
        dist_strategy.fp16_allreduce = False

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        ops, params_grads = self.inner_opt.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        # mark the program: CompiledProgram reads this when inserting the
        # grad allreduce and wraps it in bf16 casts
        loss.block.program._fp16_allreduce = True
        return ops, params_grads
