"""DGC (Deep Gradient Compression) meta-optimizer.

Counterpart of paddle_tpu/distributed/fleet/meta_optimizers/
dgc_optimizer.py: a Momentum optimizer becomes DGCMomentumOptimizer,
whose `dgc` op (ops/kernels/optimizers.py) keeps the momentum-corrected
top-k gradient and a local residual; the encoded gradient stays dense
and rides the normal c_allreduce_sum, then an sgd step applies it.
"""
from __future__ import annotations

from ....core.program import unique_name
from ....static.layer_helper import LayerHelper
from ....static.optimizer import MomentumOptimizer
from ....static.initializer import Constant
from .meta_optimizer_base import MetaOptimizerBase

__all__ = ["DGCOptimizer", "DGCMomentumOptimizer"]
class DGCMomentumOptimizer(MomentumOptimizer):
    """fluid optimizer.py DGCMomentumOptimizer parity."""

    def __init__(self, learning_rate, momentum, rampup_begin_step=0,
                 rampup_step=1, sparsity=(0.999,), **kw):
        super().__init__(learning_rate, momentum, **kw)
        self._rampup_begin_step = rampup_begin_step
        self._rampup_step = rampup_step
        self._sparsity = list(sparsity)

    def _append_optimize_op(self, param, grad, lr):
        helper = LayerHelper("dgc_momentum")
        u = helper.main_program.global_block().create_var(
            name=unique_name(param.name + "@DGC_U"), shape=param.shape,
            dtype="float32", persistable=True, stop_gradient=True)
        Constant(0.0)(u, helper.startup_program.global_block())
        encoded = helper.create_variable_for_type_inference(grad.dtype)
        grad_out = helper.main_program.global_block().create_var(
            name=unique_name(grad.name + "@DGC"), shape=grad.shape,
            dtype=grad.dtype, stop_gradient=True)
        helper.append_op(
            "dgc", inputs={"U": u, "Grad": grad},
            outputs={"UOut": u, "EncodedGrad": encoded,
                     "GradOut": grad_out},
            attrs={"m": self._momentum,
                   "sparsity": float(self._sparsity[-1]),
                   "rampup_begin_step": self._rampup_begin_step,
                   "rampup_step": self._rampup_step})
        # sgd on the sparsified gradient: DGC folds momentum into `u`
        return helper.append_op(
            "sgd",
            inputs={"Param": param, "Grad": grad_out, "LearningRate": lr},
            outputs={"ParamOut": param})


class DGCOptimizer(MetaOptimizerBase):
    _incompatible = ("AMPOptimizer",)

    def _can_apply(self):
        if not self.user_defined_strategy.dgc:
            return False
        return isinstance(self.user_defined_optimizer, MomentumOptimizer)

    def _disable_strategy(self, dist_strategy):
        dist_strategy.dgc = False

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        inner = self.user_defined_optimizer
        c = self.user_defined_strategy.dgc_configs
        opt = DGCMomentumOptimizer(
            learning_rate=inner._learning_rate,
            momentum=getattr(inner, "_momentum", 0.9),
            rampup_begin_step=c.get("rampup_begin_step", 0),
            rampup_step=c.get("rampup_step", 1),
            sparsity=c.get("sparsity", [0.999]),
            parameter_list=inner._parameter_list,
            regularization=inner._regularization,
            grad_clip=inner._grad_clip)
        return opt.minimize(loss, startup_program, parameter_list,
                            no_grad_set)
