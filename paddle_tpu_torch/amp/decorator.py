"""Static-graph AMP optimizer decorator with loss scaling.

Counterpart of paddle_tpu/amp/decorator.py (`decorate`,
`OptimizerWithMixedPrecision`): the forward is rewritten with casts, the
loss is scaled before the backward, and check_finite_and_unscale (plus
update_loss_scaling with dynamic scaling) guards the optimizer step.
bf16 shares fp32's exponent range, so `init_loss_scaling=1.0,
use_dynamic_loss_scaling=False` is the configuration the BERT pretraining
program uses.
"""
from __future__ import annotations

from ..core.program import (OpRole, default_startup_program, program_guard,
                            unique_name)
from ..static import layers
from ..static.layer_helper import LayerHelper
from .fp16_lists import AutoMixedPrecisionLists
from .fp16_utils import rewrite_program

__all__ = ["decorate", "OptimizerWithMixedPrecision"]


class OptimizerWithMixedPrecision:

    def __init__(self, optimizer, amp_lists, init_loss_scaling,
                 use_dynamic_loss_scaling, incr_every_n_steps,
                 decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
                 dest_dtype="bfloat16"):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._init_loss_scaling = float(init_loss_scaling)
        self._use_dynamic_loss_scaling = use_dynamic_loss_scaling
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._dest_dtype = dest_dtype
        self._loss_scaling = None
        self._scaled_loss = None

    def _create_scale_vars(self):
        self._loss_scaling = layers.create_global_var(
            [1], self._init_loss_scaling, "float32", persistable=True,
            name=unique_name("loss_scaling"))
        if self._use_dynamic_loss_scaling:
            self._good_steps = layers.create_global_var(
                [1], 0, "int32", persistable=True,
                name=unique_name("good_steps"))
            self._bad_steps = layers.create_global_var(
                [1], 0, "int32", persistable=True,
                name=unique_name("bad_steps"))

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        """Rewrite the program, scale the loss, append the backward."""
        program = loss.block.program
        with program_guard(program, startup_program
                           or default_startup_program()):
            rewrite_program(program, self._amp_lists, self._dest_dtype)
            # the loss may now be low precision: bring it to fp32
            if loss.dtype != "float32":
                loss = layers.cast(loss, "float32")
            self._create_scale_vars()
            with program._op_role_guard(OpRole.Forward):
                self._scaled_loss = layers.elementwise_mul(
                    loss, self._loss_scaling)
            return self._optimizer.backward(
                self._scaled_loss, startup_program, parameter_list,
                no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        """Unscale and check the gradients for inf/nan before the step."""
        program = params_grads[0][0].block.program
        with program_guard(program), \
                program._op_role_guard(OpRole.Optimize):
            grads = [g for _, g in params_grads]
            helper = LayerHelper("check_finite_and_unscale")
            found_inf = helper.create_variable_for_type_inference("bool")
            outs = [helper.block.create_var(
                name=unique_name(g.name + "@UNSCALED"), shape=g.shape,
                dtype=g.dtype, stop_gradient=True) for g in grads]
            helper.append_op(
                "check_finite_and_unscale",
                inputs={"X": grads, "Scale": [self._loss_scaling]},
                outputs={"Out": outs, "FoundInfinite": [found_inf]})
            if self._use_dynamic_loss_scaling:
                outs2 = [helper.block.create_var(
                    name=unique_name(g.name + "@GUARDED"), shape=g.shape,
                    dtype=g.dtype, stop_gradient=True) for g in grads]
                helper.append_op(
                    "update_loss_scaling",
                    inputs={"X": outs, "FoundInfinite": [found_inf],
                            "PrevLossScaling": [self._loss_scaling],
                            "InGoodSteps": [self._good_steps],
                            "InBadSteps": [self._bad_steps]},
                    outputs={"Out": outs2,
                             "LossScaling": [self._loss_scaling],
                             "OutGoodSteps": [self._good_steps],
                             "OutBadSteps": [self._bad_steps]},
                    attrs={"incr_every_n_steps": self._incr_every_n_steps,
                           "decr_every_n_nan_or_inf":
                               self._decr_every_n_nan_or_inf,
                           "incr_ratio": self._incr_ratio,
                           "decr_ratio": self._decr_ratio})
                outs = outs2
            new_pg = [(p, g) for (p, _), g in zip(params_grads, outs)]
        return self._optimizer.apply_gradients(new_pg)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        ops = self.apply_gradients(params_grads)
        loss.block.program._ps_params_grads = params_grads
        return ops, params_grads


def decorate(optimizer, amp_lists=None, init_loss_scaling=2 ** 15,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=True, dest_dtype="bfloat16"):
    """Wrap `optimizer` for mixed precision (fluid's
    contrib.mixed_precision.decorate)."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
        dest_dtype)
