"""Optimizers: program-rewriting minimize() = backward + optimizer ops.

Counterpart of paddle_tpu/static/optimizer.py: the `Optimizer` base
(`backward`, `apply_gradients`, `minimize`) and `AdamOptimizer` (`Adam`).
Accumulators (moments, beta pows) are persistable vars initialised in the
startup program, so optimizer state lives in the Scope beside the
parameters.

Not ported yet: the other optimizers, gradient clipping, regularizers and
learning-rate schedulers (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, Optional

from ..core.program import VarDesc, OpRole, default_main_program, unique_name
from .backward import append_backward
from .initializer import Constant
from .layer_helper import LayerHelper
from . import layers

__all__ = ["Optimizer", "Adam", "AdamOptimizer"]


class Optimizer:

    def __init__(self, learning_rate=0.001, parameter_list=None,
                 regularization=None, grad_clip=None, name=None):
        if regularization is not None or grad_clip is not None:
            raise NotImplementedError(
                "regularization= and grad_clip= are not ported yet "
                "(ROADMAP.md)")
        self._learning_rate = learning_rate
        self._parameter_list = parameter_list
        self._name = name or type(self).__name__
        self._lr_var: Optional[VarDesc] = None
        self._accumulators: Dict[str, Dict[str, VarDesc]] = {}

    # -- lr -----------------------------------------------------------------
    def _create_lr_var(self) -> VarDesc:
        if self._lr_var is not None:
            return self._lr_var
        lr = self._learning_rate
        if isinstance(lr, VarDesc):
            self._lr_var = lr
            return lr
        if not isinstance(lr, (int, float)):
            raise NotImplementedError(
                f"learning rate of type {type(lr).__name__}: schedulers are "
                "not ported yet")
        self._lr_var = layers.create_global_var(
            [1], float(lr), "float32", persistable=True,
            name=unique_name("learning_rate"))
        return self._lr_var

    # -- accumulators -------------------------------------------------------
    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                         dtype=None):
        acc = self._accumulators.setdefault(name, {})
        if param.name in acc:
            return acc[param.name]
        helper = LayerHelper(self._name)
        v = helper.main_program.global_block().create_var(
            name=unique_name(f"{param.name}_{name}"),
            shape=shape or param.shape,
            dtype=dtype or "float32", persistable=True, stop_gradient=True)
        v.attrs["accum_of"] = param.name
        Constant(fill_value)(v, helper.startup_program.global_block())
        acc[param.name] = v
        return v

    # -- API ----------------------------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list or self._parameter_list,
                               no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        """One optimizer op per (param, grad), in the loss's program."""
        from ..core.program import program_guard
        program = params_grads[0][0].block.program if params_grads \
            else default_main_program()
        with program_guard(program), \
                program._op_role_guard(OpRole.Optimize):
            lr = self._create_lr_var()
            ops = [self._append_optimize_op(p, g, lr)
                   for p, g in params_grads]
        return ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        ops = self.apply_gradients(params_grads)
        loss.block.program._ps_params_grads = params_grads
        return ops, params_grads

    def _append_optimize_op(self, param, grad, lr):
        raise NotImplementedError


class AdamOptimizer(Optimizer):
    _op = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        if lazy_mode:
            raise NotImplementedError(
                "Adam(lazy_mode=True) needs sparse gradients, not ported "
                "yet (ROADMAP.md)")
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _append_optimize_op(self, param, grad, lr):
        m1 = self._add_accumulator("moment1", param)
        m2 = self._add_accumulator("moment2", param)
        b1p = self._add_accumulator("beta1_pow", param, self._beta1,
                                    shape=[1])
        b2p = self._add_accumulator("beta2_pow", param, self._beta2,
                                    shape=[1])
        helper = LayerHelper(self._op)
        return helper.append_op(
            self._op,
            inputs={"Param": param, "Grad": grad, "LearningRate": lr,
                    "Moment1": m1, "Moment2": m2, "Beta1Pow": b1p,
                    "Beta2Pow": b2p},
            outputs={"ParamOut": param, "Moment1Out": m1, "Moment2Out": m2,
                     "Beta1PowOut": b1p, "Beta2PowOut": b2p},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})


Adam = AdamOptimizer
