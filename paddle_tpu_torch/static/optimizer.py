"""Optimizers: program-rewriting minimize() = backward + optimizer ops.

Counterpart of paddle_tpu/static/optimizer.py: the `Optimizer` base
(`backward`, `apply_gradients`, `minimize`, `set_lr` / `get_lr`), `SGD`,
`Momentum`, `LarsMomentum`, `Adam` (with `lazy_mode`), `AdamW`, `Adamax`,
`Adagrad`, `DecayedAdagrad`, `Adadelta`, `RMSProp`, `ProximalGD`,
`ProximalAdagrad`, `Ftrl`, `Lamb` and `Dpsgd`; the wrappers
`ExponentialMovingAverage`, `ModelAverage`, `LookaheadOptimizer` and
`RecomputeOptimizer`; the regularizers `L1Decay` / `L2Decay`, the
gradient clips `GradientClipByValue` / `ByNorm` / `ByGlobalNorm`, and
`gradient_merge`.  `apply_gradients` runs the reference's order: clip,
then regularize, then one optimizer op per parameter.  Accumulators
(moments, beta pows, velocities) are persistable vars initialised in the
startup program, so optimizer state lives in the Scope beside the
parameters.  A learning rate may be a float, a var or an
`optimizer.lr_scheduler.LRScheduler`, whose `step()` writes the new value
into the scope.

One difference from the JAX package: `Adam(lazy_mode=True)` writes
`lazy_mode` into its ops' attrs, so a sparse gradient moves only its rows;
the JAX package's class drops the flag (ROADMAP.md Queue 3).  With
`lazy_mode=False` the programs are equal.

The clips also have the dygraph `_eager_apply(params_grads)` that the 2.0
optimizers (optimizer/optimizer.py) call on torch gradients: the same
arithmetic in fp32, the result in each gradient's dtype.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..core.program import VarDesc, OpRole, default_main_program, unique_name
from .backward import append_backward
from .initializer import Constant
from .layer_helper import LayerHelper
from . import layers

__all__ = [
    "Optimizer", "SGD", "SGDOptimizer", "Momentum", "MomentumOptimizer",
    "Adam", "AdamOptimizer", "AdamW", "Adamax", "AdamaxOptimizer",
    "Adagrad", "AdagradOptimizer", "Adadelta", "AdadeltaOptimizer",
    "RMSProp", "RMSPropOptimizer", "Ftrl", "FtrlOptimizer", "Lamb",
    "LambOptimizer", "LarsMomentum", "LarsMomentumOptimizer",
    "DecayedAdagrad", "DecayedAdagradOptimizer", "DpsgdOptimizer",
    "ProximalGD", "ProximalGDOptimizer", "ProximalAdagrad",
    "ProximalAdagradOptimizer", "ExponentialMovingAverage", "ModelAverage",
    "LookaheadOptimizer", "RecomputeOptimizer", "L1Decay", "L2Decay",
    "GradientClipByValue", "GradientClipByNorm", "GradientClipByGlobalNorm",
    "gradient_merge",
]


# ---------------------------------------------------------------------------
# regularizers (fluid/regularizer.py)
# ---------------------------------------------------------------------------
class L2Decay:
    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def append(self, param, grad):
        return layers.elementwise_add(
            grad, layers.scale(param, scale=self.coeff))


class L1Decay:
    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def append(self, param, grad):
        sign = layers.cast(layers._binary_op("greater_than", param, 0.0),
                           param.dtype)
        neg = layers.cast(layers._binary_op("less_than", param, 0.0),
                          param.dtype)
        return layers.elementwise_add(
            grad, layers.scale(layers.elementwise_sub(sign, neg),
                               scale=self.coeff))


# ---------------------------------------------------------------------------
# gradient clipping (fluid/clip.py: GradientClipBy{Value,Norm,GlobalNorm})
# ---------------------------------------------------------------------------
class GradientClipByValue:
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def apply(self, params_grads):
        return [(p, layers.clip(g, self.min, self.max))
                for p, g in params_grads]

    def _eager_apply(self, params_grads):
        return [(p, torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class GradientClipByNorm:
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def apply(self, params_grads):
        return [(p, layers.clip_by_norm(g, self.clip_norm))
                for p, g in params_grads]

    def _eager_apply(self, params_grads):
        out = []
        for p, g in params_grads:
            gf = g.float()
            norm = torch.sqrt(torch.sum(torch.square(gf)))
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            out.append((p, (gf * scale).to(g.dtype)))
        return out


class GradientClipByGlobalNorm:
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def apply(self, params_grads):
        sq = [layers.reduce_sum(layers.square(g)) for _, g in params_grads]
        global_norm = layers.sqrt(layers.sums(sq))
        max_norm = layers.fill_constant([1], "float32", self.clip_norm)
        scale = layers.elementwise_div(
            max_norm,
            layers.elementwise_max(global_norm, max_norm))
        return [(p, layers.elementwise_mul(g, scale))
                for p, g in params_grads]

    def _eager_apply(self, params_grads):
        if not params_grads:
            return params_grads
        gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                            for _, g in params_grads))
        scale = self.clip_norm / torch.clamp(gn, min=self.clip_norm)
        return [(p, (g.float() * scale).to(g.dtype))
                for p, g in params_grads]


# ---------------------------------------------------------------------------
# base optimizer
# ---------------------------------------------------------------------------
class Optimizer:

    def __init__(self, learning_rate=0.001, parameter_list=None,
                 regularization=None, grad_clip=None, name=None):
        self._learning_rate = learning_rate
        self._parameter_list = parameter_list
        self._regularization = regularization
        self._grad_clip = grad_clip
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
        from ..optimizer.lr_scheduler import LRScheduler
        if isinstance(lr, LRScheduler):
            self._lr_var = lr._create_static_var()
            return self._lr_var
        self._lr_var = layers.create_global_var(
            [1], float(lr), "float32", persistable=True,
            name=unique_name("learning_rate"))
        return self._lr_var

    def set_lr(self, value, scope=None):
        """Runtime lr update: rewrite the lr var's scope value (on the
        device it is on)."""
        from .executor import global_scope
        scope = scope or global_scope()
        if self._lr_var is not None:
            cur = scope.get(self._lr_var.name)
            scope.set(self._lr_var.name, torch.tensor(
                [float(value)], dtype=torch.float32,
                device=cur.device if cur is not None else "cpu"))
        self._learning_rate = float(value)

    def get_lr(self):
        return self._learning_rate

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
        """Clip, regularize, then one optimizer op per (param, grad), in
        the loss's program."""
        from ..core.program import program_guard
        program = params_grads[0][0].block.program if params_grads \
            else default_main_program()
        with program_guard(program), \
                program._op_role_guard(OpRole.Optimize):
            if self._grad_clip is not None:
                params_grads = self._grad_clip.apply(params_grads)
            if self._regularization is not None:
                params_grads = [(p, self._regularization.append(p, g))
                                for p, g in params_grads]
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


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, param, grad, lr):
        helper = LayerHelper("sgd")
        return helper.append_op(
            "sgd",
            inputs={"Param": param, "Grad": grad, "LearningRate": lr},
            outputs={"ParamOut": param})


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _append_optimize_op(self, param, grad, lr):
        vel = self._add_accumulator("velocity", param)
        helper = LayerHelper("momentum")
        return helper.append_op(
            "momentum",
            inputs={"Param": param, "Grad": grad, "Velocity": vel,
                    "LearningRate": lr},
            outputs={"ParamOut": param, "VelocityOut": vel},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov})


class LarsMomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, epsilon=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay
        self._epsilon = epsilon

    def _append_optimize_op(self, param, grad, lr):
        vel = self._add_accumulator("velocity", param)
        helper = LayerHelper("lars_momentum")
        return helper.append_op(
            "lars_momentum",
            inputs={"Param": param, "Grad": grad, "Velocity": vel,
                    "LearningRate": lr},
            outputs={"ParamOut": param, "VelocityOut": vel},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay,
                   "epsilon": self._epsilon})


class AdamOptimizer(Optimizer):
    _op = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lazy_mode = bool(lazy_mode)

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
                   "epsilon": self._epsilon,
                   **({"lazy_mode": True} if self._lazy_mode else {})})


class AdamW(AdamOptimizer):
    """Adam with decoupled weight decay `weight_decay`; a parameter whose
    name `apply_decay_param_fun` rejects gets a plain adam op."""
    _op = "adamw"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=0.01, apply_decay_param_fun=None,
                 **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kw)
        self._coeff = weight_decay
        self._decay_fn = apply_decay_param_fun

    def _append_optimize_op(self, param, grad, lr):
        if self._decay_fn is not None and not self._decay_fn(param.name):
            saved, self._op = self._op, "adam"
            try:
                return super()._append_optimize_op(param, grad, lr)
            finally:
                self._op = saved
        op = super()._append_optimize_op(param, grad, lr)
        op.attrs["coeff"] = self._coeff
        return op


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _append_optimize_op(self, param, grad, lr):
        m = self._add_accumulator("moment", param)
        inf_norm = self._add_accumulator("inf_norm", param)
        b1p = self._add_accumulator("beta1_pow", param, self._beta1, [1])
        helper = LayerHelper("adamax")
        return helper.append_op(
            "adamax",
            inputs={"Param": param, "Grad": grad, "LearningRate": lr,
                    "Moment": m, "InfNorm": inf_norm, "Beta1Pow": b1p},
            outputs={"ParamOut": param, "MomentOut": m,
                     "InfNormOut": inf_norm, "Beta1PowOut": b1p},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, initial_accumulator_value=0.0,
                 **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _append_optimize_op(self, param, grad, lr):
        moment = self._add_accumulator("moment", param, self._init_acc)
        helper = LayerHelper("adagrad")
        return helper.append_op(
            "adagrad",
            inputs={"Param": param, "Grad": grad, "Moment": moment,
                    "LearningRate": lr},
            outputs={"ParamOut": param, "MomentOut": moment},
            attrs={"epsilon": self._epsilon})


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    def _append_optimize_op(self, param, grad, lr):
        moment = self._add_accumulator("moment", param)
        helper = LayerHelper("decayed_adagrad")
        return helper.append_op(
            "decayed_adagrad",
            inputs={"Param": param, "Grad": grad, "Moment": moment,
                    "LearningRate": lr},
            outputs={"ParamOut": param, "MomentOut": moment},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon, self._rho = epsilon, rho

    def _append_optimize_op(self, param, grad, lr):
        avg_sq_g = self._add_accumulator("avg_squared_grad", param)
        avg_sq_u = self._add_accumulator("avg_squared_update", param)
        helper = LayerHelper("adadelta")
        return helper.append_op(
            "adadelta",
            inputs={"Param": param, "Grad": grad,
                    "AvgSquaredGrad": avg_sq_g,
                    "AvgSquaredUpdate": avg_sq_u},
            outputs={"ParamOut": param, "AvgSquaredGradOut": avg_sq_g,
                     "AvgSquaredUpdateOut": avg_sq_u},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _append_optimize_op(self, param, grad, lr):
        ms = self._add_accumulator("mean_square", param)
        mg = self._add_accumulator("mean_grad", param)
        mom = self._add_accumulator("momentum", param)
        helper = LayerHelper("rmsprop")
        return helper.append_op(
            "rmsprop",
            inputs={"Param": param, "Grad": grad, "MeanSquare": ms,
                    "MeanGrad": mg, "Moment": mom, "LearningRate": lr},
            outputs={"ParamOut": param, "MeanSquareOut": ms,
                     "MeanGradOut": mg, "MomentOut": mom},
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered})


class ProximalGDOptimizer(Optimizer):
    """fluid.optimizer.ProximalGDOptimizer (proximal_gd_op.h) — proximal
    gradient descent with l1/l2 regularization folded into the step."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2 = l1, l2

    def _append_optimize_op(self, param, grad, lr):
        helper = LayerHelper("proximal_gd")
        return helper.append_op(
            "proximal_gd",
            inputs={"Param": param, "Grad": grad, "LearningRate": lr},
            outputs={"ParamOut": param},
            attrs={"l1": self._l1, "l2": self._l2})


class ProximalAdagradOptimizer(Optimizer):
    """fluid.optimizer.ProximalAdagradOptimizer (proximal_adagrad_op.h)."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2 = l1, l2

    def _append_optimize_op(self, param, grad, lr):
        moment = self._add_accumulator("moment", param)
        helper = LayerHelper("proximal_adagrad")
        return helper.append_op(
            "proximal_adagrad",
            inputs={"Param": param, "Moment": moment, "Grad": grad,
                    "LearningRate": lr},
            outputs={"ParamOut": param, "MomentOut": moment},
            attrs={"l1": self._l1, "l2": self._l2})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _append_optimize_op(self, param, grad, lr):
        sq = self._add_accumulator("squared", param)
        lin = self._add_accumulator("linear", param)
        helper = LayerHelper("ftrl")
        return helper.append_op(
            "ftrl",
            inputs={"Param": param, "Grad": grad, "SquaredAccumulator": sq,
                    "LinearAccumulator": lin, "LearningRate": lr},
            outputs={"ParamOut": param, "SquaredAccumOut": sq,
                     "LinearAccumOut": lin},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


class LambOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 exclude_from_weight_decay_fn=None, **kw):
        super().__init__(learning_rate, **kw)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _append_optimize_op(self, param, grad, lr):
        m1 = self._add_accumulator("moment1", param)
        m2 = self._add_accumulator("moment2", param)
        b1p = self._add_accumulator("beta1_pow", param, self._beta1, [1])
        b2p = self._add_accumulator("beta2_pow", param, self._beta2, [1])
        wd = self._wd
        if self._exclude_fn is not None and self._exclude_fn(param.name):
            wd = 0.0
        helper = LayerHelper("lamb")
        return helper.append_op(
            "lamb",
            inputs={"Param": param, "Grad": grad, "LearningRate": lr,
                    "Moment1": m1, "Moment2": m2, "Beta1Pow": b1p,
                    "Beta2Pow": b2p},
            outputs={"ParamOut": param, "Moment1Out": m1, "Moment2Out": m2,
                     "Beta1PowOut": b1p, "Beta2PowOut": b2p},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "weight_decay": wd})


class DpsgdOptimizer(Optimizer):
    def __init__(self, learning_rate, clip=0.9, batch_size=0.999, sigma=1e-8,
                 **kw):
        super().__init__(learning_rate, **kw)
        self._clip, self._batch_size, self._sigma = clip, batch_size, sigma

    def _append_optimize_op(self, param, grad, lr):
        helper = LayerHelper("dpsgd")
        return helper.append_op(
            "dpsgd",
            inputs={"Param": param, "Grad": grad, "LearningRate": lr},
            outputs={"ParamOut": param},
            attrs={"clip": self._clip, "batch_size": self._batch_size,
                   "sigma": self._sigma})


class ExponentialMovingAverage:
    """EMA of the trainable parameters (fluid optimizer.py
    ExponentialMovingAverage), as the JAX package computes it: `update()`
    appends, for each parameter, a shadow var (startup value 0) and the
    ops shadow = decay * shadow + (1 - decay) * param, written back with
    `assign`; `apply()` puts the shadows in the parameters' place in the
    scope (copies: the scope never holds one tensor under two names) and
    `restore()` puts the parameters back.  `thres_steps` is accepted and
    unused, as in the JAX package."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._name = name or "ema"
        self._shadows: List[Tuple[VarDesc, VarDesc]] = []

    def update(self):
        program = default_main_program()
        helper = LayerHelper(self._name)
        with program._op_role_guard(OpRole.Optimize):
            for p in program.all_parameters():
                if not p.trainable:
                    continue
                shadow = helper.main_program.global_block().create_var(
                    name=unique_name(f"{p.name}_ema"), shape=p.shape,
                    dtype=p.dtype, persistable=True, stop_gradient=True)
                Constant(0.0)(shadow,
                              helper.startup_program.global_block())
                new_shadow = layers.elementwise_add(
                    layers.scale(shadow, scale=self._decay),
                    layers.scale(p, scale=1.0 - self._decay))
                helper.append_op("assign", inputs={"X": new_shadow},
                                 outputs={"Out": shadow})
                self._shadows.append((p, shadow))

    def apply(self, executor=None, need_restore=True):
        from .executor import global_scope
        scope = global_scope()
        self._backup = {}
        for p, s in self._shadows:
            self._backup[p.name] = scope.get(p.name)
            if scope.get(s.name) is not None:
                scope.set(p.name, scope.get(s.name).clone())

    def restore(self, executor=None):
        from .executor import global_scope
        scope = global_scope()
        for name, v in self._backup.items():
            scope.set(name, v)


class ModelAverage:
    """Accumulated parameter averaging (fluid optimizer.py ModelAverage,
    on the average_accumulates op): train-time ops keep windowed sums of
    each trainable parameter; `apply()` swaps the averages in for
    evaluation and returns a context handle, so both `with
    ma.apply(exe): evaluate()` (restored on exit when `need_restore`) and
    `ma.apply(exe) ... ma.restore(exe)` work."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, name=None):
        self._window_rate = float(average_window_rate)
        self._min_window = int(min_average_window)
        self._max_window = int(max_average_window)
        self._name = name or "model_average"
        self._accs: List[Tuple[VarDesc, Dict[str, VarDesc]]] = []
        program = default_main_program()
        helper = LayerHelper(self._name)
        block = program.global_block()
        with program._op_role_guard(OpRole.Optimize):
            for p in program.all_parameters():
                if not p.trainable:
                    continue
                acc = {}
                for key, shape, dtype in (
                        ("sum_1", p.shape, p.dtype),
                        ("sum_2", p.shape, p.dtype),
                        ("sum_3", p.shape, p.dtype),
                        ("num_accumulates", (1,), "int64"),
                        ("old_num_accumulates", (1,), "int64"),
                        ("num_updates", (1,), "int64")):
                    v = block.create_var(
                        name=unique_name(f"{p.name}_avg_{key}"),
                        shape=shape, dtype=dtype, persistable=True,
                        stop_gradient=True)
                    Constant(0.0)(v, helper.startup_program.global_block())
                    acc[key] = v
                helper.append_op(
                    "average_accumulates",
                    inputs={"param": p, "in_sum_1": acc["sum_1"],
                            "in_sum_2": acc["sum_2"],
                            "in_sum_3": acc["sum_3"],
                            "in_num_accumulates": acc["num_accumulates"],
                            "in_old_num_accumulates":
                                acc["old_num_accumulates"],
                            "in_num_updates": acc["num_updates"]},
                    outputs={"out_sum_1": acc["sum_1"],
                             "out_sum_2": acc["sum_2"],
                             "out_sum_3": acc["sum_3"],
                             "out_num_accumulates":
                                 acc["num_accumulates"],
                             "out_old_num_accumulates":
                                 acc["old_num_accumulates"],
                             "out_num_updates": acc["num_updates"]},
                    attrs={"average_window": self._window_rate,
                           "min_average_window": self._min_window,
                           "max_average_window": self._max_window})
                self._accs.append((p, acc))

    def apply(self, executor=None, need_restore=True):
        """Put (s1 + s2 + s3) / (num_accumulates + old_num_accumulates)
        in each parameter's place now (the count read on the host), in
        the parameter's dtype."""
        from .executor import global_scope
        scope = global_scope()
        self._backup = {}
        for p, acc in self._accs:
            vals = {k: scope.get(v.name) for k, v in acc.items()
                    if scope.get(v.name) is not None}
            if "sum_1" not in vals:
                continue
            total = vals["sum_1"]
            for k in ("sum_2", "sum_3"):
                if k in vals:
                    total = total + vals[k]
            count = sum(int(vals[k].reshape(-1)[0]) for k in
                        ("num_accumulates", "old_num_accumulates")
                        if k in vals)
            if count <= 0:
                continue
            self._backup[p.name] = scope.get(p.name)
            # a 0-d divisor: dividing by a Python number would multiply
            # by its reciprocal on the card
            scope.set(p.name, (total / torch.full(
                (), float(count), dtype=total.dtype,
                device=total.device)).to(total.dtype))
        return _ModelAverageApplied(self, need_restore)

    def restore(self, executor=None):
        from .executor import global_scope
        scope = global_scope()
        for name, v in getattr(self, "_backup", {}).items():
            scope.set(name, v)


class _ModelAverageApplied:
    def __init__(self, ma, need_restore):
        self._ma, self._need_restore = ma, need_restore

    def __enter__(self):
        return self._ma

    def __exit__(self, *exc):
        if self._need_restore:
            self._ma.restore()
        return False


class LookaheadOptimizer:
    """Lookahead (fluid optimizer.py LookaheadOptimizer, arXiv:1907.08610):
    the inner optimizer moves the fast weights every step; every k steps
    the slow copies move alpha toward them and the fast weights reset to
    the slow ones, with mask arithmetic as the JAX package writes it:
    slow' = slow + m alpha (fast - slow), fast' = m slow' + (1 - m) fast,
    m = (step % k == 0) from an int64 step counter.  The slow copies
    start at the initial weights through a startup `scale(1.0)` (a new
    tensor, as the JAX package avoids aliasing a donated buffer); the
    per-step writes are `assign`s."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        assert inner_optimizer is not None
        assert 0.0 <= alpha <= 1.0
        assert k >= 1
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        result = self.inner_optimizer.minimize(
            loss, startup_program=startup_program,
            parameter_list=parameter_list, no_grad_set=no_grad_set)
        program = default_main_program()
        helper = LayerHelper("lookahead")
        block = program.global_block()
        startup = helper.startup_program.global_block()
        # slow copies only for the parameters the inner optimizer trains
        trained = None
        if isinstance(result, tuple) and len(result) == 2:
            trained = {p.name for p, _ in result[1]}
        elif parameter_list is not None:
            trained = {p.name if hasattr(p, "name") else str(p)
                       for p in parameter_list}
        with program._op_role_guard(OpRole.Optimize):
            step = block.create_var(name=unique_name("lookahead_step"),
                                    shape=(1,), dtype="int64",
                                    persistable=True, stop_gradient=True)
            Constant(0.0)(step, startup)
            helper.append_op("increment", inputs={"X": step},
                             outputs={"Out": step},
                             attrs={"step": 1.0})
            ki = layers.fill_constant((1,), "int64", self.k)
            mod = layers.elementwise_mod(step, ki)
            mask = layers.cast(
                layers.equal(mod, layers.fill_constant((1,), "int64", 0)),
                "float32")
            for p in program.all_parameters():
                if not p.trainable:
                    continue
                if trained is not None and p.name not in trained:
                    continue
                slow = block.create_var(
                    name=unique_name(f"{p.name}_slow"), shape=p.shape,
                    dtype=p.dtype, persistable=True, stop_gradient=True)
                startup.create_var(name=slow.name, shape=p.shape,
                                   dtype=p.dtype, persistable=True,
                                   stop_gradient=True)
                startup.append_op("scale", inputs={"X": [p.name]},
                                  outputs={"Out": [slow.name]},
                                  attrs={"scale": 1.0, "bias": 0.0})
                diff = layers.elementwise_sub(p, slow)
                new_slow = layers.elementwise_add(
                    slow, layers.elementwise_mul(
                        layers.scale(diff, scale=self.alpha), mask))
                new_fast = layers.elementwise_add(
                    layers.elementwise_mul(new_slow, mask),
                    layers.elementwise_mul(
                        p, layers.scale(mask, scale=-1.0, bias=1.0)))
                helper.append_op("assign", inputs={"X": new_slow},
                                 outputs={"Out": slow})
                helper.append_op("assign", inputs={"X": new_fast},
                                 outputs={"Out": p})
        return result


def gradient_merge(program, k_steps, startup_program=None,
                   params_grads=None, avg=True):
    """k-step gradient accumulation over an already-minimized `program`:
    gradients accumulate into persistable buffers every step, and the
    optimizer ops commit through a step-counter mask on the k-th
    (distributed/fleet/meta_optimizers/gradient_merge_optimizer.py).  The
    accumulators and the counter are startup-initialized persistables, so
    they thread through `Executor.run_steps` like any optimizer state.

    `params_grads` defaults to the pairs `minimize()` recorded on the
    program; pass them to name the pairs explicitly."""
    from ..core.program import default_startup_program
    if k_steps is None or int(k_steps) <= 1:
        return program
    pgs = params_grads or getattr(program, "_ps_params_grads", None)
    if not pgs:
        raise ValueError(
            "gradient_merge: run optimizer.minimize(loss) on the program "
            "first (it records the param/grad pairs), or pass "
            "params_grads= explicitly")
    startup = startup_program or default_startup_program()
    from ..distributed.fleet.meta_optimizers.gradient_merge_optimizer \
        import apply_gradient_merge
    apply_gradient_merge(program, startup, pgs, int(k_steps), avg=avg)
    return program


class RecomputeOptimizer(Optimizer):
    """Activation checkpointing (fluid optimizer.py RecomputeOptimizer):
    the backward replays forward segments from the checkpoints given to
    `_set_checkpoints` (static/recompute_rewrite.py); the wrapped
    optimizer applies the gradients."""

    def __init__(self, optimizer: Optimizer):
        self._optimizer = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = checkpoints

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        assert self._checkpoints is not None, \
            "call _set_checkpoints before minimize (fluid contract)"
        return append_backward(loss, parameter_list, no_grad_set,
                               checkpoints=self._checkpoints)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        ops = self.apply_gradients(params_grads)
        return ops, params_grads


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
Lamb = LambOptimizer
Adamax = AdamaxOptimizer
Adagrad = AdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
LarsMomentum = LarsMomentumOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Dpsgd = DpsgdOptimizer
ProximalGD = ProximalGDOptimizer
ProximalAdagrad = ProximalAdagradOptimizer
