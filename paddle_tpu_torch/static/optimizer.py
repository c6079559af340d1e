"""Optimizers: program-rewriting minimize() = backward + optimizer ops.

Counterpart of paddle_tpu/static/optimizer.py: the `Optimizer` base
(`backward`, `apply_gradients`, `minimize`, `set_lr` / `get_lr`), `SGD`,
`Momentum`, `Adam`, `AdamW` and `Lamb`, the regularizers `L1Decay` /
`L2Decay`, the gradient clips `GradientClipByValue` / `ByNorm` /
`ByGlobalNorm`, and `gradient_merge`.  `apply_gradients` runs the
reference's order: clip, then regularize, then one optimizer op per
parameter.  Accumulators (moments, beta pows, velocities) are persistable
vars initialised in the startup program, so optimizer state lives in the
Scope beside the parameters.  A learning rate may be a float, a var or an
`optimizer.lr_scheduler.LRScheduler`, whose `step()` writes the new value
into the scope.

The clips also have the dygraph `_eager_apply(params_grads)` that the 2.0
optimizers (optimizer/optimizer.py) call on torch gradients: the same
arithmetic in fp32, the result in each gradient's dtype.

Not ported yet (ROADMAP.md Queue 1, Training breadth): the other optimizers (Adamax,
Adagrad, Adadelta, RMSProp, Ftrl, LarsMomentum, DecayedAdagrad, Dpsgd,
ProximalGD, ProximalAdagrad), ExponentialMovingAverage, ModelAverage,
Lookahead, RecomputeOptimizer and `Adam(lazy_mode=True)`.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.program import VarDesc, OpRole, default_main_program, unique_name
from .backward import append_backward
from .initializer import Constant
from .layer_helper import LayerHelper
from . import layers

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum",
           "MomentumOptimizer", "Adam", "AdamOptimizer", "AdamW", "Lamb",
           "LambOptimizer", "L1Decay", "L2Decay", "GradientClipByValue",
           "GradientClipByNorm", "GradientClipByGlobalNorm",
           "gradient_merge"]


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


class AdamOptimizer(Optimizer):
    _op = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        if lazy_mode:
            raise NotImplementedError(
                "Adam(lazy_mode=True) needs sparse gradients, not ported "
                "yet (ROADMAP.md Queue 1, Training breadth)")
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


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
Lamb = LambOptimizer
