"""paddle.optimizer — the 2.0 dygraph optimizers.

Counterpart of paddle_tpu/optimizer/optimizer.py.  The update rules live
once, in the registered optimizer kernels (ops/kernels/optimizers.py,
the static optimizers' ops): `step()` runs the optimizer's kernel on
each parameter's value, gradient and accumulators and writes the new
value into the parameter in place, as the JAX package's `:131-143`
rebinds it.  The order is the JAX package's: the gradient clip over all
parameters (those with `need_clip` False left out), then per parameter
the coupled weight decay, then the kernel.

  * `SGD`, `Momentum`, `Adam`, `AdamW` (decoupled decay: the adamw
    kernel's `coeff`), `Lamb` (the lamb kernel's own decay), `Adamax`,
    `Adagrad`, `Adadelta` and `RMSProp`;
  * `weight_decay`: a float or `L2Decay` adds coeff * param to the
    gradient, `L1Decay` coeff * sign(param) (the JAX package applies an
    L1Decay as an L2 one);
  * `grad_clip`: `ClipGradByValue` / `ByNorm` / `ByGlobalNorm` (the
    static clips, through their `_eager_apply`);
  * the learning rate is a float or an `LRScheduler` (`get_lr`, `set_lr`
    for a float);
  * accumulators are fp32 tensors on the parameter's device, kept per
    parameter under its Paddle name (`param.paddle_name`);
    `state_dict()` / `set_state_dict()` key them `{name}_{accumulator}`
    (moment1, moment2, beta1_pow, beta2_pow, velocity, moment, inf_norm,
    avg_squared_grad, avg_squared_update, mean_square, mean_grad,
    momentum_acc) beside "LR_Scheduler", as the JAX package does.

AdamW accepts and ignores `apply_decay_param_fun` and decays every
parameter, as the JAX package does (`:248-256`; ROADMAP.md Queue 3).
The optimizer takes the eager place when it is built (CUDAPlace(0) unless
a `dygraph.guard(place)` says otherwise; it raises without a GPU) and
refuses parameters on another device.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from ..core.program import unique_name
from ..ops import kernels as _kernels  # noqa: F401  (registers the ops)
from ..ops.registry import OpContext, run_kernel
from .lr_scheduler import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb"]


def _name(p):
    """A parameter's Paddle name (one is given to a tensor without)."""
    if getattr(p, "paddle_name", None) is None:
        p.paddle_name = unique_name("param")
    return p.paddle_name


class Optimizer:
    _op_type: str = None
    # accumulator spec: (kernel slot, state key, fill, scalar)
    _accums = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, **attrs):
        from ..dygraph.base import current_place
        if parameters is None:
            raise ValueError(
                "parameters must be given when used in dygraph mode")
        self._learning_rate = learning_rate
        self._parameter_list = list(parameters)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._name = name or type(self).__name__
        self._attrs = attrs
        self._accumulators = {}  # state key -> {param name: tensor}
        self._staged_state = {}
        self._device = current_place().torch_device()
        wrong = [tuple(p.shape) for p in self._parameter_list
                 if p.device != self._device]
        if wrong:
            raise ValueError(
                f"{type(self).__name__}: parameters of shapes {wrong} are "
                f"not on the eager place {self._device}")

    # -- lr -----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("can't set_lr when lr is an LRScheduler")
        self._learning_rate = float(value)

    # -- accumulators -------------------------------------------------------
    def _fill(self, key, fill):
        return fill

    def _acc(self, key, param, fill=0.0, scalar=False):
        store = self._accumulators.setdefault(key, {})
        pname = _name(param)
        if pname not in store:
            staged = self._staged_state.get(f"{pname}_{key}")
            if staged is not None:  # from set_state_dict
                store[pname] = torch.as_tensor(staged).to(param.device)
            else:
                shape = (1,) if scalar else tuple(param.shape)
                store[pname] = torch.full(shape, self._fill(key, fill),
                                          dtype=torch.float32,
                                          device=param.device)
        return store[pname]

    # -- weight decay / clip ------------------------------------------------
    def _apply_decay_to_grad(self, param, grad):
        """Coupled decay: grad + coeff * param (L2, or a float), or
        grad + coeff * sign(param) (L1Decay)."""
        from ..static.optimizer import L1Decay
        wd = self._weight_decay
        if wd is None:
            return grad
        coeff = wd if isinstance(wd, (int, float)) else \
            getattr(wd, "coeff", 0.0)
        if not coeff:
            return grad
        p = param.detach().to(grad.dtype)
        return grad + coeff * (torch.sign(p) if isinstance(wd, L1Decay)
                               else p)

    def _clip_grads(self, params_grads):
        clip = self._grad_clip
        if clip is None:
            return params_grads
        if not hasattr(clip, "_eager_apply"):
            raise TypeError(f"{type(clip).__name__} does not support dygraph")
        to_clip = [(p, g) for p, g in params_grads
                   if getattr(p, "need_clip", True)]
        clipped = dict(zip((id(p) for p, _ in to_clip),
                           (g for _, g in clip._eager_apply(to_clip))))
        return [(p, clipped.get(id(p), g)) for p, g in params_grads]

    # -- step ---------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        if self._op_type is None:
            raise NotImplementedError(
                f"{type(self).__name__} names no optimizer kernel")
        lr = torch.full((1,), self.get_lr(), dtype=torch.float32,
                        device=self._device)
        ctx = OpContext(device=self._device)
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.requires_grad and p.grad is not None]
        for p, g in self._clip_grads(params_grads):
            ins = {"Param": p.detach(), "Grad": self._apply_decay_to_grad(p, g),
                   "LearningRate": lr}
            for slot, key, fill, scalar in self._accums:
                ins[slot] = self._acc(key, p, fill, scalar)
            outs = run_kernel(self._op_type, ins, dict(self._attrs), ctx)
            p.copy_(outs["ParamOut"])
            for slot, key, _, _ in self._accums:
                out = outs.get(slot + "Out")
                if out is not None:
                    self._accumulators[key][_name(p)] = out

    def clear_grad(self):
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """The step on the gradients `loss.backward()` left (dygraph:
        minimize does not run the backward)."""
        self.step()
        return None, [(p, p.grad) for p in self._parameter_list]

    # -- state --------------------------------------------------------------
    def state_dict(self):
        sd = OrderedDict()
        for key, store in self._accumulators.items():
            for pname, val in store.items():
                sd[f"{pname}_{key}"] = val
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    def set_state_dict(self, state_dict):
        sched = state_dict.get("LR_Scheduler")
        if sched is not None and isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(sched)
        for key, store in self._accumulators.items():
            for pname in store:
                val = state_dict.get(f"{pname}_{key}")
                if val is not None:
                    store[pname] = torch.as_tensor(val).to(
                        store[pname].device)
        # accumulators not made yet: staged for _acc to pick up
        self._staged_state = dict(state_dict)


class SGD(Optimizer):
    _op_type = "sgd"

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)


class Momentum(Optimizer):
    _op_type = "momentum"
    _accums = (("Velocity", "velocity", 0.0, False),)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, mu=momentum, use_nesterov=use_nesterov)


class Adam(Optimizer):
    _op_type = "adam"
    _accums = (("Moment1", "moment1", 0.0, False),
               ("Moment2", "moment2", 0.0, False),
               ("Beta1Pow", "beta1_pow", None, True),
               ("Beta2Pow", "beta2_pow", None, True))

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, name=None):
        # dygraph gradients are dense, so lazy_mode changes nothing (the
        # JAX package accepts and ignores it too)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, beta1=beta1, beta2=beta2, epsilon=epsilon)

    def _fill(self, key, fill):
        # the beta pow accumulators start at beta^1
        if fill is None:
            return self._attrs["beta1" if "beta1" in key else "beta2"]
        return fill


class AdamW(Adam):
    _op_type = "adamw"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, lazy_mode=False, name=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, name)
        # decoupled decay is the adamw kernel's attr, not a grad rewrite;
        # apply_decay_param_fun (in **kw) is ignored, as in the JAX package
        coeff = weight_decay if isinstance(weight_decay, (int, float)) \
            else getattr(weight_decay, "coeff", 0.01)
        self._attrs["coeff"] = float(coeff)


class Lamb(Adam):
    _op_type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, False, name)
        # the lamb kernel takes the decay as an attr (trust-scaled)
        self._attrs["weight_decay"] = float(lamb_weight_decay)


class Adamax(Optimizer):
    _op_type = "adamax"
    _accums = (("Moment", "moment", 0.0, False),
               ("InfNorm", "inf_norm", 0.0, False),
               ("Beta1Pow", "beta1_pow", None, True))

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, beta1=beta1, beta2=beta2, epsilon=epsilon)

    def _fill(self, key, fill):
        # the beta1 pow accumulator starts at beta1
        return self._attrs["beta1"] if fill is None else fill


class Adagrad(Optimizer):
    _op_type = "adagrad"
    _accums = (("Moment", "moment", 0.0, False),)

    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, epsilon=epsilon)
        if initial_accumulator_value:
            self._accums = (("Moment", "moment",
                             initial_accumulator_value, False),)


class Adadelta(Optimizer):
    _op_type = "adadelta"
    _accums = (("AvgSquaredGrad", "avg_squared_grad", 0.0, False),
               ("AvgSquaredUpdate", "avg_squared_update", 0.0, False))

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, epsilon=epsilon, rho=rho)


class RMSProp(Optimizer):
    _op_type = "rmsprop"
    _accums = (("MeanSquare", "mean_square", 0.0, False),
               ("MeanGrad", "mean_grad", 0.0, False),
               ("Moment", "momentum_acc", 0.0, False))

    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, decay=rho, epsilon=epsilon, momentum=momentum,
                         centered=centered)
