"""Dygraph AMP: the auto_cast context and GradScaler.

Counterpart of paddle_tpu/amp/auto_cast.py (the reference's
imperative/amp_auto_cast.cc and dygraph/amp/loss_scaler.py).  The cast
hook is `dygraph.tracer.amp_inputs`, which every port functional op calls
with the op type the JAX package traces for it; `cast_for_op` decides as
the JAX package's `amp_cast_inputs` does:

  * O1: white-list ops (matmul_v2, ...) cast floating inputs to the low
    dtype (bfloat16 by default), black-list ops (reduce_mean, ...) to
    fp32, and every other op runs on its inputs as they are (so a bf16
    product plus an fp32 bias promotes to fp32, in torch as in jnp);
  * O2: every op not on the black list casts to the low dtype;
  * O0: off.

`GradScaler` scales the loss, unscales the parameters' gradients (to
fp32) with one host read for the finite check, skips the optimizer step
when a gradient is not finite and halves the scale (or grows it after
`incr_every_n_steps` good steps); a second unscale before `update()`
raises.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..core.dtype import torch_dtype
from .fp16_lists import AutoMixedPrecisionLists

__all__ = ["auto_cast", "amp_guard", "GradScaler", "amp_state",
           "cast_for_op"]


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.level = "O1"
        self.dtype = "bfloat16"
        self.lists = None


_state = _AmpState()


def amp_state():
    return _state


@contextlib.contextmanager
def amp_guard(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    if level not in ("O0", "O1", "O2"):
        raise ValueError(f"level must be O0/O1/O2, got {level}")
    prev = (_state.enabled, _state.level, _state.dtype, _state.lists)
    _state.enabled = bool(enable) and level != "O0"
    _state.level = level
    _state.dtype = dtype
    _state.lists = AutoMixedPrecisionLists(custom_white_list,
                                           custom_black_list)
    try:
        yield
    finally:
        (_state.enabled, _state.level, _state.dtype, _state.lists) = prev


auto_cast = amp_guard  # paddle.amp.auto_cast 2.0 spelling


def _target_dtype(op_type: str):
    """The dtype `op_type`'s floating inputs are cast to, or None."""
    lists = _state.lists or AutoMixedPrecisionLists()
    if _state.level == "O2":
        return "float32" if op_type in lists.black_list else _state.dtype
    if op_type in lists.white_list:
        return _state.dtype
    if op_type in lists.black_list:
        return "float32"
    return None


def _cast(v, dtype):
    if isinstance(v, torch.Tensor) and v.is_floating_point() and \
            v.dtype != dtype:
        return v.to(dtype)
    return v


def cast_for_op(op_type: str, tensors):
    """`tensors` (a sequence) as the active guard casts them for one
    `op_type` op; a tuple."""
    if not _state.enabled:
        return tuple(tensors)
    target = _target_dtype(op_type)
    if target is None:
        return tuple(tensors)
    dt = torch_dtype(target)
    return tuple(_cast(t, dt) for t in tensors)


def _grads_of(optimizer):
    params = getattr(optimizer, "_parameter_list", None)
    if not params:
        raise ValueError("optimizer has no parameters to unscale")
    return params


class GradScaler:
    """paddle.amp.GradScaler."""

    def __init__(self, enable=True, init_loss_scaling=2 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._use_dynamic = use_dynamic_loss_scaling
        self._good = 0
        self._bad = 0
        self._found_inf = False
        self._unscaled = False  # guards against a second division a step

    def is_enable(self):
        return self._enable

    def get_loss_scaling(self):
        return self._scale

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    def _unscale_and_check(self, optimizer):
        """Divide every gradient by the scale (in fp32); one host read of
        whether all are finite.  Raises on a second unscale before
        update()."""
        if self._unscaled:
            raise RuntimeError(
                "unscale_() has already been called on this optimizer "
                "since the last update()")
        self._unscaled = True
        params = [p for p in _grads_of(optimizer) if p.grad is not None]
        inv = 1.0 / self._scale
        finite = []
        for p in params:
            g = p.grad.float() * inv
            finite.append(torch.isfinite(g).all())
            p.grad = g.to(p.grad.dtype)  # a parameter's own dtype
        self._found_inf = bool(finite) and \
            not bool(torch.stack(finite).all())  # the one host read

    def minimize(self, optimizer, scaled_loss, *args, **kwargs):
        """Unscale, skip on inf, step, update the dynamic scale."""
        if not self._enable:
            return optimizer.minimize(scaled_loss, *args, **kwargs)
        self.step(optimizer, scaled_loss, *args, **kwargs)
        self._update()
        return None

    def step(self, optimizer, scaled_loss=None, *args, **kwargs):
        """Unscale (if not yet) and run the optimizer step unless a
        gradient is not finite.  Does not update the scale: pair with
        update(), or use minimize()."""
        if not self._enable:
            return optimizer.step()
        if not self._unscaled:
            self._unscale_and_check(optimizer)
        if not self._found_inf:
            optimizer.step()

    def unscale_(self, optimizer):
        self._unscale_and_check(optimizer)

    def update(self):
        self._update()

    def _update(self):
        self._unscaled = False
        if not self._use_dynamic:
            self._found_inf = False
            return
        if self._found_inf:
            self._bad += 1
            self._good = 0
            if self._bad >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad = 0
        else:
            self._good += 1
            self._bad = 0
            if self._good >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good = 0
        self._found_inf = False

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio, "good_steps": self._good,
                "bad_steps": self._bad,
                "incr_every_n_steps": self._incr_every_n_steps,
                "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf}

    def load_state_dict(self, d):
        self._scale = d["scale"]
        self._good = d.get("good_steps", 0)
        self._bad = d.get("bad_steps", 0)
        self._incr_ratio = d.get("incr_ratio", self._incr_ratio)
        self._decr_ratio = d.get("decr_ratio", self._decr_ratio)
        self._incr_every_n_steps = d.get("incr_every_n_steps",
                                         self._incr_every_n_steps)
        self._decr_every_n_nan_or_inf = d.get("decr_every_n_nan_or_inf",
                                              self._decr_every_n_nan_or_inf)


AmpScaler = GradScaler  # fluid dygraph spelling
