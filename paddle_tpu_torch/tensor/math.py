"""Elementwise, scale and reduction functions (counterpart of
paddle_tpu/tensor/math.py and the eager Tensor's operators): each is the
op the JAX package traces (`elementwise_add`, `scale`, `reduce_mean`,
...), AMP-cast as that op, then a torch op; under a `to_static`
recorder the op itself, dispatched (tensor/_dispatch.py).  Python scalars stay scalars
(the result keeps the tensor's dtype, as the JAX package's `wrap_data`
makes a scalar operand of the tensor's dtype)."""
from __future__ import annotations

import torch

from ..dygraph.tracer import amp_inputs, recording
from ._dispatch import _const, _reduce, dispatch

__all__ = ["add", "subtract", "multiply", "divide", "scale", "mean", "sum"]


def _binary(op_type, fn):
    def f(x, y, name=None):
        if recording():
            if not isinstance(y, torch.Tensor):
                y = _const(x, y)
            elif not isinstance(x, torch.Tensor):
                x = _const(y, x)
            return dispatch(op_type, {"X": x, "Y": y}, {"axis": -1})
        x, y = amp_inputs(op_type, x, y)
        return fn(x, y)
    f.__name__ = op_type.split("_", 1)[1]
    return f


add = _binary("elementwise_add", torch.add)
subtract = _binary("elementwise_sub", torch.sub)
multiply = _binary("elementwise_mul", torch.mul)
divide = _binary("elementwise_div", torch.div)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    if recording():
        out = dispatch("scale", {"X": x},
                      {"scale": float(scale), "bias": float(bias),
                       "bias_after_scale": bool(bias_after_scale)})
        return dispatch(act, {"X": out}, {}) if act else out
    (x,) = amp_inputs("scale", x)
    if not bias:  # x * scale + 0 is x * scale (but for the sign of 0)
        out = x * scale
    else:
        out = x * scale + bias if bias_after_scale else (x + bias) * scale
    if act is not None:
        out = getattr(torch, act)(out)
    return out


def _dims(axis):
    if axis is None:
        return None
    return [axis] if isinstance(axis, int) else list(axis)


def mean(x, axis=None, keepdim=False, name=None):
    if recording():
        return _reduce("reduce_mean")(x, axis, keepdim)
    (x,) = amp_inputs("reduce_mean", x)
    dims = _dims(axis)
    return x.mean() if dims is None and not keepdim else \
        x.mean(dim=dims, keepdim=keepdim)


def sum(x, axis=None, keepdim=False, name=None):
    if recording():
        return _reduce("reduce_sum")(x, axis, keepdim)
    (x,) = amp_inputs("reduce_sum", x)
    dims = _dims(axis)
    return x.sum() if dims is None and not keepdim else \
        x.sum(dim=dims, keepdim=keepdim)


