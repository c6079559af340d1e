"""paddle.tensor math functions (dual-mode; counterpart of
paddle_tpu/tensor/math.py, the same names and ops).

Each dispatches the op the JAX package dispatches (tensor/_dispatch.py:
eager through the port registry's kernel, recorded under a `to_static`
recorder, appended to the Program on `VarDesc`s).  `add`, `subtract`,
`multiply`, `divide`, `scale`, `mean` and `sum`, which the dygraph
training slices run every step, keep their own eager path: the AMP cast
of the op (`elementwise_add`, `scale`, `reduce_mean`, ...) then torch
ops, with Python scalars kept scalars (the result keeps the tensor's
dtype, as the JAX package's `wrap_data` makes a scalar operand of the
tensor's dtype)."""
from __future__ import annotations

import numpy as np
import torch

from ..dygraph.tracer import amp_inputs, recording
from ._dispatch import dispatch, is_eager, reduce_attrs, wrap_data

__all__ = []  # populated below


def _export(fn, name=None):
    name = name or fn.__name__
    globals()[name] = fn
    __all__.append(name)
    return fn


def _eager_path(*tensors) -> bool:
    """The own eager path: torch tensors, no recorder."""
    return not recording() and is_eager(
        {str(i): t for i, t in enumerate(tensors)})


# ---------------------------------------------------------------------------
# unary elementwise
# ---------------------------------------------------------------------------
_UNARY = [
    "exp", "sqrt", "rsqrt", "abs", "ceil", "floor", "round", "sin", "cos",
    "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh", "reciprocal",
    "square", "sign", "erf", "log", "log2", "log10", "log1p", "sigmoid",
]


def _make_unary(op_type):
    def fn(x, name=None):
        return dispatch(op_type, {"X": x}, name=name)

    fn.__name__ = op_type
    fn.__doc__ = f"Elementwise {op_type} (kernel: ops/kernels)."
    return fn


for _op in _UNARY:
    _export(_make_unary(_op))


# ---------------------------------------------------------------------------
# binary elementwise (broadcasting)
# ---------------------------------------------------------------------------
def _binary(op_type, x, y, name=None):
    y = wrap_data(y, like=x)
    x = wrap_data(x, like=y)
    return dispatch(op_type, {"X": x, "Y": y}, {"axis": -1}, name=name)


def _own_binary(op_type, fn):
    def f(x, y, name=None):
        if not _eager_path(x, y):
            return _binary(op_type, x, y, name)
        x, y = amp_inputs(op_type, x, y)
        return fn(x, y)
    f.__name__ = op_type.split("_", 1)[1]
    return f


add = _export(_own_binary("elementwise_add", torch.add), "add")
subtract = _export(_own_binary("elementwise_sub", torch.sub), "subtract")
multiply = _export(_own_binary("elementwise_mul", torch.mul), "multiply")
divide = _export(_own_binary("elementwise_div", torch.div), "divide")


@_export
def floor_divide(x, y, name=None):
    return _binary("elementwise_floordiv", x, y, name)


@_export
def remainder(x, y, name=None):
    return _binary("elementwise_mod", x, y, name)


mod = remainder
_export(remainder, "mod")
floor_mod = remainder
_export(remainder, "floor_mod")


@_export
def pow(x, y, name=None):
    if isinstance(y, (int, float)):
        return dispatch("pow", {"X": x}, {"factor": float(y)}, name=name)
    return _binary("elementwise_pow", x, y, name)


@_export
def maximum(x, y, name=None):
    return _binary("elementwise_max", x, y, name)


@_export
def minimum(x, y, name=None):
    return _binary("elementwise_min", x, y, name)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------
def _reduce(op_type, x, axis, keepdim, name=None):
    return dispatch(op_type, {"X": x}, reduce_attrs(axis, keepdim),
                    name=name)


def _dims(axis):
    if axis is None:
        return None
    return [axis] if np.isscalar(axis) else list(axis)


@_export
def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    if _eager_path(x):
        (x,) = amp_inputs("reduce_sum", x)
        dims = _dims(axis)
        out = x.sum() if dims is None and not keepdim else \
            x.sum(dim=dims, keepdim=keepdim)
    else:
        out = _reduce("reduce_sum", x, axis, keepdim, name)
    if dtype is not None:
        from .manipulation import cast
        out = cast(out, dtype)
    return out


@_export
def mean(x, axis=None, keepdim=False, name=None):
    if not _eager_path(x):
        return _reduce("reduce_mean", x, axis, keepdim, name)
    (x,) = amp_inputs("reduce_mean", x)
    dims = _dims(axis)
    return x.mean() if dims is None and not keepdim else \
        x.mean(dim=dims, keepdim=keepdim)


@_export
def max(x, axis=None, keepdim=False, name=None):
    return _reduce("reduce_max", x, axis, keepdim, name)


@_export
def min(x, axis=None, keepdim=False, name=None):
    return _reduce("reduce_min", x, axis, keepdim, name)


@_export
def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    out = _reduce("reduce_prod", x, axis, keepdim, name)
    if dtype is not None:
        from .manipulation import cast
        out = cast(out, dtype)
    return out


@_export
def all(x, axis=None, keepdim=False, name=None):
    return _reduce("reduce_all", x, axis, keepdim, name)


@_export
def any(x, axis=None, keepdim=False, name=None):
    return _reduce("reduce_any", x, axis, keepdim, name)


@_export
def logsumexp(x, axis=None, keepdim=False, name=None):
    attrs = {"keepdim": bool(keepdim)}
    if axis is None:
        attrs["reduce_all"] = True
        attrs["axis"] = [0]
    else:
        attrs["axis"] = [axis] if np.isscalar(axis) else list(axis)
    return dispatch("logsumexp", {"X": x}, attrs, name=name)


# ---------------------------------------------------------------------------
# other math
# ---------------------------------------------------------------------------
@_export
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    if not _eager_path(x):
        out = dispatch("scale", {"X": x},
                       {"scale": float(scale), "bias": float(bias),
                        "bias_after_scale": bool(bias_after_scale)},
                       name=name)
        return dispatch(act, {"X": out}) if act else out
    (x,) = amp_inputs("scale", x)
    if not bias:  # x * scale + 0 is x * scale (but for the sign of 0)
        out = x * scale
    else:
        out = x * scale + bias if bias_after_scale else (x + bias) * scale
    if act is not None:
        out = getattr(torch, act)(out)
    return out


@_export
def clip(x, min=None, max=None, name=None):
    lo = -3.4e38 if min is None else float(min)
    hi = 3.4e38 if max is None else float(max)
    return dispatch("clip", {"X": x}, {"min": lo, "max": hi}, name=name)


@_export
def cumsum(x, axis=None, dtype=None, name=None):
    attrs = {"flatten": axis is None, "axis": int(axis or 0)}
    out = dispatch("cumsum", {"X": x}, attrs, name=name)
    if dtype is not None:
        from .manipulation import cast
        out = cast(out, dtype)
    return out


@_export
def increment(x, value=1.0, name=None):
    return dispatch("increment", {"X": x}, {"step": float(value)}, name=name)


@_export
def multiplex(inputs, index, name=None):
    return dispatch("multiplex", {"X": list(inputs), "Ids": index},
                    name=name)


@_export
def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return dispatch("stanh", {"X": x},
                    {"scale_a": scale_a, "scale_b": scale_b}, name=name)


@_export
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return dispatch("addmm", {"Input": input, "X": x, "Y": y},
                    {"Beta": float(beta), "Alpha": float(alpha)}, name=name)


@_export
def kron(x, y, name=None):
    return dispatch("kron", {"X": x, "Y": y}, name=name)


@_export
def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return dispatch("trace", {"Input": x},
                    {"offset": offset, "axis1": axis1, "axis2": axis2},
                    name=name)


@_export
def isfinite(x, name=None):
    return dispatch("isfinite_v2", {"X": x}, name=name)


@_export
def isinf(x, name=None):
    return dispatch("isinf_v2", {"X": x}, name=name)


@_export
def isnan(x, name=None):
    return dispatch("isnan_v2", {"X": x}, name=name)


@_export
def tanh_(x, name=None):
    """tanh written into x (an eager tensor, outside autograd's view of
    x's old value); a graph var gets a new var, as in the JAX package."""
    out = dispatch("tanh", {"X": x}, name=name)
    if isinstance(x, torch.Tensor):
        with torch.no_grad():
            x.copy_(out)
        return x
    return out
