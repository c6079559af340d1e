"""paddle.tensor creation functions (dual-mode; counterpart of
paddle_tpu/tensor/creation.py, the same names and ops, dispatched
through tensor/_dispatch.py)."""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtype import convert_dtype
from ..dygraph.base import in_dygraph_mode
from ..dygraph.tensor import to_tensor  # noqa: F401 (re-export)
from ._dispatch import dispatch

# the eager tensor type (the JAX package's own Tensor class)
Tensor = torch.Tensor

__all__ = [
    "to_tensor", "zeros", "ones", "full", "zeros_like", "ones_like",
    "full_like", "arange", "linspace", "eye", "empty", "empty_like",
    "meshgrid", "diag", "diag_embed", "tril", "triu", "clone", "assign",
    "Tensor",
]


def _shape_list(shape):
    if np.isscalar(shape):
        return [int(shape)]
    return [int(s) for s in shape]


def full(shape, fill_value, dtype=None, name=None):
    from ..core.dtype import get_default_dtype
    dtype = convert_dtype(dtype or get_default_dtype())
    return dispatch("fill_constant", {},
                    {"shape": _shape_list(shape), "dtype": dtype,
                     "value": float(fill_value)}, name=name)


def zeros(shape, dtype=None, name=None):
    return full(shape, 0.0, dtype, name)


def ones(shape, dtype=None, name=None):
    return full(shape, 1.0, dtype, name)


def full_like(x, fill_value, dtype=None, name=None):
    dtype = convert_dtype(dtype) if dtype else None
    return dispatch("fill_any_like", {"X": x},
                    {"value": float(fill_value), "dtype": dtype}, name=name)


def zeros_like(x, dtype=None, name=None):
    return full_like(x, 0.0, dtype, name)


def ones_like(x, dtype=None, name=None):
    return full_like(x, 1.0, dtype, name)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    if end is None:
        start, end = 0, start
    dtype = convert_dtype(dtype or "int64")
    return dispatch("range", {},
                    {"start": start, "end": end, "step": step,
                     "dtype": dtype}, name=name)


def linspace(start, stop, num, dtype=None, name=None):
    dtype = convert_dtype(dtype or "float32")
    return dispatch("linspace", {},
                    {"start": float(start), "stop": float(stop),
                     "num": int(num), "dtype": dtype}, name=name)


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return dispatch("eye", {},
                    {"num_rows": int(num_rows),
                     "num_columns": int(num_columns or num_rows),
                     "dtype": convert_dtype(dtype or "float32")}, name=name)


def empty(shape, dtype=None, name=None):
    # deterministic zeros, as the JAX package's
    return zeros(shape, dtype, name)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype, name)


def meshgrid(*args, name=None):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return dispatch("meshgrid", {"X": list(args)}, {}, ["Out"], name=name,
                    out_counts={"Out": len(args)})


def diag(x, offset=0, padding_value=0, name=None):
    return dispatch("diag_v2", {"X": x},
                    {"offset": offset, "padding_value": padding_value},
                    name=name)


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    return dispatch("diag_embed", {"Input": input},
                    {"offset": offset, "dim1": dim1, "dim2": dim2}, name=name)


def tril(x, diagonal=0, name=None):
    return dispatch("tril_triu", {"X": x},
                    {"diagonal": diagonal, "lower": True}, name=name)


def triu(x, diagonal=0, name=None):
    return dispatch("tril_triu", {"X": x},
                    {"diagonal": diagonal, "lower": False}, name=name)


def clone(x, name=None):
    return dispatch("assign", {"X": x}, name=name)


def assign(x, output=None):
    if not hasattr(x, "shape") or isinstance(x, (list, tuple)):
        x = np.asarray(x)
    if isinstance(x, np.ndarray):
        if in_dygraph_mode():
            t = to_tensor(x)
            if output is not None:
                return _set_value(output, t)
            return t
        from ..static import layers
        return layers.assign(x, output)
    out = dispatch("assign", {"X": x})
    if output is not None and isinstance(output, torch.Tensor):
        return _set_value(output, out)
    return out


def _set_value(output, value):
    """The eager `output.set_value(value)`: the values copied in, outside
    autograd."""
    with torch.no_grad():
        output.copy_(value)
    return output
