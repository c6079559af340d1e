"""paddle.tensor logic / compare functions (dual-mode; counterpart of
paddle_tpu/tensor/logic.py, the same names and ops, dispatched
through tensor/_dispatch.py)."""
from __future__ import annotations

from ._dispatch import dispatch, wrap_data

__all__ = [
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal", "logical_and", "logical_or", "logical_not",
    "logical_xor", "allclose", "equal_all", "is_empty", "is_tensor",
]


def _cmp(op_type, x, y, name=None):
    y = wrap_data(y, like=x)
    return dispatch(op_type, {"X": x, "Y": y}, name=name)


def equal(x, y, name=None):
    return _cmp("equal", x, y, name)


def not_equal(x, y, name=None):
    return _cmp("not_equal", x, y, name)


def less_than(x, y, name=None):
    return _cmp("less_than", x, y, name)


def less_equal(x, y, name=None):
    return _cmp("less_equal", x, y, name)


def greater_than(x, y, name=None):
    return _cmp("greater_than", x, y, name)


def greater_equal(x, y, name=None):
    return _cmp("greater_equal", x, y, name)


def logical_and(x, y, out=None, name=None):
    return dispatch("logical_and", {"X": x, "Y": y}, name=name)


def logical_or(x, y, out=None, name=None):
    return dispatch("logical_or", {"X": x, "Y": y}, name=name)


def logical_xor(x, y, out=None, name=None):
    return dispatch("logical_xor", {"X": x, "Y": y}, name=name)


def logical_not(x, out=None, name=None):
    return dispatch("logical_not", {"X": x}, name=name)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return dispatch("allclose", {"Input": x, "Other": y},
                    {"rtol": str(rtol), "atol": str(atol),
                     "equal_nan": equal_nan}, name=name)


def equal_all(x, y, name=None):
    return dispatch("equal_all", {"X": x, "Y": y}, name=name)


def is_empty(x, name=None):
    return dispatch("is_empty", {"X": x}, name=name)


def is_tensor(x):
    import torch
    from ..core.program import VarDesc
    return isinstance(x, (torch.Tensor, VarDesc))
