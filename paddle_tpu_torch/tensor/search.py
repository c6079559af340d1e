"""paddle.tensor search / sort functions (dual-mode; counterpart of
paddle_tpu/tensor/search.py, the same names and ops, dispatched
through tensor/_dispatch.py)."""
from __future__ import annotations

from ..core.dtype import convert_dtype
from ._dispatch import dispatch

__all__ = [
    "argmax", "argmin", "argsort", "sort", "topk", "where", "nonzero",
    "index_select", "masked_select", "index_sample",
]


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    attrs = {"axis": -1 if axis is None else int(axis),
             "flatten": axis is None, "keepdims": bool(keepdim),
             "dtype": convert_dtype(dtype)}
    return dispatch("arg_max", {"X": x}, attrs, name=name)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    attrs = {"axis": -1 if axis is None else int(axis),
             "flatten": axis is None, "keepdims": bool(keepdim),
             "dtype": convert_dtype(dtype)}
    return dispatch("arg_min", {"X": x}, attrs, name=name)


def argsort(x, axis=-1, descending=False, name=None):
    _, indices = dispatch("argsort", {"X": x},
                          {"axis": int(axis), "descending": descending},
                          ["Out", "Indices"], name=name)
    return indices


def sort(x, axis=-1, descending=False, name=None):
    out, _ = dispatch("argsort", {"X": x},
                      {"axis": int(axis), "descending": descending},
                      ["Out", "Indices"], name=name)
    return out


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    attrs = {"k": int(k), "axis": -1 if axis is None else int(axis),
             "largest": bool(largest), "sorted": bool(sorted)}
    return dispatch("top_k_v2", {"X": x}, attrs, ["Out", "Indices"],
                    name=name)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition)
    return dispatch("where", {"Condition": condition, "X": x, "Y": y},
                    name=name)


def nonzero(x, as_tuple=False, name=None):
    out = dispatch("where_index", {"Condition": x}, name=name)
    if as_tuple:
        from .manipulation import unbind
        return tuple(unbind(out, axis=1))
    return out


# re-exported from manipulation for API parity
from .manipulation import index_select, masked_select, index_sample  # noqa: E402,F401
