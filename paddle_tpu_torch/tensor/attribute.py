"""paddle.tensor attribute functions (dual-mode; counterpart of
paddle_tpu/tensor/attribute.py, the same names and ops, dispatched
through tensor/_dispatch.py)."""
from __future__ import annotations

from ._dispatch import dispatch

__all__ = ["shape", "rank", "real", "imag"]


def shape(input, name=None):
    return dispatch("shape", {"Input": input}, name=name)


def rank(input, name=None):
    from .creation import full
    return full([1], len(input.shape), "int32")


def real(x, name=None):
    return dispatch("assign", {"X": x}, name=name)


def imag(x, name=None):
    from .creation import zeros_like
    return zeros_like(x)
