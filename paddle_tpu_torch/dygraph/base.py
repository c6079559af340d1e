"""Dygraph guard, grad guards and the eager place.

Counterpart of paddle_tpu/dygraph/base.py (the reference's
fluid/dygraph/base.py guard / enabled / no_grad).  Imperative mode is
PyTorch's eager mode and is on by default; `enable_static()` turns the
flag off and `disable_static()` back on.  As in the JAX package the flag
steers only the dual-mode `paddle_tpu_torch.tensor` functions that take
no tensor input (creation, random): with it off they append their op to
the current Program (the static-graph API builds programs whatever the
flag says).  The grad guards are torch's own, and "tape recording" is
torch autograd recording:

  * `no_grad` (a context manager and, as `no_grad()`, a decorator),
    `enable_grad`, `set_grad_enabled(flag)` and `is_grad_enabled()` are
    torch.no_grad / enable_grad / set_grad_enabled / is_grad_enabled.

`guard(place)` also sets the place that `to_tensor` and new `Layer`
parameters use.  With no place set that is CUDAPlace(0), which raises
when no GPU is present (no silent move to the CPU): the CPU tests run
inside `guard(CPUPlace())`.  The place is process-wide, not per thread,
so a serving thread sees the place its model was built under.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..core.place import resolve_place

__all__ = ["enabled", "in_dygraph_mode", "in_dynamic_mode",
           "enable_static", "disable_static", "guard",
           "no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled",
           "current_place"]

_place = [None]  # the eager place; None = the default (CUDAPlace(0))


class _Mode(threading.local):
    def __init__(self):
        self.dygraph = True  # paddle 2.0's default: imperative


_mode = _Mode()


def enabled() -> bool:
    return _mode.dygraph


in_dygraph_mode = in_dynamic_mode = enabled


def enable_static():
    """paddle.enable_static: tensor functions without a tensor input
    build ops in the current Program."""
    _mode.dygraph = False


def disable_static(place=None):
    """paddle.disable_static: back to imperative mode (on `place`, when
    given, as `guard` sets it)."""
    _mode.dygraph = True
    if place is not None:
        _place[0] = resolve_place(place)


def current_place():
    """The eager place: the one `guard` set, else CUDAPlace(0) (raises
    without a GPU)."""
    return resolve_place(_place[0])


@contextlib.contextmanager
def guard(place=None):
    """fluid.dygraph.guard — run a `with` body in dygraph mode, on
    `place` when one is given."""
    prev, prev_mode = _place[0], _mode.dygraph
    _mode.dygraph = True
    if place is not None:
        _place[0] = resolve_place(place)
    try:
        yield
    finally:
        _place[0], _mode.dygraph = prev, prev_mode


# torch's grad guards (no_grad and enable_grad are context managers and
# decorators; set_grad_enabled(flag) is a context manager that also sets
# the mode when called alone)
no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled
