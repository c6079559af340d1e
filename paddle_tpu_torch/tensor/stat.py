"""paddle.tensor statistics functions (dual-mode; counterpart of
paddle_tpu/tensor/stat.py, the same names and ops, dispatched
through tensor/_dispatch.py)."""
from __future__ import annotations

import numpy as np
import torch

from ..dygraph import tracer as _tracer
from ..dygraph.tracer import recording
from ._dispatch import dispatch
from .math import mean, sum as _sum  # noqa: F401 (mean re-exported)

__all__ = ["mean", "std", "var", "numel", "median"]


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    from . import math as m
    mu = m.mean(x, axis=axis, keepdim=True)
    sq = m.multiply(m.subtract(x, mu), m.subtract(x, mu))
    out = m.mean(sq, axis=axis, keepdim=keepdim)
    if unbiased:
        if axis is None:
            n = int(np.prod(x.shape))
        else:
            axes = [axis] if np.isscalar(axis) else list(axis)
            n = int(np.prod([x.shape[a] for a in axes]))
        if n > 1:
            out = m.scale(out, scale=n / (n - 1.0))
    return out


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    from . import math as m
    return m.sqrt(var(x, axis, unbiased, keepdim))


def numel(x, name=None):
    return dispatch("size", {"Input": x}, name=name)


def median(x, axis=None, keepdim=False, name=None):
    """jnp.median: the middle element, the mean of the two middle ones for
    an even count (eager only, as in the JAX package)."""
    if not isinstance(x, torch.Tensor):
        raise NotImplementedError("median is eager-only for now")
    if recording():
        _tracer.refuse("median")
    v = x.reshape(-1) if axis is None else x
    ax = 0 if axis is None else axis
    s = torch.sort(v, dim=ax).values
    n = s.shape[ax]
    lo = s.narrow(ax, (n - 1) // 2, 1)
    hi = s.narrow(ax, n // 2, 1)
    out = (lo + hi) / 2 if n % 2 == 0 else lo.to(torch.promote_types(
        lo.dtype, torch.float32))
    if axis is None:
        return out.reshape((1,) * x.dim()) if keepdim else out.reshape(())
    return out if keepdim else out.squeeze(ax)
