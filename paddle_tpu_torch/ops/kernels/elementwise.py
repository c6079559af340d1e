"""elementwise_add and elementwise_mul with Paddle's `axis` broadcast:
Y's dims align to X's starting at `axis` (axis=-1 means numpy-style
trailing alignment).
Counterpart of paddle_tpu/ops/kernels/elementwise.py."""
from __future__ import annotations

import torch

from ..registry import register_op


def _broadcast_y(x, y, axis):
    if axis == -1 or axis is None or tuple(x.shape) == tuple(y.shape):
        return y
    # pad y's shape with trailing 1s so y.dims align to x.dims at `axis`
    pad = x.dim() - axis - y.dim()
    if pad > 0:
        y = y.reshape(tuple(y.shape) + (1,) * pad)
    return y


def _ew(name, fn):
    @register_op(name, inputs=["X", "Y"], outputs=["Out"])
    def kernel(ins, attrs, ctx):
        x, y = ins["X"], ins["Y"]
        return {"Out": fn(x, _broadcast_y(x, y, attrs.get("axis", -1)))}
    return kernel


elementwise_add = _ew("elementwise_add", torch.add)
elementwise_mul = _ew("elementwise_mul", torch.mul)
