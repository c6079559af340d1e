"""elementwise_{add,sub,mul,div,max,min,mod,floordiv,pow} with Paddle's `axis` broadcast:
Y's dims align to X's starting at `axis` (axis=-1 means numpy-style
trailing alignment).  `elementwise_mod` is Python's (and jnp.mod's)
modulo, the sign of the divisor, and has no gradient.
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


def _ew(name, fn, grad="auto"):
    @register_op(name, inputs=["X", "Y"], outputs=["Out"], grad=grad)
    def kernel(ins, attrs, ctx):
        x, y = ins["X"], ins["Y"]
        return {"Out": fn(x, _broadcast_y(x, y, attrs.get("axis", -1)))}
    return kernel


elementwise_add = _ew("elementwise_add", torch.add)
elementwise_sub = _ew("elementwise_sub", torch.sub)
elementwise_mul = _ew("elementwise_mul", torch.mul)
elementwise_div = _ew("elementwise_div", torch.div)
elementwise_max = _ew("elementwise_max", torch.maximum)
elementwise_min = _ew("elementwise_min", torch.minimum)
elementwise_mod = _ew("elementwise_mod", torch.remainder, grad=None)
elementwise_floordiv = _ew("elementwise_floordiv", torch.floor_divide,
                           grad=None)
elementwise_pow = _ew("elementwise_pow", torch.pow)
