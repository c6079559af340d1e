"""reduce_sum (the global-norm gradient clip's squared norms),
reduce_mean, reduce_max and reduce_min (the dygraph Tensor.max / min a
recorded function calls), reduce_prod, reduce_all and reduce_any (the
last two without a gradient).
Counterpart of paddle_tpu/ops/kernels/reduce.py; attrs follow the
reference: `dim` (list), `keep_dim`, `reduce_all`."""
from __future__ import annotations

import torch

from ..registry import register_op


def _reduce(name, fn, grad="auto"):
    @register_op(name, inputs=["X"], outputs=["Out"], grad=grad)
    def kernel(ins, attrs, ctx, _fn=fn):
        x = ins["X"]
        keep = attrs.get("keep_dim", False)
        if attrs.get("reduce_all", False) or x.dim() == 0:
            out = _fn(x)
            return {"Out": out.reshape((1,) * x.dim()) if keep else out}
        dim = attrs.get("dim", [0])
        dim = [dim] if isinstance(dim, int) else dim
        return {"Out": _fn(x, dim=tuple(d % x.dim() for d in dim),
                           keepdim=keep)}
    return kernel


reduce_sum = _reduce("reduce_sum", torch.sum)
reduce_mean = _reduce("reduce_mean", torch.mean)
reduce_max = _reduce("reduce_max", torch.amax)
reduce_min = _reduce("reduce_min", torch.amin)


def _one_dim_at_a_time(fn):
    """A torch reduction that takes one dim (torch.prod) over a tuple of
    dims, the highest first."""
    def f(x, dim=None, keepdim=False):
        if dim is None:
            return fn(x)
        for d in sorted(dim, reverse=True):
            x = fn(x, d, keepdim=keepdim)
        return x
    return f


reduce_prod = _reduce("reduce_prod", _one_dim_at_a_time(torch.prod))
reduce_all = _reduce("reduce_all", torch.all, grad=None)
reduce_any = _reduce("reduce_any", torch.any, grad=None)
