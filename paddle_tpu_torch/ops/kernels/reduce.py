"""reduce_sum (the global-norm gradient clip's squared norms),
reduce_mean, reduce_max and reduce_min (the dygraph Tensor.max / min a
recorded function calls).
Counterpart of paddle_tpu/ops/kernels/reduce.py; attrs follow the
reference: `dim` (list), `keep_dim`, `reduce_all`."""
from __future__ import annotations

import torch

from ..registry import register_op


def _reduce(name, fn):
    @register_op(name, inputs=["X"], outputs=["Out"])
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
