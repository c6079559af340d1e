"""reduce_sum (the global-norm gradient clip's squared norms).
Counterpart of paddle_tpu/ops/kernels/reduce.py; attrs follow the
reference: `dim` (list), `keep_dim`, `reduce_all`."""
from __future__ import annotations

import torch

from ..registry import register_op


@register_op("reduce_sum", inputs=["X"], outputs=["Out"])
def reduce_sum(ins, attrs, ctx):
    x = ins["X"]
    keep = attrs.get("keep_dim", False)
    if attrs.get("reduce_all", False) or x.dim() == 0:
        out = torch.sum(x)
        return {"Out": out.reshape((1,) * x.dim()) if keep else out}
    dim = attrs.get("dim", [0])
    dim = [dim] if isinstance(dim, int) else dim
    return {"Out": torch.sum(x, dim=tuple(d % x.dim() for d in dim),
                             keepdim=keep)}
