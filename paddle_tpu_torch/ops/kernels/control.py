"""Comparisons of the slices: equal (gradient merge's step mask),
greater_than and less_than (the L1 decay's sign).  Counterpart of the ops
of the same names in paddle_tpu/ops/kernels/control.py; none has a
gradient."""
from __future__ import annotations

import torch

from ..registry import register_op


def _binary(name, fn):
    @register_op(name, inputs=["X!", "Y!"], outputs=["Out"], grad=None)
    def kernel(ins, attrs, ctx):
        return {"Out": fn(ins["X"], ins["Y"])}
    return kernel


less_than = _binary("less_than", torch.lt)
greater_than = _binary("greater_than", torch.gt)
equal = _binary("equal", torch.eq)
