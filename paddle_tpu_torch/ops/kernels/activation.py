"""gelu (exact (erf) by default, the tanh form when attr `approximate`
is set), square and sqrt (the global-norm gradient clip).  Counterpart of
paddle_tpu/ops/kernels/activation.py."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..registry import register_op


@register_op("gelu", inputs=["X"], outputs=["Out"])
def gelu(ins, attrs, ctx):
    approx = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": F.gelu(ins["X"], approximate=approx)}


@register_op("square", inputs=["X"], outputs=["Out"])
def square(ins, attrs, ctx):
    return {"Out": torch.square(ins["X"])}


@register_op("sqrt", inputs=["X"], outputs=["Out"])
def sqrt(ins, attrs, ctx):
    return {"Out": torch.sqrt(ins["X"])}
