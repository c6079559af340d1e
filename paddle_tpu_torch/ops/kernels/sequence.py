"""im2sequence, the op paddle_tpu/ops/kernels/sequence.py registers and
nn.functional.unfold dispatches (the other sequence ops wait for their
family)."""
from __future__ import annotations

import torch.nn.functional as F

from ..registry import register_op


@register_op("im2sequence", inputs=["X", "Y?!"], outputs=["Out"])
def im2sequence(ins, attrs, ctx):
    """X [N, C, H, W] -> Out [N oh ow, C kh kw]: the patches of `kernels`
    at `strides`, `paddings` [top, bottom, left, right]; Y is not read."""
    x = ins["X"]
    kh, kw = attrs["kernels"]
    p = attrs.get("paddings", [0, 0, 0, 0])
    x = F.pad(x, [p[2], p[3], p[0], p[1]])
    cols = F.unfold(x, (kh, kw), stride=tuple(attrs.get("strides", [1, 1])))
    return {"Out": cols.transpose(1, 2).reshape(-1, cols.shape[1])}
