"""Ops of paddle_tpu/ops/kernels/op_gaps.py that the ported slices run:
label_smooth (Transformer-big's smoothed one-hot target) and
get_tensor_from_selected_rows (paddle.get_tensor_from_selected_rows)."""
from __future__ import annotations

from ..registry import register_op


@register_op("label_smooth", inputs=["X", "PriorDist?!"], outputs=["Out"])
def label_smooth(ins, attrs, ctx):
    """(1 - epsilon) * X + epsilon * prior, the prior PriorDist (one row
    over the classes) or uniform 1 / C; the gradient is the default
    (vjp): (1 - epsilon) * dOut."""
    x = ins["X"]
    eps = attrs.get("epsilon", 0.0)
    prior = ins.get("PriorDist")
    p = prior.reshape(1, -1) if prior is not None else 1.0 / x.shape[-1]
    return {"Out": (1.0 - eps) * x + eps * p}


@register_op("get_tensor_from_selected_rows", inputs=["X"],
             outputs=["Out"], grad=None)
def get_tensor_from_selected_rows(ins, attrs, ctx):
    """Densify a SelectedRows (rows scatter-added into [height, ...]); a
    dense tensor passes through."""
    from ...core.selected_rows import SelectedRows
    x = ins["X"]
    return {"Out": x.to_dense() if isinstance(x, SelectedRows) else x}
