"""Loss ops of the training slice: softmax_with_cross_entropy.

Counterpart of paddle_tpu/ops/kernels/loss.py, with the same fused hook:
with FLAGS_fused_xent on, hard labels over the last axis take the fused
kernel (ops/fused_xent.py), and the Softmax output is a zero-stride
expand of a 0-d zero, as the JAX package returns a zero placeholder
there (graphs that fetch Softmax must run with the flag off).
"""
from __future__ import annotations

import torch

from ..registry import register_op
from .nn import _cdt


@register_op("softmax_with_cross_entropy", inputs=["Logits", "Label!"],
             outputs=["Softmax", "Loss"])
def softmax_with_cross_entropy(ins, attrs, ctx):
    logits, label = ins["Logits"], ins["Label"]
    axis = attrs.get("axis", -1) % logits.dim()
    soft_label = attrs.get("soft_label", False)
    ignore_index = attrs.get("ignore_index", -100)
    from ..fused_xent import maybe_fused_xent
    fused = maybe_fused_xent(logits, label, axis, soft_label, ignore_index)
    if fused is not None:
        # Loss stays fp32 like the base branch
        zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
        return {"Softmax": zero.expand(logits.shape), "Loss": fused}
    lf = logits.to(_cdt(logits))
    logp = torch.log_softmax(lf, dim=axis)
    sm = torch.exp(logp)
    if soft_label:
        loss = -(label.to(lf.dtype) * logp).sum(dim=axis, keepdim=True)
    else:
        lbl = label
        if lbl.dim() == logits.dim() and lbl.shape[axis] == 1:
            lbl = lbl.squeeze(axis)
        lbl = lbl.long().unsqueeze(axis)
        picked = torch.gather(logp, axis,
                              lbl.clamp(0, logits.shape[axis] - 1))
        # ignored rows zero out whatever the index's sign
        loss = torch.where(lbl == ignore_index, torch.zeros_like(picked),
                           -picked)
    return {"Softmax": sm.to(logits.dtype), "Loss": loss}
