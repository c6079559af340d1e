"""Loss ops of the training slice: softmax_with_cross_entropy, and
cross_entropy over probabilities (the CTR programs' softmax head).

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


@register_op("cross_entropy", inputs=["X", "Label!"], outputs=["Y"])
def cross_entropy(ins, attrs, ctx):
    """-log(p + 1e-12) of the label's probability (hard labels; rows whose
    label is ignore_index give 0), or -sum(label * log(x + 1e-12)) over
    the last axis (soft), as the JAX package computes it."""
    x, label = ins["X"], ins["Label"]
    eps = 1e-12
    if attrs.get("soft_label", False):
        return {"Y": -(label * torch.log(x + eps)).sum(-1, keepdim=True)}
    lbl = label
    if lbl.dim() == x.dim() and lbl.shape[-1] == 1:
        lbl = lbl.squeeze(-1)
    lbl = lbl.long().unsqueeze(-1)
    p = torch.gather(x, -1, lbl.clamp(0, x.shape[-1] - 1))
    y = -torch.log(p + eps)
    ignore = attrs.get("ignore_index", -100)
    return {"Y": torch.where(lbl == ignore, torch.zeros_like(y), y)}
