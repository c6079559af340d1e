"""AMP support ops: check_finite_and_unscale and update_loss_scaling.

Counterpart of paddle_tpu/ops/kernels/amp.py.  FoundInfinite stays a
device tensor: nothing here reads it back to the host, so the step path
holds no synchronisation; update_loss_scaling selects with torch.where.
"""
from __future__ import annotations

import torch

from ..registry import register_op


@register_op("check_finite_and_unscale", inputs=["X*", "Scale!"],
             outputs=["Out*", "FoundInfinite"], grad=None, side_effect=True)
def check_finite_and_unscale(ins, attrs, ctx):
    xs = ins["X"]
    inv = 1.0 / ins["Scale"].reshape(()).float()
    found = torch.zeros((), dtype=torch.bool, device=inv.device)
    outs = []
    for x in xs:
        xf = x.float()
        found = found | ~torch.isfinite(xf).all()
        outs.append((xf * inv).to(x.dtype))
    return {"Out": outs, "FoundInfinite": found.reshape(1)}


@register_op("update_loss_scaling",
             inputs=["X*", "FoundInfinite!", "PrevLossScaling!",
                     "InGoodSteps!", "InBadSteps!"],
             outputs=["Out*", "LossScaling", "OutGoodSteps", "OutBadSteps"],
             grad=None, side_effect=True)
def update_loss_scaling(ins, attrs, ctx):
    found = ins["FoundInfinite"].reshape(())
    scale = ins["PrevLossScaling"].reshape(()).float()
    good = ins["InGoodSteps"].reshape(()).int()
    bad = ins["InBadSteps"].reshape(()).int()
    incr_every = attrs.get("incr_every_n_steps", 1000)
    decr_every = attrs.get("decr_every_n_nan_or_inf", 2)
    incr_ratio = attrs.get("incr_ratio", 2.0)
    decr_ratio = attrs.get("decr_ratio", 0.5)
    zero = torch.zeros_like(good)
    new_good = torch.where(found, zero, good + 1)
    new_bad = torch.where(found, bad + 1, zero)
    grow = new_good >= incr_every
    shrink = new_bad >= decr_every
    new_scale = torch.where(
        grow, scale * incr_ratio,
        torch.where(shrink, torch.clamp_min(scale * decr_ratio, 1.0), scale))
    new_good = torch.where(grow | shrink, zero, new_good)
    new_bad = torch.where(grow | shrink, zero, new_bad)
    # zero the grads when non-finite so the optimizer step is a no-op
    outs = [torch.where(found, torch.zeros_like(x), x) for x in ins["X"]]
    return {"Out": outs,
            "LossScaling": new_scale.reshape(ins["PrevLossScaling"].shape),
            "OutGoodSteps": new_good.reshape(ins["InGoodSteps"].shape)
            .to(ins["InGoodSteps"].dtype),
            "OutBadSteps": new_bad.reshape(ins["InBadSteps"].shape)
            .to(ins["InBadSteps"].dtype)}
