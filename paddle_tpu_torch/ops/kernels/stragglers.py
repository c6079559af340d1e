"""The proximal optimizers proximal_gd and proximal_adagrad.

Counterparts of the ops of the same names in
paddle_tpu/ops/kernels/stragglers.py:88,108 (the FTRL-proximal family):
the arithmetic there, in the parameter's own dtype, in its order."""
from __future__ import annotations

import torch

from ..registry import register_op


def _prox(prox, lr, l1, l2):
    """sign(prox) max(|prox| - lr l1, 0) / (1 + lr l2), or prox / (1 +
    lr l2) without l1."""
    if l1 > 0:
        return torch.sign(prox) * torch.clamp(torch.abs(prox) - lr * l1,
                                              min=0.0) / (1.0 + lr * l2)
    return prox / (1.0 + lr * l2)


@register_op("proximal_gd",
             inputs=["Param!", "Grad!", "LearningRate!"],
             outputs=["ParamOut"], grad=None, side_effect=True)
def proximal_gd(ins, attrs, ctx):
    p, g = ins["Param"], ins["Grad"]
    lr = ins["LearningRate"].reshape(())
    prox = p - lr * g
    return {"ParamOut": _prox(prox, lr, attrs.get("l1", 0.0),
                              attrs.get("l2", 0.0))}


@register_op("proximal_adagrad",
             inputs=["Param!", "Moment!", "Grad!", "LearningRate!"],
             outputs=["ParamOut", "MomentOut"], grad=None, side_effect=True)
def proximal_adagrad(ins, attrs, ctx):
    p, m, g = ins["Param"], ins["Moment"], ins["Grad"]
    lr = ins["LearningRate"].reshape(())
    m_out = m + g * g
    prox = p - lr * g / torch.sqrt(m_out)
    return {"ParamOut": _prox(prox, lr, attrs.get("l1", 0.0),
                              attrs.get("l2", 0.0)),
            "MomentOut": m_out}
