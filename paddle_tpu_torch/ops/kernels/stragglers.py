"""The proximal optimizers proximal_gd and proximal_adagrad, and
crop_tensor (paddle.crop_tensor).

Counterparts of the ops of the same names in
paddle_tpu/ops/kernels/stragglers.py:50,88,108 (the FTRL-proximal family:
the arithmetic there, in the parameter's own dtype, in its order)."""
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


@register_op("crop_tensor", inputs=["X", "Shape?!", "Offsets?!"],
             outputs=["Out"])
def crop_tensor(ins, attrs, ctx):
    """A `shape`-sized window of X at `offsets` (attrs or tensors read on
    the host); a shape entry of -1 runs to the end of its axis.  The
    window is clamped inside X, as jax.lax.dynamic_slice clamps it."""
    x = ins["X"]
    if ins.get("Shape") is not None:
        shape = [int(v) for v in ins["Shape"].reshape(-1).tolist()]
    else:
        shape = list(attrs.get("shape", list(x.shape)))
    if ins.get("Offsets") is not None:
        offsets = [int(v) for v in ins["Offsets"].reshape(-1).tolist()]
    else:
        offsets = list(attrs.get("offsets", [0] * x.dim()))
    out = x
    for i, (s, o) in enumerate(zip(shape, offsets)):
        s = x.shape[i] - o if s == -1 else int(s)
        o = min(max(int(o), 0), x.shape[i] - s)
        out = out.narrow(i, o, s)
    return {"Out": out}
