"""Optimizer ops of the training slice: adam (dense gradients).

Counterpart of paddle_tpu/ops/kernels/optimizers.py.  As there, the "Out"
slots are new values that the executor binds to the persistable names
(ParamOut -> the parameter, Moment1Out -> its moment, ...); nothing is
updated in place.  Arithmetic is fp32 whatever the stored dtype.

Not ported yet: `lazy_mode` and sparse (SelectedRows) gradients, and the
other optimizers (ROADMAP.md).
"""
from __future__ import annotations

import torch

from ..registry import register_op


def _lr(ins):
    return ins["LearningRate"].reshape(()).float()


@register_op("adam",
             inputs=["Param", "Grad", "LearningRate!", "Moment1", "Moment2",
                     "Beta1Pow", "Beta2Pow", "MasterParam?"],
             outputs=["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                      "Beta2PowOut", "MasterParamOut?"],
             grad=None, side_effect=True)
def adam(ins, attrs, ctx):
    if attrs.get("lazy_mode", False):
        raise NotImplementedError(
            "adam(lazy_mode=True) needs sparse gradients, not ported yet")
    p, g = ins["Param"], ins["Grad"]
    m1, m2 = ins["Moment1"], ins["Moment2"]
    b1p, b2p = ins["Beta1Pow"].float(), ins["Beta2Pow"].float()
    beta1 = attrs.get("beta1", 0.9)
    beta2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    master = ins.get("MasterParam")
    pf = (master if master is not None else p).float()
    gf = g.float()
    m1_out = beta1 * m1.float() + (1 - beta1) * gf
    m2_out = beta2 * m2.float() + (1 - beta2) * torch.square(gf)
    lr_t = _lr(ins) * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    p_out = pf - lr_t * m1_out / (torch.sqrt(m2_out) + eps)
    outs = {"ParamOut": p_out.to(p.dtype),
            "Moment1Out": m1_out.to(m1.dtype),
            "Moment2Out": m2_out.to(m2.dtype),
            "Beta1PowOut": (b1p * beta1).to(ins["Beta1Pow"].dtype),
            "Beta2PowOut": (b2p * beta2).to(ins["Beta2Pow"].dtype)}
    if master is not None:
        outs["MasterParamOut"] = p_out
    return outs
