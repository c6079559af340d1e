"""Optimizer ops of the training slices: sgd, momentum, adam, adamw and
lamb (dense gradients).

Counterpart of paddle_tpu/ops/kernels/optimizers.py.  As there, the "Out"
slots are new values that the executor binds to the persistable names
(ParamOut -> the parameter, Moment1Out -> its moment, ...); nothing is
updated in place.  Arithmetic is fp32 whatever the stored dtype.

Not ported yet: `lazy_mode` and sparse (SelectedRows) gradients, lamb's
ZeRO-sharded trust ratio (`reduce_norms_ring_id`), and the other
optimizers (ROADMAP.md Queue 1, Training breadth).
"""
from __future__ import annotations

import torch

from ..registry import register_op


def _lr(ins):
    return ins["LearningRate"].reshape(()).float()


@register_op("sgd", inputs=["Param", "LearningRate!", "Grad"],
             outputs=["ParamOut"], grad=None, side_effect=True)
def sgd(ins, attrs, ctx):
    p, g = ins["Param"], ins["Grad"]
    return {"ParamOut": (p.float() - _lr(ins) * g.float()).to(p.dtype)}


@register_op("momentum",
             inputs=["Param", "Grad", "Velocity", "LearningRate!"],
             outputs=["ParamOut", "VelocityOut"], grad=None, side_effect=True)
def momentum(ins, attrs, ctx):
    p, g, v = ins["Param"], ins["Grad"], ins["Velocity"]
    mu = attrs.get("mu", 0.9)
    lr = _lr(ins)
    pf, gf, vf = p.float(), g.float(), v.float()
    v_out = mu * vf + gf
    if attrs.get("use_nesterov", False):
        p_out = pf - (gf + mu * v_out) * lr
    else:
        p_out = pf - lr * v_out
    return {"ParamOut": p_out.to(p.dtype), "VelocityOut": v_out.to(v.dtype)}


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


@register_op("adamw",
             inputs=["Param", "Grad", "LearningRate!", "Moment1", "Moment2",
                     "Beta1Pow", "Beta2Pow", "MasterParam?"],
             outputs=["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                      "Beta2PowOut", "MasterParamOut?"],
             grad=None, side_effect=True)
def adamw(ins, attrs, ctx):
    """Decoupled weight decay: p * (1 - lr coeff), then the adam step."""
    coeff = attrs.get("coeff", 0.01)
    p = ins["Param"]
    master = ins.get("MasterParam")
    pf = (master if master is not None else p).float()
    decayed = pf * (1.0 - _lr(ins) * coeff)
    ins2 = dict(ins)
    if master is not None:
        ins2["MasterParam"] = decayed
    else:
        ins2["Param"] = decayed.to(p.dtype)
    return adam(ins2, attrs, ctx)


@register_op("lamb",
             inputs=["Param", "Grad", "LearningRate!", "Moment1", "Moment2",
                     "Beta1Pow", "Beta2Pow"],
             outputs=["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                      "Beta2PowOut"],
             grad=None, side_effect=True)
def lamb(ins, attrs, ctx):
    if attrs.get("reduce_norms_ring_id") is not None:
        raise NotImplementedError(
            "lamb over a ZeRO-sharded parameter (reduce_norms_ring_id) "
            "needs the distribution slice (ROADMAP.md Queue 1, Distribution)")
    p = ins["Param"].float()
    g = ins["Grad"].float()
    m1 = ins["Moment1"].float()
    m2 = ins["Moment2"].float()
    beta1 = attrs.get("beta1", 0.9)
    beta2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    b1p = ins["Beta1Pow"].reshape(()).float()
    b2p = ins["Beta2Pow"].reshape(()).float()
    m1_out = beta1 * m1 + (1 - beta1) * g
    m2_out = beta2 * m2 + (1 - beta2) * torch.square(g)
    m1_hat = m1_out / (1 - b1p)
    m2_hat = m2_out / (1 - b2p)
    r = m1_hat / (torch.sqrt(m2_hat) + eps) + wd * p
    p_norm = torch.sqrt(torch.sum(torch.square(p)))
    r_norm = torch.sqrt(torch.sum(torch.square(r)))
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                        torch.ones_like(p_norm))
    p_out = p - _lr(ins) * trust * r
    return {"ParamOut": p_out.to(ins["Param"].dtype),
            "Moment1Out": m1_out, "Moment2Out": m2_out,
            # 0-d, as the JAX package's (so both infer the same var shapes)
            "Beta1PowOut": (b1p * beta1).to(ins["Beta1Pow"].dtype),
            "Beta2PowOut": (b2p * beta2).to(ins["Beta2Pow"].dtype)}
