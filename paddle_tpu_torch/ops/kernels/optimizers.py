"""Optimizer ops: sgd, momentum, lars_momentum, adam, adamw, adamax,
adagrad, decayed_adagrad, adadelta, rmsprop, ftrl, lamb, dpsgd,
average_accumulates (ModelAverage's windowed sums) and dgc (fleet's
Deep Gradient Compression sparsifier).

Counterpart of paddle_tpu/ops/kernels/optimizers.py.  As there, the "Out"
slots are new values that the executor binds to the persistable names
(ParamOut -> the parameter, Moment1Out -> its moment, ...); nothing is
updated in place.  Each op keeps the JAX kernel's fp32 arithmetic in its
order, whatever the stored dtype.  sgd, momentum and adam also take a
SelectedRows gradient (core/selected_rows.py, the `is_sparse=True`
embedding's): sgd scatter-adds the row updates into the parameter,
momentum densifies it, and adam with `lazy_mode` moves only the touched
rows' parameter and moments.  dpsgd's noise is the Philox normal
(ops/random.py) keyed by (step seed, op uid), so a captured step draws
new noise on each replay.

Not ported here: lamb's ZeRO-sharded trust ratio (`reduce_norms_ring_id`,
ROADMAP.md Queue 1, Distribution).
"""
from __future__ import annotations

import torch

from ..registry import register_op
from ..random import normal
from ...core.selected_rows import SelectedRows


def _lr(ins):
    return ins["LearningRate"].reshape(()).float()


def _is_selected_rows(g):
    return isinstance(g, SelectedRows)


@register_op("sgd", inputs=["Param", "LearningRate!", "Grad"],
             outputs=["ParamOut"], grad=None, side_effect=True)
def sgd(ins, attrs, ctx):
    p, g = ins["Param"], ins["Grad"]
    if _is_selected_rows(g):
        # scatter-add the row updates into a new parameter (out of place,
        # as the JAX `.at[].add`: `p.float()` of an fp32 parameter is the
        # scope's own tensor): the [height, width] dense gradient never
        # exists
        upd = (-_lr(ins)) * g.values.float()
        return {"ParamOut": p.float().index_put((g.rows,), upd,
                                                accumulate=True)
                .to(p.dtype)}
    return {"ParamOut": (p.float() - _lr(ins) * g.float()).to(p.dtype)}


@register_op("momentum",
             inputs=["Param", "Grad", "Velocity", "LearningRate!"],
             outputs=["ParamOut", "VelocityOut"], grad=None, side_effect=True)
def momentum(ins, attrs, ctx):
    p, g, v = ins["Param"], ins["Grad"], ins["Velocity"]
    mu = attrs.get("mu", 0.9)
    lr = _lr(ins)
    if _is_selected_rows(g):
        # velocity decays everywhere, the gradient lands on touched rows
        g = g.to_dense()
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
    p, g = ins["Param"], ins["Grad"]
    m1, m2 = ins["Moment1"], ins["Moment2"]
    b1p, b2p = ins["Beta1Pow"].float(), ins["Beta2Pow"].float()
    beta1 = attrs.get("beta1", 0.9)
    beta2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    master = ins.get("MasterParam")
    pf = (master if master is not None else p).float()
    row_mask = None
    if _is_selected_rows(g):
        # lazy_mode moves only the looked-up rows (parameter and
        # moments); otherwise a missing row is a zero gradient (the
        # moments still decay).  Duplicate rows sum in to_dense().
        if attrs.get("lazy_mode", False):
            row_mask = g.row_mask().reshape(
                (-1,) + (1,) * (g.values.dim() - 1))
        g = g.to_dense()
    gf = g.float()
    m1f, m2f = m1.float(), m2.float()
    m1_out = beta1 * m1f + (1 - beta1) * gf
    m2_out = beta2 * m2f + (1 - beta2) * torch.square(gf)
    if row_mask is not None:
        m1_out = torch.where(row_mask, m1_out, m1f)
        m2_out = torch.where(row_mask, m2_out, m2f)
    lr_t = _lr(ins) * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    p_out = pf - lr_t * m1_out / (torch.sqrt(m2_out) + eps)
    if row_mask is not None:
        p_out = torch.where(row_mask, p_out, pf)
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
    sq = torch.stack([torch.sum(torch.square(p)),
                      torch.sum(torch.square(r))])
    # ZeRO (distributed/sharding.py): p and r are this rank's shard of one
    # flat parameter, and the trust ratio is defined on the whole
    # parameter's norms: sum the squared norms over the ring, both in one
    # collective.  Zero bucket padding adds zero to both sums.
    ring = attrs.get("reduce_norms_ring_id")
    if ring is not None and sq.device.type != "meta":
        from .collective import ring_group, all_reduce, _count_op
        group = ring_group(ring)
        if group is not None:
            _count_op("lamb_norms")
            sq = all_reduce(sq, "sum", group)
    p_norm = torch.sqrt(sq[0])
    r_norm = torch.sqrt(sq[1])
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                        torch.ones_like(p_norm))
    p_out = p - _lr(ins) * trust * r
    return {"ParamOut": p_out.to(ins["Param"].dtype),
            "Moment1Out": m1_out, "Moment2Out": m2_out,
            # 0-d, as the JAX package's (so both infer the same var shapes)
            "Beta1PowOut": (b1p * beta1).to(ins["Beta1Pow"].dtype),
            "Beta2PowOut": (b2p * beta2).to(ins["Beta2Pow"].dtype)}


@register_op("lars_momentum",
             inputs=["Param", "Grad", "Velocity", "LearningRate!"],
             outputs=["ParamOut", "VelocityOut"], grad=None, side_effect=True)
def lars_momentum(ins, attrs, ctx):
    p, g, v = (ins[k].float() for k in ("Param", "Grad", "Velocity"))
    mu = attrs.get("mu", 0.9)
    lars_coeff = attrs.get("lars_coeff", 0.001)
    wd = attrs.get("lars_weight_decay", 0.0005)
    eps = attrs.get("epsilon", 0.0)
    lr = _lr(ins)
    p_norm = torch.sqrt(torch.sum(torch.square(p)))
    g_norm = torch.sqrt(torch.sum(torch.square(g)))
    local_lr = torch.where(
        (p_norm > 0) & (g_norm > 0),
        lr * lars_coeff * p_norm / (g_norm + wd * p_norm + eps), lr)
    v_out = mu * v + local_lr * (g + wd * p)
    p_out = p - v_out
    return {"ParamOut": p_out.to(ins["Param"].dtype),
            "VelocityOut": v_out.to(ins["Velocity"].dtype)}


@register_op("adamax",
             inputs=["Param", "Grad", "LearningRate!", "Moment", "InfNorm",
                     "Beta1Pow"],
             outputs=["ParamOut", "MomentOut", "InfNormOut", "Beta1PowOut"],
             grad=None, side_effect=True)
def adamax(ins, attrs, ctx):
    p, g = ins["Param"].float(), ins["Grad"].float()
    m, u = ins["Moment"].float(), ins["InfNorm"].float()
    beta1 = attrs.get("beta1", 0.9)
    beta2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = _lr(ins)
    b1p = ins["Beta1Pow"].reshape(()).float()
    m_out = beta1 * m + (1 - beta1) * g
    u_out = torch.maximum(beta2 * u, torch.abs(g))
    p_out = p - (lr / (1 - b1p)) * m_out / (u_out + eps)
    return {"ParamOut": p_out.to(ins["Param"].dtype),
            "MomentOut": m_out.to(ins["Moment"].dtype),
            "InfNormOut": u_out.to(ins["InfNorm"].dtype),
            "Beta1PowOut": (b1p * beta1).reshape(
                ins["Beta1Pow"].shape).to(ins["Beta1Pow"].dtype)}


@register_op("adagrad",
             inputs=["Param", "Grad", "Moment", "LearningRate!"],
             outputs=["ParamOut", "MomentOut"], grad=None, side_effect=True)
def adagrad(ins, attrs, ctx):
    p, g = ins["Param"].float(), ins["Grad"].float()
    m = ins["Moment"].float()
    eps = attrs.get("epsilon", 1e-6)
    m_out = m + torch.square(g)
    p_out = p - _lr(ins) * g / (torch.sqrt(m_out) + eps)
    return {"ParamOut": p_out.to(ins["Param"].dtype),
            "MomentOut": m_out.to(ins["Moment"].dtype)}


@register_op("decayed_adagrad",
             inputs=["Param", "Grad", "Moment", "LearningRate!"],
             outputs=["ParamOut", "MomentOut"], grad=None, side_effect=True)
def decayed_adagrad(ins, attrs, ctx):
    p, g = ins["Param"].float(), ins["Grad"].float()
    m = ins["Moment"].float()
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    m_out = decay * m + (1 - decay) * torch.square(g)
    p_out = p - _lr(ins) * g / (torch.sqrt(m_out) + eps)
    return {"ParamOut": p_out.to(ins["Param"].dtype),
            "MomentOut": m_out.to(ins["Moment"].dtype)}


@register_op("adadelta",
             inputs=["Param", "Grad", "AvgSquaredGrad", "AvgSquaredUpdate"],
             outputs=["ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"],
             grad=None, side_effect=True)
def adadelta(ins, attrs, ctx):
    p, g = ins["Param"].float(), ins["Grad"].float()
    sg = ins["AvgSquaredGrad"].float()
    su = ins["AvgSquaredUpdate"].float()
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    sg_out = rho * sg + (1 - rho) * torch.square(g)
    upd = -torch.sqrt((su + eps) / (sg_out + eps)) * g
    su_out = rho * su + (1 - rho) * torch.square(upd)
    return {"ParamOut": (p + upd).to(ins["Param"].dtype),
            "AvgSquaredGradOut": sg_out, "AvgSquaredUpdateOut": su_out}


@register_op("rmsprop",
             inputs=["Param", "Grad", "MeanSquare", "MeanGrad", "Moment",
                     "LearningRate!"],
             outputs=["ParamOut", "MomentOut", "MeanSquareOut", "MeanGradOut"],
             grad=None, side_effect=True)
def rmsprop(ins, attrs, ctx):
    p, g = ins["Param"].float(), ins["Grad"].float()
    ms = ins["MeanSquare"].float()
    mg = ins["MeanGrad"].float()
    mom = ins["Moment"].float()
    rho = attrs.get("decay", 0.9)
    eps = attrs.get("epsilon", 1e-10)
    momentum_ = attrs.get("momentum", 0.0)
    lr = _lr(ins)
    ms_out = rho * ms + (1 - rho) * torch.square(g)
    if attrs.get("centered", False):
        mg_out = rho * mg + (1 - rho) * g
        denom = ms_out - torch.square(mg_out) + eps
    else:
        mg_out = mg
        denom = ms_out + eps
    mom_out = momentum_ * mom + lr * g / torch.sqrt(denom)
    return {"ParamOut": (p - mom_out).to(ins["Param"].dtype),
            "MomentOut": mom_out, "MeanSquareOut": ms_out,
            "MeanGradOut": mg_out}


@register_op("ftrl",
             inputs=["Param", "SquaredAccumulator", "LinearAccumulator",
                     "Grad", "LearningRate!"],
             outputs=["ParamOut", "SquaredAccumOut", "LinearAccumOut"],
             grad=None, side_effect=True)
def ftrl(ins, attrs, ctx):
    p = ins["Param"].float()
    sq = ins["SquaredAccumulator"].float()
    lin = ins["LinearAccumulator"].float()
    g = ins["Grad"].float()
    l1 = attrs.get("l1", 0.0) + 1e-10
    l2 = attrs.get("l2", 0.0) + 1e-10
    lr_power = attrs.get("lr_power", -0.5)
    lr = _lr(ins)
    new_sq = sq + torch.square(g)
    if lr_power == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(sq)) / lr
        denom = torch.sqrt(new_sq) / lr + 2 * l2
    else:
        sigma = (torch.pow(new_sq, -lr_power)
                 - torch.pow(sq, -lr_power)) / lr
        denom = torch.pow(new_sq, -lr_power) / lr + 2 * l2
    new_lin = lin + g - sigma * p
    pre = torch.clamp(new_lin, -l1, l1) - new_lin
    p_out = pre / denom
    return {"ParamOut": p_out.to(ins["Param"].dtype),
            "SquaredAccumOut": new_sq, "LinearAccumOut": new_lin}


@register_op("dpsgd", inputs=["Param", "Grad", "LearningRate!"],
             outputs=["ParamOut"], grad=None, side_effect=True)
def dpsgd(ins, attrs, ctx):
    """Clip the gradient to norm `clip`, add sigma * clip * N(0, 1) /
    batch_size, step.  The N(0, 1) draw is the Philox normal keyed by
    (the op's nonzero `seed` attr or the step seed, its uid)."""
    p, g = ins["Param"].float(), ins["Grad"].float()
    clip = attrs.get("clip", 10.0)
    batch_size = attrs.get("batch_size", 16.0)
    sigma = attrs.get("sigma", 1.0)
    g_norm = torch.sqrt(torch.sum(torch.square(g)))
    # a 0-d dividend: `float / tensor` would multiply by a reciprocal
    c = torch.full((), clip, dtype=torch.float32, device=g.device)
    g = g * torch.clamp(c / torch.clamp(g_norm, min=1e-12), max=1.0)
    seed, uid = ctx.draw_key(attrs)
    noise = sigma * clip * normal(tuple(g.shape), torch.float32, 0.0, 1.0,
                                  seed, uid, g.device)
    p_out = p - _lr(ins) * (g + noise / batch_size)
    return {"ParamOut": p_out.to(ins["Param"].dtype)}


@register_op("average_accumulates",
             inputs=["param", "in_sum_1", "in_sum_2", "in_sum_3",
                     "in_num_accumulates!", "in_old_num_accumulates!",
                     "in_num_updates!"],
             outputs=["out_sum_1", "out_sum_2", "out_sum_3",
                      "out_num_accumulates", "out_old_num_accumulates",
                      "out_num_updates"],
             grad=None, side_effect=True)
def average_accumulates(ins, attrs, ctx):
    """ModelAverage's op: each step sum_1 += param; every 16384 updates
    sum_1 spills into sum_2; when the window completes, sum_3 is replaced
    by sum_1 + sum_2, both are cleared and the window count moves to
    old_num_accumulates.  The average is (s1 + s2 + s3) / (num_accumulates
    + old_num_accumulates).  Counters stay on the device (no host read)."""
    k_max_num_accumulates = 16384
    p = ins["param"]
    s1, s2, s3 = ins["in_sum_1"], ins["in_sum_2"], ins["in_sum_3"]
    na = ins["in_num_accumulates"].reshape(())
    ona = ins["in_old_num_accumulates"].reshape(())
    nu = ins["in_num_updates"].reshape(())
    avg_window = attrs.get("average_window", 10.0)
    max_avg = attrs.get("max_average_window", 10000)
    min_avg = attrs.get("min_average_window", 10000)
    na = na + 1
    nu = nu + 1
    s1 = s1 + p
    spill = (nu % k_max_num_accumulates) == 0
    s2 = torch.where(spill, s2 + s1, s2)
    s1 = torch.where(spill, torch.zeros_like(s1), s1)
    window_full = (na >= min_avg) & (na >= torch.clamp(
        nu * avg_window, max=max_avg))
    s3_new = torch.where(window_full, s1 + s2, s3)
    s2_new = torch.where(window_full, torch.zeros_like(s2), s2)
    s1_new = torch.where(window_full, torch.zeros_like(s1), s1)
    ona_new = torch.where(window_full, na, ona)
    na_new = torch.where(window_full, torch.zeros_like(na), na)
    return {"out_sum_1": s1_new, "out_sum_2": s2_new, "out_sum_3": s3_new,
            "out_num_accumulates": na_new.reshape(
                ins["in_num_accumulates"].shape),
            "out_old_num_accumulates": ona_new.reshape(
                ins["in_old_num_accumulates"].shape),
            "out_num_updates": nu.reshape(ins["in_num_updates"].shape)}


@register_op("dgc", inputs=["U", "Grad", "Param?"],
             outputs=["UOut", "EncodedGrad", "GradOut"],
             grad=None, side_effect=True)
def dgc(ins, attrs, ctx):
    """Deep Gradient Compression (arXiv:1712.01887), the JAX package's
    dense form: u = m u + g (momentum correction; one rounding, as XLA
    fuses it), keep the top (1 - sparsity) share of |u| (at least one
    element, ties at the threshold kept), the kept values are the
    gradient and the rest stays in u as the local residual.  The encoded
    gradient stays dense and rides the normal c_allreduce_sum."""
    u, g = ins["U"], ins["Grad"]
    m = float(attrs.get("m", 0.9))
    sparsity = float(attrs.get("sparsity", 0.999))
    m64 = torch.tensor(m, dtype=torch.float32).double()
    u_new = (m64 * u.double() + g.double()).float()
    flat = u_new.reshape(-1)
    k = max(1, int(flat.numel() * (1.0 - sparsity)))
    thresh = torch.topk(flat.abs(), k).values[-1]
    mask = u_new.abs() >= thresh
    zero = torch.zeros((), dtype=torch.float32, device=u_new.device)
    encoded = torch.where(mask, u_new, zero)
    u_out = torch.where(mask, zero, u_new)  # the residual stays local
    return {"UOut": u_out.to(u.dtype), "EncodedGrad": encoded.to(g.dtype),
            "GradOut": encoded.to(g.dtype)}
