"""NN ops of the slices: layer_norm, softmax, dropout, lookup_table_v2,
fc.

Counterparts of the kernels of the same names in
paddle_tpu/ops/kernels/nn.py, with the same attrs and dtype rules:
normalization and softmax compute in fp32 for half-precision inputs and
return the input dtype.  `dropout` draws its mask with the Philox kernel
of ops/dropout.py (not the JAX package's threefry bits) and has an
explicit gradient that reads the saved Mask: a vjp replay of the forward
would draw again."""
from __future__ import annotations

import math

import torch

from ..dropout import apply_mask, dropout_fwd
from ..registry import register_op


def _cdt(x):
    """f32 accumulation for half types; preserve f32/f64."""
    return torch.float32 if x.dtype in (torch.bfloat16, torch.float16) \
        else x.dtype


@register_op("layer_norm", inputs=["X", "Scale?", "Bias?"],
             outputs=["Y", "Mean", "Variance"])
def layer_norm(ins, attrs, ctx):
    x = ins["X"]
    eps = attrs.get("epsilon", 1e-5)
    bna = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(bna, x.dim()))
    xf = x.to(_cdt(x))
    m = xf.mean(dim=axes, keepdim=True)
    v = xf.var(dim=axes, unbiased=False, keepdim=True)
    y = (xf - m) * torch.rsqrt(v + eps)
    norm_shape = (1,) * bna + tuple(x.shape[bna:])
    if ins.get("Scale") is not None:
        y = y * ins["Scale"].to(_cdt(x)).reshape(norm_shape)
    if ins.get("Bias") is not None:
        y = y + ins["Bias"].to(_cdt(x)).reshape(norm_shape)
    flat = int(math.prod(x.shape[:bna]))
    return {"Y": y.to(x.dtype), "Mean": m.reshape(flat),
            "Variance": v.reshape(flat)}


@register_op("softmax", inputs=["X"], outputs=["Out"])
def softmax(ins, attrs, ctx):
    x = ins["X"]
    out = torch.softmax(x.to(_cdt(x)), dim=attrs.get("axis", -1))
    return {"Out": out.to(x.dtype)}


def _dropout_mode(attrs, ctx):
    """(p, upscale_in_train?, test mode?) of a dropout op."""
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    return (float(attrs.get("dropout_prob", 0.5)), impl == "upscale_in_train",
            bool(attrs.get("is_test", False) or ctx.is_test))


def _infer_dropout(ins, attrs):
    x = ins["X"]
    return {"Out": torch.empty_like(x, device="meta"),
            "Mask": torch.empty(x.shape, dtype=torch.uint8, device="meta")}


def _dropout_grad(ins, attrs, ctx):
    """dX from the saved Mask, scaled as the forward was: keep ? dOut / q
    : 0 (upscale_in_train) or keep ? dOut : 0 in training; dOut or
    dOut (1 - p) in test mode (the vjp of the JAX package's kernel with
    the same keep mask)."""
    dout = ins["Out@GRAD"]
    p, upscale, test = _dropout_mode(attrs, ctx)
    if test:
        return {"X@GRAD": dout if upscale else
                dout * float(torch.tensor(1.0 - p, dtype=dout.dtype))}
    return {"X@GRAD": apply_mask(dout, ins["Mask"].bool(), p, upscale)}


@register_op("dropout", inputs=["X", "Seed?!"], outputs=["Out", "Mask"],
             grad=_dropout_grad, infer_shape=_infer_dropout)
def dropout(ins, attrs, ctx):
    x = ins["X"]
    p, upscale, test = _dropout_mode(attrs, ctx)
    if test:
        out = x if upscale else \
            x * float(torch.tensor(1.0 - p, dtype=x.dtype))
        return {"Out": out, "Mask": torch.ones_like(x, dtype=torch.uint8)}
    seed, uid = ctx.draw_key(attrs, ins.get("Seed"))
    out, mask = dropout_fwd(x.contiguous(), p, seed, uid, upscale)
    return {"Out": out, "Mask": mask}


def _embedding(w, ids, attrs):
    padding_idx = attrs.get("padding_idx", -1)
    ids = ids.long()
    out = w[ids]
    if padding_idx is not None and padding_idx != -1:
        pid = padding_idx if padding_idx >= 0 else w.shape[0] + padding_idx
        out = out.masked_fill((ids == pid)[..., None], 0)
    return out


@register_op("lookup_table_v2", inputs=["W", "Ids!"], outputs=["Out"])
def lookup_table_v2(ins, attrs, ctx):
    return {"Out": _embedding(ins["W"], ins["Ids"], attrs)}


@register_op("fc", inputs=["Input", "W", "Bias?"], outputs=["Out"])
def fc(ins, attrs, ctx):
    """The op fc_fuse_pass writes for mul + bias add (paddle_tpu's fc
    kernel): flatten at in_num_col_dims, x @ W + b, optional relu/tanh."""
    x, w = ins["Input"], ins["W"]
    in_num_col_dims = attrs.get("in_num_col_dims", 1)
    x2 = x.reshape(int(math.prod(x.shape[:in_num_col_dims])), -1)
    out = torch.matmul(x2, w)
    if ins.get("Bias") is not None:
        out = out + ins["Bias"]
    act = attrs.get("activation_type", "")
    if act == "relu":
        out = torch.relu(out)
    elif act == "tanh":
        out = torch.tanh(out)
    return {"Out": out.reshape(tuple(x.shape[:in_num_col_dims])
                               + (w.shape[1],))}
