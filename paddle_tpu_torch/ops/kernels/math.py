"""Math ops of the slices: matmul, matmul_v2, mul, scale, sum, mean, abs,
and the gradient clips' clip and clip_by_norm and gradient merge's
increment.

Counterparts of paddle_tpu/ops/kernels/math.py.  Large products go to
torch.matmul, as the JAX package leaves them to XLA.  A float32 product
runs in full float32 unless the caller enables TF32 in torch.backends."""
from __future__ import annotations

import math

import torch

from ..registry import register_op
from ...core.selected_rows import SelectedRows


@register_op("matmul", inputs=["X", "Y"], outputs=["Out"])
def matmul(ins, attrs, ctx):
    x, y = ins["X"], ins["Y"]
    if attrs.get("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": out}


@register_op("mul", inputs=["X", "Y"], outputs=["Out"])
def mul(ins, attrs, ctx):
    # flatten X to 2-D at x_num_col_dims, Y at y_num_col_dims (mul_op.cc)
    x, y = ins["X"], ins["Y"]
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(int(math.prod(xs[:xnc])), -1)
    y2 = y.reshape(int(math.prod(ys[:ync])), -1)
    return {"Out": torch.matmul(x2, y2).reshape(xs[:xnc] + ys[ync:])}


@register_op("scale", inputs=["X"], outputs=["Out"])
def scale(ins, attrs, ctx):
    x = ins["X"]
    if isinstance(x, SelectedRows):
        # scale a sparse gradient's values (a bias would densify it)
        if attrs.get("bias", 0.0) != 0.0:
            raise ValueError("scale(bias!=0) on SelectedRows would densify")
        s = torch.tensor(attrs.get("scale", 1.0), dtype=x.values.dtype,
                         device=x.values.device)
        return {"Out": SelectedRows(x.rows, x.values * s, x.height)}
    s = attrs.get("scale", 1.0)
    b = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": x * s + b}
    return {"Out": (x + b) * s}


@register_op("sum", inputs=["X*"], outputs=["Out"])
def sum_op(ins, attrs, ctx):
    """Elementwise sum of the inputs (append_backward accumulates the
    gradient pieces of a var with it).  Over SelectedRows only, the sum
    is the concatenation (scatter-add semantics); mixed with dense ones,
    each SelectedRows is densified first."""
    xs = ins["X"]
    if any(isinstance(x, SelectedRows) for x in xs):
        if all(isinstance(x, SelectedRows) for x in xs):
            return {"Out": SelectedRows(
                torch.cat([x.rows for x in xs]),
                torch.cat([x.values for x in xs]), xs[0].height)}
        xs = [x.to_dense() if isinstance(x, SelectedRows) else x
              for x in xs]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


@register_op("mean", inputs=["X"], outputs=["Out"])
def mean(ins, attrs, ctx):
    return {"Out": ins["X"].mean()}


@register_op("clip", inputs=["X", "Min?!", "Max?!"], outputs=["Out"])
def clip(ins, attrs, ctx):
    lo = ins.get("Min")
    hi = ins.get("Max")
    lo = attrs.get("min", -math.inf) if lo is None else lo
    hi = attrs.get("max", math.inf) if hi is None else hi
    x = ins["X"]
    if not isinstance(lo, torch.Tensor):
        lo = torch.full((), lo, dtype=x.dtype, device=x.device)
    if not isinstance(hi, torch.Tensor):
        hi = torch.full((), hi, dtype=x.dtype, device=x.device)
    return {"Out": torch.clamp(x, lo, hi)}


@register_op("clip_by_norm", inputs=["X"], outputs=["Out"])
def clip_by_norm(ins, attrs, ctx):
    """x * max_norm / norm(x) where norm(x) > max_norm, in fp32."""
    x = ins["X"]
    max_norm = attrs["max_norm"]
    xf = x.float()
    norm = torch.sqrt(torch.sum(torch.square(xf)))
    factor = torch.where(norm > max_norm,
                         max_norm / torch.clamp(norm, min=1e-12),
                         torch.ones_like(norm))
    return {"Out": (xf * factor).to(x.dtype)}


@register_op("increment", inputs=["X"], outputs=["Out"], grad=None)
def increment(ins, attrs, ctx):
    x = ins["X"]
    return {"Out": x + torch.full((), attrs.get("step", 1.0), dtype=x.dtype,
                                  device=x.device)}


@register_op("matmul_v2", inputs=["X", "Y"], outputs=["Out"])
def matmul_v2(ins, attrs, ctx):
    """paddle.matmul's op (the dygraph `F.linear` and `paddle.matmul`
    record it): `trans_x` / `trans_y` swap the last two axes."""
    x, y = ins["X"], ins["Y"]
    if attrs.get("trans_x", False):
        x = x.transpose(-1, -2)
    if attrs.get("trans_y", False):
        y = y.transpose(-1, -2)
    return {"Out": torch.matmul(x, y)}


@register_op("abs", inputs=["X"], outputs=["Out"])
def abs_op(ins, attrs, ctx):
    return {"Out": torch.abs(ins["X"])}
