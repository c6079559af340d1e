"""Math ops of the slices: matmul, matmul_v2, mul, scale, sum, mean, abs,
and the gradient clips' clip and clip_by_norm and gradient merge's
increment; the ops of paddle.tensor's math and linalg functions (bmm,
mv, dot, kron, cumsum, logsumexp, trace, tril_triu, cross, the norms,
dist, cholesky, inverse, histogram, allclose, isfinite_v2 / isinf_v2 /
isnan_v2, einsum, addmm, sign; paddle_tpu/ops/kernels/math.py:63-368).

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


@register_op("bmm", inputs=["X", "Y"], outputs=["Out"])
def bmm(ins, attrs, ctx):
    return {"Out": torch.matmul(ins["X"], ins["Y"])}


@register_op("mv", inputs=["X", "Vec"], outputs=["Out"])
def mv(ins, attrs, ctx):
    return {"Out": torch.matmul(ins["X"], ins["Vec"])}


@register_op("dot", inputs=["X", "Y"], outputs=["Out"])
def dot(ins, attrs, ctx):
    """Row-wise dot product; the last dim kept as 1 (dot_op.cc)."""
    return {"Out": torch.sum(ins["X"] * ins["Y"], dim=-1, keepdim=True)}


@register_op("addmm", inputs=["Input", "X", "Y"], outputs=["Out"])
def addmm(ins, attrs, ctx):
    out = attrs.get("Alpha", 1.0) * torch.matmul(ins["X"], ins["Y"]) + \
        attrs.get("Beta", 1.0) * ins["Input"]
    return {"Out": out.to(ins["X"].dtype)}


@register_op("kron", inputs=["X", "Y"], outputs=["Out"])
def kron(ins, attrs, ctx):
    return {"Out": torch.kron(ins["X"], ins["Y"])}


@register_op("sign", inputs=["X"], outputs=["Out"], grad=None)
def sign(ins, attrs, ctx):
    return {"Out": torch.sign(ins["X"])}


@register_op("cumsum", inputs=["X"], outputs=["Out"])
def cumsum(ins, attrs, ctx):
    x = ins["X"]
    axis = attrs.get("axis", -1)
    if attrs.get("flatten", False):
        x, axis = x.reshape(-1), 0
    if attrs.get("reverse", False):
        out = torch.flip(torch.cumsum(torch.flip(x, (axis,)), dim=axis),
                         (axis,))
    else:
        out = torch.cumsum(x, dim=axis)
    if attrs.get("exclusive", False):
        out = out - x
    return {"Out": out}


@register_op("logsumexp", inputs=["X"], outputs=["Out"])
def logsumexp(ins, attrs, ctx):
    x = ins["X"]
    axis = attrs.get("axis", None) or attrs.get("dim", None)
    keep = attrs.get("keepdim", False)
    if attrs.get("reduce_all", False) or axis is None:
        axis = tuple(range(x.dim()))
    elif isinstance(axis, int):
        axis = (axis,)
    return {"Out": torch.logsumexp(x, dim=tuple(axis), keepdim=keep)}


@register_op("trace", inputs=["Input"], outputs=["Out"])
def trace(ins, attrs, ctx):
    return {"Out": torch.diagonal(ins["Input"], attrs.get("offset", 0),
                                  attrs.get("axis1", 0),
                                  attrs.get("axis2", 1)).sum(-1)}


@register_op("tril_triu", inputs=["X"], outputs=["Out"])
def tril_triu(ins, attrs, ctx):
    fn = torch.tril if attrs.get("lower", True) else torch.triu
    return {"Out": fn(ins["X"], attrs.get("diagonal", 0))}


@register_op("cholesky", inputs=["X"], outputs=["Out"])
def cholesky(ins, attrs, ctx):
    out = torch.linalg.cholesky(ins["X"])
    return {"Out": out.transpose(-1, -2) if attrs.get("upper", False)
            else out}


@register_op("inverse", inputs=["Input"], outputs=["Output"])
def inverse(ins, attrs, ctx):
    return {"Output": torch.linalg.inv(ins["Input"])}


@register_op("cross", inputs=["X", "Y"], outputs=["Out"])
def cross(ins, attrs, ctx):
    dim = attrs.get("dim", None)
    if dim is None or dim == -100:  # the reference's DefaultDim sentinel
        dim = next(i for i, s in enumerate(ins["X"].shape) if s == 3)
    return {"Out": torch.linalg.cross(ins["X"], ins["Y"], dim=dim)}


@register_op("dist", inputs=["X", "Y"], outputs=["Out"])
def dist(ins, attrs, ctx):
    """The p-norm of X - Y over all elements (inf: max |d|, -inf: min,
    0: the count of nonzeros)."""
    p = attrs.get("p", 2.0)
    d = (ins["X"] - ins["Y"]).reshape(-1)
    if p == math.inf:
        return {"Out": torch.amax(torch.abs(d))}
    if p == -math.inf:
        return {"Out": torch.amin(torch.abs(d))}
    if p == 0:
        return {"Out": torch.sum(d != 0).to(d.dtype)}
    return {"Out": torch.pow(torch.sum(torch.pow(torch.abs(d), p)),
                             1.0 / p)}


@register_op("p_norm", inputs=["X"], outputs=["Out"])
def p_norm(ins, attrs, ctx):
    """(sum |x|^p)^(1/p) along `axis` (over all elements when
    `asvector`), the JAX kernel's formula."""
    x = ins["X"]
    p = attrs.get("porder", 2.0)
    axis = attrs.get("axis", -1)
    if attrs.get("asvector", False):
        x, axis = x.reshape(-1), 0
    return {"Out": torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=axis,
                                       keepdim=attrs.get("keepdim", False)),
                             1.0 / p)}


@register_op("frobenius_norm", inputs=["X"], outputs=["Out"])
def frobenius_norm(ins, attrs, ctx):
    x = ins["X"]
    axis = attrs.get("dim", None)
    if attrs.get("reduce_all", False) or axis is None:
        axis = tuple(range(x.dim()))
    return {"Out": torch.sqrt(torch.sum(torch.square(x), dim=tuple(axis),
                                        keepdim=attrs.get("keep_dim",
                                                          False)))}


def _infer_histogram(ins, attrs):
    return {"Out": torch.empty((attrs.get("bins", 100),), dtype=torch.int64,
                               device="meta")}


@register_op("histogram", inputs=["X!"], outputs=["Out"], grad=None,
             infer_shape=_infer_histogram)
def histogram(ins, attrs, ctx):
    """Counts in `bins` equal bins over [min, max] (the data's range when
    both are 0), the last bin closed, as jnp.histogram; int64."""
    x = ins["X"].reshape(-1)
    bins = attrs.get("bins", 100)
    lo, hi = attrs.get("min", 0), attrs.get("max", 0)
    xd = x.double()
    if lo == hi == 0:
        lo, hi = float(xd.min()), float(xd.max())
        if lo == hi:  # numpy widens an empty range to +-0.5
            lo, hi = lo - 0.5, hi + 0.5
    edges = torch.linspace(float(lo), float(hi), bins + 1,
                           dtype=torch.float64, device=x.device)
    idx = torch.searchsorted(edges, xd, right=True) - 1
    idx = torch.where(xd == edges[-1], torch.full_like(idx, bins - 1), idx)
    inside = (idx >= 0) & (idx < bins)
    out = torch.zeros(bins, dtype=torch.int64, device=x.device)
    out.index_add_(0, idx[inside], torch.ones_like(idx[inside]))
    return {"Out": out}


@register_op("allclose", inputs=["Input!", "Other!"], outputs=["Out"],
             grad=None)
def allclose(ins, attrs, ctx):
    a, b = ins["Input"], ins["Other"]
    close = torch.isclose(a, b, rtol=float(attrs.get("rtol", 1e-5)),
                          atol=float(attrs.get("atol", 1e-8)),
                          equal_nan=bool(attrs.get("equal_nan", False)))
    return {"Out": torch.all(close)}


@register_op("isfinite_v2", inputs=["X!"], outputs=["Out"], grad=None)
def isfinite_v2(ins, attrs, ctx):
    return {"Out": torch.isfinite(ins["X"])}


@register_op("isinf_v2", inputs=["X!"], outputs=["Out"], grad=None)
def isinf_v2(ins, attrs, ctx):
    return {"Out": torch.isinf(ins["X"])}


@register_op("isnan_v2", inputs=["X!"], outputs=["Out"], grad=None)
def isnan_v2(ins, attrs, ctx):
    return {"Out": torch.isnan(ins["X"])}


@register_op("einsum", inputs=["Operands*"], outputs=["Out"])
def einsum_op(ins, attrs, ctx):
    return {"Out": torch.einsum(attrs["equation"], *ins["Operands"])}


@register_op("norm", inputs=["X"], outputs=["Out", "Norm"])
def norm(ins, attrs, ctx):
    """X / sqrt(sum X^2 + epsilon) along `axis`, and that norm."""
    x = ins["X"]
    n = torch.sqrt(torch.sum(torch.square(x), dim=attrs.get("axis", -1),
                             keepdim=True) + attrs.get("epsilon", 1e-10))
    return {"Out": x / n, "Norm": n}


@register_op("bilinear_tensor_product", inputs=["X", "Y", "Weight", "Bias?"],
             outputs=["Out"])
def bilinear_tensor_product(ins, attrs, ctx):
    """Out[b, o] = X[b] Weight[o] Y[b] (+ Bias)."""
    out = torch.einsum("bi,oij,bj->bo", ins["X"], ins["Weight"], ins["Y"])
    if ins.get("Bias") is not None:
        out = out + ins["Bias"]
    return {"Out": out}
