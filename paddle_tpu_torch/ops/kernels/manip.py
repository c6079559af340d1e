"""Tensor manipulation ops of the slices: reshape2, transpose2,
flatten_contiguous_range, gather, fill_constant, cast, one_hot_v2,
gradient merge's where and
fill_zeros_like, assign (EMA's and Lookahead's state writes) and
fill_any_like (the backward seed of a loss with a dynamic shape).
Counterparts of paddle_tpu/ops/kernels/manip.py.

transpose2 returns a strided view (no copy); the flash kernel reads the
[B, H, S, D] view through its strides, and the reshape that follows the
attention copies only where the layout demands it."""
from __future__ import annotations

import torch

from ..registry import register_op
from ...core.dtype import torch_dtype


def _resolve_shape(shape, x):
    """reshape semantics: 0 -> copy input dim, -1 -> infer."""
    shape = list(shape)
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    return tuple(shape)


def _xshape(x):
    return torch.zeros((0,) + tuple(x.shape), dtype=x.dtype, device=x.device)


@register_op("reshape2", inputs=["X", "Shape?!", "ShapeTensor*?!"],
             outputs=["Out", "XShape"])
def reshape2(ins, attrs, ctx):
    x = ins["X"]
    return {"Out": x.reshape(_resolve_shape(attrs.get("shape", []), x)),
            "XShape": _xshape(x)}


@register_op("transpose2", inputs=["X"], outputs=["Out", "XShape"])
def transpose2(ins, attrs, ctx):
    x = ins["X"]
    return {"Out": x.permute(*attrs["axis"]), "XShape": _xshape(x)}


def _infer_constant(ins, attrs):
    return {"Out": torch.empty(tuple(attrs.get("shape", [])),
                               dtype=torch_dtype(attrs.get("dtype",
                                                           "float32")),
                               device="meta")}


@register_op("fill_constant", inputs=["ShapeTensor?!", "ValueTensor?!"],
             outputs=["Out"], grad=None, infer_shape=_infer_constant)
def fill_constant(ins, attrs, ctx):
    shape = tuple(attrs.get("shape", []))
    dt = torch_dtype(attrs.get("dtype", "float32"))
    if ins.get("ValueTensor") is not None:
        return {"Out": ins["ValueTensor"].reshape(()).to(dt).expand(shape)
                .clone()}
    value = attrs.get("value", 0.0)
    if isinstance(value, str):
        value = float(value)
    return {"Out": torch.full(shape, value, dtype=dt, device=ctx.device)}


@register_op("cast", inputs=["X"], outputs=["Out"])
def cast(ins, attrs, ctx):
    return {"Out": ins["X"].to(torch_dtype(attrs["out_dtype"]))}


@register_op("where", inputs=["Condition!", "X", "Y"], outputs=["Out"])
def where(ins, attrs, ctx):
    return {"Out": torch.where(ins["Condition"].bool(), ins["X"], ins["Y"])}


@register_op("fill_zeros_like", inputs=["X!"], outputs=["Out"], grad=None)
def fill_zeros_like(ins, attrs, ctx):
    return {"Out": torch.zeros_like(ins["X"])}


@register_op("one_hot_v2", inputs=["X!"], outputs=["Out"], grad=None)
def one_hot_v2(ins, attrs, ctx):
    """float32 one-hot rows over `depth` classes; an id outside [0, depth)
    gives a row of zeros, as jax.nn.one_hot (torch's F.one_hot would fail
    on it, on the card only at a device assert)."""
    ids = ins["X"].long().unsqueeze(-1)
    classes = torch.arange(int(attrs["depth"]), device=ids.device)
    return {"Out": (ids == classes).to(torch.float32)}


@register_op("assign", inputs=["X"], outputs=["Out"])
def assign(ins, attrs, ctx):
    """Out = X (the value itself, as the JAX package's).  When it binds
    one persistable's tensor to another's name, a captured step
    (`Executor.run_steps`) still gives each name its own buffer."""
    return {"Out": ins["X"]}


@register_op("fill_any_like", inputs=["X!"], outputs=["Out"], grad=None)
def fill_any_like(ins, attrs, ctx):
    """`value` at X's runtime shape, in `dtype` (X's when it is None or
    -1): append_backward's seed of a loss with a dynamic shape."""
    x = ins["X"]
    dt = attrs.get("dtype", None)
    dt = x.dtype if dt in (None, -1) else torch_dtype(dt)
    return {"Out": torch.full(tuple(x.shape), attrs.get("value", 0.0),
                              dtype=dt, device=x.device)}


# the ZeRO bucket plumbing (distributed/sharding.py): flatten, concat,
# pad, slice and reshape the gradient and parameter buckets
@register_op("reshape", inputs=["X", "Shape?!"], outputs=["Out"])
def reshape(ins, attrs, ctx):
    x = ins["X"]
    return {"Out": x.reshape(_resolve_shape(attrs.get("shape", []), x))}


@register_op("concat", inputs=["X*", "AxisTensor?!"], outputs=["Out"])
def concat(ins, attrs, ctx):
    return {"Out": torch.cat(list(ins["X"]), dim=attrs.get("axis", 0))}


@register_op("slice", inputs=["Input", "StartsTensor?!", "EndsTensor?!"],
             outputs=["Out"])
def slice_op(ins, attrs, ctx):
    """A view of `Input` cut along `axes` (negative bounds count from the
    end, as the JAX package's); `decrease_axis` drops those dims."""
    x = ins["Input"]
    out = x
    for a, s, e in zip(attrs["axes"], attrs.get("starts", []),
                       attrs.get("ends", [])):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        out = out.narrow(a, s, max(e - s, 0))
    for a in sorted(attrs.get("decrease_axis", []), reverse=True):
        out = out.squeeze(a)
    return {"Out": out}


@register_op("pad", inputs=["X"], outputs=["Out"])
def pad(ins, attrs, ctx):
    """`paddings` = [before_0, after_0, before_1, ...], filled with
    `pad_value`."""
    x = ins["X"]
    p = attrs["paddings"]
    widths = []
    for i in reversed(range(x.dim())):  # torch lists the last dim first
        widths += [int(p[2 * i]), int(p[2 * i + 1])]
    return {"Out": torch.nn.functional.pad(
        x, widths, value=float(attrs.get("pad_value", 0.0)))}


@register_op("flatten_contiguous_range", inputs=["X"],
             outputs=["Out", "XShape"])
def flatten_contiguous_range(ins, attrs, ctx):
    """paddle.flatten's op: axes start_axis..stop_axis merged into one."""
    x = ins["X"]
    nd = max(x.dim(), 1)
    start = attrs.get("start_axis", 1) % nd
    stop = attrs.get("stop_axis", -1) % nd
    shape = tuple(x.shape[:start]) + (-1,) + tuple(x.shape[stop + 1:])
    return {"Out": x.reshape(shape), "XShape": _xshape(x)}


@register_op("gather", inputs=["X", "Index!", "Axis?!"], outputs=["Out"])
def gather(ins, attrs, ctx):
    axis = attrs.get("axis", 0)
    if ins.get("Axis") is not None:
        axis = int(ins["Axis"])
    idx = ins["Index"].long()
    out = torch.index_select(ins["X"], axis, idx.reshape(-1))
    return {"Out": out.reshape(tuple(ins["X"].shape[:axis % ins["X"].dim()])
                               + tuple(idx.shape)
                               + tuple(ins["X"].shape[
                                   axis % ins["X"].dim() + 1:]))}
