"""Tensor manipulation ops of the slices: reshape2, transpose2,
fill_constant, cast, one_hot_v2, gradient merge's where and
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
