"""Ops of paddle_tpu/ops/kernels/op_gaps.py that the ported slices run:
label_smooth (Transformer-big's smoothed one-hot target),
get_tensor_from_selected_rows (paddle.get_tensor_from_selected_rows),
unfold (im2col as the 2.0 API), max_pool3d_with_index and
depthwise_conv2d_transpose (cuDNN through nn.py's `ConvFn`)."""
from __future__ import annotations

import torch.nn.functional as F

from ..registry import register_op
from .nn import conv_transpose_nd, pool_forward, window_argmax


@register_op("label_smooth", inputs=["X", "PriorDist?!"], outputs=["Out"])
def label_smooth(ins, attrs, ctx):
    """(1 - epsilon) * X + epsilon * prior, the prior PriorDist (one row
    over the classes) or uniform 1 / C; the gradient is the default
    (vjp): (1 - epsilon) * dOut."""
    x = ins["X"]
    eps = attrs.get("epsilon", 0.0)
    prior = ins.get("PriorDist")
    p = prior.reshape(1, -1) if prior is not None else 1.0 / x.shape[-1]
    return {"Out": (1.0 - eps) * x + eps * p}


@register_op("get_tensor_from_selected_rows", inputs=["X"],
             outputs=["Out"], grad=None)
def get_tensor_from_selected_rows(ins, attrs, ctx):
    """Densify a SelectedRows (rows scatter-added into [height, ...]); a
    dense tensor passes through."""
    from ...core.selected_rows import SelectedRows
    x = ins["X"]
    return {"Out": x.to_dense() if isinstance(x, SelectedRows) else x}


@register_op("unfold", inputs=["X"], outputs=["Y"])
def unfold(ins, attrs, ctx):
    """X [N, C, H, W] -> Y [N, C kh kw, L], L the sliding positions;
    `paddings` 2 values (both sides) or 4 (top, left, bottom, right)."""
    x = ins["X"]
    kh, kw = attrs["kernel_sizes"]
    p = list(attrs.get("paddings", [0, 0, 0, 0]))
    top, bottom = (p[0], p[2]) if len(p) == 4 else (p[0], p[0])
    left, right = (p[1], p[3]) if len(p) == 4 else (p[1], p[1])
    x = F.pad(x, [left, right, top, bottom])
    return {"Y": F.unfold(x, (kh, kw),
                          dilation=tuple(attrs.get("dilations", [1, 1])),
                          stride=tuple(attrs.get("strides", [1, 1])))}


@register_op("max_pool3d_with_index", inputs=["X"], outputs=["Out", "Mask"])
def max_pool3d_with_index(ins, attrs, ctx):
    """Max pool over [D, H, W] and the flat argmax of each window over the
    unpadded volume (ties to the smallest index, padded cells never win);
    Out and Mask share the padded geometry.  `adaptive` raises, as in the
    reference."""
    x = ins["X"]
    ksize = list(attrs["ksize"])
    if attrs.get("global_pooling", False):
        ksize = list(x.shape[2:])
    strides = list(attrs.get("strides", ksize))
    pads = list(attrs.get("paddings", [0, 0, 0]))
    if attrs.get("adaptive", False):
        raise NotImplementedError(
            "max_pool3d_with_index adaptive=True: use pool3d(adaptive) "
            "when indices are not needed")
    out = pool_forward(x, {"pooling_type": "max", "ksize": ksize,
                           "strides": strides, "paddings": pads}, 3)
    mask = window_argmax(x, ksize, strides, [(p, p) for p in pads])
    return {"Out": out, "Mask": mask}


@register_op("depthwise_conv2d_transpose", inputs=["Input", "Filter"],
             outputs=["Output"])
def depthwise_conv2d_transpose(ins, attrs, ctx):
    """The per-channel transposed convolution: Filter [C, 1, kh, kw],
    groups = C, NCHW, `paddings` 2 or 4 values cropping the output."""
    x = ins["Input"]
    a = {k: attrs[k] for k in ("strides", "dilations", "paddings")
         if k in attrs}
    return {"Output": conv_transpose_nd(x, ins["Filter"], a, 2,
                                        groups=x.shape[1])}
