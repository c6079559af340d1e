"""paddle.nn.functional — the subset the GPT `/generate` slice and the
dygraph BERT training slice call.

Counterpart of paddle_tpu/nn/functional.py, written as torch ops on torch
tensors with Paddle's conventions: a `linear` weight is [in,
features_out]; `embedding` writes zeros for `padding_idx`; `gelu`
defaults to the exact erf form.  Each function first calls
`dygraph.tracer.amp_inputs` with the op type(s) the JAX package traces
for it (`linear` is `matmul_v2` then `elementwise_add`), so under
`amp.auto_cast` the casts are the JAX package's.

  * `dropout`: the identity in eval ("upscale_in_train") or a scale by
    1 - p ("downgrade_in_infer"), and the identity at p = 0.  In training
    it is `ops.dropout.DropoutFn`: the forward is `dropout_fwd` (the
    Philox kernel on a CUDA tensor, its plain version on a CPU one), keyed
    by `global_seed()` and `next_eager_uid()`; the backward is the
    explicit gradient from the saved Mask (`apply_mask`, as the static
    `dropout` op's grad), so nothing is drawn twice;
  * `cross_entropy` / `softmax_with_cross_entropy` run the port's
    `softmax_with_cross_entropy` kernel (reductions, `ignore_index`,
    `weight`, soft labels), so with FLAGS_fused_xent on, hard labels over
    the last axis take the fused cross-entropy kernel (ops/fused_xent.py),
    as the static op does (the JAX package fuses only under a trace);
  * `mse_loss`, and the activations `relu`, `tanh`, `gelu`, `softmax`,
    `log_softmax`;
  * the vision functions: `conv2d` (the conv2d op's kernel, cuDNN with
    TF32 off for fp32 operands in the forward and the backward, then the
    bias as an `elementwise_add`), `max_pool2d`, `avg_pool2d`,
    `adaptive_avg_pool2d` (the `pool2d` kernel, with its reference
    quirks: `ceil_mode` is not read, adaptive windows are in // out), and
    `batch_norm` (the batch_norm kernel's statistics and gradient; in
    training it writes the new running stats into the buffers it was
    given, as the JAX package's `set_value` does).  Under `auto_cast`
    conv2d is white, batch_norm black and pool2d gray, as listed in
    amp/fp16_lists.py;
  * the vision tier: `conv2d_transpose`, `conv3d`, `max_pool2d(
    return_mask=True)`, `adaptive_max_pool2d`, `instance_norm`,
    `group_norm`, `normalize`, `cosine_similarity`, `dropout2d`, `pad`,
    `interpolate` / `upsample`, `pixel_shuffle`, `unfold`, `grid_sample`,
    `affine_grid`, `temporal_shift` and `relu6` dispatch in every mode
    (tensor/_dispatch.py: eager through the registry's kernel, recorded
    under a recorder) the op(s) the JAX function dispatches, with its
    quirks (`unfold` is im2sequence, `pad` reads no mode; ROADMAP.md
    Queue 3).

Under a `jit.to_static` recorder (`dygraph.tracer.recording()`) each
function instead dispatches the op(s) the JAX package's function
dispatches, with its slots and attrs (tensor/_dispatch.py): the
registry's kernel runs and the op is recorded.  In training,
`batch_norm` then records its running-stat update for the replay instead
of writing the buffers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dygraph.tracer import amp_inputs, eager_draw_key, recording
from ..ops.dropout import DropoutFn as _DropoutFn
from ..ops.kernels.nn import BatchNormFn, conv_nd, pool_forward

__all__ = ["linear", "embedding", "layer_norm", "gelu", "relu", "relu6",
           "tanh", "sigmoid",
           "softmax", "log_softmax", "dropout", "dropout_with_mask",
           "cross_entropy", "softmax_with_cross_entropy", "mse_loss",
           "conv2d", "conv2d_transpose", "conv3d", "max_pool2d",
           "avg_pool2d", "adaptive_avg_pool2d", "adaptive_max_pool2d",
           "batch_norm", "instance_norm", "group_norm", "normalize",
           "dropout2d", "pad", "interpolate", "upsample", "pixel_shuffle",
           "unfold", "grid_sample", "affine_grid", "cosine_similarity",
           "temporal_shift"]


def _dispatch(op_type, ins, attrs=None, outs=("Out",)):
    from ..tensor._dispatch import dispatch
    return dispatch(op_type, ins, attrs or {}, outs)


def linear(x, weight, bias=None, name=None):
    """x @ weight (+ bias), weight [in, out] (Paddle's layout)."""
    if recording():
        out = _dispatch("matmul_v2", {"X": x, "Y": weight},
                        {"trans_x": False, "trans_y": False})
        if bias is not None:
            out = _dispatch("elementwise_add", {"X": out, "Y": bias},
                            {"axis": -1})
        return out
    x, weight = amp_inputs("matmul_v2", x, weight)
    out = torch.matmul(x, weight)
    if bias is None:
        return out
    out, bias = amp_inputs("elementwise_add", out, bias)
    return out + bias


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of `weight` [V, E] at ids `x`; rows of `padding_idx` are 0
    (the lookup_table_v2 contract)."""
    if recording():
        return _dispatch("lookup_table_v2", {"W": weight, "Ids": x},
                         {"padding_idx": -1 if padding_idx is None
                          else padding_idx})
    (weight,) = amp_inputs("lookup_table_v2", weight)
    out = torch.nn.functional.embedding(x, weight)
    if padding_idx is not None and padding_idx != -1:
        pad = padding_idx % weight.shape[0]
        out = out.masked_fill((x == pad).unsqueeze(-1), 0.0)
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    if recording():
        n_norm = 1 if np.isscalar(normalized_shape) else \
            len(normalized_shape)
        return _dispatch("layer_norm", {"X": x, "Scale": weight,
                                        "Bias": bias},
                         {"epsilon": epsilon,
                          "begin_norm_axis": len(x.shape) - n_norm},
                         ("Y", "Mean", "Variance"))[0]
    x, weight, bias = amp_inputs("layer_norm", x, weight, bias)
    shape = [normalized_shape] if np.isscalar(normalized_shape) \
        else list(normalized_shape)
    return torch.nn.functional.layer_norm(x, shape, weight, bias, epsilon)


def _pair(v, n=2):
    return [v] * n if np.isscalar(v) else list(v)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """The conv2d op over `x` ([N, C, H, W], or NHWC) and `weight` [out,
    in / groups, kh, kw]; `padding` an int, 2 or 4 values, or "SAME" /
    "VALID"."""
    attrs = {"strides": _pair(stride), "paddings": _pair(padding),
             "dilations": _pair(dilation), "groups": groups,
             "data_format": data_format}
    if isinstance(padding, str):
        attrs["paddings"] = [0, 0]
        attrs["padding_algorithm"] = padding.upper()
    if recording():
        out = _dispatch("conv2d", {"Input": x, "Filter": weight}, attrs,
                        ("Output",))
        if bias is not None:
            out = _dispatch("elementwise_add", {"X": out, "Y": bias},
                            {"axis": 1 if data_format.startswith("NC")
                             else -1})
        return out
    x, weight = amp_inputs("conv2d", x, weight)
    out = conv_nd(x, weight, attrs, 2)
    if bias is None:
        return out
    out, bias = amp_inputs("elementwise_add", out, bias)
    return out + bias.reshape((1, -1, 1, 1) if data_format.startswith("NC")
                              else (1, 1, 1, -1))


def _pool2d(x, attrs):
    if recording():
        return _dispatch("pool2d", {"X": x}, attrs)
    (x,) = amp_inputs("pool2d", x)
    return pool_forward(x, attrs, 2)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    ks = _pair(kernel_size)
    attrs = {"pooling_type": "max", "ksize": ks,
             "strides": _pair(stride) if stride is not None else ks,
             "paddings": _pair(padding), "ceil_mode": ceil_mode,
             "global_pooling": False, "data_format": data_format,
             "exclusive": True}
    if return_mask:
        return _dispatch("max_pool2d_with_index", {"X": x}, attrs,
                         ("Out", "Mask"))
    return _pool2d(x, attrs)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, data_format="NCHW", name=None):
    ks = _pair(kernel_size)
    return _pool2d(x, {"pooling_type": "avg", "ksize": ks,
                       "strides": _pair(stride) if stride is not None
                       else ks, "paddings": _pair(padding),
                       "ceil_mode": ceil_mode, "global_pooling": False,
                       "data_format": data_format, "exclusive": exclusive})


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _pool2d(x, {"pooling_type": "avg", "ksize": _pair(output_size),
                       "adaptive": True, "strides": [1, 1],
                       "paddings": [0, 0], "global_pooling": False,
                       "data_format": data_format, "exclusive": True})


def adaptive_max_pool2d(x, output_size, data_format="NCHW", name=None):
    return _pool2d(x, {"pooling_type": "max", "ksize": _pair(output_size),
                       "adaptive": True, "strides": [1, 1],
                       "paddings": [0, 0], "global_pooling": False,
                       "data_format": data_format, "exclusive": True})


def _bias_add(out, bias, data_format):
    if bias is None:
        return out
    return _dispatch("elementwise_add", {"X": out, "Y": bias},
                     {"axis": 1 if data_format.startswith("NC") else -1})


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCHW", name=None):
    """The conv2d_transpose op, weight [in, out / groups, kh, kw];
    `output_padding` and `output_size` are not passed on, as in the JAX
    package."""
    attrs = {"strides": _pair(stride), "paddings": _pair(padding),
             "dilations": _pair(dilation), "groups": groups,
             "data_format": data_format}
    out = _dispatch("conv2d_transpose", {"Input": x, "Filter": weight},
                    attrs, ("Output",))
    return _bias_add(out, bias, data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    attrs = {"strides": _pair(stride, 3), "paddings": _pair(padding, 3),
             "dilations": _pair(dilation, 3), "groups": groups,
             "data_format": data_format}
    out = _dispatch("conv3d", {"Input": x, "Filter": weight}, attrs,
                    ("Output",))
    return _bias_add(out, bias, data_format)


def batch_norm(x, running_mean, running_var, weight, bias, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None, name=None):
    """Batch norm over the channel axis; in training (and without
    `use_global_stats`) on the batch statistics, the running stats
    updated in place: mean * momentum + batch mean * (1 - momentum)."""
    attrs = {"momentum": momentum, "epsilon": epsilon,
             "data_format": data_format, "is_test": not training,
             "use_global_stats": bool(use_global_stats)}
    if recording():
        from ..dygraph import tracer
        y, mean_out, var_out, _, _, _ = _dispatch(
            "batch_norm",
            {"X": x, "Scale": weight, "Bias": bias, "Mean": running_mean,
             "Variance": running_var}, attrs,
            ("Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance",
             "ReserveSpace"))
        if training:
            tracer._PROGRAM_RECORDER.update(running_mean, mean_out)
            tracer._PROGRAM_RECORDER.update(running_var, var_out)
        return y
    x, weight, bias = amp_inputs("batch_norm", x, weight, bias)
    y, mean_out, var_out, _, _ = BatchNormFn.apply(
        x, weight, bias, running_mean, running_var, attrs, False)
    if training:
        with torch.no_grad():
            running_mean.copy_(mean_out)
            running_var.copy_(var_out)
    return y


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, eps=1e-5, momentum=0.9, name=None):
    return _dispatch("instance_norm", {"X": x, "Scale": weight,
                                       "Bias": bias}, {"epsilon": eps},
                     ("Y", "SavedMean", "SavedVariance"))[0]


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    return _dispatch("group_norm", {"X": x, "Scale": weight, "Bias": bias},
                     {"epsilon": epsilon, "groups": num_groups,
                      "data_format": data_format},
                     ("Y", "Mean", "Variance"))[0]


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """x / ||x||_p along `axis`: the norm op for p = 2 (epsilon inside
    the square root), else p_norm then a division."""
    if p == 2:
        return _dispatch("norm", {"X": x},
                         {"axis": int(axis), "epsilon": float(epsilon),
                          "is_test": True}, ("Out", "Norm"))[0]
    from ..tensor import math as M
    pn = _dispatch("p_norm", {"X": x},
                   {"porder": float(p), "axis": int(axis), "keepdim": True,
                    "epsilon": float(epsilon)})
    return M.divide(x, pn)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    from ..tensor import math as M
    return M.sum(M.multiply(normalize(x1, axis=axis, epsilon=eps),
                            normalize(x2, axis=axis, epsilon=eps)),
                 axis=axis)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """The pad op: `pad` of 2 x rank values [before_0, after_0, ...], or
    fewer, applied from the LAST axis on ([left, right, top, bottom]).
    The op pads with `value` whatever `mode` says (ROADMAP.md Queue 3)."""
    nd = len(x.shape)
    if len(pad) == nd * 2:
        paddings = [int(p) for p in pad]
    else:
        paddings = [0] * (nd * 2)
        for j, (lo, hi) in enumerate(zip(pad[0::2], pad[1::2])):
            paddings[2 * (nd - 1 - j)] = int(lo)
            paddings[2 * (nd - 1 - j) + 1] = int(hi)
    return _dispatch("pad", {"X": x}, {"paddings": paddings,
                                       "pad_value": float(value),
                                       "mode": mode})


_INTERP_OPS = {"nearest": "nearest_interp_v2",
               "bilinear": "bilinear_interp_v2",
               "bicubic": "bicubic_interp_v2",
               "trilinear": "trilinear_interp", "linear": "linear_interp"}


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """The interpolation op of `mode` (vision.py's kernels: jax.image's
    resize arithmetic); `size` sets out_h and out_w, so the 1-d and 3-d
    modes take their size from `scale_factor` (ROADMAP.md Queue 3)."""
    attrs = {"align_corners": align_corners, "align_mode": align_mode,
             "data_layout": data_format}
    if size is not None:
        size = _pair(size)
        attrs["out_h"], attrs["out_w"] = int(size[0]), int(size[1])
    if scale_factor is not None:
        attrs["scale"] = (float(scale_factor) if np.isscalar(scale_factor)
                          else list(scale_factor))
    return _dispatch(_INTERP_OPS[mode], {"X": x}, attrs)


upsample = interpolate


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    return _dispatch("pixel_shuffle", {"X": x},
                     {"upscale_factor": upscale_factor,
                      "data_format": data_format})


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """The im2sequence op, as the JAX package dispatches it: [N oh ow,
    C kh kw] (not paddle's [N, C kh kw, L]); `dilations` is not read
    (ROADMAP.md Queue 3)."""
    return _dispatch("im2sequence", {"X": x},
                     {"kernels": _pair(kernel_sizes),
                      "strides": _pair(strides),
                      "paddings": _pair(paddings, 4)})


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    return _dispatch("grid_sampler", {"X": x, "Grid": grid},
                     {"mode": mode, "padding_mode": padding_mode,
                      "align_corners": align_corners}, ("Output",))


def affine_grid(theta, out_shape, align_corners=True, name=None):
    return _dispatch("affine_grid", {"Theta": theta},
                     {"output_shape": list(out_shape),
                      "align_corners": align_corners}, ("Output",))


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    return _dispatch("temporal_shift", {"X": x},
                     {"seg_num": seg_num, "shift_ratio": shift_ratio})


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Element-wise dropout, as the JAX package's (no whole channels)."""
    return dropout(x, p, training=training)


def relu6(x, name=None):
    return _dispatch("relu6", {"X": x})


def _unary(op_type, fn):
    def f(x, name=None):
        if recording():
            return _dispatch(op_type, {"X": x})
        (x,) = amp_inputs(op_type, x)
        return fn(x)
    f.__name__ = op_type
    return f


relu = _unary("relu", torch.relu)
tanh = _unary("tanh", torch.tanh)
sigmoid = _unary("sigmoid", torch.sigmoid)


def gelu(x, approximate=False, name=None):
    if recording():
        return _dispatch("gelu", {"X": x},
                         {"approximate": bool(approximate)})
    (x,) = amp_inputs("gelu", x)
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def softmax(x, axis=-1, dtype=None, name=None):
    if recording():
        return _dispatch("softmax", {"X": x}, {"axis": int(axis)})
    (x,) = amp_inputs("softmax", x)
    return torch.softmax(x, dim=int(axis))


def log_softmax(x, axis=-1, dtype=None, name=None):
    if recording():
        return _dispatch("log_softmax", {"X": x}, {"axis": int(axis)})
    (x,) = amp_inputs("log_softmax", x)
    return torch.log_softmax(x, dim=int(axis))


def dropout_with_mask(x, p=0.5, training=True, mode="upscale_in_train"):
    """(Out, Mask uint8) of the `dropout` op: the JAX package's kernel
    outputs, with the port's draw (Philox keyed by the global seed and
    the next eager uid) in training."""
    if recording():
        impl = mode if mode in ("upscale_in_train", "downgrade_in_infer") \
            else "upscale_in_train"
        return _dispatch("dropout", {"X": x},
                         {"dropout_prob": float(p), "is_test": not training,
                          "dropout_implementation": impl},
                         ("Out", "Mask"))
    (x,) = amp_inputs("dropout", x)
    upscale = mode != "downgrade_in_infer"
    if not training:
        out = x if upscale else \
            x * float(torch.tensor(1.0 - p, dtype=x.dtype))
        return out, torch.ones_like(x, dtype=torch.uint8)
    seed, uid = eager_draw_key()
    return _DropoutFn.apply(x, float(p), seed, uid, upscale)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if axis is not None:
        raise NotImplementedError("dropout along an axis is not ported "
                                  "(ROADMAP.md Queue 1, The rest)")
    if training and p == 0 and not recording():
        return x  # every element kept, x / 1: no draw, no launch
    return dropout_with_mask(x, p, training, mode)[0]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _reduce_loss(loss, reduction):
    from ..tensor import math as M
    if reduction == "mean":
        return M.mean(loss)
    if reduction == "sum":
        return M.sum(loss)
    return loss


def softmax_with_cross_entropy(logits, label, soft_label=False, axis=-1,
                               ignore_index=-100, return_softmax=False,
                               name=None):
    if recording():
        loss, sm = _dispatch(
            "softmax_with_cross_entropy", {"Logits": logits, "Label": label},
            {"soft_label": bool(soft_label), "ignore_index": ignore_index,
             "axis": int(axis)}, ("Loss", "Softmax"))
        return (loss, sm) if return_softmax else loss
    from ..ops.kernels.loss import softmax_with_cross_entropy as kernel
    (logits,) = amp_inputs("softmax_with_cross_entropy", logits)
    outs = kernel({"Logits": logits, "Label": label},
                  {"soft_label": bool(soft_label), "axis": int(axis),
                   "ignore_index": ignore_index}, None)
    return (outs["Loss"], outs["Softmax"]) if return_softmax \
        else outs["Loss"]


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    from ..tensor import math as M
    if recording():
        if weight is not None:
            from ..dygraph.tracer import refuse
            refuse("cross_entropy(weight=...)")
        loss, _ = _dispatch(
            "softmax_with_cross_entropy", {"Logits": input, "Label": label},
            {"soft_label": bool(soft_label), "ignore_index": ignore_index,
             "axis": int(axis), "use_softmax": use_softmax},
            ("Loss", "Softmax"))
        return _reduce_loss(loss, reduction)
    loss = softmax_with_cross_entropy(input, label, soft_label, axis,
                                      ignore_index)
    if weight is not None and not soft_label:
        lbl = label.squeeze(-1) if label.shape[-1] == 1 else label
        (weight,) = amp_inputs("gather", weight)
        w = weight[lbl.long()]
        w = w.unsqueeze(-1) if w.dim() < loss.dim() else w
        loss = M.multiply(loss, w)
        if reduction == "mean":
            return M.divide(M.sum(loss), M.sum(w))
    return _reduce_loss(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    if recording():
        return _reduce_loss(_dispatch("mse_loss", {"X": input, "Y": label}),
                            reduction)
    input, label = amp_inputs("mse_loss", input, label)
    return _reduce_loss(torch.square(input - label), reduction)
