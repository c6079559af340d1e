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
    amp/fp16_lists.py.

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
from ..ops.kernels.nn import BatchNormFn, conv2d_forward, pool2d_forward

__all__ = ["linear", "embedding", "layer_norm", "gelu", "relu", "tanh",
           "sigmoid",
           "softmax", "log_softmax", "dropout", "dropout_with_mask",
           "cross_entropy", "softmax_with_cross_entropy", "mse_loss",
           "conv2d", "max_pool2d", "avg_pool2d", "adaptive_avg_pool2d",
           "batch_norm"]


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
    out = conv2d_forward(x, weight, attrs)
    if bias is None:
        return out
    out, bias = amp_inputs("elementwise_add", out, bias)
    return out + bias.reshape((1, -1, 1, 1) if data_format.startswith("NC")
                              else (1, 1, 1, -1))


def _pool2d(x, attrs):
    if recording():
        return _dispatch("pool2d", {"X": x}, attrs)
    (x,) = amp_inputs("pool2d", x)
    return pool2d_forward(x, attrs)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    if return_mask:
        raise NotImplementedError(
            "max_pool2d(return_mask=True) needs max_pool2d_with_index, not "
            "ported yet (ROADMAP.md Queue 1, The rest)")
    ks = _pair(kernel_size)
    return _pool2d(x, {"pooling_type": "max", "ksize": ks,
                       "strides": _pair(stride) if stride is not None
                       else ks, "paddings": _pair(padding),
                       "ceil_mode": ceil_mode, "global_pooling": False,
                       "data_format": data_format, "exclusive": True})


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
        x, weight, bias, running_mean, running_var, attrs)
    if training:
        with torch.no_grad():
            running_mean.copy_(mean_out)
            running_var.copy_(var_out)
    return y


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
