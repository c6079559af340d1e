"""NN ops of the slices: conv2d, pool2d, batch_norm, layer_norm, softmax,
dropout, lookup_table and lookup_table_v2, fc.

Counterparts of the kernels of the same names in
paddle_tpu/ops/kernels/nn.py, with the same attrs and dtype rules:
normalization and softmax compute in fp32 for half-precision inputs and
return the input dtype.  `dropout` draws its mask with the Philox kernel
of ops/dropout.py (not the JAX package's threefry bits) and has an
explicit gradient that reads the saved Mask: a vjp replay of the forward
would draw again.  The embeddings have the JAX package's explicit
gradient too: a scatter-add, or with `is_sparse` a SelectedRows.

The JAX package computes conv2d, pool2d and batch_norm outside any Pallas
kernel (`lax.conv_general_dilated`, `lax.reduce_window`, jnp), so here
they are cuDNN and ATen calls through torch:

  * `conv2d` is `Conv2dFn` (F.conv2d forward, aten.convolution_backward
    backward) with cuDNN's TF32 off around both for fp32 operands, so an
    fp32 convolution is an fp32 convolution whatever the process-wide
    flag says; its grad op is explicit (no forward replay);
  * `pool2d` keeps the reference's semantics, quirks included: it pools
    the last two axes whatever `data_format` says and ignores
    `ceil_mode`; `adaptive` pools in windows of in // out;
  * `batch_norm` computes the batch statistics as the reference does
    (biased variance in fp32, `SavedVariance` the inverse standard
    deviation, running stats `mean * momentum + m * (1 - momentum)`);
    torch's batch_norm in its inference form only applies them to make
    Y, and the grad op is ATen's batch-norm backward over `SavedMean` /
    `SavedVariance` (no replay, so the running stats move once a step).
    The static builder writes `data_layout`, the kernel reads
    `data_format`, as in the reference.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from ..dropout import DropoutFn, apply_mask
from ..registry import register_op
from ...core.selected_rows import SelectedRows


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
    out, mask = DropoutFn.apply(x, p, seed, uid, upscale)
    return {"Out": out, "Mask": mask}


def _embedding(w, ids, attrs):
    padding_idx = attrs.get("padding_idx", -1)
    ids = ids.long()
    out = w[ids]
    if padding_idx is not None and padding_idx != -1:
        pid = padding_idx if padding_idx >= 0 else w.shape[0] + padding_idx
        out = out.masked_fill((ids == pid)[..., None], 0)
    return out


def _lookup_table_grad(squeeze_trailing):
    """The embedding's gradient, explicit as the JAX package's
    (paddle_tpu/ops/kernels/nn.py:499): Out@GRAD's rows (zero at
    `padding_idx`) scatter-added into a [vocab, width] gradient, or, with
    `is_sparse`, handed on as a SelectedRows {ids, rows} pair that the
    optimizer scatter-adds itself (the dense gradient never exists)."""

    def grad_kernel(ins, attrs, ctx):
        w, ids, og = ins["W"], ins["Ids"], ins["Out@GRAD"]
        if squeeze_trailing and ids.shape[-1] == 1:
            ids = ids.squeeze(-1)
        rows = ids.reshape(-1).long()
        vals = og.reshape((-1,) + tuple(w.shape[1:])).to(w.dtype)
        padding_idx = attrs.get("padding_idx", -1)
        if padding_idx is not None and padding_idx != -1:
            pid = padding_idx if padding_idx >= 0 else w.shape[0] + padding_idx
            vals = torch.where((rows != pid)[:, None], vals,
                               torch.zeros_like(vals))
        if attrs.get("is_sparse", False):
            return {"W@GRAD": SelectedRows(rows, vals, w.shape[0])}
        return {"W@GRAD": torch.zeros_like(w).index_put_(
            (rows,), vals, accumulate=True)}

    return grad_kernel


@register_op("lookup_table", inputs=["W", "Ids!"], outputs=["Out"],
             grad=_lookup_table_grad(squeeze_trailing=True))
def lookup_table(ins, attrs, ctx):
    ids = ins["Ids"]
    ids = ids.squeeze(-1) if ids.shape[-1] == 1 else ids
    return {"Out": _embedding(ins["W"], ids, attrs)}


@register_op("lookup_table_v2", inputs=["W", "Ids!"], outputs=["Out"],
             grad=_lookup_table_grad(squeeze_trailing=False))
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


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def exact_fp32(x):
    """cuDNN's TF32 off while an fp32 CUDA convolution is issued (the
    default lets cuDNN round fp32 operands to TF32); the previous
    setting comes back afterwards."""
    if not (x.is_cuda and x.dtype == torch.float32):
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _conv_padding(paddings, algo, ndims):
    if algo == "SAME":
        return "SAME"
    if algo == "VALID":
        return [(0, 0)] * ndims
    p = list(paddings)
    if len(p) == ndims:
        return [(pi, pi) for pi in p]
    if len(p) == 2 * ndims:
        return [(p[2 * i], p[2 * i + 1]) for i in range(ndims)]
    raise ValueError(f"bad paddings {paddings}")


def _same_pads(sizes, windows, strides):
    """(lo, hi) per spatial dim of "SAME" padding: XLA's rule, the output
    ceil(in / stride) and the odd pixel at the end."""
    pads = []
    for n, k, s in zip(sizes, windows, strides):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _conv_geometry(x, w, attrs):
    """(strides, dilations, groups, pads) of a 2-D conv over NCHW `x`,
    pads as (lo, hi) per spatial dim."""
    strides = list(attrs.get("strides", [1, 1]))
    dilations = list(attrs.get("dilations", [1, 1]))
    pads = _conv_padding(attrs.get("paddings", [0, 0]),
                         attrs.get("padding_algorithm", "EXPLICIT"), 2)
    if pads == "SAME":
        eff = [(k - 1) * d + 1 for k, d in zip(w.shape[2:], dilations)]
        pads = _same_pads(x.shape[2:], eff, strides)
    return strides, dilations, int(attrs.get("groups", 1)), pads


def _pad_operand(x, pads, value=0.0):
    """(x, symmetric padding): x padded by F.pad where a side differs."""
    if all(lo == hi for lo, hi in pads):
        return x, [lo for lo, _ in pads]
    return F.pad(x, [p for lo, hi in reversed(pads) for p in (lo, hi)],
                 value=value), [0] * len(pads)


class Conv2dFn(torch.autograd.Function):
    """F.conv2d with an explicit backward (aten.convolution_backward), both
    under `exact_fp32`: autograd runs a backward outside the forward's
    context, so the backward sets the flag again."""

    @staticmethod
    def forward(x, w, stride, padding, dilation, groups):
        with exact_fp32(x):
            return F.conv2d(x, w, None, stride, padding, dilation, groups)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w = inputs[:2]
        ctx.geometry = inputs[2:]
        ctx.save_for_backward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx, gw = conv2d_backward(g, x, w, *ctx.geometry,
                                 ctx.needs_input_grad[:2])
        return gx, gw, None, None, None, None


def conv2d_backward(g, x, w, stride, padding, dilation, groups, mask):
    """(dX, dW) of F.conv2d at `g`; `mask` says which to compute."""
    with exact_fp32(x):
        gx, gw, _ = torch.ops.aten.convolution_backward(
            g.to(x.dtype), x, w, None, list(stride), list(padding),
            list(dilation), False, [0, 0], groups,
            [bool(mask[0]), bool(mask[1]), False])
    return gx, gw


def _nchw(x, attrs):
    return x.movedim(-1, 1) if attrs.get("data_format") == "NHWC" else x


def _from_nchw(x, attrs):
    return x.movedim(1, -1) if attrs.get("data_format") == "NHWC" else x


def conv2d_forward(x, w, attrs):
    """The conv2d op's output (no bias) in the layout of `x`."""
    x = _nchw(x, attrs)
    strides, dilations, groups, pads = _conv_geometry(x, w, attrs)
    xp, sym = _pad_operand(x, pads)
    out = Conv2dFn.apply(xp, w, strides, sym, dilations, groups)
    return _from_nchw(out, attrs)


def _conv2d_grad(ins, attrs, ctx):
    """Input, Filter and Bias gradients of conv2d from Output@GRAD alone
    (the forward is not replayed): one cuDNN backward call."""
    x, w, g = ins["Input"], ins["Filter"], ins.get("Output@GRAD")
    if g is None:
        return {}
    x, g = _nchw(x, attrs), _nchw(g, attrs)
    strides, dilations, groups, pads = _conv_geometry(x, w, attrs)
    xp, sym = _pad_operand(x, pads)
    gx, gw = conv2d_backward(g, xp, w, strides, sym, dilations, groups,
                             (True, True))
    if xp is not x:  # crop the explicit padding back off
        (t, _), (l, _) = pads
        gx = gx[:, :, t:t + x.shape[2], l:l + x.shape[3]]
    out = {"Input@GRAD": _from_nchw(gx, attrs), "Filter@GRAD": gw}
    if ins.get("Bias") is not None:
        out["Bias@GRAD"] = g.sum(dim=(0, 2, 3)).to(ins["Bias"].dtype)
    return out


@register_op("conv2d", inputs=["Input", "Filter", "Bias?"],
             outputs=["Output"], grad=_conv2d_grad)
def conv2d(ins, attrs, ctx):
    out = conv2d_forward(ins["Input"], ins["Filter"], attrs)
    if ins.get("Bias") is not None:
        out = out + ins["Bias"].reshape(1, -1, 1, 1)
    return {"Output": out}


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------
def pool2d_forward(x, attrs):
    """The reference's `_pool` over the last two axes: max or avg (the
    count of real pixels in a window when `exclusive`, else the window
    size), global, adaptive in windows of in // out."""
    ptype = attrs.get("pooling_type", "max")
    ksize = list(attrs.get("ksize", [2, 2]))
    strides = list(attrs.get("strides", ksize))
    pads = attrs.get("paddings", [0, 0])
    if attrs.get("global_pooling", False) or attrs.get("adaptive", False) \
            and all(k == 1 for k in ksize):
        if ptype == "max":
            return x.amax(dim=(-2, -1), keepdim=True)
        return x.mean(dim=(-2, -1), keepdim=True)
    if attrs.get("adaptive", False):
        ksize = [n // o for n, o in zip(x.shape[-2:], ksize)]
        strides, pads = list(ksize), [0, 0]
    pads = _conv_padding(pads, attrs.get("padding_algorithm", "EXPLICIT"),
                         2)
    if pads == "SAME":
        pads = _same_pads(x.shape[-2:], ksize, strides)
    # torch pads symmetrically by at most half a window; other pads are
    # an explicit F.pad (-inf for max, 0 for avg)
    implicit = all(lo == hi and 2 * lo <= k
                   for (lo, hi), k in zip(pads, ksize))
    if ptype == "max":
        if implicit:
            return F.max_pool2d(x, ksize, strides, [lo for lo, _ in pads])
        xp, _ = _pad_operand(x, pads, value=-math.inf)
        return F.max_pool2d(xp, ksize, strides)
    exclusive = attrs.get("exclusive", True)
    if implicit:
        return F.avg_pool2d(x, ksize, strides, [lo for lo, _ in pads],
                            count_include_pad=not exclusive)
    xp, _ = _pad_operand(x, pads)
    if not exclusive:
        return F.avg_pool2d(xp, ksize, strides)
    total = F.avg_pool2d(xp, ksize, strides, divisor_override=1)
    ones, _ = _pad_operand(x.new_ones((1, 1) + tuple(x.shape[-2:])), pads)
    return total / F.avg_pool2d(ones, ksize, strides, divisor_override=1)


@register_op("pool2d", inputs=["X"], outputs=["Out"])
def pool2d(ins, attrs, ctx):
    return {"Out": pool2d_forward(ins["X"], attrs)}


# ---------------------------------------------------------------------------
# batch_norm
# ---------------------------------------------------------------------------
def _bn_layout(x, attrs):
    """(channel axis, x with the channel axis at 1) of a batch_norm."""
    fmt = attrs.get("data_format", "NCHW")
    caxis = 1 if fmt == "NCHW" and x.dim() > 1 else x.dim() - 1
    return caxis, x.movedim(caxis, 1)


def _bn_global(attrs, ctx):
    is_test = attrs.get("is_test", False) or (ctx is not None
                                              and ctx.is_test)
    return bool(is_test or attrs.get("use_global_stats", False))


def batch_norm_forward(ins, attrs, ctx):
    """The batch_norm op's outputs; X in its own layout and dtype."""
    x = ins["X"]
    mean, var = ins["Mean"], ins["Variance"]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    caxis, xc = _bn_layout(x, attrs)
    cdt = _cdt(x)
    xf = xc.to(cdt)
    if _bn_global(attrs, ctx):
        m, v = mean, var
        mean_out, var_out = mean, var
    else:
        v, m = torch.var_mean(xf, dim=[d for d in range(xf.dim())
                                       if d != 1], unbiased=False)
        mean_out = mean * momentum + m * (1 - momentum)
        var_out = var * momentum + v * (1 - momentum)
    inv = torch.rsqrt(v + eps)
    # torch's inference-form batch norm applies the statistics above:
    # one elementwise pass, (x - m) * rsqrt(v + eps) * scale + bias
    y = F.batch_norm(xf, m.to(cdt), v.to(cdt), ins["Scale"].to(cdt),
                     ins["Bias"].to(cdt), training=False, eps=eps)
    return {"Y": y.movedim(1, caxis).to(x.dtype), "MeanOut": mean_out,
            "VarianceOut": var_out, "SavedMean": m, "SavedVariance": inv}


def batch_norm_backward(g, x, scale, m, inv, train, attrs):
    """(dX, dScale, dBias) of batch_norm at dY = `g`, from the forward's
    statistics: `m` and `inv` the batch mean and inverse standard
    deviation when `train` (the gradient through them included), else the
    running mean and variance."""
    eps = attrs.get("epsilon", 1e-5)
    caxis, xc = _bn_layout(x, attrs)
    cdt = _cdt(x)
    gc = g.movedim(caxis, 1).to(cdt)
    if train:
        args = (None, None, m.to(cdt), inv.to(cdt))
    else:
        args = (m.to(cdt), inv.to(cdt), None, None)
    gx, gs, gb = torch.ops.aten.native_batch_norm_backward(
        gc, xc.to(cdt), scale.to(cdt), *args, train, eps,
        [True, True, True])
    return gx.movedim(1, caxis).to(x.dtype), gs.to(scale.dtype), \
        gb.to(scale.dtype)


class BatchNormFn(torch.autograd.Function):
    """batch_norm for autograd (the dygraph path): Y and the statistics of
    `batch_norm_forward`, the gradient of `batch_norm_backward`."""

    @staticmethod
    def forward(x, scale, bias, mean, var, attrs):
        outs = batch_norm_forward({"X": x, "Scale": scale, "Bias": bias,
                                   "Mean": mean, "Variance": var}, attrs,
                                  None)
        # with the running stats in use the stats are the inputs
        # themselves: autograd takes views of them, not the inputs
        return tuple(t.view_as(t) if t is mean or t is var else t
                     for t in (outs["Y"], outs["MeanOut"],
                               outs["VarianceOut"], outs["SavedMean"],
                               outs["SavedVariance"]))

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, _, mean, var, attrs = inputs
        ctx.attrs, ctx.train = attrs, not _bn_global(attrs, None)
        ctx.save_for_backward(x, scale, *((output[3], output[4])
                                          if ctx.train else (mean, var)))
        ctx.mark_non_differentiable(*output[1:])

    @staticmethod
    def backward(ctx, g, *_):
        x, scale, m, s = ctx.saved_tensors
        gx, gs, gb = batch_norm_backward(g, x, scale, m, s, ctx.train,
                                         ctx.attrs)
        return gx, gs, gb, None, None, None


def _batch_norm_grad(ins, attrs, ctx):
    """X, Scale and Bias gradients from Y@GRAD and the saved statistics
    (no replay of the forward, which would move the running stats' values
    it computes a second time)."""
    g = ins.get("Y@GRAD")
    if g is None:
        return {}
    train = not _bn_global(attrs, ctx)
    m, s = ((ins["SavedMean"], ins["SavedVariance"]) if train else
            (ins["Mean"], ins["Variance"]))
    gx, gs, gb = batch_norm_backward(g, ins["X"], ins["Scale"], m, s,
                                     train, attrs)
    return {"X@GRAD": gx, "Scale@GRAD": gs, "Bias@GRAD": gb}


@register_op("batch_norm",
             inputs=["X", "Scale", "Bias", "Mean", "Variance"],
             outputs=["Y", "MeanOut", "VarianceOut", "SavedMean",
                      "SavedVariance", "ReserveSpace?"],
             grad=_batch_norm_grad)
def batch_norm(ins, attrs, ctx):
    # the dygraph Function, so that a to_static replay under autograd
    # backpropagates through batch_norm_backward; the executor's is_test
    # is folded into the attrs the Function reads
    a = dict(attrs, is_test=_bn_global(dict(attrs, use_global_stats=False),
                                       ctx))
    outs = BatchNormFn.apply(ins["X"], ins["Scale"], ins["Bias"],
                             ins["Mean"], ins["Variance"], a)
    return dict(zip(("Y", "MeanOut", "VarianceOut", "SavedMean",
                     "SavedVariance"), outs))
