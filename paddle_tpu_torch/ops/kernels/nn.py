"""NN ops: conv2d, conv3d, depthwise_conv2d, conv2d_transpose,
conv3d_transpose, pool2d, pool3d, max_pool2d_with_index, spp, unpool,
batch_norm, sync_batch_norm, instance_norm, group_norm, lrn, data_norm,
spectral_norm, layer_norm, softmax, dropout, lookup_table,
lookup_table_v2, embedding, fc, add_position_encoding, pixel_shuffle,
space_to_depth, temporal_shift and shuffle_channel.

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

  * the convolutions are `ConvFn` (aten.convolution, direct or
    transposed, any spatial rank; aten.convolution_backward) with cuDNN's
    TF32 off around both for fp32 operands (`exact_fp32`), so an fp32
    convolution is an fp32 convolution whatever the process-wide flag
    says.  conv2d's grad op is explicit (one backward call, no forward
    replay); the others' grad ops replay the forward under vjp, so their
    backward is that same cuDNN call.  A transposed convolution is one
    transposed cuDNN call and a crop to the reference's geometry
    (`conv_transpose_nd`);
  * `pool2d` (`pool_forward` at rank 2) keeps the reference's semantics,
    quirks included: it pools
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
  * pool3d is pool2d's `pool_forward` at rank 3; the *_with_index ops'
    Mask is `window_argmax` (ties to the smallest flat index, never
    torch's `return_indices`, whose order is unspecified); the JAX
    package cannot differentiate them (its paired reduce_window), the
    port's gradient is the max pool's;
  * sync_batch_norm allreduces sum x, sum x^2 and the count over the
    ring's process group (ops/kernels/collective.py; the local batch
    norm off a process group) and has an explicit grad op that
    allreduces the two sums dX needs;
  * instance_norm, group_norm, lrn, data_norm and spectral_norm are
    torch compositions of the JAX formulas, their grad ops the vjp.
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


def _conv_geometry(x, w, attrs, nd):
    """(strides, dilations, pads) of a direct convolution over the last
    `nd` axes of NC... `x`, pads as (lo, hi) per spatial dim."""
    strides = list(attrs.get("strides", [1] * nd))
    dilations = list(attrs.get("dilations", [1] * nd))
    pads = _conv_padding(attrs.get("paddings", [0] * nd),
                         attrs.get("padding_algorithm", "EXPLICIT"), nd)
    if pads == "SAME":
        eff = [(k - 1) * d + 1 for k, d in zip(w.shape[2:], dilations)]
        pads = _same_pads(x.shape[2:], eff, strides)
    return strides, dilations, pads


def _pad_operand(x, pads, value=0.0):
    """(x, symmetric padding): x padded by F.pad where a side differs."""
    if all(lo == hi for lo, hi in pads):
        return x, [lo for lo, _ in pads]
    return F.pad(x, [p for lo, hi in reversed(pads) for p in (lo, hi)],
                 value=value), [0] * len(pads)


def convolution_backward(g, x, w, stride, padding, dilation, transposed,
                         groups, mask):
    """(dX, dW) of aten.convolution at `g` under `exact_fp32`; `mask`
    says which to compute."""
    with exact_fp32(x):
        gx, gw, _ = torch.ops.aten.convolution_backward(
            g.to(x.dtype), x, w, None, list(stride), list(padding),
            list(dilation), transposed, [0] * len(stride), groups,
            [bool(mask[0]), bool(mask[1]), False])
    return gx, gw


class ConvFn(torch.autograd.Function):
    """aten.convolution (any spatial rank, direct or transposed) with an
    explicit backward (`convolution_backward`), both under `exact_fp32`:
    autograd runs a backward outside the forward's context, so the
    backward sets the flag again."""

    @staticmethod
    def forward(x, w, stride, padding, dilation, transposed, groups):
        with exact_fp32(x):
            return torch.ops.aten.convolution(
                x, w, None, list(stride), list(padding), list(dilation),
                transposed, [0] * len(stride), groups)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w = inputs[:2]
        ctx.geometry = inputs[2:]
        ctx.save_for_backward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx, gw = convolution_backward(g, x, w, *ctx.geometry,
                                      ctx.needs_input_grad[:2])
        return gx, gw, None, None, None, None, None


_CHANNELS_LAST = ("NHWC", "NDHWC")


def conv_nd(x, w, attrs, nd, groups=None, transpose=False):
    """The JAX package's `_conv`: a convolution over the last `nd` axes
    of NC... `x` (moved from NHWC / NDHWC and back), or with `transpose`
    its `_conv_transpose_nd`; no bias."""
    last = attrs.get("data_format", "NCHW") in _CHANNELS_LAST
    if last:
        x = x.movedim(-1, 1)
    if transpose:
        out = conv_transpose_nd(x, w, attrs, nd)
    else:
        strides, dilations, pads = _conv_geometry(x, w, attrs, nd)
        xp, sym = _pad_operand(x, pads)
        g = attrs.get("groups", 1) if groups is None else groups
        out = ConvFn.apply(xp, w, strides, sym, dilations, False, int(g))
    return out.movedim(1, -1) if last else out


def _conv2d_grad(ins, attrs, ctx):
    """Input, Filter and Bias gradients of conv2d from Output@GRAD alone
    (the forward is not replayed): one cuDNN backward call."""
    x, w, g = ins["Input"], ins["Filter"], ins.get("Output@GRAD")
    if g is None:
        return {}
    last = attrs.get("data_format", "NCHW") in _CHANNELS_LAST
    if last:
        x, g = x.movedim(-1, 1), g.movedim(-1, 1)
    strides, dilations, pads = _conv_geometry(x, w, attrs, 2)
    xp, sym = _pad_operand(x, pads)
    gx, gw = convolution_backward(g, xp, w, strides, sym, dilations, False,
                                  int(attrs.get("groups", 1)), (True, True))
    if xp is not x:  # crop the explicit padding back off
        gx = gx[(slice(None), slice(None)) + tuple(
            slice(lo, lo + n) for (lo, _), n in zip(pads, x.shape[2:]))]
    out = {"Input@GRAD": gx.movedim(1, -1) if last else gx,
           "Filter@GRAD": gw}
    if ins.get("Bias") is not None:
        out["Bias@GRAD"] = g.sum(dim=(0, 2, 3)).to(ins["Bias"].dtype)
    return out


@register_op("conv2d", inputs=["Input", "Filter", "Bias?"],
             outputs=["Output"], grad=_conv2d_grad)
def conv2d(ins, attrs, ctx):
    out = conv_nd(ins["Input"], ins["Filter"], attrs, 2)
    if ins.get("Bias") is not None:
        out = out + ins["Bias"].reshape(1, -1, 1, 1)
    return {"Output": out}


def conv_transpose_nd(x, w, attrs, nd, groups=None):
    """The JAX package's `_conv_transpose_nd` (paddle_tpu/ops/kernels/
    nn.py:68): filter [Cin, Cout / groups, k...]; `paddings` crop the
    output, (D - 1) s - lo - hi + (k - 1) d + 1; "SAME" pads the dilated
    input by (k_eff - 1) // 2 and the rest, as lax does for a string
    padding with lhs dilation; `output_size` end-pads with zeros within
    [natural, natural + stride - 1].  "SAME" with a stride above 1
    raises lax's error.  One transposed cuDNN convolution,
    then the crop (F.pad with negative widths where a side differs)."""
    strides = list(attrs.get("strides", [1] * nd))
    dilations = list(attrs.get("dilations", [1] * nd))
    pads = _conv_padding(attrs.get("paddings", [0] * nd),
                         attrs.get("padding_algorithm", "EXPLICIT"), nd)
    eff = [(k - 1) * d + 1 for k, d in zip(w.shape[2:], dilations)]
    if pads == "SAME":
        if any(s != 1 for s in strides):
            raise ValueError(
                "String padding is not implemented for transposed "
                "convolution using this op. Please either exactly specify "
                "the required padding or use conv_transpose.")
        crops = [(e - 1 - (e - 1) // 2, (e - 1) // 2) for e in eff]
    else:
        crops = list(pads)
    sym = [max(0, min(lo, hi)) for lo, hi in crops]
    g = int(attrs.get("groups", 1) if groups is None else groups)
    out = ConvFn.apply(x, w, strides, sym, dilations, True, g)
    rest = [(lo - p, hi - p) for (lo, hi), p in zip(crops, sym)]
    if any(lo or hi for lo, hi in rest):
        out = F.pad(out, [-c for lo, hi in reversed(rest) for c in (lo, hi)])
    osize = attrs.get("output_size") or []
    if osize:
        ends = []
        for i, want in enumerate(osize):
            have = out.shape[2 + i]
            if not have <= want < have + strides[i]:
                raise ValueError(
                    f"conv_transpose output_size[{i}]={want} invalid: "
                    f"must be in [{have}, {have + strides[i] - 1}]")
            ends.append(want - have)
        out = F.pad(out, [p for e in reversed(ends) for p in (0, e)])
    return out.to(x.dtype)


@register_op("conv3d", inputs=["Input", "Filter"], outputs=["Output"])
def conv3d(ins, attrs, ctx):
    return {"Output": conv_nd(ins["Input"], ins["Filter"], attrs, 3)}


@register_op("depthwise_conv2d", inputs=["Input", "Filter"],
             outputs=["Output"])
def depthwise_conv2d(ins, attrs, ctx):
    """groups = C_in, read from the layout (filter [C * mult, 1, kh, kw])."""
    x = ins["Input"]
    c_in = x.shape[1] if attrs.get("data_format", "NCHW") == "NCHW" \
        else x.shape[-1]
    return {"Output": conv_nd(x, ins["Filter"], attrs, 2, groups=c_in)}


@register_op("conv2d_transpose", inputs=["Input", "Filter"],
             outputs=["Output"])
def conv2d_transpose(ins, attrs, ctx):
    """NCHW whatever `data_format` says, as the reference (it calls
    `_conv_transpose_nd` directly; ROADMAP.md Queue 3)."""
    return {"Output": conv_transpose_nd(ins["Input"], ins["Filter"], attrs,
                                        2)}


@register_op("conv3d_transpose", inputs=["Input", "Filter"],
             outputs=["Output"])
def conv3d_transpose(ins, attrs, ctx):
    return {"Output": conv_nd(ins["Input"], ins["Filter"], attrs, 3,
                              transpose=True)}


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------
_POOL_FNS = {2: (F.max_pool2d, F.avg_pool2d), 3: (F.max_pool3d, F.avg_pool3d)}


def pool_forward(x, attrs, nd):
    """The reference's `_pool` over the last `nd` axes: max or avg (the
    count of real pixels in a window when `exclusive`, else the window
    size), global, adaptive in windows of in // out."""
    ptype = attrs.get("pooling_type", "max")
    ksize = list(attrs.get("ksize", [2] * nd))
    strides = list(attrs.get("strides", ksize))
    pads = attrs.get("paddings", [0] * nd)
    axes = tuple(range(-nd, 0))
    if attrs.get("global_pooling", False) or attrs.get("adaptive", False) \
            and all(k == 1 for k in ksize):
        if ptype == "max":
            return x.amax(dim=axes, keepdim=True)
        return x.mean(dim=axes, keepdim=True)
    if attrs.get("adaptive", False):
        ksize = [n // o for n, o in zip(x.shape[-nd:], ksize)]
        strides, pads = list(ksize), [0] * nd
    pads = _conv_padding(pads, attrs.get("padding_algorithm", "EXPLICIT"),
                         nd)
    if pads == "SAME":
        pads = _same_pads(x.shape[-nd:], ksize, strides)
    max_pool, avg_pool = _POOL_FNS[nd]
    if ptype != "max" and nd == 3 and x.device.type == "cpu" and \
            x.dtype in (torch.bfloat16, torch.float16):
        # ATen's CPU avg_pool3d has no half kernels: pool in fp32
        return pool_forward(x.float(), attrs, nd).to(x.dtype)
    # torch pads symmetrically by at most half a window; other pads are
    # an explicit F.pad (-inf for max, 0 for avg)
    implicit = all(lo == hi and 2 * lo <= k
                   for (lo, hi), k in zip(pads, ksize))
    if ptype == "max":
        if implicit:
            return max_pool(x, ksize, strides, [lo for lo, _ in pads])
        xp, _ = _pad_operand(x, pads, value=-math.inf)
        return max_pool(xp, ksize, strides)
    exclusive = attrs.get("exclusive", True)
    if implicit:
        return avg_pool(x, ksize, strides, [lo for lo, _ in pads],
                        count_include_pad=not exclusive)
    xp, _ = _pad_operand(x, pads)
    if not exclusive:
        return avg_pool(xp, ksize, strides)
    total = avg_pool(xp, ksize, strides, divisor_override=1)
    ones, _ = _pad_operand(x.new_ones((1, 1) + tuple(x.shape[-nd:])), pads)
    return total / avg_pool(ones, ksize, strides, divisor_override=1)


@register_op("pool2d", inputs=["X"], outputs=["Out"])
def pool2d(ins, attrs, ctx):
    return {"Out": pool_forward(ins["X"], attrs, 2)}


@register_op("pool3d", inputs=["X"], outputs=["Out"])
def pool3d(ins, attrs, ctx):
    return {"Out": pool_forward(ins["X"], attrs, 3)}


def window_argmax(x, ksize, strides, pads):
    """The flat index (over each unpadded [*spatial] volume) of every
    window's maximum, the smallest index on a tie: the JAX package's
    paired (value, index) reduce_window.  Padded cells never win."""
    nd = len(ksize)
    spatial = tuple(x.shape[-nd:])
    idx = torch.arange(math.prod(spatial), device=x.device).reshape(spatial)
    idx = idx.expand(x.shape)
    if any(lo or hi for lo, hi in pads):
        widths = [p for lo, hi in reversed(pads) for p in (lo, hi)]
        x = F.pad(x, widths, value=-math.inf)
        idx = F.pad(idx, widths, value=math.prod(spatial))
    for d, (k, s) in enumerate(zip(ksize, strides)):
        x = x.unfold(2 + d, k, s)
        idx = idx.unfold(2 + d, k, s)
    vals = x.reshape(x.shape[:2 + nd] + (-1,))
    idx = idx.reshape(vals.shape)
    best = vals.amax(dim=-1, keepdim=True)
    big = torch.full_like(idx, math.prod(spatial))
    return torch.where(vals == best, idx, big).amin(dim=-1)


@register_op("max_pool2d_with_index", inputs=["X"], outputs=["Out", "Mask"])
def max_pool2d_with_index(ins, attrs, ctx):
    """Out is the pool2d max (padded by `paddings`); Mask the argmax over
    the UNPADDED input, as the reference computes it (with nonzero
    paddings the two shapes differ, ROADMAP.md Queue 3)."""
    x = ins["X"]
    out = pool_forward(x, dict(attrs, pooling_type="max"), 2)
    ksize = list(attrs.get("ksize", [2, 2]))
    strides = list(attrs.get("strides", ksize))
    mask = window_argmax(x, ksize, strides, [(0, 0), (0, 0)])
    return {"Out": out, "Mask": mask}


@register_op("spp", inputs=["X"], outputs=["Out"])
def spp(ins, attrs, ctx):
    """Spatial pyramid pooling: level l pools to 2^l x 2^l bins (adaptive,
    windows of in // bins), flattened and concatenated."""
    x = ins["X"]
    ptype = attrs.get("pooling_type", "max")
    n = x.shape[0]
    outs = [pool_forward(x, {"pooling_type": ptype, "ksize": [2 ** l] * 2,
                             "adaptive": True}, 2).reshape(n, -1)
            for l in range(attrs.get("pyramid_height", 2))]
    return {"Out": torch.cat(outs, dim=1)}


@register_op("unpool", inputs=["X", "Indices!"], outputs=["Out"])
def unpool(ins, attrs, ctx):
    """X's values written at their flat Indices into zeros of
    `output_size` (default twice X's height and width)."""
    x, idx = ins["X"], ins["Indices"].long()
    n, c, h, w = x.shape
    oh, ow = attrs.get("output_size", [h * 2, w * 2])[-2:]
    out = x.new_zeros((n, c, oh * ow)).scatter(
        2, idx.reshape(n, c, -1), x.reshape(n, c, -1))
    return {"Out": out.reshape(n, c, oh, ow)}


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
        gx, gs, gb = torch.ops.aten.native_batch_norm_backward(
            gc, xc.to(cdt), scale.to(cdt), None, None, m.to(cdt),
            inv.to(cdt), True, eps, [True, True, True])
    else:
        # the running statistics are constants: dX = dY scale / sqrt(var
        # + eps).  Written out: CUDA's native_batch_norm_backward asserts
        # saved statistics even in inference form
        bs = (1, -1) + (1,) * (xc.dim() - 2)
        inv_std = torch.rsqrt(inv.to(cdt) + eps)
        xhat = (xc.to(cdt) - m.to(cdt).reshape(bs)) * inv_std.reshape(bs)
        dims = [0] + list(range(2, xc.dim()))
        gx = gc * (scale.to(cdt) * inv_std).reshape(bs)
        gs, gb = (gc * xhat).sum(dims), gc.sum(dims)
    return gx.movedim(1, caxis).to(x.dtype), gs.to(scale.dtype), \
        gb.to(scale.dtype)


class BatchNormFn(torch.autograd.Function):
    """batch_norm for autograd (the dygraph path and a to_static replay):
    Y and the statistics of `batch_norm_forward`, the gradient of
    `batch_norm_backward`; with `sync` those of `sync_batch_norm_forward`
    and `sync_batch_norm_backward` (both communicate)."""

    @staticmethod
    def forward(x, scale, bias, mean, var, attrs, sync):
        fwd = sync_batch_norm_forward if sync else batch_norm_forward
        outs = fwd({"X": x, "Scale": scale, "Bias": bias, "Mean": mean,
                    "Variance": var}, attrs, None)
        # with the running stats in use the stats are the inputs
        # themselves: autograd takes views of them, not the inputs
        return tuple(t.view_as(t) if t is mean or t is var else t
                     for t in (outs["Y"], outs["MeanOut"],
                               outs["VarianceOut"], outs["SavedMean"],
                               outs["SavedVariance"]))

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, _, mean, var, attrs, sync = inputs
        ctx.attrs, ctx.sync = attrs, sync
        ctx.train = not (_sbn_test if sync else _bn_global)(attrs, None)
        ctx.save_for_backward(x, scale, *((output[3], output[4])
                                          if ctx.train else (mean, var)))
        ctx.mark_non_differentiable(*output[1:])

    @staticmethod
    def backward(ctx, g, *_):
        x, scale, m, s = ctx.saved_tensors
        bwd = sync_batch_norm_backward if ctx.sync else batch_norm_backward
        gx, gs, gb = bwd(g, x, scale, m, s, ctx.train, ctx.attrs)
        return gx, gs, gb, None, None, None, None


def _bn_grad(sync):
    """The grad kernel of batch_norm (`sync` False) or sync_batch_norm:
    X, Scale and Bias gradients from Y@GRAD and the saved statistics (no
    replay of the forward, which would move the running stats' values it
    computes a second time, and could not differentiate sync_batch_norm's
    collectives; in training its backward allreduces the two sums the
    gradient needs)."""
    def grad(ins, attrs, ctx):
        g = ins.get("Y@GRAD")
        if g is None:
            return {}
        train = not (_sbn_test if sync else _bn_global)(attrs, ctx)
        m, s = ((ins["SavedMean"], ins["SavedVariance"]) if train else
                (ins["Mean"], ins["Variance"]))
        bwd = sync_batch_norm_backward if sync else batch_norm_backward
        gx, gs, gb = bwd(g, ins["X"], ins["Scale"], m, s, train, attrs)
        return {"X@GRAD": gx, "Scale@GRAD": gs, "Bias@GRAD": gb}
    return grad


@register_op("batch_norm",
             inputs=["X", "Scale", "Bias", "Mean", "Variance"],
             outputs=["Y", "MeanOut", "VarianceOut", "SavedMean",
                      "SavedVariance", "ReserveSpace?"],
             grad=_bn_grad(False))
def batch_norm(ins, attrs, ctx):
    # the dygraph Function, so that a to_static replay under autograd
    # backpropagates through batch_norm_backward; the executor's is_test
    # is folded into the attrs the Function reads
    a = dict(attrs, is_test=_bn_global(dict(attrs, use_global_stats=False),
                                       ctx))
    outs = BatchNormFn.apply(ins["X"], ins["Scale"], ins["Bias"],
                             ins["Mean"], ins["Variance"], a, False)
    return dict(zip(("Y", "MeanOut", "VarianceOut", "SavedMean",
                     "SavedVariance"), outs))


# ---------------------------------------------------------------------------
# sync_batch_norm
# ---------------------------------------------------------------------------
def _sbn_group(attrs):
    from .collective import ring_group
    return ring_group(attrs.get("ring_id", 0))


def _sbn_test(attrs, ctx):
    """sync_batch_norm reads `is_test` only, never `use_global_stats`
    (the JAX package's kernel; ROADMAP.md Queue 3)."""
    return bool(attrs.get("is_test", False) or (ctx is not None
                                                and ctx.is_test))


def _bshape(x, caxis):
    return tuple(x.shape[caxis] if i == caxis else 1 for i in range(x.dim()))


def sync_batch_norm_forward(ins, attrs, ctx):
    """The sync_batch_norm op's outputs: batch statistics from the sums
    s1 = sum x and s2 = sum x^2 and the count, allreduced over the ring's
    process group (the local values off a process group), the one-pass
    variance s2 / cnt - m^2, as the JAX package's kernel."""
    from .collective import all_reduce, world_of
    x = ins["X"]
    mean, var = ins["Mean"], ins["Variance"]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    caxis, _ = _bn_layout(x, attrs)
    axes = [i for i in range(x.dim()) if i != caxis]
    xf = x.to(_cdt(x))
    if _sbn_test(attrs, ctx):
        m, v = mean, var
        mean_out, var_out = mean, var
    else:
        group = _sbn_group(attrs)
        s1, s2 = xf.sum(dim=axes), (xf * xf).sum(dim=axes)
        cnt = float(math.prod(x.shape[i] for i in axes))
        if group is not None:
            s1 = all_reduce(s1, "sum", group)
            s2 = all_reduce(s2, "sum", group)
            cnt = cnt * world_of(group)
        m = s1 / cnt
        v = s2 / cnt - m * m
        mean_out = mean * momentum + m * (1 - momentum)
        var_out = var * momentum + v * (1 - momentum)
    inv = torch.rsqrt(v + eps)
    bs = _bshape(x, caxis)
    y = (xf - m.reshape(bs)) * inv.reshape(bs) * ins["Scale"].reshape(bs) \
        + ins["Bias"].reshape(bs)
    return {"Y": y.to(x.dtype), "MeanOut": mean_out, "VarianceOut": var_out,
            "SavedMean": m, "SavedVariance": inv}


def sync_batch_norm_backward(g, x, scale, m, inv, train, attrs):
    """(dX, dScale, dBias) at dY = `g`, as `batch_norm_backward`: `m` and
    `inv` the batch mean and inverse standard deviation when `train`,
    else the running mean and variance.  In training dX is the gradient
    of the ranks' summed losses: N the global count, sums of dY and dY
    xhat allreduced, dX = scale inv (dY - sum dY / N - xhat sum dY xhat /
    N); dScale and dBias are this rank's sums (the gradient allreduce
    adds the ranks').  With the running stats dX = dY scale inv."""
    from .collective import all_reduce, world_of
    if not train:
        inv = torch.rsqrt(inv + attrs.get("epsilon", 1e-5))
    caxis, _ = _bn_layout(x, attrs)
    axes = [i for i in range(x.dim()) if i != caxis]
    bs = _bshape(x, caxis)
    cdt = _cdt(x)
    gf, xf = g.to(cdt), x.to(cdt)
    xhat = (xf - m.reshape(bs).to(cdt)) * inv.reshape(bs).to(cdt)
    dbias = gf.sum(dim=axes)
    dscale = (gf * xhat).sum(dim=axes)
    k = scale.to(cdt) * inv.to(cdt)
    if not train:
        gx = gf * k.reshape(bs)
    else:
        group = _sbn_group(attrs)
        cnt = float(math.prod(x.shape[i] for i in axes))
        sb, ss = dbias, dscale
        if group is not None:
            sb = all_reduce(dbias, "sum", group)
            ss = all_reduce(dscale, "sum", group)
            cnt = cnt * world_of(group)
        gx = k.reshape(bs) * (gf - (sb / cnt).reshape(bs)
                              - xhat * (ss / cnt).reshape(bs))
    return gx.to(x.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype)


def _infer_sync_batch_norm(ins, attrs):
    """Build-time shapes without the collectives: Y as X, the statistics
    as the running ones ([C])."""
    x, mean = ins["X"], ins["Mean"]
    stat = torch.empty(mean.shape, dtype=_cdt(x), device="meta")
    return {"Y": torch.empty_like(x, device="meta"),
            "MeanOut": torch.empty_like(mean, device="meta"),
            "VarianceOut": torch.empty_like(mean, device="meta"),
            "SavedMean": stat, "SavedVariance": stat}


@register_op("sync_batch_norm",
             inputs=["X", "Scale", "Bias", "Mean", "Variance"],
             outputs=["Y", "MeanOut", "VarianceOut", "SavedMean",
                      "SavedVariance", "ReserveSpace?"],
             grad=_bn_grad(True),
             infer_shape=_infer_sync_batch_norm)
def sync_batch_norm(ins, attrs, ctx):
    a = dict(attrs, is_test=_sbn_test(attrs, ctx))
    outs = BatchNormFn.apply(ins["X"], ins["Scale"], ins["Bias"],
                             ins["Mean"], ins["Variance"], a, True)
    return dict(zip(("Y", "MeanOut", "VarianceOut", "SavedMean",
                     "SavedVariance"), outs))


# ---------------------------------------------------------------------------
# instance / group / local response / data / spectral norm
# ---------------------------------------------------------------------------
@register_op("instance_norm", inputs=["X", "Scale?", "Bias?"],
             outputs=["Y", "SavedMean", "SavedVariance"])
def instance_norm(ins, attrs, ctx):
    """Normalized over the spatial axes of each (n, c); SavedMean and
    SavedVariance are [N * C], the latter the inverse standard deviation."""
    x = ins["X"]
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(2, x.dim()))
    xf = x.to(_cdt(x))
    v, m = torch.var_mean(xf, dim=axes, unbiased=False, keepdim=True)
    inv = torch.rsqrt(v + eps)
    y = (xf - m) * inv
    bs = (1, x.shape[1]) + (1,) * (x.dim() - 2)
    if ins.get("Scale") is not None:
        y = y * ins["Scale"].reshape(bs)
    if ins.get("Bias") is not None:
        y = y + ins["Bias"].reshape(bs)
    n, c = x.shape[:2]
    return {"Y": y.to(x.dtype), "SavedMean": m.reshape(n * c),
            "SavedVariance": inv.reshape(n * c)}


@register_op("group_norm", inputs=["X", "Scale?", "Bias?"],
             outputs=["Y", "Mean", "Variance"])
def group_norm(ins, attrs, ctx):
    """Normalized over each group of C / groups channels and the spatial
    axes (NCHW; `data_layout` is not read, as in the reference); Mean and
    Variance are [N, groups]."""
    x = ins["X"]
    g = attrs.get("groups", 1)
    eps = attrs.get("epsilon", 1e-5)
    n, c = x.shape[:2]
    xf = x.to(_cdt(x)).reshape((n, g, c // g) + tuple(x.shape[2:]))
    v, m = torch.var_mean(xf, dim=tuple(range(2, xf.dim())),
                          unbiased=False, keepdim=True)
    y = ((xf - m) * torch.rsqrt(v + eps)).reshape(x.shape)
    bs = (1, c) + (1,) * (x.dim() - 2)
    if ins.get("Scale") is not None:
        y = y * ins["Scale"].reshape(bs)
    if ins.get("Bias") is not None:
        y = y + ins["Bias"].reshape(bs)
    return {"Y": y.to(x.dtype), "Mean": m.reshape(n, g),
            "Variance": v.reshape(n, g)}


@register_op("lrn", inputs=["X"], outputs=["Out", "MidOut"])
def lrn(ins, attrs, ctx):
    """Out = X / (k + alpha * sum of squares over `n` channels)^beta."""
    x = ins["X"]
    n_size = attrs.get("n", 5)
    half = n_size // 2
    sq = F.pad(torch.square(x), [0, 0, 0, 0, half, half])
    acc = sum(sq[:, i:i + x.shape[1]] for i in range(n_size))
    mid = attrs.get("k", 1.0) + attrs.get("alpha", 1e-4) * acc
    return {"Out": x / torch.pow(mid, attrs.get("beta", 0.75)),
            "MidOut": mid}


@register_op("data_norm", inputs=["X", "BatchSize", "BatchSum",
                                  "BatchSquareSum", "scale_w?", "bias?"],
             outputs=["Y", "Means", "Scales"])
def data_norm(ins, attrs, ctx):
    """(X - BatchSum / BatchSize) * sqrt(BatchSize / BatchSquareSum), the
    per-channel statistics broadcast along the layout's channel axis."""
    x = ins["X"]
    bsize = ins["BatchSize"]
    means = ins["BatchSum"] / bsize
    scales = torch.sqrt(bsize / ins["BatchSquareSum"])
    layout = attrs.get("data_layout", "NCHW")
    caxis = x.dim() - 1 if (layout == "NHWC" or x.dim() <= 2) else 1
    bs = [1] * x.dim()
    bs[caxis] = means.shape[0]
    y = (x - means.reshape(bs)) * scales.reshape(bs)
    if ins.get("scale_w") is not None:
        y = y * ins["scale_w"].reshape(bs)
    if ins.get("bias") is not None:
        y = y + ins["bias"].reshape(bs)
    return {"Y": y, "Means": means, "Scales": scales}


@register_op("spectral_norm", inputs=["Weight", "U", "V"], outputs=["Out"])
def spectral_norm(ins, attrs, ctx):
    """Weight / sigma, sigma from `power_iters` power iterations on U, V
    (differentiated through, as the reference's vjp)."""
    w, u, v = ins["Weight"], ins["U"], ins["V"]
    dim = attrs.get("dim", 0)
    eps = attrs.get("eps", 1e-12)
    w_mat = w.movedim(dim, 0).reshape(w.shape[dim], -1)
    for _ in range(attrs.get("power_iters", 1)):
        v = w_mat.t() @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = w_mat @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    return {"Out": w / (u @ w_mat @ v)}


# ---------------------------------------------------------------------------
# embedding and rearrangements
# ---------------------------------------------------------------------------
@register_op("embedding", inputs=["W", "Ids!"], outputs=["Out"],
             grad=_lookup_table_grad(squeeze_trailing=False))
def embedding(ins, attrs, ctx):
    return {"Out": _embedding(ins["W"], ins["Ids"], attrs)}


@register_op("add_position_encoding", inputs=["X"], outputs=["Out"])
def add_position_encoding(ins, attrs, ctx):
    """alpha X + beta enc, enc[:, 2i] = sin(pos 10000^(-2i/d)) and
    enc[:, 2i + 1] the cos (interleaved; an odd d truncated)."""
    x = ins["X"]
    _, seq, d = x.shape
    pos = torch.arange(seq, dtype=torch.float32,
                       device=x.device)[:, None]
    i = torch.arange((d + 1) // 2, dtype=torch.float32,
                     device=x.device)[None, :]
    freq = torch.pow(torch.tensor(10000.0, device=x.device), -2.0 * i / d)
    enc = torch.stack([torch.sin(pos * freq), torch.cos(pos * freq)],
                      dim=-1).reshape(seq, -1)[:, :d]
    return {"Out": attrs.get("alpha", 1.0) * x
            + attrs.get("beta", 1.0) * enc[None].to(x.dtype)}


@register_op("pixel_shuffle", inputs=["X"], outputs=["Out"])
def pixel_shuffle(ins, attrs, ctx):
    x = ins["X"]
    r = attrs.get("upscale_factor", 1)
    n, c, h, w = x.shape
    x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return {"Out": x.reshape(n, c // (r * r), h * r, w * r)}


@register_op("space_to_depth", inputs=["X"], outputs=["Out"])
def space_to_depth(ins, attrs, ctx):
    x = ins["X"]
    bs = attrs["blocksize"]
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // bs, bs, w // bs, bs).permute(0, 3, 5, 1, 2, 4)
    return {"Out": x.reshape(n, c * bs * bs, h // bs, w // bs)}


@register_op("temporal_shift", inputs=["X"], outputs=["Out"])
def temporal_shift(ins, attrs, ctx):
    """Of each segment of `seg_num` frames, the first C ratio channels
    shift one frame back, the next C ratio one frame on (zeros enter)."""
    x = ins["X"]
    seg = attrs["seg_num"]
    ratio = attrs.get("shift_ratio", 0.25)
    nt, c, h, w = x.shape
    x = x.reshape(nt // seg, seg, c, h, w)
    c1, c2 = int(c * ratio), int(c * 2 * ratio)
    pad = F.pad(x, [0, 0, 0, 0, 0, 0, 1, 1])
    out = torch.cat([pad[:, :-2, :c1], pad[:, 2:, c1:c2], x[:, :, c2:]],
                    dim=2)
    return {"Out": out.reshape(nt, c, h, w)}


@register_op("shuffle_channel", inputs=["X"], outputs=["Out"])
def shuffle_channel(ins, attrs, ctx):
    x = ins["X"]
    g = attrs.get("group", 1)
    n, c, h, w = x.shape
    return {"Out": x.reshape(n, g, c // g, h, w).transpose(1, 2)
            .reshape(x.shape)}
