"""Tensor manipulation ops: reshape2, transpose2, flatten_contiguous_range,
gather, fill_constant, cast, one_hot_v2, where, fill_zeros_like, assign,
fill_any_like, and the ops of the paddle.tensor functions (squeeze2 to
meshgrid, paddle_tpu/ops/kernels/manip.py:44-598: the shape ops, split /
stack / unbind, gather_nd / scatter, the index ops, expand / tile / flip /
roll, the creation ops eye / linspace / range, arg_max / argsort /
top_k_v2 / unique, shape / size, diag).
Counterparts of paddle_tpu/ops/kernels/manip.py.

transpose2 returns a strided view (no copy); the flash kernel reads the
[B, H, S, D] view through its strides, and the reshape that follows the
attention copies only where the layout demands it.

Orders the JAX package's kernels pin, where a CUDA library gives none:
  * top_k_v2 is `jax.lax.top_k`: XLA's total order (+NaN above +inf,
    -NaN below -inf, +0 above -0), ties to the lower index, the `sorted`
    attr ignored.  It sorts integer keys of that order with a stable
    sort (torch.topk pins no tie order on the card);
  * argsort is `jnp.argsort(-x if descending else x)`: stable, every NaN
    last whatever its sign, -0 equal to +0, the negation literal (it
    sorts total-order keys of the NaNs and zeros made canonical);
  * arg_max / arg_min return the first extreme, a NaN counting as both;
  * unique's `Indices` are the first occurrences, NaNs one value (numpy's
    `equal_nan`).
Data-dependent shapes (`DYNAMIC_SHAPE_OPS`: masked_select, where_index,
unique) leave their outputs' shapes unset at build time, as the JAX
package's static build does, and a program holding one runs its
`run_steps` eagerly, one `run` a step (no CUDA graph holds a host-read
shape)."""
from __future__ import annotations

import math

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


_PAD_MODES = {"constant": "constant", "reflect": "reflect",
              "edge": "replicate", "replicate": "replicate",
              "circular": "circular"}


def _pad_nd(x, widths, mode, value):
    """F.pad of `x` by `widths` (torch order: the last axis first)."""
    if mode == "constant":
        return torch.nn.functional.pad(x, widths, value=float(value))
    return torch.nn.functional.pad(x, widths, mode=_PAD_MODES[mode])


@register_op("pad2d", inputs=["X"], outputs=["Out"])
def pad2d(ins, attrs, ctx):
    """`paddings` [top, bottom, left, right] of H and W (NCHW or NHWC);
    `mode` constant (`pad_value`), reflect or edge."""
    x = ins["X"]
    p = [int(v) for v in attrs["paddings"]]
    mode = attrs.get("mode", "constant")
    nhwc = attrs.get("data_format", "NCHW") != "NCHW"
    if nhwc:
        x = x.movedim(-1, 1)
    out = _pad_nd(x, [p[2], p[3], p[0], p[1]], mode,
                  attrs.get("pad_value", 0.0))
    return {"Out": out.movedim(1, -1) if nhwc else out}


@register_op("pad3d", inputs=["X"], outputs=["Out"])
def pad3d(ins, attrs, ctx):
    """`paddings` [left, right, top, bottom, front, back] of W, H and D
    (NCDHW; `data_format` is not read); `mode` constant (`value`),
    reflect, replicate or circular."""
    p = [int(v) for v in attrs["paddings"]]
    return {"Out": _pad_nd(ins["X"], p, attrs.get("mode", "constant"),
                           attrs.get("value", 0.0))}


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


# ---------------------------------------------------------------------------
# the ops of the paddle.tensor functions
# ---------------------------------------------------------------------------
# ops whose output shapes depend on the data
DYNAMIC_SHAPE_OPS = frozenset(("masked_select", "where_index", "unique"))


def _unset_shapes(ins, attrs):
    """Build-time shapes of a data-dependent op: none, as the JAX
    package's static build leaves them."""
    return {}


def _infer_like(slot_in, slot_out="Out", dtype=None):
    def infer(ins, attrs):
        x = ins[slot_in]
        return {slot_out: torch.empty(tuple(x.shape), dtype=dtype or x.dtype,
                                      device="meta")}
    return infer


def _squeeze(x, axes):
    if not axes:
        axes = [i for i, s in enumerate(x.shape) if s == 1]
    axes = tuple(a % x.dim() for a in axes if x.shape[a % x.dim()] == 1)
    return x.squeeze(axes) if axes else x


@register_op("squeeze2", inputs=["X"], outputs=["Out", "XShape"])
def squeeze2(ins, attrs, ctx):
    x = ins["X"]
    return {"Out": _squeeze(x, attrs.get("axes", [])), "XShape": _xshape(x)}


@register_op("unsqueeze2", inputs=["X"], outputs=["Out", "XShape"])
def unsqueeze2(ins, attrs, ctx):
    x = ins["X"]
    out = x
    for a in sorted(attrs.get("axes", [])):
        out = out.unsqueeze(a)
    return {"Out": out, "XShape": _xshape(x)}


@register_op("split", inputs=["X"], outputs=["Out*"])
def split(ins, attrs, ctx):
    x = ins["X"]
    axis = attrs.get("axis", 0)
    sections = list(attrs.get("sections", []))
    if sections:
        if -1 in sections:
            known = sum(s for s in sections if s != -1)
            sections[sections.index(-1)] = x.shape[axis] - known
        return {"Out": list(torch.split(x, sections, dim=axis))}
    num = attrs.get("num", 0)
    return {"Out": list(torch.split(x, x.shape[axis] // num, dim=axis))}


@register_op("stack", inputs=["X*"], outputs=["Y"])
def stack(ins, attrs, ctx):
    return {"Y": torch.stack(list(ins["X"]), dim=attrs.get("axis", 0))}


@register_op("unstack", inputs=["X"], outputs=["Y*"])
def unstack(ins, attrs, ctx):
    return {"Y": list(torch.unbind(ins["X"], dim=attrs.get("axis", 0)))}


@register_op("unbind", inputs=["X"], outputs=["Out*"])
def unbind(ins, attrs, ctx):
    return {"Out": list(torch.unbind(ins["X"], dim=attrs.get("axis", 0)))}


def _index_tuple(idx):
    idx = idx.long()
    return tuple(idx[..., i] for i in range(idx.shape[-1]))


@register_op("gather_nd", inputs=["X", "Index!"], outputs=["Out"])
def gather_nd(ins, attrs, ctx):
    """x[index[..., 0], ..., index[..., k-1]]: the leading k dims picked
    by the rows of the last axis of Index."""
    return {"Out": ins["X"][_index_tuple(ins["Index"])]}


@register_op("scatter", inputs=["X", "Ids!", "Updates"], outputs=["Out"])
def scatter(ins, attrs, ctx):
    """Rows Ids of X set to (overwrite) or added by Updates."""
    ids = ins["Ids"].long().reshape(-1)
    return {"Out": ins["X"].index_put(
        (ids,), ins["Updates"],
        accumulate=not attrs.get("overwrite", True))}


@register_op("scatter_nd_add", inputs=["X", "Index!", "Updates"],
             outputs=["Out"])
def scatter_nd_add(ins, attrs, ctx):
    return {"Out": ins["X"].index_put(_index_tuple(ins["Index"]),
                                      ins["Updates"], accumulate=True)}


@register_op("strided_slice", inputs=["Input"], outputs=["Out"])
def strided_slice(ins, attrs, ctx):
    """Python slicing start:end:stride along each of `axes` (a negative
    stride walks backwards, through an index list: torch slices forwards
    only); `decrease_axis` drops those dims."""
    x = ins["Input"]
    out = x
    for a, s, e, st in zip(attrs["axes"], attrs["starts"], attrs["ends"],
                           attrs["strides"]):
        a = a % x.dim()
        if st > 0:
            sl = [slice(None)] * x.dim()
            sl[a] = slice(s, e, st)
            out = out[tuple(sl)]
        else:
            keep = list(range(x.shape[a]))[slice(s, e, st)]
            out = out.index_select(a, torch.tensor(keep, dtype=torch.long,
                                                   device=x.device))
    for a in sorted(attrs.get("decrease_axis", []), reverse=True):
        out = out.squeeze(a)
    return {"Out": out}


def _take(x, idx, axis):
    """jnp.take(x, idx, axis): the index's shape in place of the axis."""
    axis = axis % x.dim()
    idx = idx.long()
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                       + tuple(x.shape[axis + 1:]))


@register_op("index_select", inputs=["X", "Index!"], outputs=["Out"])
def index_select(ins, attrs, ctx):
    return {"Out": _take(ins["X"], ins["Index"], attrs.get("dim", 0))}


@register_op("index_sample", inputs=["X", "Index!"], outputs=["Out"])
def index_sample(ins, attrs, ctx):
    return {"Out": torch.gather(ins["X"], 1, ins["Index"].long())}


@register_op("masked_select", inputs=["X", "Mask!"], outputs=["Y"],
             infer_shape=_unset_shapes)
def masked_select(ins, attrs, ctx):
    return {"Y": torch.masked_select(ins["X"], ins["Mask"].bool())}


@register_op("where_index", inputs=["Condition!"], outputs=["Out"], grad=None,
             infer_shape=_unset_shapes)
def where_index(ins, attrs, ctx):
    """[N, rank] int64 coordinates of the nonzero elements, row-major."""
    return {"Out": torch.nonzero(ins["Condition"]).to(torch.int64)}


@register_op("expand_v2", inputs=["X"], outputs=["Out"])
def expand_v2(ins, attrs, ctx):
    x = ins["X"]
    shape = list(attrs["shape"])
    if len(shape) > x.dim():
        x = x.reshape((1,) * (len(shape) - x.dim()) + tuple(x.shape))
    shape = [x.shape[i] if s == -1 else s for i, s in enumerate(shape)]
    return {"Out": x.expand(tuple(shape))}


@register_op("expand_as_v2", inputs=["X", "Y?!"], outputs=["Out"])
def expand_as_v2(ins, attrs, ctx):
    shape = attrs.get("target_shape")
    if shape is None:
        shape = ins["Y"].shape
    return {"Out": ins["X"].expand(tuple(shape))}


@register_op("tile", inputs=["X"], outputs=["Out"])
def tile(ins, attrs, ctx):
    return {"Out": torch.tile(ins["X"], tuple(attrs["repeat_times"]))}


@register_op("flip", inputs=["X"], outputs=["Out"])
def flip(ins, attrs, ctx):
    return {"Out": torch.flip(ins["X"], tuple(attrs["axis"]))}


@register_op("reverse", inputs=["X"], outputs=["Out"])
def reverse(ins, attrs, ctx):
    return {"Out": torch.flip(ins["X"], tuple(attrs["axis"]))}


@register_op("roll", inputs=["X"], outputs=["Out"])
def roll(ins, attrs, ctx):
    x = ins["X"]
    shifts = attrs["shifts"]
    axis = attrs.get("axis", attrs.get("dims", None))
    if axis is None or (isinstance(axis, (list, tuple)) and not axis):
        s = shifts[0] if isinstance(shifts, (list, tuple)) else shifts
        return {"Out": torch.roll(x.reshape(-1), int(s)).reshape(x.shape)}
    return {"Out": torch.roll(x, tuple(shifts), tuple(axis))}


@register_op("assign_value", inputs=[], outputs=["Out"], grad=None)
def assign_value(ins, attrs, ctx):
    values = attrs.get("fp32_values") or attrs.get("int32_values") \
        or attrs.get("int64_values") or attrs.get("values")
    return {"Out": torch.tensor(
        values, dtype=torch_dtype(attrs.get("dtype", "float32")),
        device=ctx.device).reshape(tuple(attrs["shape"]))}


def _infer_eye(ins, attrs):
    rows = attrs["num_rows"]
    cols = attrs.get("num_columns", -1)
    cols = rows if cols in (None, -1) else cols
    return {"Out": torch.empty((rows, cols), device="meta",
                               dtype=torch_dtype(attrs.get("dtype",
                                                           "float32")))}


@register_op("eye", inputs=[], outputs=["Out"], grad=None,
             infer_shape=_infer_eye)
def eye(ins, attrs, ctx):
    rows = attrs["num_rows"]
    cols = attrs.get("num_columns", -1)
    cols = rows if cols in (None, -1) else cols
    return {"Out": torch.eye(rows, cols, device=ctx.device,
                             dtype=torch_dtype(attrs.get("dtype",
                                                         "float32")))}


def _linspace(start, stop, num, dtype, device):
    """jnp.linspace: start + i (stop - start) / (num - 1), the last point
    stop exactly, computed in float64 and rounded once to `dtype`."""
    if num == 1:
        return torch.tensor([start], dtype=torch.float64,
                            device=device).to(dtype)
    i = torch.arange(num, dtype=torch.float64, device=device)
    out = start + i * ((stop - start) / (num - 1))
    out[-1] = stop
    return out.to(dtype)


def _infer_linspace(ins, attrs):
    if ins.get("Num") is not None:
        return {}
    return {"Out": torch.empty((int(attrs["num"]),), device="meta",
                               dtype=torch_dtype(attrs.get("dtype",
                                                           "float32")))}


@register_op("linspace", inputs=["Start?!", "Stop?!", "Num?!"],
             outputs=["Out"], grad=None, infer_shape=_infer_linspace)
def linspace(ins, attrs, ctx):
    if ins.get("Num") is not None:
        start = ins["Start"]
        return {"Out": _linspace(float(start.reshape(())),
                                 float(ins["Stop"].reshape(())),
                                 int(ins["Num"].reshape(())), start.dtype,
                                 start.device)}
    return {"Out": _linspace(float(attrs["start"]), float(attrs["stop"]),
                             int(attrs["num"]),
                             torch_dtype(attrs.get("dtype", "float32")),
                             ctx.device)}


def _infer_range(ins, attrs):
    if ins.get("Start") is not None:
        return {}
    n = max(int(math.ceil((attrs["end"] - attrs["start"]) / attrs["step"])),
            0)
    return {"Out": torch.empty((n,), device="meta",
                               dtype=torch_dtype(attrs.get("dtype",
                                                           "int64")))}


@register_op("range", inputs=["Start?!", "End?!", "Step?!"], outputs=["Out"],
             grad=None, infer_shape=_infer_range)
def range_op(ins, attrs, ctx):
    """arange(start, end, step) from attrs (paddle.arange) or from input
    tensors read on the host (fluid's range)."""
    if ins.get("Start") is not None:
        s, e, st = (ins[k].reshape(()).item() for k in ("Start", "End",
                                                         "Step"))
        return {"Out": torch.arange(s, e, st, dtype=ins["Start"].dtype,
                                    device=ins["Start"].device)}
    return {"Out": torch.arange(attrs["start"], attrs["end"], attrs["step"],
                                dtype=torch_dtype(attrs.get("dtype",
                                                            "int64")),
                                device=ctx.device)}


def _arg_extreme(fn):
    def kernel(ins, attrs, ctx):
        x = ins["X"]
        keep = attrs.get("keepdims", False)
        if attrs.get("flatten"):
            out = fn(x.reshape(-1), dim=0, keepdim=keep)
        else:
            out = fn(x, dim=attrs.get("axis", -1), keepdim=keep)
        return {"Out": out.to(torch_dtype(attrs.get("dtype", "int64")))}
    return kernel


register_op("arg_max", inputs=["X!"], outputs=["Out"], grad=None)(
    _arg_extreme(torch.argmax))
register_op("arg_min", inputs=["X!"], outputs=["Out"], grad=None)(
    _arg_extreme(torch.argmin))


@register_op("argsort", inputs=["X"], outputs=["Out", "Indices"])
def argsort(ins, attrs, ctx):
    x = ins["X"]
    axis = attrs.get("axis", -1)
    key = x.detach()
    if attrs.get("descending", False):
        key = -key
    if key.is_floating_point():
        # one +NaN and one zero: the card's sort orders NaNs by their sign
        # bit and -0 below +0, numpy's every NaN last and the zeros equal
        key = total_order_key(torch.where(
            torch.isnan(key), torch.full((), float("nan"), dtype=key.dtype,
                                         device=key.device), key + 0.0))
    idx = torch.sort(key, dim=axis, stable=True).indices
    return {"Out": torch.take_along_dim(x, idx, dim=axis),
            "Indices": idx.to(torch.int64)}


_INT_VIEW = {torch.float32: torch.int32, torch.float64: torch.int64,
             torch.bfloat16: torch.int16, torch.float16: torch.int16}


def total_order_key(x, negate=False):
    """Integer keys ordered as XLA compares floats (+NaN above +inf, -NaN
    below -inf, -0 below +0): the bits, the magnitude bits flipped for a
    set sign bit.  `negate` keys -x, its sign bit flipped in the integer
    view (a float negation on the card does not flip a NaN's sign).
    Integers are their own keys."""
    it = _INT_VIEW.get(x.dtype)
    if it is None:
        return -x if negate else x
    bits = x.contiguous().view(it)
    info = torch.iinfo(it)
    if negate:
        bits = bits ^ torch.tensor(info.min, dtype=it, device=x.device)
    flip = torch.tensor(info.max, dtype=it, device=x.device)
    return torch.where(bits < 0, bits ^ flip, bits)


@register_op("top_k_v2", inputs=["X", "K?!"], outputs=["Out", "Indices"])
def top_k_v2(ins, attrs, ctx):
    """jax.lax.top_k along `axis` (of -x when not `largest`): a stable
    descending sort of total-order keys, the first k."""
    x = ins["X"]
    k = attrs.get("k", 1)
    if ins.get("K") is not None:
        k = int(ins["K"].reshape(()).item())
    axis = attrs.get("axis", -1)
    xm = torch.movedim(x, axis, -1)
    key = total_order_key(xm.detach(),
                          negate=not attrs.get("largest", True))
    idx = torch.sort(key, dim=-1, descending=True,
                     stable=True).indices[..., :k]
    vals = torch.take_along_dim(xm, idx, dim=-1)
    return {"Out": torch.movedim(vals, -1, axis),
            "Indices": torch.movedim(idx, -1, axis).to(torch.int64)}


def _unique(x):
    """jnp.unique of the flattened x: sorted values, first-occurrence
    positions, the inverse map (x's shape) and counts; NaNs count as one
    value, after every other."""
    flat = x.reshape(-1)
    if flat.is_floating_point():
        flat = flat + 0.0  # -0 and +0 one value, +0, on every device
    n = flat.numel()
    nan = torch.isnan(flat) if flat.is_floating_point() else None
    if nan is not None and bool(nan.any()):
        vals, inv, cnt = torch.unique(flat[~nan], sorted=True,
                                      return_inverse=True,
                                      return_counts=True)
        full_inv = torch.full((n,), vals.numel(), dtype=torch.int64,
                              device=flat.device)
        full_inv[~nan] = inv
        vals = torch.cat([vals, flat[nan][:1]])
        cnt = torch.cat([cnt, nan.sum().reshape(1)])
        inv = full_inv
    else:
        vals, inv, cnt = torch.unique(flat, sorted=True, return_inverse=True,
                                      return_counts=True)
    pos = torch.arange(n, device=flat.device)
    first = torch.full((vals.numel(),), n, dtype=torch.int64,
                       device=flat.device).scatter_reduce(
        0, inv, pos, "amin")
    return vals, first, inv.reshape(x.shape), cnt


@register_op("unique", inputs=["X!"],
             outputs=["Out", "Indices", "Index", "Counts"], grad=None,
             infer_shape=_unset_shapes)
def unique(ins, attrs, ctx):
    out, first, inv, cnt = _unique(ins["X"])
    dt = torch_dtype(attrs.get("dtype", "int64"))
    return {"Out": out, "Indices": first.to(dt), "Index": inv.to(dt),
            "Counts": cnt.to(dt)}


@register_op("shape", inputs=["Input!"], outputs=["Out"], grad=None)
def shape(ins, attrs, ctx):
    x = ins["Input"]
    return {"Out": torch.tensor(tuple(x.shape), dtype=torch.int32,
                                device=ctx.device if x.is_meta
                                else x.device)}


@register_op("size", inputs=["Input!"], outputs=["Out"], grad=None)
def size(ins, attrs, ctx):
    x = ins["Input"]
    return {"Out": torch.tensor(x.numel(), dtype=torch.int64,
                                device=ctx.device if x.is_meta
                                else x.device)}


@register_op("is_empty", inputs=["X!"], outputs=["Out"], grad=None)
def is_empty(ins, attrs, ctx):
    x = ins["X"]
    return {"Out": torch.tensor(x.numel() == 0,
                                device=ctx.device if x.is_meta
                                else x.device)}


@register_op("diag_v2", inputs=["X"], outputs=["Out"])
def diag_v2(ins, attrs, ctx):
    """jnp.diag: a vector to a matrix (off-diagonal `padding_value`), a
    matrix to its `offset` diagonal."""
    x = ins["X"]
    offset = attrs.get("offset", 0)
    out = torch.diag(x, offset)
    pv = attrs.get("padding_value", 0.0)
    if x.dim() == 1 and pv != 0:
        mask = torch.diag(torch.ones(x.shape[0], dtype=torch.bool,
                                     device=x.device), offset)
        out = torch.where(mask, out, torch.full((), pv, dtype=x.dtype,
                                                device=x.device))
    return {"Out": out}


@register_op("diag_embed", inputs=["Input"], outputs=["Out"])
def diag_embed(ins, attrs, ctx):
    """The last axis as the `offset` diagonal of new trailing [n, n]
    matrices (the JAX package's kernel uses the last two dims whatever
    dim1 / dim2 say)."""
    return {"Out": torch.diag_embed(ins["Input"], attrs.get("offset", 0),
                                    -2, -1)}


@register_op("meshgrid", inputs=["X*"], outputs=["Out*"])
def meshgrid(ins, attrs, ctx):
    return {"Out": list(torch.meshgrid(*ins["X"], indexing="ij"))}


@register_op("multiplex", inputs=["Ids!", "X*"], outputs=["Out"])
def multiplex(ins, attrs, ctx):
    """Row i of the output is row i of X[Ids[i]]."""
    ids = ins["Ids"].long().reshape(-1)
    stacked = torch.stack(list(ins["X"]), dim=0)
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return {"Out": stacked[ids, rows]}


@register_op("shard_index", inputs=["X!"], outputs=["Out"], grad=None)
def shard_index(ins, attrs, ctx):
    x = ins["X"]
    size = (attrs["index_num"] + attrs["nshards"] - 1) // attrs["nshards"]
    in_shard = torch.div(x, size, rounding_mode="floor") == attrs["shard_id"]
    return {"Out": torch.where(in_shard, torch.remainder(x, size),
                               torch.full((), attrs.get("ignore_value", -1),
                                          dtype=x.dtype, device=x.device))}
