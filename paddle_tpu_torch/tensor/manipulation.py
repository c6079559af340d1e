"""paddle.tensor manipulation functions (dual-mode; counterpart of
paddle_tpu/tensor/manipulation.py, the same names and ops).  Each
dispatches the JAX package's op through tensor/_dispatch.py; `flatten`
keeps the dygraph slices' eager path (the AMP cast of
`flatten_contiguous_range`, gray: no cast, then torch.flatten)."""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtype import convert_dtype
from ..dygraph.tracer import amp_inputs, recording
from ._dispatch import dispatch, is_eager

__all__ = [
    "reshape", "transpose", "concat", "split", "stack", "unstack", "squeeze",
    "unsqueeze", "flatten", "cast", "slice", "gather", "gather_nd", "scatter",
    "scatter_nd_add", "expand", "expand_as", "tile", "flip", "roll", "unique",
    "unbind", "chunk", "broadcast_to", "strided_slice", "index_select",
    "index_sample", "masked_select", "shard_index", "reverse", "t",
]


def _axes_list(a):
    return [a] if np.isscalar(a) else list(a)


def reshape(x, shape, name=None):
    return dispatch("reshape2", {"X": x}, {"shape": list(shape)}, name=name)


def transpose(x, perm, name=None):
    return dispatch("transpose2", {"X": x}, {"axis": list(perm)}, name=name)


def t(input, name=None):
    nd = len(input.shape)
    if nd <= 1:
        return dispatch("assign", {"X": input}, name=name)
    if nd != 2:
        raise ValueError("paddle.t expects a tensor of rank <= 2")
    return transpose(input, [1, 0], name)


def concat(x, axis=0, name=None):
    if hasattr(axis, "numpy"):
        axis = int(axis.numpy())
    return dispatch("concat", {"X": list(x)}, {"axis": int(axis)}, name=name)


def split(x, num_or_sections, axis=0, name=None):
    attrs = {"axis": int(axis)}
    if np.isscalar(num_or_sections):
        attrs["num"] = n = int(num_or_sections)
        attrs["sections"] = []
    else:
        attrs["num"] = 0
        attrs["sections"] = list(num_or_sections)
        n = len(attrs["sections"])
    return dispatch("split", {"X": x}, attrs, ["Out"], name=name,
                    out_counts={"Out": n})


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis, name)


def stack(x, axis=0, name=None):
    return dispatch("stack", {"X": list(x)}, {"axis": int(axis)}, ["Y"],
                    name=name)


def unstack(x, axis=0, num=None, name=None):
    n = num if num is not None else x.shape[axis]
    return dispatch("unstack", {"X": x},
                    {"axis": int(axis), "num": int(n)}, ["Y"], name=name,
                    out_counts={"Y": n})


def unbind(input, axis=0, name=None):
    return dispatch("unbind", {"X": input}, {"axis": int(axis)}, ["Out"],
                    name=name, out_counts={"Out": input.shape[axis]})


def squeeze(x, axis=None, name=None):
    axes = [] if axis is None else _axes_list(axis)
    return dispatch("squeeze2", {"X": x}, {"axes": axes}, name=name)


def unsqueeze(x, axis, name=None):
    return dispatch("unsqueeze2", {"X": x}, {"axes": _axes_list(axis)},
                    name=name)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    if recording() or not is_eager({"X": x}):
        return dispatch("flatten_contiguous_range", {"X": x},
                        {"start_axis": start_axis, "stop_axis": stop_axis},
                        name=name)
    (x,) = amp_inputs("flatten_contiguous_range", x)
    return torch.flatten(x, start_axis, stop_axis)


def cast(x, dtype):
    return dispatch("cast", {"X": x}, {"out_dtype": convert_dtype(dtype)})


def slice(input, axes, starts, ends, name=None):
    return dispatch("slice", {"Input": input},
                    {"axes": list(axes), "starts": list(starts),
                     "ends": list(ends)}, name=name)


def strided_slice(x, axes, starts, ends, strides, name=None):
    return dispatch("strided_slice", {"Input": x},
                    {"axes": list(axes), "starts": list(starts),
                     "ends": list(ends), "strides": list(strides)},
                    name=name)


def gather(x, index, axis=None, name=None):
    return dispatch("gather", {"X": x, "Index": index},
                    {"axis": 0 if axis is None else int(axis)}, name=name)


def gather_nd(x, index, name=None):
    return dispatch("gather_nd", {"X": x, "Index": index}, name=name)


def scatter(x, index, updates, overwrite=True, name=None):
    return dispatch("scatter", {"X": x, "Ids": index, "Updates": updates},
                    {"overwrite": bool(overwrite)}, name=name)


def scatter_nd_add(x, index, updates, name=None):
    return dispatch("scatter_nd_add",
                    {"X": x, "Index": index, "Updates": updates}, name=name)


def expand(x, shape, name=None):
    return dispatch("expand_v2", {"X": x}, {"shape": list(shape)}, name=name)


broadcast_to = expand


def expand_as(x, y, name=None):
    return dispatch("expand_as_v2", {"X": x, "Y": y},
                    {"target_shape": list(y.shape)}, name=name)


def tile(x, repeat_times, name=None):
    return dispatch("tile", {"X": x},
                    {"repeat_times": list(repeat_times)}, name=name)


def flip(x, axis, name=None):
    return dispatch("flip", {"X": x}, {"axis": _axes_list(axis)}, name=name)


def reverse(x, axis, name=None):
    return dispatch("reverse", {"X": x}, {"axis": _axes_list(axis)},
                    name=name)


def roll(x, shifts, axis=None, name=None):
    attrs = {"shifts": _axes_list(shifts)}
    attrs["axis"] = [] if axis is None else _axes_list(axis)
    return dispatch("roll", {"X": x}, attrs, name=name)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    outs = dispatch("unique", {"X": x},
                    {"return_index": return_index,
                     "return_inverse": return_inverse,
                     "return_counts": return_counts,
                     "dtype": convert_dtype(dtype)},
                    ["Out", "Indices", "Index", "Counts"], name=name)
    out, indices, inverse, counts = outs
    result = [out]
    if return_index:
        result.append(indices)
    if return_inverse:
        result.append(inverse)
    if return_counts:
        result.append(counts)
    return result[0] if len(result) == 1 else tuple(result)


def index_select(x, index, axis=0, name=None):
    return dispatch("index_select", {"X": x, "Index": index},
                    {"dim": int(axis)}, name=name)


def index_sample(x, index, name=None):
    return dispatch("index_sample", {"X": x, "Index": index}, name=name)


def masked_select(x, mask, name=None):
    return dispatch("masked_select", {"X": x, "Mask": mask}, {}, ["Y"],
                    name=name)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1,
                name=None):
    return dispatch("shard_index", {"X": input},
                    {"index_num": index_num, "nshards": nshards,
                     "shard_id": shard_id, "ignore_value": ignore_value},
                    name=name)
