"""TensorArray ops: create_tensor_array / write_to_array /
read_from_array / lod_array_length.

Counterpart of paddle_tpu/ops/kernels/tensor_array.py, with its layout:
an array is a fixed-capacity device buffer [capacity, ...] plus a 0-d
int32 size (`TensorArrayVal`).  Capacity is fixed at the first write
(the `max_len` attr, else FLAGS_tensor_array_max_len, 256).  A write is
an out-of-place `index_copy` (differentiable, and no host read of the
index), a read an `index_select`.
"""
from __future__ import annotations

import torch

from ..registry import register_op

__all__ = ["TensorArrayVal", "DEFAULT_MAX_LEN"]

DEFAULT_MAX_LEN = 256


class TensorArrayVal:
    """Fixed-capacity device tensor array: buffer [capacity, ...] + size."""

    def __init__(self, buffer, size):
        self.buffer = buffer
        self.size = size

    @property
    def capacity(self):
        return self.buffer.shape[0]

    def __repr__(self):
        return (f"TensorArrayVal(capacity={self.buffer.shape[0]}, "
                f"elem={tuple(self.buffer.shape[1:])}, "
                f"dtype={self.buffer.dtype})")


def _no_shapes(ins, attrs):
    return {}


@register_op("create_tensor_array", inputs=[], outputs=["Out"], grad=None,
             infer_shape=_no_shapes)
def create_tensor_array(ins, attrs, ctx):
    from ...core.dtype import torch_dtype
    dt = torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": TensorArrayVal(
        torch.zeros((0,), dtype=dt, device=ctx.device),
        torch.zeros((), dtype=torch.int32, device=ctx.device))}


@register_op("write_to_array", inputs=["X", "I!", "Array?"],
             outputs=["Out"], grad=None, infer_shape=_no_shapes)
def write_to_array(ins, attrs, ctx):
    x, i = ins["X"], ins["I"]
    arr = ins.get("Array")
    i = i.reshape(()).to(torch.int32)
    if arr is None or (arr.buffer.dim() == 1 and arr.buffer.shape[0] == 0):
        # the first write fixes capacity and element shape
        max_len = int(attrs.get("max_len") or 0)
        if max_len <= 0:
            from ...core.flags import flag
            max_len = int(flag("tensor_array_max_len", DEFAULT_MAX_LEN))
        buf = torch.zeros((max_len,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        arr = TensorArrayVal(buf, torch.zeros((), dtype=torch.int32,
                                              device=x.device))
    buf = arr.buffer.index_copy(0, i.reshape(1).long(),
                                x.unsqueeze(0).to(arr.buffer.dtype))
    size = torch.maximum(arr.size, i + 1)
    return {"Out": TensorArrayVal(buf, size)}


@register_op("read_from_array", inputs=["X", "I!"], outputs=["Out"],
             grad=None, infer_shape=_no_shapes)
def read_from_array(ins, attrs, ctx):
    arr, i = ins["X"], ins["I"]
    return {"Out": arr.buffer.index_select(
        0, i.reshape(1).long()).squeeze(0)}


@register_op("lod_array_length", inputs=["X!"], outputs=["Out"], grad=None,
             infer_shape=_no_shapes)
def lod_array_length(ins, attrs, ctx):
    return {"Out": ins["X"].size.reshape(1).to(torch.int64)}
