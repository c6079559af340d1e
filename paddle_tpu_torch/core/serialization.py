"""Tensor codec: the half of paddle_tpu/core/serialization.py that model
directories and checkpoints need.

`encode_tensor` / `decode_tensor` are the checkpoint shards' payload
codec: a tensor lowers to a numpy-storable view plus a dtype tag, bf16 as
its uint16 bit pattern with the tag "bfloat16" (the JAX package's tags
and views, so the CRC of a payload is the same in both packages).  A bf16
payload decodes as a uint16 view reinterpreted as torch.bfloat16, never
through ml_dtypes, which the GPU machine does not have.

`tensor_to_bytes` / `tensor_from_bytes` write and read the same
self-describing record (magic + length-prefixed JSON header + raw buffer)
as the JAX package, so a bf16 parameter saved by either package (as a
`.npt` file, numpy having no bf16 dtype) loads in the other.  bf16 is
stored as its uint16 bit pattern, bit-exact.

The framework.proto program container is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import json

import numpy as np
import torch

__all__ = ["encode_tensor", "decode_tensor", "tensor_to_bytes",
           "tensor_from_bytes"]

_TENSOR_MAGIC = b"PTT1"


def _view(t: torch.Tensor):
    """(numpy view, logical dtype tag) of a CPU tensor."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, a.dtype.name


def encode_tensor(value):
    """(contiguous numpy view, logical dtype tag) of a tensor or an array:
    a bf16 tensor becomes its uint16 bit view tagged "bfloat16", every
    other dtype passes through with its numpy name as the tag.  A CUDA
    tensor is copied to the host first (synchronously)."""
    if isinstance(value, torch.Tensor):
        return _view(value)
    a = np.asarray(value)
    if not a.flags["C_CONTIGUOUS"]:
        # .reshape(a.shape) undoes ascontiguousarray's 0-d -> 1-d promotion
        a = np.ascontiguousarray(a).reshape(a.shape)
    if a.dtype.name == "bfloat16":  # an ml_dtypes array, where one exists
        return a.view(np.uint16), "bfloat16"
    return a, a.dtype.name


def decode_tensor(view, dtype_tag: str) -> torch.Tensor:
    """Inverse of `encode_tensor`: a CPU tensor of the logical dtype,
    bit-exact for bf16 (the uint16 view reinterpreted)."""
    a = np.asarray(view)
    if not a.flags["C_CONTIGUOUS"]:
        a = np.ascontiguousarray(a).reshape(a.shape)
    if dtype_tag == "bfloat16":
        if a.dtype != np.uint16:
            raise ValueError(
                f"bfloat16 payload must be a uint16 view, got {a.dtype}")
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype.name != dtype_tag:
        a = a.astype(np.dtype(dtype_tag))
    return torch.from_numpy(a)


def tensor_to_bytes(t: torch.Tensor) -> bytes:
    view, tag = _view(t)
    header = json.dumps({"dtype": tag, "vdtype": view.dtype.str,
                         "shape": list(view.shape)}).encode()
    return (_TENSOR_MAGIC + len(header).to_bytes(4, "little") + header
            + view.tobytes())


def tensor_from_bytes(data: bytes) -> torch.Tensor:
    if data[:4] != _TENSOR_MAGIC:
        raise ValueError("not a paddle_tpu tensor record (bad magic)")
    hlen = int.from_bytes(data[4:8], "little")
    meta = json.loads(data[8:8 + hlen].decode())
    # .copy(): a bytes-backed frombuffer view is read-only
    view = np.frombuffer(data[8 + hlen:],
                         dtype=np.dtype(meta["vdtype"])).copy()
    expect = int(np.prod(meta["shape"])) if meta["shape"] else 1
    if view.size != expect:
        raise ValueError(
            f"tensor record truncated: {view.size} elements, header "
            f"declares {expect}")
    return decode_tensor(view.reshape(meta["shape"]), meta["dtype"])
