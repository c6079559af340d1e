"""Dtype system: the canonical dtype names of paddle_tpu/core/dtype.py,
mapped onto torch dtypes.

The IR keeps dtypes as strings ("float32", "bfloat16", ...) exactly as the
JAX package does, so a serialized Program is the same in both packages;
only the runtime mapping differs (bf16 -> torch.bfloat16).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["convert_dtype", "torch_dtype", "dtype_name", "set_default_dtype",
           "get_default_dtype"]

_ALIASES = {
    "float": "float32",
    "double": "float64",
    "half": "float16",
    "int": "int32",
    "long": "int64",
}

_TORCH = {
    "bool": torch.bool, "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
_NAMES = {v: k for k, v in _TORCH.items()}


def convert_dtype(dtype) -> str:
    """Normalise any dtype spec (str, np.dtype, torch.dtype, python type)
    to the canonical string name."""
    if dtype is None:
        return None
    if isinstance(dtype, str):
        name = _ALIASES.get(dtype, dtype)
    elif isinstance(dtype, torch.dtype):
        name = dtype_name(dtype)
    elif dtype in (float,):
        name = "float32"
    elif dtype in (int,):
        name = "int64"
    elif dtype in (bool,):
        name = "bool"
    else:
        name = np.dtype(dtype).name
    if name not in _TORCH:
        raise TypeError(f"unsupported dtype: {dtype!r}")
    return name


def torch_dtype(dtype) -> torch.dtype:
    return _TORCH[convert_dtype(dtype)]


def dtype_name(dtype: torch.dtype) -> str:
    """torch.dtype -> canonical name (torch.float32 -> "float32")."""
    try:
        return _NAMES[dtype]
    except KeyError:
        raise TypeError(f"unsupported dtype: {dtype!r}") from None


# -- default dtype (paddle.get/set_default_dtype) ---------------------------
_DEFAULT_DTYPE = "float32"


def set_default_dtype(d):
    global _DEFAULT_DTYPE
    name = convert_dtype(d)
    if name not in ("float16", "bfloat16", "float32", "float64"):
        raise ValueError(f"unsupported default dtype {d!r}")
    _DEFAULT_DTYPE = name


def get_default_dtype():
    return _DEFAULT_DTYPE
