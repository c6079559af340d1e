"""`to_tensor`.  Counterpart of paddle_tpu/dygraph/tensor.py:364: there it
builds the JAX package's eager `Tensor`; here it returns a `torch.Tensor`
on the eager place (dygraph.base.current_place, CUDAPlace(0) unless a
`guard(place)` says otherwise).  Python floats become float32 and Python
ints int64, as paddle.to_tensor makes them; numpy arrays keep their
dtype."""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtype import torch_dtype

__all__ = ["to_tensor"]


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor: a torch.Tensor on `place` (default: the eager
    place); `stop_gradient=False` makes it require grad."""
    from .base import current_place
    from ..core.place import resolve_place
    device = (current_place() if place is None
              else resolve_place(place)).torch_device()
    if isinstance(data, torch.Tensor):
        t = data.detach().to(device)
    else:
        arr = np.asarray(data)
        if arr.dtype == np.float64 and not isinstance(data, np.ndarray):
            arr = arr.astype(np.float32)
        t = torch.as_tensor(arr, device=device)
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    if not stop_gradient:
        t.requires_grad_(True)
    return t
