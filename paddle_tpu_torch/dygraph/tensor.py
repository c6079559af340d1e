"""The eager tensor: a plain `torch.Tensor`, and Paddle's tensor methods
that torch has no counterpart for, as module-level functions.

Counterpart of paddle_tpu/dygraph/tensor.py.  There `Tensor` is the JAX
package's own wrapper with a tape; here eager tensors are torch tensors
(no subclass: a `__torch_function__` would sit on every op of the hot
path), autograd is torch's, and `requires_grad` stands for
`not stop_gradient`.  A parameter (`Layer.create_parameter`) is a
`torch.nn.Parameter` that carries its Paddle name and attributes.

=============================  =========================================
Paddle (JAX package)           port
=============================  =========================================
`paddle.to_tensor(data)`       `to_tensor(data)` (on the eager place)
`t.stop_gradient`              `not t.requires_grad`
`t.stop_gradient = False`      `t.requires_grad_(True)`
`t.backward(g, retain_graph)`  `backward(t, g, retain_graph)`
                               (`t.backward()` is torch's, which also
                               works; `backward` adds Paddle's
                               second-backward error and the ones seed
                               of a non-scalar root)
`t.gradient()`                 `gradient(t)` (numpy, or None)
`t.grad`                       `t.grad` (a torch tensor)
`t.clear_gradient()`,          `clear_grad(t)`
`t.clear_grad()`
`t.astype(dtype)`, `t.cast`    `astype(t, dtype)` (Paddle dtype names)
`t.register_hook(fn)`          `t.register_hook(fn)`
`t.numpy()`                    `numpy(t)`
`param.name`                   `param.paddle_name` (torch's
                               `Tensor.name` is read-only)
`param.need_clip`              `param.need_clip`
`param.trainable`              `param.requires_grad`
=============================  =========================================
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtype import torch_dtype

__all__ = ["to_tensor", "backward", "gradient", "clear_grad",
           "clear_gradient", "astype", "numpy"]


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor: a torch.Tensor on `place` (default: the eager
    place); `stop_gradient=False` makes it require grad.  Python floats
    become float32 and Python ints int64, as paddle.to_tensor makes them;
    numpy arrays keep their dtype."""
    from .base import current_place
    from .tracer import eager_name, quiet, recording
    from ..core.place import resolve_place
    if recording():
        # a constant of a traced function: the JAX package's Tensor()
        eager_name()
        with quiet():
            return to_tensor(data, dtype, place, stop_gradient)
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


def backward(t, grad_tensor=None, retain_graph=False):
    """Tensor.backward (dygraph/engine.run_backward)."""
    from .engine import run_backward
    run_backward(t, grad_tensor, retain_graph)


def gradient(t):
    """Tensor.gradient(): the gradient as a numpy array, or None."""
    return None if t.grad is None else numpy(t.grad)


def clear_grad(t):
    """Tensor.clear_grad() / clear_gradient(): drop the gradient."""
    t.grad = None


clear_gradient = clear_grad


def astype(t, dtype):
    """Tensor.astype / cast: `t` in the Paddle-named dtype."""
    return t.to(torch_dtype(dtype))


def numpy(t):
    """Tensor.numpy() (bfloat16, which numpy lacks, as float32)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
