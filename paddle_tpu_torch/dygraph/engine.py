"""Dygraph autograd engine on torch autograd.

Counterpart of paddle_tpu/dygraph/engine.py (the reference's
imperative/basic_engine.cc and partial_grad_engine.cc).  There a
host-side walk of the JAX package's own tape runs each op's grad kernel;
here the tape is torch autograd, and these functions give it Paddle's
contract:

  * `run_backward(root, grad_tensor, retain_graph)`: `Tensor.backward()`.
    Gradients accumulate into every reachable leaf that requires grad
    (`not stop_gradient`), non-leaf gradients are not kept, the seed is
    ones of the root's shape, and a second backward over a graph that was
    not retained raises RuntimeError (the root remembers, as the JAX
    package's `_FREED` root does);
  * `grad(outputs, inputs, grad_outputs, retain_graph, create_graph,
    only_inputs, allow_unused, no_grad_vars)`: `paddle.grad`, which
    leaves `.grad` alone.  An input no output reaches raises unless
    `allow_unused` (then None); a tensor in `no_grad_vars` absorbs the
    gradient, passing zeros on to what produced it (an input in
    `no_grad_vars` is unreachable), as in the JAX package; the graph is kept
    unless `retain_graph=False` (the JAX package never frees it here);
    `create_graph=True` returns gradients that are on the tape;
  * `register_tensor_hook(t, hook)`: `Tensor.register_hook`; the hook
    sees the gradient of `t` and may return a replacement.
"""
from __future__ import annotations

import torch

__all__ = ["run_backward", "grad", "register_tensor_hook"]

_FREED_ATTR = "_paddle_graph_freed"


def register_tensor_hook(tensor, hook):
    """Call `hook(grad)` on the gradient of `tensor`; a non-None return
    replaces it.  Returns a handle with `.remove()`."""
    return tensor.register_hook(hook)


def _seed(root, grad_tensor):
    if grad_tensor is None:
        return torch.ones_like(root)
    return torch.as_tensor(grad_tensor, dtype=root.dtype, device=root.device)


def _check_not_freed(t):
    if getattr(t, _FREED_ATTR, False):
        raise RuntimeError(
            "backward() called twice on the same graph; pass "
            "retain_graph=True to the first call to allow this")


def run_backward(root, grad_tensor=None, retain_graph=False):
    """tensor.backward(): accumulate gradients into every reachable leaf
    that requires grad."""
    if not root.requires_grad:
        raise RuntimeError("backward() on a tensor with stop_gradient=True")
    _check_not_freed(root)
    torch.autograd.backward(root, _seed(root, grad_tensor),
                            retain_graph=retain_graph)
    if not retain_graph and root.grad_fn is not None:
        setattr(root, _FREED_ATTR, True)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad: the gradients of `outputs` with respect to `inputs`,
    without touching `.grad`."""
    outputs = list(outputs) if isinstance(outputs, (list, tuple)) \
        else [outputs]
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) \
        else [inputs]
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    elif not isinstance(grad_outputs, (list, tuple)):
        grad_outputs = [grad_outputs]
    for out in outputs:
        if getattr(out, _FREED_ATTR, False):
            raise RuntimeError(
                "grad(): the graph reaching this output was freed by a "
                "previous backward(); pass retain_graph=True to backward()")
    blocked = list(no_grad_vars or [])
    blocked_ids = {id(t) for t in blocked}
    want = [t for t in inputs if id(t) not in blocked_ids]
    # a blocked tensor passes a zero gradient on to what produced it
    handles = [t.register_hook(torch.zeros_like) for t in blocked
               if t.requires_grad and t.grad_fn is not None]
    try:
        gs = torch.autograd.grad(
            outputs, want, [_seed(o, g) for o, g in zip(outputs,
                                                        grad_outputs)],
            retain_graph=True if retain_graph is None else retain_graph,
            create_graph=create_graph, allow_unused=True) if want else ()
    finally:
        for h in handles:
            h.remove()
    got = dict(zip(map(id, want), gs))
    results = [got.get(id(t)) for t in inputs]
    for t, g in zip(inputs, results):
        if g is None and not allow_unused:
            raise RuntimeError(
                f"input of shape {tuple(t.shape)} is unreachable from "
                "outputs (set allow_unused=True to get None)")
    return results
