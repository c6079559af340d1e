"""Build-time shape/dtype inference.

Counterpart of paddle_tpu/core/infer_shape.py.  There every kernel is
abstractly evaluated with `jax.eval_shape`; here the op's torch kernel
runs on tensors of the "meta" device, which carry shape and dtype but no
data.  Dynamic dims (-1, the batch dim) are bound to the same sentinel
size as in the JAX package and mapped back to -1 in the outputs, so both
packages infer the same shapes (including derived ones such as
layer_norm's flattened Mean).  Ops whose kernels cannot run on meta
tensors (random draws, the flash-attention wrapper) declare an explicit
`infer_shape` in the registry.
"""
from __future__ import annotations

import torch

from ..ops.registry import get_op_info, OpContext
from .dtype import dtype_name, torch_dtype

# prime, unlikely to appear as a derived static dim (same as paddle_tpu)
_SENTINEL = 191


def _meta_for(var):
    if var.shape is None:
        raise NotImplementedError(f"var {var.name} has no shape")
    shape = tuple(_SENTINEL if s == -1 else s for s in var.shape)
    return torch.empty(shape, dtype=torch_dtype(var.dtype), device="meta")


def infer_shape_for_op(block, op) -> None:
    """Fill in shape/dtype of op outputs from inputs by running the kernel
    on meta tensors.  Called from Block.append_op; silently skips if
    inputs are incomplete."""
    info = get_op_info(op.type)
    if info is None:
        raise NotImplementedError(op.type)

    ins = {}
    for slot in info.inputs:
        names = op.inputs.get(slot.name, [])
        if not names:
            if not slot.optional:
                return  # incomplete op; executor will error later if run
            ins[slot.name] = [] if slot.duplicable else None
            continue
        try:
            metas = [_meta_for(block.var(n)) for n in names]
        except (KeyError, NotImplementedError):
            return
        ins[slot.name] = metas if slot.duplicable else metas[0]

    # a jit.to_static recorder records none of these meta-tensor ops
    from ..dygraph.tracer import quiet
    with quiet():
        if info.infer_shape is not None:
            outs = info.infer_shape(ins, op.attrs)
        else:
            try:
                outs = info.kernel(ins, op.attrs, OpContext(seed=0))
            except Exception:  # noqa: BLE001 — best-effort, as in paddle_tpu
                return

    for slot in info.outputs:
        names = op.outputs.get(slot.name, [])
        if not names:
            continue
        res = outs.get(slot.name) if isinstance(outs, dict) else None
        if res is None:
            continue
        res_list = res if isinstance(res, (list, tuple)) else [res]
        for name, t in zip(names, res_list):
            if t is None:
                continue
            try:
                v = block.var(name)
            except KeyError:
                v = block.create_var(name=name)
            v.shape = tuple(-1 if s == _SENTINEL else int(s) for s in t.shape)
            v.dtype = dtype_name(t.dtype)
