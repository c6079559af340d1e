"""Random initializer ops: uniform_random, gaussian_random.

Counterparts of paddle_tpu/ops/kernels/random.py.  A draw is keyed by
`OpContext.draw_key` (the op's `seed` attr when it is not 0, else the step
seed `OpContext.seed_tensor`; the op's uid) and drawn by ops/random.py: the
Philox kernel on the card (the seed read from device memory, so a CUDA
graph of the step draws anew on each replay and equals eager run() for
the same step seed), its plain version on the CPU.  They are not the JAX
package's threefry draws."""
from __future__ import annotations

from ..registry import register_op
from ..random import normal, uniform
from ...core.dtype import torch_dtype
from .manip import _infer_constant


@register_op("uniform_random", inputs=["ShapeTensor?!"], outputs=["Out"],
             grad=None, infer_shape=_infer_constant)
def uniform_random(ins, attrs, ctx):
    seed, uid = ctx.draw_key(attrs)
    return {"Out": uniform(tuple(attrs.get("shape", [])),
                           torch_dtype(attrs.get("dtype", "float32")),
                           attrs.get("min", -1.0), attrs.get("max", 1.0),
                           seed, uid, ctx.device)}


@register_op("gaussian_random", inputs=["ShapeTensor?!"], outputs=["Out"],
             grad=None, infer_shape=_infer_constant)
def gaussian_random(ins, attrs, ctx):
    seed, uid = ctx.draw_key(attrs)
    return {"Out": normal(tuple(attrs.get("shape", [])),
                          torch_dtype(attrs.get("dtype", "float32")),
                          attrs.get("mean", 0.0), attrs.get("std", 1.0),
                          seed, uid, ctx.device)}
