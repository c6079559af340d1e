"""Random ops: uniform_random, gaussian_random, truncated_gaussian_random,
bernoulli, randint, randperm, sampling_id and multinomial.

Counterparts of paddle_tpu/ops/kernels/random.py.  multinomial ignores
`replacement` (it always samples with replacement) and, like sampling_id,
samples from log(X + 1e-12), as the JAX ops do (`:79-94`).  A draw is keyed by
`OpContext.draw_key` (the op's `seed` attr when it is not 0, else the step
seed `OpContext.seed_tensor`; the op's uid) and drawn by ops/random.py: the
Philox kernel on the card (the seed read from device memory, so a CUDA
graph of the step draws anew on each replay and equals eager run() for
the same step seed), its plain version on the CPU.  They are not the JAX
package's threefry draws."""
from __future__ import annotations

import torch

from ..registry import register_op
from ..random import (bernoulli_draw, categorical, normal, randint_draw,
                      randperm as _randperm, truncated_normal, uniform)
from ...core.dtype import torch_dtype
from .manip import _infer_constant, _infer_like


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


@register_op("truncated_gaussian_random", inputs=[], outputs=["Out"],
             grad=None, infer_shape=_infer_constant)
def truncated_gaussian_random(ins, attrs, ctx):
    seed, uid = ctx.draw_key(attrs)
    return {"Out": truncated_normal(tuple(attrs.get("shape", [])),
                                    torch_dtype(attrs.get("dtype",
                                                          "float32")),
                                    attrs.get("mean", 0.0),
                                    attrs.get("std", 1.0), seed, uid,
                                    ctx.device)}


@register_op("bernoulli", inputs=["X"], outputs=["Out"], grad=None,
             infer_shape=_infer_like("X"))
def bernoulli(ins, attrs, ctx):
    seed, uid = ctx.draw_key(attrs)
    return {"Out": bernoulli_draw(ins["X"], seed, uid)}


def _infer_randint(ins, attrs):
    return {"Out": torch.empty(tuple(attrs["shape"]), device="meta",
                               dtype=torch_dtype(attrs.get("dtype",
                                                           "int64")))}


@register_op("randint", inputs=[], outputs=["Out"], grad=None,
             infer_shape=_infer_randint)
def randint(ins, attrs, ctx):
    seed, uid = ctx.draw_key(attrs)
    return {"Out": randint_draw(tuple(attrs["shape"]),
                                torch_dtype(attrs.get("dtype", "int64")),
                                attrs.get("low", 0), attrs.get("high", 100),
                                seed, uid, ctx.device)}


def _infer_randperm(ins, attrs):
    return {"Out": torch.empty((attrs["n"],), device="meta",
                               dtype=torch_dtype(attrs.get("dtype",
                                                           "int64")))}


@register_op("randperm", inputs=[], outputs=["Out"], grad=None,
             infer_shape=_infer_randperm)
def randperm(ins, attrs, ctx):
    seed, uid = ctx.draw_key(attrs)
    return {"Out": _randperm(int(attrs["n"]),
                             torch_dtype(attrs.get("dtype", "int64")),
                             seed, uid, ctx.device)}


def _infer_samples(num_attr):
    def infer(ins, attrs):
        x = ins["X"]
        tail = (attrs.get("num_samples", 1),) if num_attr else ()
        return {"Out": torch.empty(tuple(x.shape[:-1]) + tail,
                                   dtype=torch.int64, device="meta")}
    return infer


@register_op("sampling_id", inputs=["X!"], outputs=["Out"], grad=None,
             infer_shape=_infer_samples(False))
def sampling_id(ins, attrs, ctx):
    x = ins["X"]
    seed, uid = ctx.draw_key(attrs)
    return {"Out": categorical(torch.log(x + 1e-12), 1, seed, uid,
                               x.device)[..., 0]}


@register_op("multinomial", inputs=["X!"], outputs=["Out"], grad=None,
             infer_shape=_infer_samples(True))
def multinomial(ins, attrs, ctx):
    x = ins["X"]
    seed, uid = ctx.draw_key(attrs)
    return {"Out": categorical(torch.log(x + 1e-12),
                               int(attrs.get("num_samples", 1)), seed, uid,
                               x.device)}
