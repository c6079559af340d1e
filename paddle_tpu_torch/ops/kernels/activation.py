"""relu, gelu (exact (erf) by default, the tanh form when attr
`approximate` is set), square and sqrt (the global-norm gradient clip),
sigmoid and log.
Counterpart of paddle_tpu/ops/kernels/activation.py.  relu's grad op
reads the forward's Out (dX = dOut where Out > 0, else 0: jax.nn.relu's
gradient, 0 at 0) instead of replaying the forward."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..registry import register_op


def _relu_grad(ins, attrs, ctx):
    g = ins.get("Out@GRAD")
    if g is None:
        return {}
    return {"X@GRAD": torch.ops.aten.threshold_backward(g, ins["Out"], 0)}


@register_op("relu", inputs=["X"], outputs=["Out"], grad=_relu_grad)
def relu(ins, attrs, ctx):
    return {"Out": torch.relu(ins["X"])}


@register_op("gelu", inputs=["X"], outputs=["Out"])
def gelu(ins, attrs, ctx):
    approx = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": F.gelu(ins["X"], approximate=approx)}


@register_op("square", inputs=["X"], outputs=["Out"])
def square(ins, attrs, ctx):
    return {"Out": torch.square(ins["X"])}


@register_op("sqrt", inputs=["X"], outputs=["Out"])
def sqrt(ins, attrs, ctx):
    return {"Out": torch.sqrt(ins["X"])}


@register_op("sigmoid", inputs=["X"], outputs=["Out"])
def sigmoid(ins, attrs, ctx):
    return {"Out": torch.sigmoid(ins["X"])}


@register_op("log", inputs=["X"], outputs=["Out"])
def log(ins, attrs, ctx):
    return {"Out": torch.log(ins["X"])}
