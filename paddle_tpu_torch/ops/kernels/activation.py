"""relu, gelu (exact (erf) by default, the tanh form when attr
`approximate` is set), square and sqrt (the global-norm gradient clip),
sigmoid, log, tanh and log_softmax; the unary ops of paddle.tensor's
math functions (exp, rsqrt, ceil, floor, round, the trigonometric and
hyperbolic ones, reciprocal, erf, log2 / log10 / log1p), pow (a scalar
`factor`) and stanh (paddle_tpu/ops/kernels/activation.py:19-66).
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


@register_op("relu6", inputs=["X"], outputs=["Out"])
def relu6(ins, attrs, ctx):
    """min(max(x, 0), threshold): jnp.clip's gradient, which splits a tie
    (x at 0 or at the threshold: 1/2; torch.clamp passes all of it)."""
    x = ins["X"]
    lo = x.new_zeros(())
    hi = x.new_full((), float(attrs.get("threshold", 6.0)))
    return {"Out": torch.minimum(torch.maximum(x, lo), hi)}


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


@register_op("tanh", inputs=["X"], outputs=["Out"])
def tanh(ins, attrs, ctx):
    return {"Out": torch.tanh(ins["X"])}


@register_op("log_softmax", inputs=["X"], outputs=["Out"])
def log_softmax(ins, attrs, ctx):
    return {"Out": torch.log_softmax(ins["X"], dim=int(attrs.get("axis", -1)))}


def _act(name, fn, grad="auto"):
    @register_op(name, inputs=["X"], outputs=["Out"], grad=grad)
    def kernel(ins, attrs, ctx, _fn=fn):
        return {"Out": _fn(ins["X"], attrs)}
    return kernel


_act("exp", lambda x, a: torch.exp(x))
_act("rsqrt", lambda x, a: torch.rsqrt(x))
# ceil, floor and round have no gradient in the JAX package; round is
# numpy's (halves to even), as torch.round
_act("ceil", lambda x, a: torch.ceil(x), grad=None)
_act("floor", lambda x, a: torch.floor(x), grad=None)
_act("round", lambda x, a: torch.round(x), grad=None)
_act("sin", lambda x, a: torch.sin(x))
_act("cos", lambda x, a: torch.cos(x))
_act("tan", lambda x, a: torch.tan(x))
_act("asin", lambda x, a: torch.asin(x))
_act("acos", lambda x, a: torch.acos(x))
_act("atan", lambda x, a: torch.atan(x))
_act("sinh", lambda x, a: torch.sinh(x))
_act("cosh", lambda x, a: torch.cosh(x))
_act("reciprocal", lambda x, a: torch.reciprocal(x))
_act("erf", lambda x, a: torch.erf(x))
_act("log2", lambda x, a: torch.log2(x))
_act("log10", lambda x, a: torch.log10(x))
_act("log1p", lambda x, a: torch.log1p(x))
_act("pow", lambda x, a: torch.pow(x, a.get("factor", 1.0)))
_act("stanh", lambda x, a: a.get("scale_b", 1.7159) *
     torch.tanh(a.get("scale_a", 0.67) * x))
