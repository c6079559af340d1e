"""Comparisons of the slices: equal (gradient merge's and Lookahead's step
masks), greater_than and less_than (the L1 decay's sign), greater_equal
and logical_and (LocalSGD's begin step), and
optimization_barrier (the recompute rewrite's).  Counterpart of the ops
of the same names in paddle_tpu/ops/kernels/control.py; none has a
gradient."""
from __future__ import annotations

import torch

from ..registry import register_op


def _binary(name, fn):
    @register_op(name, inputs=["X!", "Y!"], outputs=["Out"], grad=None)
    def kernel(ins, attrs, ctx):
        return {"Out": fn(ins["X"], ins["Y"])}
    return kernel


less_than = _binary("less_than", torch.lt)
greater_than = _binary("greater_than", torch.gt)
equal = _binary("equal", torch.eq)
greater_equal = _binary("greater_equal", torch.ge)
logical_and = _binary("logical_and", torch.logical_and)


@register_op("optimization_barrier", inputs=["X*"], outputs=["Out*"],
             grad=None, side_effect=True)
def optimization_barrier(ins, attrs, ctx):
    """The recompute rewrite routes a replayed segment's inputs through
    this op.  In the JAX package it is `jax.lax.optimization_barrier`, so
    that XLA cannot merge the replay with the original forward inside its
    whole-block jit.  The eager port runs every op as it comes and has no
    such merge, so here it is an identity.  It returns copies, not its
    inputs: an output never aliases a buffer that a captured step
    (`Executor.run_steps`) updates in place."""
    return {"Out": [x.clone() for x in ins["X"]]}
