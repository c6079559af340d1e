"""Dygraph tracer bookkeeping: the eager draw key and the AMP interception
point.

Counterpart of paddle_tpu/dygraph/tracer.py.  There `trace_op` runs each
eager op's kernel and records a GradNode on the JAX package's own tape;
here ops are torch ops and the tape is torch autograd, so what is left
of the tracer is its bookkeeping:

  * `eager_draw_key()`: the (seed, uid) an eager random op draws with,
    `global_seed()` and `next_eager_uid()` (core/generator.py), as
    `trace_op` hands them to its kernel (`:97-99`).  The port advances the
    uid on random ops only (the JAX package on every traced op), so the
    masks of a model differ between the packages; one op's draw does not;
  * `amp_inputs(op_type, *tensors)`: the AMP cast of `trace_op`
    (`:112-119`).  Every port functional op calls it with the op type the
    JAX package would trace for it (`F.linear` -> "matmul_v2" then
    "elementwise_add", `F.layer_norm` -> "layer_norm", ...), and under an
    active `amp.auto_cast` the floating inputs are cast as
    `amp.auto_cast.cast_for_op` decides, as the JAX package's
    `amp_cast_inputs` (paddle_tpu/amp/auto_cast.py:71-91).  The cast is
    a torch op, so its backward casts the gradient back to the input's
    dtype.
"""
from __future__ import annotations

from ..core.generator import global_seed, next_eager_uid

__all__ = ["eager_draw_key", "amp_inputs"]


def eager_draw_key():
    """(seed, uid) of one eager random draw."""
    return global_seed(), next_eager_uid()


def amp_inputs(op_type: str, *tensors):
    """The inputs of one `op_type` op as AMP would cast them (unchanged
    outside `auto_cast`); returns a tuple, one entry per argument."""
    from ..amp.auto_cast import amp_state, cast_for_op
    if not amp_state().enabled:
        return tensors
    return cast_for_op(op_type, tensors)
