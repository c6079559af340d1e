"""Tensor manipulation functions (counterpart of
paddle_tpu/tensor/manipulation.py): `flatten`, the op
`flatten_contiguous_range` the JAX package traces, AMP-cast as that op
(gray: no cast), then torch.flatten."""
from __future__ import annotations

import torch

from ..dygraph.tracer import amp_inputs, recording

__all__ = ["flatten"]


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    if recording():
        from ._dispatch import dispatch
        return dispatch("flatten_contiguous_range", {"X": x},
                        {"start_axis": start_axis, "stop_axis": stop_axis})
    (x,) = amp_inputs("flatten_contiguous_range", x)
    return torch.flatten(x, start_axis, stop_axis)
