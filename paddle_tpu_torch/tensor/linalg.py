"""paddle.matmul (counterpart of paddle_tpu/tensor/linalg.py:17): the
`matmul_v2` op, on the AMP white list."""
from __future__ import annotations

import torch

from ..dygraph.tracer import amp_inputs, recording

__all__ = ["matmul"]


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    if recording():
        from ._dispatch import dispatch
        return dispatch("matmul_v2", {"X": x, "Y": y},
                        {"trans_x": bool(transpose_x),
                         "trans_y": bool(transpose_y)})
    x, y = amp_inputs("matmul_v2", x, y)
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)
