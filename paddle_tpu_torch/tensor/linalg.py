"""paddle.tensor linalg functions (dual-mode; counterpart of
paddle_tpu/tensor/linalg.py, the same names and ops).  `matmul` (the
`matmul_v2` op, on the AMP white list) keeps the dygraph slices' eager
path: the AMP cast, then torch.matmul."""
from __future__ import annotations

import numpy as np
import torch

from ..dygraph.tracer import amp_inputs, recording
from ._dispatch import dispatch, is_eager

__all__ = [
    "matmul", "mm", "bmm", "dot", "mv", "norm", "dist", "cholesky",
    "inverse", "cross", "histogram", "t", "transpose",
]


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    if recording() or not is_eager({"X": x, "Y": y}):
        return dispatch("matmul_v2", {"X": x, "Y": y},
                        {"trans_x": bool(transpose_x),
                         "trans_y": bool(transpose_y)}, name=name)
    x, y = amp_inputs("matmul_v2", x, y)
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def mm(input, mat2, name=None):
    return matmul(input, mat2, name=name)


def bmm(x, y, name=None):
    return dispatch("bmm", {"X": x, "Y": y}, name=name)


def dot(x, y, name=None):
    return dispatch("dot", {"X": x, "Y": y}, name=name)


def mv(x, vec, name=None):
    return dispatch("mv", {"X": x, "Vec": vec}, name=name)


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    if p == "fro" and axis is None:
        return dispatch("frobenius_norm", {"X": x},
                        {"dim": [0], "keep_dim": keepdim, "reduce_all": True},
                        name=name)
    if p == "fro":
        dims = [axis] if np.isscalar(axis) else list(axis)
        return dispatch("frobenius_norm", {"X": x},
                        {"dim": dims, "keep_dim": keepdim,
                         "reduce_all": False}, name=name)
    porder = float(p) if not isinstance(p, str) else float(p)
    attrs = {"porder": porder, "keepdim": keepdim, "epsilon": 1e-12}
    if axis is None:
        attrs["asvector"] = True
        attrs["axis"] = 0
    else:
        attrs["asvector"] = False
        attrs["axis"] = int(axis) if np.isscalar(axis) else int(axis[0])
    return dispatch("p_norm", {"X": x}, attrs, name=name)


def dist(x, y, p=2, name=None):
    return dispatch("dist", {"X": x, "Y": y}, {"p": float(p)}, name=name)


def cholesky(x, upper=False, name=None):
    return dispatch("cholesky", {"X": x}, {"upper": bool(upper)}, name=name)


def inverse(x, name=None):
    return dispatch("inverse", {"Input": x}, {}, ["Output"], name=name)


def cross(x, y, axis=None, name=None):
    return dispatch("cross", {"X": x, "Y": y},
                    {"dim": -1 if axis is None else int(axis)}, name=name)


def histogram(input, bins=100, min=0, max=0, name=None):
    return dispatch("histogram", {"X": input},
                    {"bins": bins, "min": min, "max": max}, name=name)


# aliases shared with manipulation
from .manipulation import t, transpose  # noqa: E402,F401
