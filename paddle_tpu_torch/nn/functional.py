"""paddle.nn.functional — the subset the GPT `/generate` slice calls.

Counterpart of paddle_tpu/nn/functional.py (`linear` :137, `embedding`
:335, `layer_norm` :248, `gelu` :49, `softmax` :97, `dropout` :318),
written as torch ops on torch tensors with Paddle's conventions: a
`linear` weight is [in, features_out]; `embedding` writes zeros for
`padding_idx`; `gelu` defaults to the exact erf form; `dropout` is the
identity in eval ("upscale_in_train") or scales by 1 - p
("downgrade_in_infer").  Dropout in training draws a mask, which waits
for the dygraph training slice: it raises there (p > 0).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["linear", "embedding", "layer_norm", "gelu", "softmax",
           "dropout"]


def linear(x, weight, bias=None, name=None):
    """x @ weight (+ bias), weight [in, out] (Paddle's layout)."""
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of `weight` [V, E] at ids `x`; rows of `padding_idx` are 0
    (the lookup_table_v2 contract)."""
    out = torch.nn.functional.embedding(x, weight)
    if padding_idx is not None and padding_idx != -1:
        pad = padding_idx % weight.shape[0]
        out = out.masked_fill((x == pad).unsqueeze(-1), 0.0)
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    shape = [normalized_shape] if np.isscalar(normalized_shape) \
        else list(normalized_shape)
    return torch.nn.functional.layer_norm(x, shape, weight, bias, epsilon)


def gelu(x, approximate=False, name=None):
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def softmax(x, axis=-1, dtype=None, name=None):
    return torch.softmax(x, dim=int(axis))


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training or p == 0:
        if not training and mode == "downgrade_in_infer":
            return x * (1.0 - p)
        return x
    raise NotImplementedError(
        "dropout in training (p > 0) needs the dygraph training slice "
        "(ROADMAP Queue 1 item 5): call .eval() or use p = 0")
