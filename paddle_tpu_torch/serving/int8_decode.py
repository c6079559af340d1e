"""Dygraph int8 decode: a weight-only quantized Linear and the model
builder.

Counterpart of paddle_tpu/serving/int8_decode.py (its tp = 1 half; at
tp > 1 serving/tp_decode.py stamps the decode programs with
``slim.freeze_weights_int8`` instead).  ``Int8Linear`` runs the
``int8_matmul`` op (dynamic per-tensor activation quantization, the int8
product into int32 through ``torch._int_mm`` on the card, one dequant
multiply, the bias) over weights quantized through
``fake_channel_wise_quantize_abs_max`` with ``quant_axis=1`` (per
out-channel): the same grid as the static ``slim.freeze_weights_int8``,
and bitwise the JAX package's.

``quantize_decode_model`` builds a quantized SIBLING: a fresh
``GPTModel`` on the model's device from the same config and state_dict,
with every q/k/v/out-proj and fc1/fc2 ``Linear`` swapped for an
``Int8Linear``.  The float original is untouched (it stays the baseline
the token-equality contract compares against).  Embeddings, LayerNorms,
biases and the tied-embedding logits matmul stay fp32.
"""
from __future__ import annotations

import torch

from ..dygraph.layers import Layer
from ..ops.kernels.quantize import column_major
from ..ops.registry import OpContext, run_kernel

__all__ = ["Int8Linear", "quantize_decode_model"]

_MAX_RANGE = 127.0


def _quantize_weight(w: torch.Tensor):
    """Per-out-channel int8 of a [in, out] weight through the registered
    kernel: (int8 weight, fp32 scales [out])."""
    r = run_kernel("fake_channel_wise_quantize_abs_max",
                   {"X": w.detach().float()},
                   {"bit_length": 8, "quant_axis": 1},
                   OpContext(device=w.device))
    return r["Out"].to(torch.int8), r["OutScale"].float()


class Int8Linear(Layer):
    """Weight-only int8 drop-in for a float ``nn.Linear``: int8 weight and
    per-out-channel fp32 scale buffers on the weight's device, forward
    through the ``int8_matmul`` op."""

    def __init__(self, linear):
        super().__init__()
        w = linear.weight
        if w.dim() != 2:
            raise ValueError(
                f"Int8Linear needs a 2-D weight, got {tuple(w.shape)}")
        q, scale = _quantize_weight(w)
        self.in_features = int(w.shape[0])
        self.out_features = int(w.shape[1])
        # column-major: the layout torch._int_mm takes without a copy
        self.register_buffer("weight_int8", column_major(q))
        self.register_buffer("weight_scale", scale)
        self.bias = linear.bias

    def forward(self, x):
        ins = {"X": x, "W": self.weight_int8, "WScale": self.weight_scale,
               "Bias": self.bias}
        return run_kernel("int8_matmul", ins, {"max_range": _MAX_RANGE},
                          OpContext(device=x.device))["Out"]

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, int8")


def _place_of(device: torch.device):
    from ..core.place import CPUPlace, CUDAPlace
    if device.type == "cuda":
        return CUDAPlace(device.index or 0)
    return CPUPlace()


def quantize_decode_model(model):
    """An int8 weight-only SIBLING of a dygraph GPT decode model: a fresh
    ``GPTModel`` from ``model.config`` on the model's device, loaded with
    its state_dict, every block's q/k/v/out-proj and fc1/fc2 ``Linear``
    swapped for an ``Int8Linear``.  Returned in eval mode; ``model`` is
    untouched."""
    from ..dygraph import guard
    from ..models.gpt import GPTModel
    inner = getattr(model, "gpt", model)
    with guard(_place_of(inner.device)):
        clone = GPTModel(inner.config)
    clone.set_state_dict(inner.state_dict())
    clone.eval()
    for blk in clone.blocks:
        for holder, name in ((blk.attn, "q_proj"), (blk.attn, "k_proj"),
                             (blk.attn, "v_proj"), (blk.attn, "out_proj"),
                             (blk, "fc1"), (blk, "fc2")):
            setattr(holder, name, Int8Linear(getattr(holder, name)))
    return clone
