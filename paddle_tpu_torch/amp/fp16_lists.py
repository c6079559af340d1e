"""Auto-mixed-precision op lists: white (run in the low dtype), black
(keep fp32) and gray (follow the inputs) op sets.

Copy of paddle_tpu/amp/fp16_lists.py, which has no JAX dependency of its
own: the same lists make the AMP rewrite emit the same program in both
packages.  The low-precision dtype defaults to bfloat16; matrix products
(and the flash-attention kernels, fp32 accumulation inside) are white,
numerically sensitive reductions black.
"""
from __future__ import annotations

import copy

__all__ = ["AutoMixedPrecisionLists", "white_list", "black_list", "gray_list"]

# Ops that gain from bf16 on the tensor cores
white_list = {
    "matmul", "matmul_v2", "mul", "fc", "bmm", "mv",
    "conv2d", "conv3d", "conv2d_transpose", "conv3d_transpose",
    "depthwise_conv2d",
    # attention kernels: fp32 accumulation inside
    "flash_attention", "ring_attention",
}

# Numerically sensitive: keep fp32
black_list = {
    "exp", "log", "log1p", "square", "rsqrt",
    "cross_entropy",
    "cross_entropy2", "bce_loss", "nll_loss", "sigmoid_cross_entropy_with_logits",
    "mean", "reduce_mean", "reduce_sum", "sum",
    "batch_norm", "sync_batch_norm", "instance_norm",
    "group_norm", "norm", "p_norm", "frobenius_norm", "squared_l2_norm",
    "cos_sim", "kldiv_loss", "huber_loss", "smooth_l1_loss",
    "cumsum", "logsumexp", "erf",
}

# Dtype follows the inputs
gray_list = {
    # these kernels upcast to fp32 INTERNALLY (ops/kernels/loss.py and
    # nn.py's softmax/layer_norm, through nn._cdt), so bf16
    # activations reach them directly — same math as black-listing, minus
    # the materialized fp32 casts of the largest tensors in an LM step
    # (logits, attention scores, residual-stream layer_norm inputs) and
    # their fp32 cotangents
    "softmax_with_cross_entropy", "softmax", "log_softmax", "layer_norm",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "relu", "gelu", "sigmoid", "tanh", "relu6",
    "leaky_relu", "swish", "hard_swish", "prelu", "maximum", "minimum",
    "pool2d", "pool3d", "reshape2", "reshape", "transpose2", "transpose",
    "concat", "split", "slice", "stack", "unstack", "squeeze", "unsqueeze",
    "squeeze2", "unsqueeze2", "flatten", "flatten2", "dropout", "pad",
    "pad2d", "pad3d", "expand", "expand_v2", "tile", "gather", "gather_nd",
    "scatter", "scale", "clip", "bilinear_interp", "nearest_interp",
    "flatten_contiguous_range",
}


class AutoMixedPrecisionLists:
    """User deltas applied to the default lists; everything not white or
    gray is treated as black."""

    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None):
        self.white_list = copy.copy(white_list)
        self.black_list = copy.copy(black_list)
        self.gray_list = copy.copy(gray_list)
        self.black_varnames = set(custom_black_varnames or ())
        if custom_white_list:
            for op in custom_white_list:
                self.white_list.add(op)
                self.black_list.discard(op)
                self.gray_list.discard(op)
        if custom_black_list:
            for op in custom_black_list:
                self.black_list.add(op)
                self.white_list.discard(op)
                self.gray_list.discard(op)
        if self.white_list & self.black_list:
            raise ValueError("op appears in both custom white and black "
                             f"lists: {self.white_list & self.black_list}")
