"""paddle.nn common layers: Identity, Linear, Embedding, Dropout,
Dropout2D, Flatten, Pad2D, Upsample / UpsamplingBilinear2D /
UpsamplingNearest2D, PixelShuffle, CosineSimilarity and Bilinear.
Counterpart of paddle_tpu/nn/layer/common.py, with Paddle's parameter
shapes and default initializers (Linear: Xavier-uniform weight [in, out],
zero bias; Embedding: Normal(0, 1) table; Bilinear: weight [out, in1,
in2] and bias [1, out], the default initializers).  Dropout draws its
mask in training (F.dropout: the Philox kernel) and is the identity in
eval; Dropout2D is Dropout, as in the JAX package."""
from __future__ import annotations

import numpy as np
import torch

from ...dygraph.layers import Layer
from ...static.initializer import Normal, XavierInitializer
from .. import functional as F

__all__ = ["Identity", "Linear", "Dropout", "Dropout2D", "Embedding",
           "Flatten", "Pad2D", "Upsample", "UpsamplingBilinear2D",
           "UpsamplingNearest2D", "PixelShuffle", "CosineSimilarity",
           "Bilinear"]


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Linear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=XavierInitializer())
        self.bias = (self.create_parameter([out_features], attr=bias_attr,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.weight.shape[0]}, "
                f"out_features={self.weight.shape[1]}")


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.mode = p, mode

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training, mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=Normal(0.0, 1.0))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, self._padding_idx)


class Dropout2D(Dropout):
    pass


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        from ...tensor.manipulation import flatten
        return flatten(x, self.start_axis, self.stop_axis)


class Pad2D(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.padding = padding if not np.isscalar(padding) \
            else [padding] * 4
        self.mode, self.value, self.data_format = mode, value, data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     self.data_format)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.align_mode, self.data_format = align_mode, data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr)
        self.bias = (self.create_parameter([1, out_features], attr=bias_attr,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x1, x2):
        from ...tensor._dispatch import dispatch
        return dispatch("bilinear_tensor_product",
                        {"X": x1, "Y": x2, "Weight": self.weight,
                         "Bias": self.bias}, {})
