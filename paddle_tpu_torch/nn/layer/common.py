"""paddle.nn common layers: Identity, Linear, Embedding, Dropout.
Counterpart of paddle_tpu/nn/layer/common.py, with Paddle's parameter
shapes and default initializers (Linear: Xavier-uniform weight [in, out],
zero bias; Embedding: Normal(0, 1) table).  Dropout draws its mask in
training (F.dropout: the Philox kernel) and is the identity in eval."""
from __future__ import annotations

import torch

from ...dygraph.layers import Layer
from ...static.initializer import Normal, XavierInitializer
from .. import functional as F

__all__ = ["Identity", "Linear", "Dropout", "Embedding"]


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
