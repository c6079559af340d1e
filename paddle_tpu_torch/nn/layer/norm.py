"""paddle.nn LayerNorm (counterpart of paddle_tpu/nn/layer/norm.py:122):
scale initialized to 1, bias to 0, epsilon 1e-5.  The other norm layers
wait for ROADMAP Queue 1 item 5."""
from __future__ import annotations

import numpy as np

from ...dygraph.layers import Layer
from ...static.initializer import Constant
from .. import functional as F

__all__ = ["LayerNorm"]


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if np.isscalar(normalized_shape):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        n = int(np.prod(normalized_shape))
        self.weight = (self.create_parameter(
            [n], attr=weight_attr, default_initializer=Constant(1.0))
            if weight_attr is not False else None)
        self.bias = (self.create_parameter([n], attr=bias_attr, is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"
