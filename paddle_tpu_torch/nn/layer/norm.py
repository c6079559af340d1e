"""paddle.nn norm layers (counterpart of paddle_tpu/nn/layer/norm.py):
BatchNorm (the fluid-style layer, with `act`), BatchNorm2D and LayerNorm.
BatchNorm's running stats are buffers (`_mean`, `_variance`) that
F.batch_norm updates in place in training; they are in `state_dict`.
LayerNorm: scale initialized to 1, bias to 0, epsilon 1e-5.  The other
norm layers (BatchNorm1D / 3D, SyncBatchNorm, GroupNorm, InstanceNorm*,
...) wait for ROADMAP.md Queue 1, The rest."""
from __future__ import annotations

import numpy as np

from ...dygraph.layers import Layer
from ...static.initializer import Constant
from .. import functional as F

__all__ = ["BatchNorm", "BatchNorm2D", "LayerNorm"]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = "NCHW" if data_format in (
            "NC", "NCL", "NCHW", "NCDHW") else "NHWC"
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True)
        self._mean = self.register_buffer(
            "_mean", np.zeros([num_features], np.float32))
        self._variance = self.register_buffer(
            "_variance", np.ones([num_features], np.float32))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}"


class BatchNorm(_BatchNormBase):
    """fluid-style BatchNorm(num_channels), `act` applied after (an F
    activation by name)."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, use_global_stats=False,
                 **kw):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout,
                         use_global_stats or None)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        return getattr(F, self._act)(out) if self._act else out


class BatchNorm2D(_BatchNormBase):
    pass


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
