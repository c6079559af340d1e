"""paddle.nn norm layers (counterpart of paddle_tpu/nn/layer/norm.py):
BatchNorm (the fluid-style layer, with `act`), BatchNorm1D / 2D / 3D,
SyncBatchNorm (with `convert_sync_batchnorm`), LayerNorm, GroupNorm,
InstanceNorm1D / 2D / 3D, LocalResponseNorm and SpectralNorm.
BatchNorm's running stats are buffers (`_mean`, `_variance`) that
F.batch_norm updates in place in training; they are in `state_dict`.
LayerNorm: scale initialized to 1, bias to 0, epsilon 1e-5.

SyncBatchNorm dispatches the sync_batch_norm op: its kernel allreduces
the batch sums over ring 0's process group (torch.distributed; the
local statistics off a process group) and its gradient allreduces the
two sums dX needs, so each rank's Y, running stats and dX are those of
one batch norm over the global batch.  It reads `is_test` only (the
layer's training flag), never `use_global_stats`, as the JAX kernel."""
from __future__ import annotations

import numpy as np
import torch

from ...dygraph.layers import Layer
from ...static.initializer import Constant
from .. import functional as F

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "SpectralNorm"]


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


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Batch norm over the global batch of ring 0's process group (the
    module docstring); the same as BatchNorm on one process."""

    def forward(self, x):
        from ...dygraph import tracer
        from ...tensor._dispatch import dispatch
        attrs = {"momentum": self._momentum, "epsilon": self._epsilon,
                 "data_format": self._data_format,
                 "is_test": not self.training}
        y, mean_out, var_out, _, _ = dispatch(
            "sync_batch_norm",
            {"X": x, "Scale": self.weight, "Bias": self.bias,
             "Mean": self._mean, "Variance": self._variance}, attrs,
            ["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"])
        if self.training:
            if tracer.recording():
                tracer._PROGRAM_RECORDER.update(self._mean, mean_out)
                tracer._PROGRAM_RECORDER.update(self._variance, var_out)
            else:
                with torch.no_grad():
                    self._mean.copy_(mean_out)
                    self._variance.copy_(var_out)
        return y

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """`layer` with every BatchNorm* sublayer (recursively) replaced by
        a SyncBatchNorm sharing its parameters and buffers."""
        out = layer
        if isinstance(layer, _BatchNormBase) and \
                not isinstance(layer, SyncBatchNorm):
            out = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon)
            out.weight = layer.weight
            out.bias = layer.bias
            out._mean = layer._mean
            out._variance = layer._variance
        for name, sub in list(layer._modules.items()):
            layer._modules[name] = cls.convert_sync_batchnorm(sub)
        return out


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


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = (self.create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=Constant(1.0))
            if weight_attr is not False else None)
        self.bias = (self.create_parameter([num_channels], attr=bias_attr,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is not False:
            self.scale = self.create_parameter(
                [num_features], attr=weight_attr,
                default_initializer=Constant(1.0))
            self.bias = self.create_parameter([num_features], attr=bias_attr,
                                              is_bias=True)
        else:
            self.scale = self.bias = None

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        from ...tensor._dispatch import dispatch
        out, _ = dispatch("lrn", {"X": x},
                          {"n": self.size, "alpha": self.alpha,
                           "beta": self.beta, "k": self.k},
                          ["Out", "MidOut"])
        return out


class SpectralNorm(Layer):
    """Weight / sigma (the spectral_norm op) of the weight passed to
    forward; `weight_u` and `weight_v` are parameters (their default
    initializer, as in the JAX package)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None):
        super().__init__()
        self._dim, self._power_iters, self._eps = dim, power_iters, eps
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        self.weight_u = self.create_parameter([h], default_initializer=None)
        self.weight_v = self.create_parameter([w], default_initializer=None)

    def forward(self, weight):
        from ...tensor._dispatch import dispatch
        return dispatch("spectral_norm",
                        {"Weight": weight, "U": self.weight_u,
                         "V": self.weight_v},
                        {"dim": self._dim, "power_iters": self._power_iters,
                         "eps": self._eps})
