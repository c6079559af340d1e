"""paddle.nn Conv2D (counterpart of paddle_tpu/nn/layer/conv.py): weight
[out, in / groups, kh, kw], Xavier-initialized, zero bias, through
F.conv2d.  Conv1D, Conv3D and the transposed convolutions wait for
ROADMAP.md Queue 1, The rest."""
from __future__ import annotations

import numpy as np

from ...dygraph.layers import Layer
from ...static.initializer import XavierInitializer
from .. import functional as F

__all__ = ["Conv2D"]


def _pair(v, n=2):
    return [v] * n if np.isscalar(v) else list(v)


class Conv2D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _pair(kernel_size)
        self._stride = _pair(stride)
        self._padding = padding
        self._dilation = _pair(dilation)
        self._groups = groups or 1
        self._data_format = data_format
        self.weight = self.create_parameter(
            [out_channels, in_channels // self._groups] + self._kernel_size,
            attr=weight_attr, default_initializer=XavierInitializer())
        self.bias = (self.create_parameter([out_channels], attr=bias_attr,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")
