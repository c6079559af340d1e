"""paddle.nn conv layers (counterpart of paddle_tpu/nn/layer/conv.py):
Conv1D (conv2d over operands unsqueezed at axis 2), Conv2D, Conv3D,
Conv2DTranspose and Conv3DTranspose.  The weight is [out, in / groups,
k...] ([in, out / groups, k...] transposed), Xavier-initialized, the bias
zero.  Conv2DTranspose reads neither `output_padding` nor `output_size`
and Conv3DTranspose dispatches its op directly, as in the JAX package."""
from __future__ import annotations

import numpy as np

from ...dygraph.layers import Layer
from ...static.initializer import XavierInitializer
from .. import functional as F

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv2DTranspose",
           "Conv3DTranspose"]


def _pair(v, n=2):
    return [v] * n if np.isscalar(v) else list(v)


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, weight_attr, bias_attr,
                 data_format, nd, transpose=False):
        super().__init__()
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _pair(kernel_size, nd)
        self._stride = _pair(stride, nd)
        self._padding = padding
        self._dilation = _pair(dilation, nd)
        self._groups = groups or 1
        self._data_format = data_format
        if transpose:
            w_shape = [in_channels, out_channels // self._groups] + \
                self._kernel_size
        else:
            w_shape = [out_channels, in_channels // self._groups] + \
                self._kernel_size
        self.weight = self.create_parameter(
            w_shape, attr=weight_attr,
            default_initializer=XavierInitializer())
        self.bias = (self.create_parameter([out_channels], attr=bias_attr,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 1)

    def forward(self, x):
        from ...tensor.manipulation import squeeze, unsqueeze
        out = F.conv2d(unsqueeze(x, 2), unsqueeze(self.weight, 2),
                       self.bias, stride=[1, self._stride[0]],
                       padding=[0, self._padding
                                if np.isscalar(self._padding)
                                else self._padding[0]],
                       dilation=[1, self._dilation[0]], groups=self._groups)
        return squeeze(out, 2)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 2)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 3)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 2, transpose=True)
        self._output_padding = output_padding

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._dilation, self._groups, output_size,
                                  self._data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 3, transpose=True)

    def forward(self, x, output_size=None):
        from ...tensor._dispatch import dispatch
        attrs = {"strides": self._stride,
                 "paddings": _pair(self._padding, 3),
                 "dilations": self._dilation, "groups": self._groups,
                 "data_format": self._data_format}
        out = dispatch("conv3d_transpose",
                       {"Input": x, "Filter": self.weight}, attrs,
                       ["Output"])
        if self.bias is not None:
            out = dispatch("elementwise_add", {"X": out, "Y": self.bias},
                           {"axis": 1})
        return out
