"""paddle.nn pooling layers (counterpart of
paddle_tpu/nn/layer/pooling.py): MaxPool2D, AvgPool2D and
AdaptiveAvgPool2D over the F functions.  MaxPool2D(return_mask=True)
raises (max_pool2d_with_index is not ported); the 1-D and adaptive max
layers wait for ROADMAP.md Queue 1, The rest."""
from __future__ import annotations

from ...dygraph.layers import Layer
from .. import functional as F

__all__ = ["MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D"]


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__()
        self.ksize, self.stride, self.padding = kernel_size, stride, padding
        self.return_mask, self.ceil_mode = return_mask, ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.ksize, self.stride, self.padding,
                            self.ceil_mode, self.return_mask,
                            self.data_format)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.ksize, self.stride, self.padding = kernel_size, stride, padding
        self.ceil_mode, self.exclusive = ceil_mode, exclusive
        self.data_format = data_format

    def forward(self, x):
        return F.avg_pool2d(x, self.ksize, self.stride, self.padding,
                            self.ceil_mode, self.exclusive, self.data_format)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self._output_size = output_size
        self._data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self._output_size, self._data_format)
