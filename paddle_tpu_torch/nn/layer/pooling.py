"""paddle.nn pooling layers (counterpart of
paddle_tpu/nn/layer/pooling.py): MaxPool2D (with `return_mask`: the
max_pool2d_with_index op, (Out, Mask)), AvgPool2D, AdaptiveAvgPool2D,
AdaptiveMaxPool2D (`return_mask` is not read, as in the JAX package), and
MaxPool1D / AvgPool1D (the 2-d pools over X unsqueezed at axis 2)."""
from __future__ import annotations

from ...dygraph.layers import Layer
from .. import functional as F

__all__ = ["MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D", "AdaptiveMaxPool2D",
           "MaxPool1D", "AvgPool1D"]


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


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self._output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self._output_size)


class MaxPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, name=None):
        super().__init__()
        self.ksize = kernel_size
        self.stride = stride if stride is not None else kernel_size
        self.padding, self.ceil_mode = padding, ceil_mode

    def forward(self, x):
        from ...tensor.manipulation import squeeze, unsqueeze
        out = F.max_pool2d(unsqueeze(x, 2), [1, self.ksize],
                           [1, self.stride], [0, self.padding],
                           self.ceil_mode)
        return squeeze(out, 2)


class AvgPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        self.ksize = kernel_size
        self.stride = stride if stride is not None else kernel_size
        self.padding, self.exclusive = padding, exclusive
        self.ceil_mode = ceil_mode

    def forward(self, x):
        from ...tensor.manipulation import squeeze, unsqueeze
        out = F.avg_pool2d(unsqueeze(x, 2), [1, self.ksize],
                           [1, self.stride], [0, self.padding],
                           self.ceil_mode, self.exclusive)
        return squeeze(out, 2)
