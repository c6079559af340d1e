"""paddle.nn activation layers (counterpart of
paddle_tpu/nn/layer/activation.py): ReLU, ReLU6, Tanh, Sigmoid, GELU,
Softmax and LogSoftmax over the functional forms.  The other activation layers
wait for ROADMAP.md Queue 1, The rest."""
from __future__ import annotations

from ...dygraph.layers import Layer
from .. import functional as F

__all__ = ["ReLU", "ReLU6", "Tanh", "Sigmoid", "GELU", "Softmax",
           "LogSoftmax"]


def _act_layer(name, fn):
    class _Act(Layer):
        def __init__(self, name=None):
            super().__init__()

        def forward(self, x):
            return fn(x)

    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _act_layer("ReLU", F.relu)
ReLU6 = _act_layer("ReLU6", F.relu6)
Tanh = _act_layer("Tanh", F.tanh)
Sigmoid = _act_layer("Sigmoid", F.sigmoid)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return F.gelu(x, self._approximate)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.softmax(x, self._axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.log_softmax(x, self._axis)
