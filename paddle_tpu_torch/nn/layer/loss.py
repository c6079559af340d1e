"""paddle.nn loss layers (counterpart of paddle_tpu/nn/layer/loss.py):
CrossEntropyLoss and MSELoss over the functional forms.  The other loss
layers wait for ROADMAP.md Queue 1, The rest."""
from __future__ import annotations

from ...dygraph.layers import Layer
from .. import functional as F

__all__ = ["CrossEntropyLoss", "MSELoss"]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        self._weight = weight
        self._ignore_index = ignore_index
        self._reduction = reduction
        self._soft_label = soft_label
        self._axis = axis
        self._use_softmax = use_softmax

    def forward(self, input, label):
        return F.cross_entropy(input, label, self._weight,
                               self._ignore_index, self._reduction,
                               self._soft_label, self._axis,
                               self._use_softmax)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self._reduction)
