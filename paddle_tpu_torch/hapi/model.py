"""paddle.Model — the Keras-like train / eval / predict API, one batch at a
time.

Counterpart of paddle_tpu/hapi/model.py (the reference's hapi/model.py
`Model`), driving the dygraph path: `train_batch(inputs, labels)` runs
the network's forward (under `amp.auto_cast(level)` when `prepare` got
`amp_configs`), the loss, `loss.backward()` (no loss scaling, as in the
JAX package), the optimizer's `step()` and `clear_grad()`, and returns
`[loss]`.  Inputs and labels may be numpy arrays (moved to the eager
place, which the Model takes when it is built: CUDAPlace(0) unless a
`dygraph.guard(place)` says otherwise; it raises without a GPU) or
tensors.

Not ported yet, each raising: `fit`, `evaluate` and `predict` (they need
`io.DataLoader`, `metric/` and hapi/callbacks.py), `save` / `load`
(`checkpoint/`), `summary`, `prepare(use_jit=True)` (`jit/`) and
`metrics` (`metric/`) — ROADMAP.md Queue 1, The rest.
"""
from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from ..dygraph.base import current_place
from ..dygraph.tensor import numpy as _numpy
from ..dygraph.tensor import to_tensor

__all__ = ["Model"]

_QUEUE = "ROADMAP.md Queue 1, The rest"


def _to_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _not_ported(what, needs):
    raise NotImplementedError(f"Model.{what} needs {needs}, not ported yet "
                              f"({_QUEUE})")


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = _to_list(inputs)
        self._labels = _to_list(labels)
        self._place = current_place()
        self._optimizer = None
        self._loss = None
        self._amp = False
        self._amp_level = "O1"
        self.stop_training = False

    # -- prepare ------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, use_jit=False):
        if use_jit:
            _not_ported("prepare(use_jit=True)", "jit/ (to_static)")
        if metrics:
            _not_ported("prepare(metrics=...)", "metric/")
        self._optimizer = optimizer
        self._loss = loss
        self._amp = amp_configs is not None
        self._amp_level = (amp_configs or {}).get("level", "O1") \
            if isinstance(amp_configs, dict) else "O1"
        return self

    # -- single-batch ops ---------------------------------------------------
    def _tensors(self, xs):
        return [x if isinstance(x, torch.Tensor)
                else to_tensor(np.asarray(x), place=self._place)
                for x in _to_list(xs)]

    def _loss_outs(self, inputs, labels):
        """(loss, outputs): the forward and the loss, under auto_cast when
        prepare() got amp_configs."""
        from ..amp import auto_cast
        if self._loss is None:
            raise RuntimeError("prepare(loss=...) required for training")
        cm = auto_cast(level=self._amp_level) if self._amp \
            else nullcontext()
        with cm:
            outs = _to_list(self.network(*self._tensors(inputs)))
            loss = self._loss(*(outs + self._tensors(labels)))
        return loss, outs

    def train_batch(self, inputs, labels=None, update=True):
        """One forward, backward and optimizer step; returns [loss]."""
        self.network.train()
        loss, _ = self._loss_outs(inputs, labels)
        loss.backward()
        if update and self._optimizer is not None:
            self._optimizer.step()
            self._optimizer.clear_grad()
        return [float(loss.detach())]

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        with torch.no_grad():
            loss, _ = self._loss_outs(inputs, labels)
        return [float(loss.detach())]

    def predict_batch(self, inputs):
        self.network.eval()
        with torch.no_grad():
            out = self.network(*self._tensors(inputs))
        return [_numpy(o) for o in _to_list(out)]

    def parameters(self, *args, **kwargs):
        return list(self.network.parameters(*args, **kwargs))

    # -- not ported yet -----------------------------------------------------
    def fit(self, *args, **kwargs):
        _not_ported("fit", "io.DataLoader and hapi/callbacks.py")

    def evaluate(self, *args, **kwargs):
        _not_ported("evaluate", "io.DataLoader and metric/")

    def predict(self, *args, **kwargs):
        _not_ported("predict", "io.DataLoader")

    def save(self, *args, **kwargs):
        _not_ported("save", "checkpoint/")

    def load(self, *args, **kwargs):
        _not_ported("load", "checkpoint/")

    def summary(self, *args, **kwargs):
        _not_ported("summary", "hapi's summary over Input specs")
