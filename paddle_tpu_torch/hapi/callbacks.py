"""Training callbacks: Callback / CallbackList, ProgBarLogger,
ModelCheckpoint, EarlyStopping, LRSchedulerCallback and
config_callbacks.  Counterpart of paddle_tpu/hapi/callbacks.py (the
reference's hapi/callbacks.py), the same code."""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .progressbar import ProgressBar

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "EarlyStopping", "LRSchedulerCallback", "config_callbacks"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = dict(params or {})

    # hook surface (callbacks.py parity)
    def on_train_begin(self, logs=None): pass
    def on_train_end(self, logs=None): pass
    def on_eval_begin(self, logs=None): pass
    def on_eval_end(self, logs=None): pass
    def on_predict_begin(self, logs=None): pass
    def on_predict_end(self, logs=None): pass
    def on_epoch_begin(self, epoch, logs=None): pass
    def on_epoch_end(self, epoch, logs=None): pass
    def on_train_batch_begin(self, step, logs=None): pass
    def on_train_batch_end(self, step, logs=None): pass
    def on_eval_batch_begin(self, step, logs=None): pass
    def on_eval_batch_end(self, step, logs=None): pass
    def on_predict_batch_begin(self, step, logs=None): pass
    def on_predict_batch_end(self, step, logs=None): pass


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)

        def call(*args, **kwargs):
            for c in self.callbacks:
                getattr(c, name)(*args, **kwargs)
        return call


class ProgBarLogger(Callback):
    """callbacks.py ProgBarLogger parity."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        if self.verbose and self.params.get("epochs"):
            print(f"Epoch {epoch + 1}/{self.params['epochs']}")
        self._bar = ProgressBar(self.steps, verbose=self.verbose)

    def on_train_batch_end(self, step, logs=None):
        logs = logs or {}
        if self.verbose and (step + 1) % self.log_freq == 0:
            self._bar.update(step + 1, list(logs.items()))

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        if self.verbose:
            self._bar.update(self.steps or 0, list(logs.items()))


class ModelCheckpoint(Callback):
    """callbacks.py ModelCheckpoint: save every `save_freq` epochs."""

    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.model and self.save_dir and \
                (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.model and self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    """callbacks.py EarlyStopping parity (monitors an eval metric)."""

    def __init__(self, monitor="loss", mode="auto", patience=0,
                 min_delta=0, baseline=None, save_best_model=True,
                 save_dir=None):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.save_dir = save_dir
        self.wait = 0
        self.best = baseline
        self.stopped_epoch = 0
        self._epoch = 0
        if mode == "auto":
            mode = "min" if "loss" in monitor or "err" in monitor else "max"
        self.mode = mode

    def _better(self, cur, ref):
        if self.mode == "min":
            return cur < ref - self.min_delta
        return cur > ref + self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        self._epoch = epoch

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(np.asarray(cur).reshape(-1)[0])
        if self.best is None or self._better(cur, self.best):
            self.best = cur
            self.wait = 0
            if self.save_best_model and self.model is not None \
                    and self.save_dir:
                self.model.save(os.path.join(self.save_dir, "best_model"))
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = self._epoch
                if self.model is not None:
                    self.model.stop_training = True


class LRSchedulerCallback(Callback):
    """Steps the optimizer's LRScheduler each epoch (callbacks.py
    LRScheduler)."""

    def __init__(self, by_step=False, by_epoch=True):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "step") else None

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     verbose=2, log_freq=1, save_freq=1, save_dir=None,
                     metrics=None, force_params=True):
    """callbacks.py config_callbacks: assemble the default list.

    force_params=False (nested evaluate/predict inside fit) only sets
    params on callbacks that don't have any yet, so a user callback shared
    with the outer fit keeps its epochs/steps configuration.
    """
    user = list(callbacks or [])
    cbks = list(user)
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.insert(0, ProgBarLogger(log_freq, verbose=verbose))
    if not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    if not any(isinstance(c, LRSchedulerCallback) for c in cbks):
        cbks.append(LRSchedulerCallback())
    lst = CallbackList(cbks)
    lst.set_model(model)
    params = {"epochs": epochs, "steps": steps, "verbose": verbose,
              "metrics": metrics or []}
    for c in lst.callbacks:
        if force_params or not c.params:
            c.set_params(params)
    return lst
