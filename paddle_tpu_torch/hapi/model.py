"""paddle.Model — the Keras-like train / eval / predict API.

Counterpart of paddle_tpu/hapi/model.py (the reference's hapi/model.py
`Model` with `fit`, `evaluate`, `predict`, `train_batch` / `eval_batch`
/ `predict_batch`, `save` / `load`, `summary`, and `Input`), driving the
dygraph path: `train_batch(inputs, labels)` runs the network's forward
(under `amp.auto_cast(level)` when `prepare` got `amp_configs`), the
loss, `loss.backward()` (no loss scaling, as in the JAX package), the
optimizer's `step()` and `clear_grad()`, updates the metrics and returns
`[loss] + metric values`.  Inputs and labels may be numpy arrays (moved
to the eager place, which the Model takes when it is built: CUDAPlace(0)
unless a `dygraph.guard(place)` says otherwise; it raises without a GPU)
or tensors.

  * `prepare(use_jit=True)` runs forward and loss as one
    `jit.StaticFunction` per inputs/labels split: recorded once, replayed
    through the executor's op kernels under torch autograd (jit/);
  * `prepare(metrics=...)`: `metric.Metric`s, updated from each batch's
    outputs and labels on the host (`compute`, `update`, `accumulate`);
  * `fit(train_data, eval_data, ...)` over an `io.DataLoader` (a
    `Dataset` is wrapped in one) with the callbacks of hapi/callbacks.py,
    returning the per-epoch logs; with `save_dir` every `save_freq`-th
    epoch commits a checkpoint (parameters, optimizer state, the LR
    scheduler's and the generator's state) through checkpoint/, a
    SIGTERM commits the last completed epoch (the preemption handler),
    and `resume=True` restarts at the epoch after the newest valid
    checkpoint; the chaos harness's kill directives (testing/chaos.py)
    count train batches here;
  * `evaluate` (mean loss and the metrics) and `predict` (outputs per
    batch, or stacked);
  * `save(path)` writes `<path>.pdparams` (and with `training`,
    `<path>.pdopt`): pickles of numpy trees, the JAX package's files, so
    either package loads the other's; `load(path)` reads them;
  * `summary()` / `summary(net)`: the JAX package's layer table and
    parameter counts.
"""
from __future__ import annotations

import os
import pickle
from contextlib import nullcontext
from typing import List

import numpy as np
import torch

from ..dygraph.base import current_place
from ..dygraph.tensor import numpy as _numpy
from ..dygraph.tensor import to_tensor
from .callbacks import config_callbacks

__all__ = ["Model", "Input", "summary"]


class Input:
    """hapi Input spec (name / shape / dtype), read by `summary`."""

    def __init__(self, shape=None, dtype="float32", name=None):
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.name = name

    def __repr__(self):
        return f"Input(name={self.name}, shape={self.shape}, " \
               f"dtype={self.dtype})"


def _to_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _make_loader(data, batch_size, shuffle, drop_last, num_workers):
    from ..io import DataLoader, Dataset
    if data is None:
        return None
    if isinstance(data, DataLoader):
        return data
    if isinstance(data, Dataset):
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=num_workers)
    raise TypeError(f"train_data must be Dataset or DataLoader, "
                    f"got {type(data)}")


def _host(v):
    """A tensor as a numpy COPY (bf16 as its exact float32; a CPU tensor's
    numpy() would alias memory the optimizer updates in place); nested
    dicts (the LR scheduler's state) and Python values kept."""
    if isinstance(v, torch.Tensor):
        return np.array(_numpy(v), copy=True)
    if isinstance(v, dict):
        return type(v)((k, _host(x)) for k, x in v.items())
    return v


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = _to_list(inputs)
        self._labels = _to_list(labels)
        self._place = current_place()
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._amp = False
        self._amp_level = "O1"
        self._use_jit = False
        self._jit_fns = {}
        self.stop_training = False

    # -- prepare ------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, use_jit=False):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        self._amp = amp_configs is not None
        self._amp_level = (amp_configs or {}).get("level", "O1") \
            if isinstance(amp_configs, dict) else "O1"
        self._use_jit = bool(use_jit)
        # one StaticFunction per inputs/labels split: the split is baked
        # into each trace, so it selects the trace
        self._jit_fns = {}
        return self

    def _jit_fn_for(self, n_in: int):
        fn = self._jit_fns.get(n_in)
        if fn is None:
            from ..jit import StaticFunction

            def fwd_loss(*args):
                outs = _to_list(self.network(*args[:n_in]))
                loss_t = self._loss(*(outs + list(args[n_in:])))
                return tuple([loss_t] + outs)

            fn = StaticFunction(fwd_loss, layer=self.network)
            self._jit_fns[n_in] = fn
        return fn

    # -- single-batch ops ---------------------------------------------------
    def _tensors(self, xs):
        return [x if isinstance(x, torch.Tensor)
                else to_tensor(np.asarray(x), place=self._place)
                for x in _to_list(xs)]

    def _loss_outs(self, inputs, labels):
        """(loss, outputs, labels): the forward and the loss (the jit or
        the eager path), under auto_cast when prepare() got
        amp_configs."""
        from ..amp import auto_cast
        if self._loss is None:
            raise RuntimeError("prepare(loss=...) required for training")
        cm = auto_cast(level=self._amp_level) if self._amp \
            else nullcontext()
        ins, lbls = self._tensors(inputs), self._tensors(labels)
        with cm:
            if self._use_jit:
                res = self._jit_fn_for(len(ins))(*(ins + lbls))
                return res[0], list(res[1:]), lbls
            outs = _to_list(self.network(*ins))
            loss = self._loss(*(outs + lbls))
        return loss, outs, lbls

    def train_batch(self, inputs, labels=None, update=True):
        """One forward, backward and optimizer step; returns [loss] plus
        the metric values."""
        self.network.train()
        loss, outs, lbls = self._loss_outs(inputs, labels)
        loss.backward()
        if update and self._optimizer is not None:
            self._optimizer.step()
            self._optimizer.clear_grad()
        return [float(loss.detach())] + self._update_metrics(outs, lbls)

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        with torch.no_grad():
            loss, outs, lbls = self._loss_outs(inputs, labels)
        return [float(loss.detach())] + self._update_metrics(outs, lbls)

    def predict_batch(self, inputs):
        self.network.eval()
        with torch.no_grad():
            out = self.network(*self._tensors(inputs))
        return [_numpy(o) for o in _to_list(out)]

    def _update_metrics(self, outs, lbls):
        """The metric protocol (metric/metrics.py): compute(pred, label)
        -> intermediate(s) -> update(*intermediates) -> accumulate()."""
        vals = []
        for m in self._metrics:
            raw = [_numpy(t) if isinstance(t, torch.Tensor)
                   else np.asarray(t) for t in (outs + lbls)]
            inter = m.compute(*raw)
            if not isinstance(inter, (list, tuple)):
                inter = (inter,)
            m.update(*inter)
            acc = m.accumulate()
            accs = acc if isinstance(acc, (list, tuple)) else [acc]
            vals.extend(float(np.asarray(a).reshape(-1)[0]) for a in accs)
        return vals

    def _metric_names(self):
        names = []
        for m in self._metrics:
            n = m.name() if callable(getattr(m, "name", None)) else str(m)
            names.extend(n if isinstance(n, (list, tuple)) else [n])
        return names

    # -- fit / evaluate / predict -------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, resume=False):
        """hapi model.py fit, with the checkpoint, preemption and resume
        contract of the module docstring; returns the per-epoch logs."""
        loader = _make_loader(train_data, batch_size, shuffle, drop_last,
                              num_workers)
        eval_loader = _make_loader(eval_data, batch_size, False, False,
                                   num_workers)
        start_epoch = 0
        ckpt_mgr = None
        if resume and save_dir is None:
            raise ValueError("fit(resume=True) needs save_dir")
        if save_dir is not None:
            from ..checkpoint import CheckpointManager
            ckpt_root = os.path.join(save_dir, "checkpoints")
            if not resume and os.path.isdir(ckpt_root):
                # a previous run's higher-numbered checkpoints would be
                # garbage-collected against this run's and hijack a later
                # resume: a non-resuming fit owns its save_dir
                import shutil
                import warnings
                warnings.warn(
                    f"fit(resume=False) discarding stale checkpoints "
                    f"under {ckpt_root}", RuntimeWarning, stacklevel=2)
                shutil.rmtree(ckpt_root)
            ckpt_mgr = CheckpointManager(ckpt_root)
            if resume:
                ckpt = ckpt_mgr.load()
                if ckpt is not None:
                    self._restore_fit_state(ckpt)
                    start_epoch = ckpt.step + 1
        steps = len(loader) if hasattr(loader, "__len__") else None
        cbks = config_callbacks(callbacks, model=self, epochs=epochs,
                                steps=steps, verbose=verbose,
                                log_freq=log_freq, save_freq=save_freq,
                                save_dir=save_dir,
                                metrics=["loss"] + self._metric_names())
        self.stop_training = False
        cbks.on_train_begin()
        history = []
        # preemption: SIGTERM commits the newest EPOCH-BOUNDARY state
        # (cached by value after every epoch): a mid-epoch snapshot would
        # resume at epoch+1 with half an epoch of updates baked in
        epoch_cache = [None]
        if ckpt_mgr is not None:
            ckpt_mgr.set_state_provider(lambda: epoch_cache[0])
            ckpt_mgr.install_preemption_handler()
        from ..testing import chaos as _chaos
        batches_done = 0
        try:
            for epoch in range(start_epoch, epochs):
                if self.stop_training:
                    break
                for m in self._metrics:
                    m.reset()
                cbks.on_epoch_begin(epoch)
                logs = {}
                for step, batch in enumerate(loader):
                    cbks.on_train_batch_begin(step)
                    ins, lbls = self._split_batch(batch)
                    res = self.train_batch(ins, lbls)
                    logs = dict(zip(["loss"] + self._metric_names(), res))
                    cbks.on_train_batch_end(step, logs)
                    batches_done += 1
                    _chaos.step_hook(batches_done)
                cbks.on_epoch_end(epoch, logs)
                history.append(logs)
                if ckpt_mgr is not None:
                    state, extra = self._fit_state()
                    extra["epoch"] = epoch
                    epoch_cache[0] = (epoch, {k: _host(v) for k, v in
                                              state.items()}, extra)
                    if (epoch + 1) % save_freq == 0 or \
                            epoch + 1 == epochs:
                        ckpt_mgr.save(epoch, state, extra=extra)
                if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                    self.evaluate(eval_loader, batch_size=batch_size,
                                  verbose=0, callbacks=callbacks)
        finally:
            if ckpt_mgr is not None:
                import sys
                # read BEFORE the except below rebinds exc_info
                propagating = sys.exc_info()[0] is not None
                try:
                    ckpt_mgr.close()  # drains in-flight saves
                except Exception:
                    # a deferred save error must not mask an exception
                    # already propagating out of the train loop
                    if not propagating:
                        raise
                    import warnings
                    warnings.warn(
                        "checkpoint manager close failed while another "
                        "exception was propagating", RuntimeWarning)
        cbks.on_train_end()
        return history

    def _fit_state(self):
        """(state, extra) of an epoch checkpoint: tensors prefixed model/
        and opt/; the LR scheduler's dict and the generator state ride
        extra."""
        from ..core.generator import get_rng_state
        state = {"model/" + k: v for k, v in
                 self.network.state_dict().items()}
        extra = {"rng": get_rng_state()}
        if self._optimizer is not None and \
                hasattr(self._optimizer, "state_dict"):
            for k, v in self._optimizer.state_dict().items():
                if k == "LR_Scheduler":
                    extra["lr_scheduler"] = {
                        kk: float(vv) for kk, vv in v.items()}
                else:
                    state["opt/" + k] = v
        return state, extra

    def _restore_fit_state(self, ckpt):
        params = {k[len("model/"):]: v for k, v in ckpt.state.items()
                  if k.startswith("model/")}
        self.network.set_state_dict(params)
        opt_state = {k[len("opt/"):]: v for k, v in ckpt.state.items()
                     if k.startswith("opt/")}
        if "rng" in ckpt.extra:
            from ..core.generator import set_rng_state
            set_rng_state(ckpt.extra["rng"])
        if "lr_scheduler" in ckpt.extra:
            opt_state["LR_Scheduler"] = ckpt.extra["lr_scheduler"]
        if opt_state and self._optimizer is not None and \
                hasattr(self._optimizer, "set_state_dict"):
            self._optimizer.set_state_dict(opt_state)

    def _split_batch(self, batch):
        batch = _to_list(batch)
        n_in = max(1, len(self._inputs)) if self._inputs else 1
        if len(batch) == 1:
            return batch, []
        if self._inputs:
            return batch[:n_in], batch[n_in:]
        return batch[:-1] if len(batch) > 1 else batch, batch[-1:]

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None):
        loader = _make_loader(eval_data, batch_size, False, False,
                              num_workers)
        for m in self._metrics:
            m.reset()
        cbks = config_callbacks(callbacks, model=self, steps=None,
                                verbose=verbose,
                                metrics=["loss"] + self._metric_names(),
                                force_params=False)
        cbks.on_eval_begin()
        logs = {}
        losses = []
        for step, batch in enumerate(loader):
            ins, lbls = self._split_batch(batch)
            res = self.eval_batch(ins, lbls)
            losses.append(res[0])
            logs = dict(zip(["loss"] + self._metric_names(), res))
        logs["loss"] = float(np.mean(losses)) if losses else 0.0
        cbks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=0):
        loader = _make_loader(test_data, batch_size, False, False,
                              num_workers)
        outputs: List[List[np.ndarray]] = []
        for batch in loader:
            ins, _ = self._split_batch(batch)
            outputs.append(self.predict_batch(ins))
        # transpose: a list over outputs, each a list over batches
        n_out = len(outputs[0]) if outputs else 0
        per_out = [[b[i] for b in outputs] for i in range(n_out)]
        if stack_outputs:
            per_out = [np.concatenate(o, axis=0) for o in per_out]
        return per_out

    # -- save / load / summary ----------------------------------------------
    def save(self, path, training=True):
        """<path>.pdparams (+ .pdopt when training), each written to a
        temporary file and renamed into place (checkpoint/atomic.py)."""
        from ..checkpoint.atomic import atomic_write
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with atomic_write(path + ".pdparams") as f:
            pickle.dump(_host(dict(self.network.state_dict())), f,
                        protocol=4)
        if training and self._optimizer is not None and \
                hasattr(self._optimizer, "state_dict"):
            with atomic_write(path + ".pdopt") as f:
                pickle.dump(_host(dict(self._optimizer.state_dict())), f,
                            protocol=4)

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        with open(path + ".pdparams", "rb") as f:
            self.network.set_state_dict(pickle.load(f))
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(opt_path):
            with open(opt_path, "rb") as f:
                self._optimizer.set_state_dict(pickle.load(f))

    def parameters(self, *args, **kwargs):
        return list(self.network.parameters(*args, **kwargs))

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size or
                       [i.shape for i in self._inputs] or None)


def summary(net, input_size=None, dtypes=None):
    """hapi summary: the layer table and parameter counts.  Weight-tied
    parameters (BERT's MLM decoder sharing the word embedding) count
    once."""
    rows = []
    total = 0
    trainable = 0
    seen = set()
    for name, sub in net.named_sublayers(include_self=True):
        n_params = 0
        for p in sub.parameters(recurse=False):
            if id(p) in seen:
                continue
            seen.add(id(p))
            size = int(np.prod(tuple(p.shape)))
            n_params += size
            if p.requires_grad:
                trainable += size
        total += n_params
        rows.append((name or type(sub).__name__, type(sub).__name__,
                     n_params))
    lines = [f"{'Layer':<40}{'Type':<28}{'Params':>12}", "-" * 80]
    for r in rows:
        lines.append(f"{r[0]:<40}{r[1]:<28}{r[2]:>12,}")
    lines += ["-" * 80, f"Total params: {total:,}",
              f"Trainable params: {trainable:,}"]
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}
