"""paddle.metric — training metrics.

Counterpart of paddle_tpu/metric/metrics.py (the reference's
paddle/metric/metrics.py: the Metric base, Accuracy, Precision, Recall,
Auc), the same code: `compute` turns one batch's predictions and labels
into numpy intermediates and `update` accumulates them on the host.  A
torch tensor (on the card too) is copied to the host once, where numpy
reads it.
"""
from __future__ import annotations

import abc
from typing import List, Sequence, Union

import numpy as np



def _np(x):
    """A numpy array of an array-like or a torch tensor (bfloat16, which
    numpy lacks, as float32)."""
    if isinstance(x, np.ndarray):
        return x
    if hasattr(x, "detach") and hasattr(x, "cpu"):
        from ..dygraph.tensor import numpy as _t_numpy
        return _t_numpy(x)
    return np.asarray(x)

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc"]


class Metric(abc.ABC):
    def __init__(self):
        pass

    @abc.abstractmethod
    def name(self):
        raise NotImplementedError

    @abc.abstractmethod
    def update(self, *args):
        raise NotImplementedError

    @abc.abstractmethod
    def accumulate(self):
        raise NotImplementedError

    @abc.abstractmethod
    def reset(self):
        raise NotImplementedError

    def compute(self, *args):
        """Optional traceable pre-processing of (pred, label) whose outputs
        feed update(); default passes through."""
        return args


class Accuracy(Metric):
    """Top-k accuracy. update() takes the per-sample correctness matrix
    produced by compute() (shape [batch, topk])."""

    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label):
        pred = _np(pred)
        label = _np(label)
        idx = np.argsort(-pred, axis=-1)[..., :self.maxk]
        if label.ndim == pred.ndim:  # one-hot / index column
            if label.shape[-1] == 1:
                label = label[..., 0]
            else:
                label = label.argmax(-1)
        correct = (idx == label[..., None]).astype(np.float32)
        return correct

    def update(self, correct):
        correct = _np(correct).reshape(-1, correct.shape[-1])
        num = correct.shape[0]
        for i, k in enumerate(self.topk):
            self.total[i] += float(correct[:, :k].sum())
        self.count += num
        res = [self.total[i] / max(1, self.count)
               for i in range(len(self.topk))]
        return res[0] if len(res) == 1 else res

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = 0

    def accumulate(self):
        res = [t / max(1, self.count) for t in self.total]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision: TP / (TP + FP).  pred is probability of class 1."""

    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = np.rint(_np(preds)).astype(np.int64).reshape(-1)
        labels = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return float(self.tp) / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall: TP / (TP + FN)."""

    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = np.rint(_np(preds)).astype(np.int64).reshape(-1)
        labels = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return float(self.tp) / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC via the reference's thresholded-bucket trapezoid estimate
    (metrics.py Auc; same algorithm as the auc op)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self.curve = curve
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds)
        if preds.ndim == 2 and preds.shape[1] >= 2:
            pos_prob = preds[:, 1]
        else:
            pos_prob = preds.reshape(-1)
        labels = _np(labels).reshape(-1)
        bins = (pos_prob * self.num_thresholds).astype(np.int64)
        bins = np.clip(bins, 0, self.num_thresholds)
        n = self.num_thresholds + 1
        pos_mask = labels != 0
        self._stat_pos += np.bincount(bins[pos_mask], minlength=n)
        self._stat_neg += np.bincount(bins[~pos_mask], minlength=n)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    @staticmethod
    def trapezoid_area(x1, x2, y1, y2):
        return abs(x1 - x2) * (y1 + y2) / 2.0

    def accumulate(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        idx = self.num_thresholds
        while idx >= 0:
            new_pos = tot_pos + self._stat_pos[idx]
            new_neg = tot_neg + self._stat_neg[idx]
            auc += self.trapezoid_area(tot_neg, new_neg, tot_pos, new_pos)
            tot_pos, tot_neg = new_pos, new_neg
            idx -= 1
        denom = tot_pos * tot_neg
        return float(auc / denom) if denom else 0.0

    def name(self):
        return self._name
