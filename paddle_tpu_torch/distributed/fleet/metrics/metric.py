"""Distributed metrics: a local value aggregated over the workers.

Counterpart of paddle_tpu/distributed/fleet/metrics/metric.py: sum, max,
min, mae, rmse, acc and auc reduce each worker's local statistics
through `fleet.util.all_reduce` (torch.distributed over the default
group; a world of one without a process group).
"""
from __future__ import annotations

import builtins

import numpy as np

__all__ = ["sum", "max", "min", "auc", "mae", "rmse", "acc"]


def _util():
    from ..base.fleet_base import fleet
    if fleet.util is None:
        from ..base.util_factory import UtilBase
        return UtilBase()  # fleet not initialised: the default group
    return fleet.util


def _to_np(value, scope=None):
    if scope is not None and isinstance(value, str):
        v = scope.get(value)
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                          else v)
    if hasattr(value, "detach"):
        return value.detach().cpu().numpy()
    if hasattr(value, "numpy"):
        return value.numpy()
    return np.asarray(value)
def sum(input, scope=None, util=None):
    util = util or _util()
    return util.all_reduce(_to_np(input, scope), "sum")


def max(input, scope=None, util=None):
    util = util or _util()
    return util.all_reduce(_to_np(input, scope), "max")


def min(input, scope=None, util=None):
    util = util or _util()
    return util.all_reduce(_to_np(input, scope), "min")


def mae(abserr, total_ins_num, scope=None, util=None):
    """metric.py mae: global sum of abs error / global instance count."""
    util = util or _util()
    err = util.all_reduce(_to_np(abserr, scope), "sum")
    cnt = util.all_reduce(_to_np(total_ins_num, scope), "sum")
    return float(np.sum(err)) / float(np.sum(cnt))


def rmse(sqrerr, total_ins_num, scope=None, util=None):
    util = util or _util()
    err = util.all_reduce(_to_np(sqrerr, scope), "sum")
    cnt = util.all_reduce(_to_np(total_ins_num, scope), "sum")
    return float(np.sqrt(np.sum(err) / np.sum(cnt)))


def acc(correct, total, scope=None, util=None):
    util = util or _util()
    c = util.all_reduce(_to_np(correct, scope), "sum")
    t = util.all_reduce(_to_np(total, scope), "sum")
    return float(np.sum(c)) / float(np.sum(t))


def auc(stat_pos, stat_neg, scope=None, util=None):
    """metric.py auc: merge per-worker positive/negative histogram stats
    and integrate the ROC curve globally."""
    util = util or _util()
    pos = np.asarray(util.all_reduce(_to_np(stat_pos, scope), "sum"),
                     dtype=np.float64).ravel()
    neg = np.asarray(util.all_reduce(_to_np(stat_neg, scope), "sum"),
                     dtype=np.float64).ravel()
    # walk buckets from high score to low, trapezoidal area
    tot_pos = builtins.sum(pos)
    tot_neg = builtins.sum(neg)
    if tot_pos == 0 or tot_neg == 0:
        return 0.5
    area = 0.0
    cum_pos = 0.0
    cum_neg = 0.0
    for i in range(len(pos) - 1, -1, -1):
        new_pos = cum_pos + pos[i]
        new_neg = cum_neg + neg[i]
        area += (new_neg - cum_neg) * (cum_pos + new_pos) / 2.0
        cum_pos, cum_neg = new_pos, new_neg
    return float(area / (tot_pos * tot_neg))
