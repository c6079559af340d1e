"""UtilBase: worker collectives on host values, and file sharding.

Counterpart of paddle_tpu/distributed/fleet/base/util_factory.py
(`fleet.util`): all_reduce / barrier / all_gather over the workers, on
numpy values and Python objects, through torch.distributed (a world of
one when no process group is initialised).  A failed collective raises;
nothing falls back to the local value.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["UtilBase", "UtilFactory"]


def _group():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist
    return None


def _device(dist):
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class UtilBase:
    def __init__(self):
        self.role_maker = None

    def _set_role_maker(self, role_maker):
        self.role_maker = role_maker

    def all_reduce(self, input, mode="sum", comm_world="worker"):
        """`mode` ("sum", "max", "min") of `input` over the workers."""
        arr = np.asarray(input)
        dist = _group()
        if dist is None:
            return arr
        op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
              "min": dist.ReduceOp.MIN}[mode]
        t = torch.from_numpy(np.array(arr, copy=True)).to(_device(dist))
        dist.all_reduce(t, op=op)
        return t.cpu().numpy().reshape(arr.shape)

    def barrier(self, comm_world="worker"):
        dist = _group()
        if dist is not None:
            dist.barrier()

    def all_gather(self, input, comm_world="worker"):
        """Every worker's `input` (any picklable value), in rank order."""
        dist = _group()
        if dist is None:
            return [input]
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, input)
        return out

    def get_file_shard(self, files):
        """This worker's even share of `files` (the dataset contract)."""
        if not isinstance(files, list):
            raise TypeError("files should be a list of file paths")
        n = self.role_maker.worker_num() if self.role_maker else 1
        idx = self.role_maker.worker_index() if self.role_maker else 0
        per, rem = divmod(len(files), n)
        begin = per * idx + min(idx, rem)
        end = begin + per + (1 if idx < rem else 0)
        return files[begin:end]

    def print_on_rank(self, message, rank_id=0):
        me = self.role_maker.worker_index() if self.role_maker else 0
        if me == rank_id:
            print(message)


class UtilFactory:
    def _create_util(self, context=None):
        util = UtilBase()
        if context and "role_maker" in context:
            util._set_role_maker(context["role_maker"])
        return util
