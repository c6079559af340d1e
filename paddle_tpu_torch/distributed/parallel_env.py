"""ParallelEnv: the PADDLE_* environment contract of a launched rank.

Counterpart of paddle_tpu/distributed/parallel_env.py.  The launcher
(`distributed.launch`) and `distributed.spawn` set, for each process:
PADDLE_TRAINER_ID (its rank), PADDLE_TRAINERS_NUM (the world size),
PADDLE_CURRENT_ENDPOINT, PADDLE_TRAINER_ENDPOINTS (rank 0's is the
rendezvous of `init_parallel_env`) and FLAGS_selected_gpus (the CUDA
device of the rank: one process per rank, one device each).
"""
from __future__ import annotations

import os

__all__ = ["ParallelEnv"]


class ParallelEnv:
    def __init__(self):
        self._rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self._world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self._device_id = int(os.environ.get("FLAGS_selected_gpus", "0")
                              .split(",")[0])
        self._current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._trainer_endpoints = [e for e in eps.split(",") if e]
        self._nrings = int(os.environ.get("FLAGS_nccl_nrings", "1"))

    @property
    def rank(self):
        return self._rank

    @property
    def world_size(self):
        return self._world_size

    @property
    def device_id(self):
        return self._device_id

    @property
    def current_endpoint(self):
        return self._current_endpoint

    @property
    def trainer_endpoints(self):
        return self._trainer_endpoints

    @property
    def nrings(self):
        return self._nrings

    # legacy aliases (parallel.py exposes local_rank/nranks)
    local_rank = rank
    nranks = world_size
    dev_id = device_id
