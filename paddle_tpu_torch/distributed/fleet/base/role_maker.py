"""RoleMaker: the job's topology from the environment.

Counterpart of paddle_tpu/distributed/fleet/base/role_maker.py, the
collective role: PaddleCloudRoleMaker reads PADDLE_TRAINER_ID and
PADDLE_TRAINER_ENDPOINTS (the launcher's contract); UserDefinedRoleMaker
takes them as arguments.  The parameter-server roles (TRAINING_ROLE=
PSERVER, server endpoints) are not ported (ROADMAP.md Queue 1,
Distribution) and raise.  Barrier and all-gather go through
torch.distributed when a process group is initialised (a world of one
otherwise).
"""
from __future__ import annotations

import os
from enum import IntEnum

__all__ = ["Role", "RoleMakerBase", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker"]

_LATER = "ROADMAP.md Queue 1, Distribution"


class Role(IntEnum):
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class RoleMakerBase:
    def __init__(self):
        self._worker_endpoints = []
        self._server_endpoints = []
        self._role_is_generated = False
        self._role = None
        self._current_id = -1

    def _generate_role(self):
        raise NotImplementedError

    def _ensure(self):
        if not self._role_is_generated:
            self._generate_role()

    def is_worker(self):
        self._ensure()
        return self._role == Role.WORKER

    def is_server(self):
        self._ensure()
        return self._role == Role.SERVER

    def is_first_worker(self):
        self._ensure()
        return self._role == Role.WORKER and self._current_id == 0

    def worker_index(self):
        self._ensure()
        return self._current_id

    def server_index(self):
        self._ensure()
        return self._current_id

    def worker_num(self):
        self._ensure()
        n = len(self._worker_endpoints)
        if n <= 1:
            n = max(n, int(os.environ.get("PADDLE_TRAINERS_NUM", "1")))
        return max(1, n)

    def server_num(self):
        self._ensure()
        return len(self._server_endpoints)

    def get_trainer_endpoints(self):
        self._ensure()
        return self._worker_endpoints

    def get_pserver_endpoints(self):
        self._ensure()
        return self._server_endpoints

    def role_id(self):
        return (self.worker_index() if self.is_worker()
                else self.server_index())

    def _barrier(self, comm_world=None):
        from .util_factory import UtilBase
        UtilBase().barrier()

    def _all_gather(self, input, comm_world=None):
        from .util_factory import UtilBase
        return UtilBase().all_gather(input)


class PaddleCloudRoleMaker(RoleMakerBase):
    """The collective role from PADDLE_TRAINER_ID / PADDLE_TRAINER_ENDPOINTS."""

    def __init__(self, is_collective=False, **kwargs):
        super().__init__()
        self._is_collective = is_collective
        self._kwargs = kwargs

    def _generate_role(self):
        if not self._is_collective and os.environ.get(
                "TRAINING_ROLE", "TRAINER").upper() == "PSERVER":
            raise NotImplementedError(
                f"the parameter-server role (TRAINING_ROLE=PSERVER) is not "
                f"ported yet ({_LATER})")
        self._worker_endpoints = [
            e for e in os.environ.get(
                "PADDLE_TRAINER_ENDPOINTS", "").split(",") if e]
        self._current_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self._role = Role.WORKER
        if not self._worker_endpoints:
            self._worker_endpoints = ["127.0.0.1:0"]
        self._role_is_generated = True


class UserDefinedRoleMaker(RoleMakerBase):
    """An explicit collective topology."""

    def __init__(self, is_collective=False, current_id=0, role=Role.WORKER,
                 worker_num=1, worker_endpoints=None, server_endpoints=None,
                 **kwargs):
        super().__init__()
        if role != Role.WORKER or server_endpoints:
            raise NotImplementedError(
                f"parameter-server roles are not ported yet ({_LATER})")
        self._is_collective = is_collective
        self._current_id = current_id
        self._role = role
        self._worker_endpoints = worker_endpoints or \
            [f"127.0.0.1:{6170 + i}" for i in range(worker_num)]

    def _generate_role(self):
        self._role_is_generated = True
