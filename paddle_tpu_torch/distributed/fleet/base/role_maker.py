"""RoleMaker: the job's topology from the environment.

Counterpart of paddle_tpu/distributed/fleet/base/role_maker.py.
PaddleCloudRoleMaker reads the launcher's contract: in collective mode
PADDLE_TRAINER_ID and PADDLE_TRAINER_ENDPOINTS; in parameter-server mode
also TRAINING_ROLE (TRAINER or PSERVER), PADDLE_PSERVERS_IP_PORT_LIST and,
for a server, POD_IP and PADDLE_PORT, whose endpoint's position in the
server list is the server's index.  UserDefinedRoleMaker takes the same
topology as arguments.  Barrier and all-gather go through the gloo
rendezvous store (distributed/gloo.py) when the launcher configured one
(PADDLE_GLOO_RENDEZVOUS), in the role's own comm world (workers and
servers never share keys), else through torch.distributed when a process
group is initialised (a world of one otherwise).
"""
from __future__ import annotations

import os
from enum import IntEnum

__all__ = ["Role", "RoleMakerBase", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker"]


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

    # cached per instance: each role maker has its own role, and the env
    # may be set after an earlier role maker was made
    def _get_gloo(self):
        if not getattr(self, "_gloo_checked", False):
            from ...gloo import gloo_from_env
            self._gloo = gloo_from_env(
                "worker" if self.is_worker() else "server")
            self._gloo_checked = True
        return self._gloo

    def _default_world(self):
        # a server's role maker never lands on the workers' store keys
        # (different world sizes would alias barriers and gathers)
        return "worker" if self.is_worker() else "server"

    def _barrier(self, comm_world=None):
        g = self._get_gloo()
        if g is not None:
            g.barrier(comm_world or self._default_world())
            return
        from .util_factory import UtilBase
        UtilBase().barrier()

    def _all_gather(self, input, comm_world=None):
        g = self._get_gloo()
        if g is not None:
            return g.all_gather(input, comm_world or self._default_world())
        from .util_factory import UtilBase
        return UtilBase().all_gather(input)


class PaddleCloudRoleMaker(RoleMakerBase):
    """The role from the launcher's environment (module docstring)."""

    def __init__(self, is_collective=False, **kwargs):
        super().__init__()
        self._is_collective = is_collective
        self._kwargs = kwargs

    def _generate_role(self):
        self._worker_endpoints = [
            e for e in os.environ.get(
                "PADDLE_TRAINER_ENDPOINTS", "").split(",") if e]
        if self._is_collective:
            self._current_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
            self._role = Role.WORKER
        else:
            role = os.environ.get("TRAINING_ROLE", "TRAINER").upper()
            self._server_endpoints = [
                e for e in os.environ.get(
                    "PADDLE_PSERVERS_IP_PORT_LIST", "").split(",") if e]
            if role == "PSERVER":
                self._role = Role.SERVER
                ep = (f"{os.environ.get('POD_IP', '127.0.0.1')}:"
                      f"{os.environ.get('PADDLE_PORT', '0')}")
                self._current_id = (self._server_endpoints.index(ep)
                                    if ep in self._server_endpoints else 0)
            else:
                self._role = Role.WORKER
                self._current_id = int(os.environ.get(
                    "PADDLE_TRAINER_ID", "0"))
        if not self._worker_endpoints:
            self._worker_endpoints = ["127.0.0.1:0"]
        self._role_is_generated = True


class UserDefinedRoleMaker(RoleMakerBase):
    """An explicit topology, collective or parameter-server."""

    def __init__(self, is_collective=False, current_id=0, role=Role.WORKER,
                 worker_num=1, worker_endpoints=None, server_endpoints=None,
                 **kwargs):
        super().__init__()
        self._is_collective = is_collective
        self._current_id = current_id
        self._role = role
        self._worker_endpoints = worker_endpoints or \
            [f"127.0.0.1:{6170 + i}" for i in range(worker_num)]
        self._server_endpoints = server_endpoints or []

    def _generate_role(self):
        self._role_is_generated = True
