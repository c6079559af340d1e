"""Gloo-analog: CPU-side barrier / all_gather / all_reduce for the fleet
control plane.

Counterpart of paddle_tpu/distributed/gloo.py (Paddle's GlooWrapper and
the python `Gloo` of fleet's role_maker, RENDEZVOUS.HDFS/FILE/HTTP), with
the same store layout and env contract.

Scope: the DENSE collective path is torch.distributed (NCCL or the gloo
backend) and never touches this; what Gloo does for fleet jobs is
host-side coordination — role-maker barriers, UtilBase all_gather of
small python objects, PS init fences.  So this is a small store-based
implementation with two rendezvous backends:

  * FILE  — a shared directory (single host or NFS): each rank writes
    `<prefix>/<world>/<generation>/<rank>` and polls for its peers —
    byte-for-byte the HdfsStore pattern with local files.
  * HTTP  — the parameter server's KV server (distributed/ps/
    kv_server.py) as the store, over its OP_SET / OP_PULL plane (the
    reference's http_server.py role).

Generation counters make barriers/gathers reusable (no stale-key
aliasing between consecutive collectives).
"""
from __future__ import annotations

import os
import pickle
import time
from typing import Any, List, Optional

__all__ = ["Gloo", "RENDEZVOUS", "gloo_from_env"]


class RENDEZVOUS:
    HDFS = 1   # accepted for parity; maps to FILE semantics on a mount
    FILE = 2
    HTTP = 3


class _FileStore:
    def __init__(self, path: str, prefix: str = ""):
        self.root = os.path.join(path, prefix or "gloo")
        os.makedirs(self.root, exist_ok=True)

    def set(self, key: str, blob: bytes):
        p = os.path.join(self.root, key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, p)  # atomic publish

    def get(self, key: str) -> Optional[bytes]:
        p = os.path.join(self.root, key)
        try:
            with open(p, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def delete(self, key: str):
        try:
            os.remove(os.path.join(self.root, key))
        except OSError:
            pass


class _KVStore:
    """The HTTP rendezvous store: the parameter server's KV server."""

    def __init__(self, endpoint: str, prefix: str = ""):
        from .ps.kv_server import KVClient
        self._c = KVClient([endpoint])
        self._prefix = prefix or "gloo"

    def set(self, key: str, blob: bytes):
        import numpy as np
        self._c.set_param(f"{self._prefix}/{key}",
                          np.frombuffer(blob, dtype=np.uint8).copy())

    def get(self, key: str) -> Optional[bytes]:
        try:
            arr = self._c.pull(f"{self._prefix}/{key}")
        except KeyError:
            return None
        import numpy as np
        return np.asarray(arr, dtype=np.uint8).tobytes()

    def delete(self, key: str):
        # the KV server has no delete: overwrite with an empty value
        # (get() reads a zero-length value as present, so a stale key
        # shrinks to nothing rather than going away)
        import numpy as np
        try:
            self._c.set_param(f"{self._prefix}/{key}",
                              np.zeros((0,), np.uint8))
        except (ConnectionError, OSError):
            pass


class Gloo:
    """Barrier + object collectives over a rendezvous store."""

    def __init__(self):
        self._store = None
        self._rank = 0
        self._size = 1
        self._gen = {}
        self._timeout = float(os.environ.get(
            "PADDLE_GLOO_RUN_TIMEOUT_SECONDS", "300"))
        self._is_initialized = False

    # -- reference Gloo.init signature (role_maker.py:65) -------------------
    def init(self, rendezvous, role, role_id, worker_num, server_num=0,
             need_init_all=False, kwargs=None):
        kwargs = kwargs or {}
        prefix = kwargs.get("store.prefix", "")
        if rendezvous in (RENDEZVOUS.FILE, RENDEZVOUS.HDFS):
            path = kwargs.get("dfs.path", "")
            if not path:
                raise ValueError("Gloo FILE rendezvous needs dfs.path")
            self._store = _FileStore(path, prefix)
        elif rendezvous == RENDEZVOUS.HTTP:
            host = kwargs.get("http.host", "")
            port = kwargs.get("http.port", "")
            if not host or not port:
                raise ValueError("Gloo HTTP rendezvous needs http.host/port")
            self._store = _KVStore(f"{host}:{port}", prefix)
        else:
            raise ValueError(f"unknown rendezvous {rendezvous}")
        self._rank = int(role_id)
        # the size of THIS role's world (reference: servers rendezvous in
        # their own comm, role_maker.py _init_fs role="SERVER")
        self._size = int(server_num if (str(role).lower() == "server"
                                        and server_num) else worker_num)
        self._role = role
        self._is_initialized = True

    def rank(self):
        return self._rank

    def size(self):
        return self._size

    def is_initialized(self):
        return self._is_initialized

    # -- collectives --------------------------------------------------------
    def _next_gen(self, world: str) -> int:
        g = self._gen.get(world, 0)
        self._gen[world] = g + 1
        return g

    def _gather_blobs(self, world: str, payload: bytes) -> List[bytes]:
        gen = self._next_gen(world)
        base = f"{world}/{gen}"
        self._store.set(f"{base}/{self._rank}", payload)
        if gen > 1:
            # safe-point GC: we completed gen-1, so every peer WROTE its
            # gen-1 blob, and writing gen-1 proves that peer finished
            # READING all of gen-2 — our gen-2 blob can never be needed
            # again.  (gen-1 is NOT safe: a slow peer may still be
            # polling it.)  Keeps a long-running job at <= 2 blobs per
            # rank per world instead of one per collective.
            self._store.delete(f"{world}/{gen - 2}/{self._rank}")
        out: List[Optional[bytes]] = [None] * self._size
        deadline = time.time() + self._timeout
        while True:
            missing = False
            for r in range(self._size):
                if out[r] is None:
                    out[r] = self._store.get(f"{base}/{r}")
                    if out[r] is None:
                        missing = True
            if not missing:
                return out  # type: ignore[return-value]
            if time.time() > deadline:
                absent = [r for r in range(self._size) if out[r] is None]
                raise TimeoutError(
                    f"gloo {world} collective gen {gen}: ranks {absent} "
                    f"absent after {self._timeout:.0f}s")
            time.sleep(0.02)

    def barrier(self, comm_world: str = "worker"):
        self._gather_blobs(f"barrier/{comm_world}", b"1")

    def all_gather(self, obj: Any, comm_world: str = "worker") -> List[Any]:
        blobs = self._gather_blobs(f"gather/{comm_world}",
                                   pickle.dumps(obj))
        return [pickle.loads(b) for b in blobs]

    def all_reduce(self, x, fn="sum", comm_world: str = "worker"):
        import numpy as np
        vals = self.all_gather(np.asarray(x), comm_world)
        if fn in ("sum", "SUM"):
            return sum(vals[1:], vals[0])
        if fn in ("max", "MAX"):
            return np.maximum.reduce(vals)
        if fn in ("min", "MIN"):
            return np.minimum.reduce(vals)
        raise ValueError(f"unknown reduce fn {fn!r}")


def gloo_from_env(role: str = "worker") -> Optional[Gloo]:
    """Build a Gloo from the launcher env contract
    (PADDLE_GLOO_RENDEZVOUS / PADDLE_GLOO_FS_PATH /
    PADDLE_GLOO_HTTP_ENDPOINT — the reference fleet launch variables);
    returns None when no rendezvous is configured.

    rank/size are ROLE-aware: workers index by PADDLE_TRAINER_ID over
    PADDLE_TRAINERS_NUM, servers by their endpoint's position in
    PADDLE_PSERVERS_IP_PORT_LIST (or PADDLE_PSERVER_ID), so the two
    role worlds never alias each other's store keys."""
    rdv = os.environ.get("PADDLE_GLOO_RENDEZVOUS", "")
    if not rdv:
        return None
    g = Gloo()
    if role == "server":
        servers = [e for e in os.environ.get(
            "PADDLE_PSERVERS_IP_PORT_LIST", "").split(",") if e]
        size = max(1, len(servers))
        rank_env = os.environ.get("PADDLE_PSERVER_ID")
        if rank_env is not None:
            rank = int(rank_env)
        else:
            ep = (f"{os.environ.get('POD_IP', '127.0.0.1')}:"
                  f"{os.environ.get('PADDLE_PORT', '0')}")
            if ep not in servers:
                # a silent rank-0 fallback would let several servers
                # claim the same rank and alias store keys — fail loud
                raise ValueError(
                    f"gloo server rendezvous: endpoint {ep!r} not in "
                    f"PADDLE_PSERVERS_IP_PORT_LIST {servers}; set "
                    "PADDLE_PSERVER_ID explicitly or fix POD_IP/"
                    "PADDLE_PORT")
            rank = servers.index(ep)
    else:
        rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        size = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    kwargs = {
        # run-unique namespace: a restarted/elastic incarnation (or a
        # second job sharing the same dfs.path) must not consume a
        # previous run's blobs — the launcher stamps a fresh id per
        # incarnation; collectives can't survive a MID-RUN single-rank
        # restart (peers are mid-generation), which matches the
        # reference gloo's behavior (rendezvous is per-job)
        "store.prefix": "gloo_" + os.environ.get(
            "PADDLE_GLOO_RUN_ID", os.environ.get("PADDLE_JOB_ID", "run0")),
    }
    rdv_i = int(rdv)
    if rdv_i in (RENDEZVOUS.FILE, RENDEZVOUS.HDFS):
        kwargs["dfs.path"] = os.environ.get("PADDLE_GLOO_FS_PATH", "")
    else:
        ep = os.environ.get("PADDLE_GLOO_HTTP_ENDPOINT", "")
        host, _, port = ep.rpartition(":")
        kwargs["http.host"] = host
        kwargs["http.port"] = port
    g.init(rdv_i, role, rank, worker_num=size, server_num=size,
           kwargs=kwargs)
    return g
