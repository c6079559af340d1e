"""The PS runtime behind fleet.init_worker / init_server / run_server /
stop_worker.

Counterpart of paddle_tpu/distributed/ps/the_one_ps.py: the role maker
says which endpoint this server serves and how many trainers it waits
for; a worker connects a KVClient to every server.  The KV server and
client are kv_server.py's.
"""
from __future__ import annotations

__all__ = ["ps_runtime", "PSRuntime"]


class PSRuntime:
    def __init__(self):
        self._server = None
        self._client = None

    # fleet.init_worker()
    def init_worker(self, fleet):
        from .kv_server import KVClient
        eps = fleet.server_endpoints()
        if not eps:
            raise RuntimeError("no pserver endpoints configured "
                               "(PADDLE_PSERVERS_IP_PORT_LIST)")
        self._client = KVClient(eps)
        self._client.wait_server_ready()
        fleet._ps_client = self._client

    # fleet.init_server() / run_server()
    def init_server(self, fleet, *args, **kwargs):
        from .kv_server import KVServer
        idx = fleet.server_index()
        ep = fleet.server_endpoints()[idx]
        self._server = KVServer(ep, num_trainers=fleet.worker_num())
        fleet._ps_server = self._server

    def run_server(self, fleet):
        if self._server is None:
            self.init_server(fleet)
        self._server.serve()  # blocks (listen_and_serv semantics)

    def stop_worker(self, fleet):
        if self._client is not None:
            self._client.shutdown_servers()
            self._client.close()


_runtime = PSRuntime()


def ps_runtime() -> PSRuntime:
    return _runtime
