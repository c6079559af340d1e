"""paddle.distributed.spawn: start the ranks of a job as processes.

Counterpart of paddle_tpu/distributed/spawn.py.  Each of `nprocs`
processes (multiprocessing's "spawn" start method, so CUDA is safe in
the children) runs `func(*args)` under the PADDLE_* contract
(parallel_env.py): its rank, the world size, the endpoints on free
local ports, and FLAGS_selected_gpus, its CUDA device.  The devices are
`selected_devices` (a comma-separated list, one entry a process, or a
list; "0,0" puts two ranks on one card, which gloo allows and NCCL
refuses), else rank i gets device i.  `join()` waits for every process
and, when one fails, stops the others and raises with its traceback.
"""
from __future__ import annotations

import multiprocessing
import os
import socket
import sys
import traceback

__all__ = ["spawn", "get_free_ports", "MultiprocessContext"]


def get_free_ports(n):
    ports, socks = [], []
    for _ in range(n):
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        socks.append(s)
    for s in socks:
        s.close()
    return ports


def _wrap(func, i, nprocs, endpoints, devices, args, error_queue):
    env = os.environ
    env["PADDLE_TRAINER_ID"] = str(i)
    env["PADDLE_TRAINERS_NUM"] = str(nprocs)
    env["PADDLE_CURRENT_ENDPOINT"] = endpoints[i]
    env["PADDLE_TRAINER_ENDPOINTS"] = ",".join(endpoints)
    env["FLAGS_selected_gpus"] = str(devices[i])
    try:
        func(*args)
    except KeyboardInterrupt:
        pass
    except BaseException:
        error_queue.put(traceback.format_exc())
        sys.exit(1)


class MultiprocessContext:
    def __init__(self, processes, error_queues):
        self.processes = processes
        self.error_queues = error_queues

    def join(self, timeout=None):
        """Wait for the processes; when one exits non-zero, terminate the
        rest (they would wait in a collective for it) and raise."""
        import time
        from multiprocessing.connection import wait
        deadline = None if timeout is None else time.time() + timeout
        while True:
            failed = [i for i, p in enumerate(self.processes)
                      if p.exitcode not in (0, None)]
            alive = [p for p in self.processes if p.exitcode is None]
            if failed or not alive:
                break
            left = None if deadline is None else deadline - time.time()
            if left is not None and left <= 0:
                return False
            wait([p.sentinel for p in alive], timeout=left)
        if failed:
            for p in self.processes:
                if p.is_alive():
                    p.terminate()
            for p in self.processes:
                p.join(10)
            i = failed[0]
            q = self.error_queues[i]
            msg = q.get() if not q.empty() else \
                f"exitcode {self.processes[i].exitcode}"
            raise RuntimeError(f"worker {i} failed:\n{msg}")
        return True


def spawn(func, args=(), nprocs=1, join=True, daemon=False, **options):
    """Launch `nprocs` processes running `func(*args)` under the PADDLE_*
    contract; option: `selected_devices`."""
    if nprocs < 1:
        nprocs = 1
    devices = options.get("selected_devices")
    if devices is None:
        devices = list(range(nprocs))
    elif isinstance(devices, str):
        devices = [d.strip() for d in devices.split(",") if d.strip()]
    devices = [int(d) for d in devices]
    if len(devices) != nprocs:
        raise ValueError(f"spawn: {len(devices)} selected devices for "
                         f"{nprocs} processes")
    ports = get_free_ports(nprocs)
    endpoints = [f"127.0.0.1:{p}" for p in ports]
    ctx = multiprocessing.get_context("spawn")
    processes, error_queues = [], []
    for i in range(nprocs):
        q = ctx.SimpleQueue()
        p = ctx.Process(target=_wrap,
                        args=(func, i, nprocs, endpoints, devices, args, q),
                        daemon=daemon)
        p.start()
        processes.append(p)
        error_queues.append(q)
    mp_ctx = MultiprocessContext(processes, error_queues)
    if join:
        mp_ctx.join()
    return mp_ctx
