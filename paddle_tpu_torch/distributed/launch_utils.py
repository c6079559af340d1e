"""Cluster / pod topology and the launcher's process management.

Counterpart of paddle_tpu/distributed/launch_utils.py: the Cluster / Pod
/ Trainer description, `get_cluster`, `start_local_trainers` (one
process per local rank under the PADDLE_* contract, logs to
workerlog.N), `poll_local_trainers`, `terminate_procs` (SIGTERM, a
grace period, then SIGKILL, every child reaped) and
`watch_local_trainers`, the fail-fast watchdog: a rank that exits
non-zero leaves its peers waiting in their next collective, so the pod
is torn down and the launcher raises.  The JAX package's heartbeat
stall detection is the observability tier's, not ported (ROADMAP.md).
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import List, Optional

__all__ = ["Cluster", "Pod", "Trainer", "get_cluster",
           "start_local_trainers", "watch_local_trainers", "terminate_procs",
           "poll_local_trainers", "find_free_ports"]


class Trainer:
    def __init__(self, endpoint="", rank=-1, devices=None):
        self.endpoint = endpoint
        self.rank = rank
        self.accelerators = devices or []

    def __repr__(self):
        return f"Trainer(rank={self.rank}, ep={self.endpoint})"


class Pod:
    """One node."""

    def __init__(self, id=0, addr="127.0.0.1"):
        self.id = id
        self.addr = addr
        self.port = None
        self.trainers: List[Trainer] = []
        self.servers: List[Trainer] = []
        self.workers: List[Trainer] = []

    def rank(self):
        return self.id


class Cluster:
    def __init__(self, hdfs=None):
        self.job_server = None
        self.pods: List[Pod] = []
        self.hdfs = hdfs

    def trainers_nranks(self) -> int:
        return len(self.trainers_endpoints())

    def trainers_endpoints(self) -> List[str]:
        return [t.endpoint for p in self.pods for t in p.trainers]

    def pods_endpoints(self):
        return [f"{p.addr}:{p.port}" for p in self.pods]


def find_free_ports(num):
    from .spawn import get_free_ports
    return get_free_ports(num)


def get_cluster(node_ips, node_ip, trainer_endpoints, devices_per_proc):
    """Cluster, and this node's Pod, from the resolved endpoints (a list
    per node, or one flat list split by ip); `devices_per_proc` holds
    the device set of each trainer on a node."""
    cluster = Cluster()
    rank = 0
    for pod_id, ip in enumerate(node_ips):
        pod = Pod(pod_id, ip)
        eps = (trainer_endpoints[pod_id]
               if isinstance(trainer_endpoints[0], list)
               else [e for e in trainer_endpoints
                     if e.split(":")[0] == ip])
        for i, ep in enumerate(eps):
            devs = (devices_per_proc[i]
                    if i < len(devices_per_proc) else [i])
            pod.trainers.append(Trainer(ep, rank, devs))
            rank += 1
        cluster.pods.append(pod)
    pod = next(p for p in cluster.pods if p.addr == node_ip)
    return cluster, pod


class TrainerProc:
    def __init__(self):
        self.proc: Optional[subprocess.Popen] = None
        self.log_fn = None
        self.rank = None
        self.local_rank = None
        self.cmd = None


def start_local_trainers(cluster: Cluster, pod: Pod, training_script,
                         training_script_args, log_dir=None, envs=None):
    """One subprocess per local trainer, under the PADDLE_* contract."""
    procs = []
    for local_rank, t in enumerate(pod.trainers):
        env = dict(os.environ, **(envs or {}))
        env.update({
            "PADDLE_TRAINER_ID": str(t.rank),
            "PADDLE_CURRENT_ENDPOINT": t.endpoint,
            "PADDLE_TRAINERS_NUM": str(cluster.trainers_nranks()),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(
                cluster.trainers_endpoints()),
            "FLAGS_selected_gpus": ",".join(str(d) for d in t.accelerators),
        })
        cmd = [sys.executable, "-u", training_script] + \
            list(training_script_args)
        tp = TrainerProc()
        tp.rank = t.rank
        tp.local_rank = local_rank
        tp.cmd = cmd
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            tp.log_fn = open(os.path.join(
                log_dir, f"workerlog.{local_rank}"), "a")
            tp.proc = subprocess.Popen(cmd, env=env, stdout=tp.log_fn,
                                       stderr=tp.log_fn)
        else:
            tp.proc = subprocess.Popen(cmd, env=env)
        procs.append(tp)
    return procs


def terminate_procs(procs: List[TrainerProc], sigterm_grace: float = 10.0):
    """Tear a pod down: SIGTERM, then SIGKILL whatever is alive after
    `sigterm_grace` seconds (a rank waiting in a dead collective never
    answers SIGTERM); every child is reaped."""
    for tp in procs:
        if tp.proc is not None and tp.proc.poll() is None:
            tp.proc.terminate()
    deadline = time.time() + max(0.0, float(sigterm_grace))
    for tp in procs:
        if tp.proc is None:
            continue
        try:
            tp.proc.wait(max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            tp.proc.kill()
            try:
                tp.proc.wait(10)
            except subprocess.TimeoutExpired:  # pragma: no cover
                pass
        if tp.log_fn:
            tp.log_fn.close()
            tp.log_fn = None


def poll_local_trainers(procs: List[TrainerProc]):
    """One supervision tick: (alive, done, failed); exited trainers'
    logs are closed."""
    alive, done, failed = [], [], []
    for tp in procs:
        ret = tp.proc.poll()
        if ret is None:
            alive.append(tp)
        elif ret == 0:
            done.append(tp)
        else:
            failed.append(tp)
        if ret is not None and tp.log_fn:
            tp.log_fn.close()
            tp.log_fn = None
    return alive, done, failed


def watch_local_trainers(procs: List[TrainerProc], nranks,
                         sigterm_grace: float = 10.0) -> List[TrainerProc]:
    """Poll the children; on any non-zero exit tear the pod down and
    raise.  Returns the trainers still alive."""
    alive, _done, failed = poll_local_trainers(procs)
    if failed:
        terminate_procs(procs, sigterm_grace)
        codes = {tp.rank: tp.proc.poll() for tp in failed}
        raise RuntimeError(
            f"trainer rank(s) {sorted(codes)} exited with code(s) "
            f"{codes}; job aborted ({nranks} ranks)")
    return alive
