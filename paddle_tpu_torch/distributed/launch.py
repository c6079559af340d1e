"""`python -m paddle_tpu_torch.distributed.launch --nproc_per_node N
script.py [args]`: the collective job launcher.

Counterpart of paddle_tpu/distributed/launch.py's `launch_collective`.
One process per rank (the port's idiom: one CUDA device each, or any
number of gloo ranks), `--nproc_per_node` on each of `--ips`, with the
PADDLE_* contract (rank, world size, endpoints from `--started_port` or
free ports, FLAGS_selected_gpus from `--selected_gpus` or the local
rank) and logs under `--log_dir` (workerlog.N).  The launcher
supervises: when a rank exits non-zero the pod is torn down at once
(SIGTERM, `--term_grace` seconds, SIGKILL) and the launcher exits 1,
since the other ranks would wait in their next collective forever.

Not ported: `--elastic` re-forming, `--fleet_dir` cross-host fleets and
`--run_mode ps` (ROADMAP.md Queue 1, Distribution); each raises.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from .launch_utils import (get_cluster, start_local_trainers,
                           poll_local_trainers, terminate_procs,
                           find_free_ports)

__all__ = ["launch_collective", "main"]

_LATER = "ROADMAP.md Queue 1, Distribution"


def _parse_args(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--ips", type=str, default="127.0.0.1",
                   help="comma-separated node ips")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="rank processes per node")
    p.add_argument("--selected_gpus", type=str, default=None,
                   help="comma-separated CUDA device of each local rank "
                        "(default: the local rank)")
    p.add_argument("--started_port", type=int, default=None)
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--run_mode", type=str, default="collective",
                   choices=["collective", "ps"])
    p.add_argument("--elastic", action="store_true")
    p.add_argument("--fleet_dir", type=str, default=None)
    p.add_argument("--term_grace", type=float, default=10.0,
                   help="seconds between SIGTERM and SIGKILL at teardown")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _spawn_pod(args, nproc):
    node_ips = [ip.strip() for ip in args.ips.split(",") if ip.strip()]
    this_ip = os.environ.get("POD_IP", node_ips[0])
    if args.started_port is not None:
        ports = list(range(args.started_port, args.started_port + nproc))
    else:
        ports = find_free_ports(nproc)
    endpoints = [[f"{ip}:{port}" for port in ports] for ip in node_ips]
    if args.selected_gpus:
        gpus = [int(g) for g in args.selected_gpus.split(",") if g.strip()]
        if len(gpus) != nproc:
            raise ValueError(f"--selected_gpus names {len(gpus)} devices "
                             f"for {nproc} processes a node")
        devices_per_proc = [[g] for g in gpus]
    else:
        devices_per_proc = [[i] for i in range(nproc)]
    cluster, pod = get_cluster(node_ips, this_ip, endpoints,
                               devices_per_proc)
    procs = start_local_trainers(cluster, pod, args.training_script,
                                 args.training_script_args,
                                 log_dir=args.log_dir)
    return cluster, procs


def launch_collective(args):
    """Start the pod and supervise it: 0 when every rank exits 0, 1 (the
    pod torn down) as soon as one exits non-zero."""
    cluster, procs = _spawn_pod(args, args.nproc_per_node)
    failed = []
    try:
        while True:
            procs, _done, failed = poll_local_trainers(procs)
            if failed or not procs:
                break
            time.sleep(0.2)
    except KeyboardInterrupt:
        terminate_procs(procs, sigterm_grace=args.term_grace)
        return 1
    if not failed:
        return 0
    codes = {tp.rank: tp.proc.poll() for tp in failed}
    terminate_procs(procs + failed, sigterm_grace=args.term_grace)
    sys.stderr.write(
        f"trainer rank(s) {sorted(codes)} exited non-zero {codes}; pod of "
        f"{cluster.trainers_nranks()} ranks terminated\n")
    return 1


def main(argv=None):
    args = _parse_args(argv)
    if args.run_mode == "ps":
        raise NotImplementedError(
            f"the parameter-server launcher (--run_mode ps) is not ported "
            f"yet ({_LATER})")
    if args.elastic or args.fleet_dir:
        raise NotImplementedError(
            f"elastic launching (--elastic, --fleet_dir) is not ported yet "
            f"({_LATER})")
    return launch_collective(args)


if __name__ == "__main__":
    sys.exit(main())
