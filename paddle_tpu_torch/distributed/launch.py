"""`python -m paddle_tpu_torch.distributed.launch --nproc_per_node N
script.py [args]`: the collective job launcher.

Counterpart of paddle_tpu/distributed/launch.py's `launch_collective`.
One process per rank (the port's idiom: one CUDA device each, or any
number of gloo ranks), `--nproc_per_node` on each of `--ips`, with the
PADDLE_* contract (rank, world size, endpoints from `--started_port` or
free ports, FLAGS_selected_gpus from `--selected_gpus` or the local
rank) and logs under `--log_dir` (workerlog.N).  The launcher
supervises: when a rank exits non-zero (or, with `--heartbeat_dir`, a
live rank's heartbeat goes stale past `--stall_timeout`) the pod is torn
down at once (SIGTERM, `--term_grace` seconds, SIGKILL: a rank waiting in
a collective on a dead peer never answers SIGTERM, and the teardown never
waits on it longer), since the other ranks would wait in their next
collective forever.  Without `--elastic` the launcher then exits 1.

`--elastic` re-forms the pod from the survivors, as the JAX package's
launcher does: the new world is the largest power-of-two divisor of the
logical world (`--nproc_per_node` x hosts) that the survivors fill (a
rank ended by a signal is lost capacity; a rank that exited with an
error in the same tick, its collective on the lost peer failing, is
not), and the relaunched ranks get the elastic env contract
(PADDLE_TPU_ELASTIC=1, PADDLE_TPU_ELASTIC_LOGICAL_WORLD=<N>,
PADDLE_TPU_ELASTIC_RESTART=<n>) and fresh rendezvous ports; they resume
through `Executor.restore_from_checkpoint`, at most `--max_restarts`
times.  `--elastic --fleet_dir <shared dir>` (or several `--ips`) runs
`launch_collective_fleet`: each host's launcher joins the fleet control
plane (distributed/fleet_control.py), supervises its trainers and its
peers' membership, and on a lost host agrees the survivor set, world and
restore step with the other survivors and relaunches with the
PADDLE_TPU_FLEET_* contract.  `--journal_dir` is exported to the
trainers (PADDLE_TPU_JOURNAL_DIR), whose journals the agreement reads.

`--run_mode ps` (or any of `--server_num`, `--servers`) runs
`launch_ps`: `--server_num` parameter servers (or the `--servers`
endpoints) and `--worker_num` trainers (or `--workers`), each a process
of the training script with the PS env contract (TRAINING_ROLE=PSERVER or
TRAINER, PADDLE_PSERVERS_IP_PORT_LIST, PADDLE_TRAINERS_NUM, a server's
POD_IP / PADDLE_PORT, a trainer's PADDLE_TRAINER_ID), logs under
`--log_dir` (serverlog.N, workerlog.N).  The launcher returns when every
trainer has exited: 0 when all exited 0; a trainer that fails tears the
job down at once (its peers would wait on the servers' sync rounds).  A
server is expected to end when a trainer's `fleet.stop_worker()` shuts
the servers down; one still running `--term_grace` seconds after the
last trainer is terminated.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from .launch_utils import (get_cluster, start_local_trainers,
                           poll_local_trainers, terminate_procs,
                           find_free_ports)

__all__ = ["launch_collective", "launch_collective_fleet", "launch_ps",
           "main", "elastic_world_size"]


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
    p.add_argument("--server_num", type=int, default=None,
                   help="parameter servers on free local ports (ps mode)")
    p.add_argument("--worker_num", type=int, default=None,
                   help="trainers (ps mode)")
    p.add_argument("--servers", type=str, default="",
                   help="comma-separated server endpoints (ps mode)")
    p.add_argument("--workers", type=str, default="",
                   help="comma-separated trainer endpoints (ps mode)")
    p.add_argument("--elastic", action="store_true",
                   help="supervise: on a lost rank, re-form the pod from "
                        "the survivors and relaunch, resuming from the "
                        "last checkpoint; with several --ips hosts this "
                        "needs --fleet_dir")
    p.add_argument("--max_restarts", type=int, default=3,
                   help="elastic relaunch budget before giving up")
    p.add_argument("--fleet_dir", type=str,
                   default=os.environ.get("PADDLE_TPU_FLEET_DIR"),
                   help="shared-filesystem rendezvous dir of a multi-host "
                        "elastic fleet (distributed/fleet_control.py)")
    p.add_argument("--host_rank", type=int, default=None,
                   help="this host's index in --ips (default: the "
                        "position of POD_IP in --ips, else 0); explicit "
                        "when several hosts run on one machine")
    p.add_argument("--host_capacity", type=int, default=None,
                   help="logical ranks this host contributes to the fleet "
                        "world (default: --nproc_per_node)")
    p.add_argument("--member_timeout", type=float, default=20.0,
                   help="seconds without a membership refresh before a "
                        "fleet host counts as lost")
    p.add_argument("--journal_dir", type=str,
                   default=os.environ.get("PADDLE_TPU_JOURNAL_DIR"),
                   help="run-journal dir, exported to the trainers")
    p.add_argument("--heartbeat_dir", type=str, default=None,
                   help="trainers beat here each training step "
                        "(PADDLE_TPU_HEARTBEAT_DIR); a live rank whose "
                        "heartbeat is older than --stall_timeout is torn "
                        "down like a dead one")
    p.add_argument("--stall_timeout", type=float, default=300.0,
                   help="seconds without a heartbeat before a rank counts "
                        "as stalled")
    p.add_argument("--term_grace", type=float, default=10.0,
                   help="seconds between SIGTERM and SIGKILL at teardown")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def elastic_world_size(survivors: int, logical_world: int) -> int:
    """Largest power-of-two divisor of `logical_world` that `survivors`
    ranks can fill — the world the re-formed pod runs at (the elastic
    schedule requires the world to divide the logical one)."""
    if survivors < 1:
        return 0
    w = 1
    while w * 2 <= survivors and logical_world % (w * 2) == 0:
        w *= 2
    return w


def _lost(failed):
    """The failed ranks whose slot is gone: those a signal ended, where
    any did (a killed rank); a rank that exited with an error in the same
    tick is its peer failing in a collective on it, and still capacity.
    Where none was killed, every failed rank."""
    killed = [tp for tp in failed if tp.proc.returncode is not None
              and tp.proc.returncode < 0]
    return killed or failed


def _sweep_heartbeats(hb_dir):
    """A new pod must not trip on a previous incarnation's beats."""
    os.makedirs(hb_dir, exist_ok=True)
    for name in os.listdir(hb_dir):
        if name.startswith("heartbeat.rank"):
            try:
                os.unlink(os.path.join(hb_dir, name))
            except OSError:
                pass


def _devices(args, nproc):
    if args.selected_gpus:
        gpus = [int(g) for g in args.selected_gpus.split(",") if g.strip()]
        if len(gpus) < nproc:
            raise ValueError(f"--selected_gpus names {len(gpus)} devices "
                             f"for {nproc} processes a node")
        return [[g] for g in gpus[:nproc]]
    return [[i] for i in range(nproc)]


def _spawn_pod(args, nproc, envs=None):
    node_ips = [ip.strip() for ip in args.ips.split(",") if ip.strip()]
    this_ip = os.environ.get("POD_IP", node_ips[0])
    if args.started_port is not None:
        ports = list(range(args.started_port, args.started_port + nproc))
    else:
        ports = find_free_ports(nproc)
    endpoints = [[f"{ip}:{port}" for port in ports] for ip in node_ips]
    cluster, pod = get_cluster(node_ips, this_ip, endpoints,
                               _devices(args, nproc))
    procs = start_local_trainers(cluster, pod, args.training_script,
                                 args.training_script_args,
                                 log_dir=args.log_dir, envs=envs)
    return cluster, procs


def launch_collective(args):
    """Start the pod and supervise it: 0 when every rank exits 0.  On a
    rank that exits non-zero (or stalls) the pod is torn down fail-fast;
    without --elastic the launcher then returns 1, with it the pod is
    re-formed from the survivors and relaunched (fresh ports, the elastic
    env contract) up to --max_restarts times."""
    nproc = args.nproc_per_node
    n_ips = len([ip for ip in args.ips.split(",") if ip.strip()])
    if args.elastic and (n_ips > 1 or args.fleet_dir):
        if not args.fleet_dir:
            sys.stderr.write(
                "--elastic with multiple --ips hosts needs --fleet_dir "
                "(a shared-filesystem rendezvous dir every host "
                "mounts)\n")
            return 2
        return launch_collective_fleet(args)
    logical_world = nproc * n_ips
    hb_dir = args.heartbeat_dir
    restarts = 0
    while True:
        envs = {}
        if args.elastic:
            envs = {"PADDLE_TPU_ELASTIC": "1",
                    "PADDLE_TPU_ELASTIC_LOGICAL_WORLD": str(logical_world),
                    "PADDLE_TPU_ELASTIC_RESTART": str(restarts)}
        if args.journal_dir:
            envs["PADDLE_TPU_JOURNAL_DIR"] = args.journal_dir
        if hb_dir:
            envs["PADDLE_TPU_HEARTBEAT_DIR"] = hb_dir
            _sweep_heartbeats(hb_dir)
        cluster, procs = _spawn_pod(args, nproc, envs)
        failed, stalled = [], []
        try:
            while True:
                procs, _done, failed = poll_local_trainers(procs)
                if failed or not procs:
                    break
                if hb_dir:
                    from ..observability.heartbeat import stalled_ranks
                    stalled = stalled_ranks(
                        hb_dir, args.stall_timeout,
                        ranks=[tp.rank for tp in procs])
                    if stalled:
                        break
                time.sleep(0.2)
        except KeyboardInterrupt:
            terminate_procs(procs, sigterm_grace=args.term_grace)
            return 1
        if not failed and not stalled:
            return 0
        if failed:
            codes = {tp.rank: tp.proc.poll() for tp in failed}
        else:
            codes = {r: "stalled" for r in stalled}
            sys.stderr.write(
                f"trainer rank(s) {stalled} stalled: no heartbeat for "
                f"{args.stall_timeout}s — treating as lost\n")
        # fail fast: the peers of a dead rank wait in its next collective;
        # SIGTERM lets their preemption handlers checkpoint
        t0 = time.monotonic()
        terminate_procs(procs + failed, sigterm_grace=args.term_grace)
        survivors = nproc - len(_lost(failed)) - len(stalled)
        if survivors < 1 and stalled and not failed:
            survivors = 1  # every process was alive: re-form minimally
        if not args.elastic or restarts >= args.max_restarts:
            sys.stderr.write(
                f"trainer rank(s) {sorted(codes)} exited non-zero "
                f"{codes}; pod of {cluster.trainers_nranks()} ranks "
                f"terminated (elastic={bool(args.elastic)}, "
                f"restarts={restarts})\n")
            return 1
        new_world = elastic_world_size(survivors, logical_world)
        if new_world < 1:
            sys.stderr.write("no surviving capacity to re-form the pod\n")
            return 1
        sys.stderr.write(
            f"elastic: rank(s) {sorted(codes)} lost ({codes}); re-forming "
            f"pod {nproc} -> {new_world} of logical {logical_world}, "
            f"restart {restarts + 1}/{args.max_restarts} (teardown "
            f"{time.monotonic() - t0:.3f} s)\n")
        nproc = new_world
        restarts += 1


def _spawn_fleet_pod(args, nproc, envs, member_hosts, my_host, node_ips):
    """This host's trainers for the current fleet formation: trainer ranks
    are dense over the formation (sorted member hosts x nproc), the
    rank layout the checkpoint manager, the journals and the heartbeats
    share.  Pods are picked by host INDEX: simulated fleets run several
    hosts on one ip.  Other hosts' endpoints are not connected to (a
    fleet's hosts share state through the checkpoints and the fleet
    barrier, not through a process group)."""
    from .launch_utils import Cluster, Pod, Trainer
    members = sorted(int(h) for h in member_hosts)
    my_index = members.index(int(my_host))
    if args.started_port is not None:
        ports = list(range(args.started_port, args.started_port + nproc))
    else:
        ports = find_free_ports(nproc)
    devices = _devices(args, nproc)
    cluster = Cluster()
    rank = 0
    for idx, h in enumerate(members):
        ip = node_ips[h] if h < len(node_ips) else "127.0.0.1"
        pod = Pod(idx, ip)
        for i in range(nproc):
            pod.trainers.append(Trainer(f"{ip}:{ports[i]}", rank,
                                        devices[i]))
            rank += 1
        cluster.pods.append(pod)
    pod = cluster.pods[my_index]
    procs = start_local_trainers(cluster, pod, args.training_script,
                                 args.training_script_args,
                                 log_dir=args.log_dir, envs=envs)
    return procs, [t.rank for t in pod.trainers]


def launch_collective_fleet(args):
    """Multi-host elastic supervision: this host's launcher joined to the
    fleet control plane (distributed/fleet_control.py).  It (1)
    rendezvouses at --fleet_dir and agrees the epoch-0 formation, (2)
    spawns its trainers with the elastic and fleet env contract, (3)
    supervises its trainers' exits and heartbeats and its peers'
    membership, and (4) on any loss tears its pod down and runs the
    two-phase survivor agreement, so every surviving launcher re-forms
    to the SAME world and restore step, then relaunches."""
    from .fleet_control import (FleetAgreementTimeout, FleetController,
                                fleet_rank)
    nproc = args.nproc_per_node
    node_ips = [ip.strip() for ip in args.ips.split(",") if ip.strip()]
    n_ips = max(1, len(node_ips))
    host = args.host_rank
    if host is None:
        pod_ip = os.environ.get("POD_IP", "")
        host = node_ips.index(pod_ip) if pod_ip in node_ips else 0
    capacity = args.host_capacity or nproc
    logical_world = capacity * n_ips
    hb_dir = args.heartbeat_dir
    ctl = FleetController(
        args.fleet_dir, host=host, capacity=capacity,
        logical_world=logical_world,
        member_timeout_s=args.member_timeout,
        journal_dir=args.journal_dir, heartbeat_dir=hb_dir,
        stall_timeout_s=(args.stall_timeout if hb_dir else None))
    # a reused fleet dir must not replay a previous run's agreement
    ctl.reset_rendezvous()
    try:
        commit = ctl.form(expect=range(n_ips))
    except FleetAgreementTimeout as e:
        sys.stderr.write(f"fleet formation failed: {e}\n")
        return 1
    restarts = 0
    while True:
        my_rank0 = fleet_rank(host, commit.members) * nproc
        ranks = list(range(my_rank0, my_rank0 + nproc))
        envs = {"PADDLE_TPU_ELASTIC": "1",
                "PADDLE_TPU_ELASTIC_LOGICAL_WORLD": str(logical_world),
                "PADDLE_TPU_ELASTIC_RESTART": str(restarts)}
        envs.update(ctl.env_for_workers(commit))
        if args.journal_dir:
            envs["PADDLE_TPU_JOURNAL_DIR"] = args.journal_dir
        if hb_dir:
            envs["PADDLE_TPU_HEARTBEAT_DIR"] = hb_dir
            _sweep_heartbeats(hb_dir)
        sys.stderr.write(
            f"fleet host {host}: epoch {commit.epoch} members "
            f"{commit.members} world {commit.world} restore_step "
            f"{commit.restore_step} — spawning ranks {ranks}\n")
        procs, ranks = _spawn_fleet_pod(args, nproc, envs,
                                        commit.members, host, node_ips)
        failed, stalled, lost = [], [], []
        try:
            while True:
                ctl.tick(ranks=ranks)
                procs, _done, failed = poll_local_trainers(procs)
                if failed:
                    break
                if not procs:  # every local trainer finished cleanly
                    ctl.leave()
                    ctl.close()
                    return 0
                if hb_dir:
                    from ..observability.heartbeat import stalled_ranks
                    stalled = stalled_ranks(
                        hb_dir, args.stall_timeout,
                        ranks=[tp.rank for tp in procs])
                    if stalled:
                        break
                lost = ctl.lost_members(commit)
                if lost:
                    break
                if ctl.reform_requested():
                    break
                time.sleep(0.3)
        except KeyboardInterrupt:
            terminate_procs(procs, sigterm_grace=args.term_grace)
            ctl.close()
            return 1
        why = (f"rank(s) failed {[tp.rank for tp in failed]}" if failed
               else f"rank(s) stalled {stalled}" if stalled
               else f"host(s) lost {lost}" if lost
               else "peer requested re-form")
        sys.stderr.write(
            f"fleet host {host}: {why} at epoch {commit.epoch} — "
            "tearing down local pod for survivor agreement\n")
        terminate_procs(procs + failed, sigterm_grace=args.term_grace)
        if restarts >= args.max_restarts:
            sys.stderr.write(
                f"fleet host {host}: restart budget exhausted "
                f"({restarts}/{args.max_restarts})\n")
            ctl.close()
            return 1
        try:
            commit = ctl.reform(commit)
        except FleetAgreementTimeout as e:
            sys.stderr.write(f"fleet re-form failed: {e}\n")
            ctl.close()
            return 1
        if commit.world < 1 or host not in commit.members:
            sys.stderr.write(
                f"fleet host {host}: not part of the re-formed fleet "
                f"{commit.members}\n")
            ctl.close()
            return 1
        restarts += 1


def launch_ps(args):
    """The parameter-server job: servers and trainers as processes of the
    training script with the PS env contract (module docstring)."""
    import subprocess
    server_eps = [e for e in args.servers.split(",") if e]
    worker_eps = [e for e in args.workers.split(",") if e]
    if not server_eps:
        n = args.server_num or 1
        server_eps = [f"127.0.0.1:{p}" for p in find_free_ports(n)]
    if not worker_eps:
        n = args.worker_num or 1
        worker_eps = [f"127.0.0.1:{p}" for p in find_free_ports(n)]
    base_env = dict(os.environ)
    base_env["PADDLE_PSERVERS_IP_PORT_LIST"] = ",".join(server_eps)
    base_env["PADDLE_TRAINERS_NUM"] = str(len(worker_eps))
    cmd = [sys.executable, "-u", args.training_script] + \
        args.training_script_args
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)

    def start(env, log_name):
        out = None
        if args.log_dir:
            out = open(os.path.join(args.log_dir, log_name), "w")
        p = subprocess.Popen(cmd, env=env, stdout=out,
                             stderr=subprocess.STDOUT if out else None)
        if out is not None:
            out.close()
        return p

    servers, trainers = [], []
    for i, ep in enumerate(server_eps):
        ip, port = ep.rsplit(":", 1)
        servers.append(start(dict(base_env, TRAINING_ROLE="PSERVER",
                                  PADDLE_PORT=port, POD_IP=ip,
                                  PADDLE_TRAINER_ID=str(i)),
                             f"serverlog.{i}"))
    for i, ep in enumerate(worker_eps):
        trainers.append(start(dict(base_env, TRAINING_ROLE="TRAINER",
                                   PADDLE_TRAINER_ID=str(i),
                                   PADDLE_CURRENT_ENDPOINT=ep),
                              f"workerlog.{i}"))
    everyone = servers + trainers

    def teardown(procs):
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + max(0.0, float(args.term_grace))
        for p in procs:
            try:
                p.wait(max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    while True:
        codes = [p.poll() for p in trainers]
        bad = {i: c for i, c in enumerate(codes) if c not in (None, 0)}
        dead_servers = {i: p.poll() for i, p in enumerate(servers)
                        if p.poll() not in (None, 0)}
        if bad or dead_servers:
            sys.stderr.write(
                f"ps launch: trainer(s) {bad} / server(s) {dead_servers} "
                "exited non-zero; tearing the job down\n")
            teardown(everyone)
            return 1
        if all(c == 0 for c in codes):
            break
        time.sleep(0.2)
    # every trainer exited 0: the servers end on a trainer's stop_worker
    deadline = time.time() + max(0.0, float(args.term_grace))
    while time.time() < deadline and any(p.poll() is None
                                         for p in servers):
        time.sleep(0.1)
    teardown(servers)
    return 0


def main(argv=None):
    args = _parse_args(argv)
    if args.run_mode == "ps" or args.server_num or args.servers:
        return launch_ps(args)
    return launch_collective(args)


if __name__ == "__main__":
    sys.exit(main())
