"""The port's elastic launcher on the CPU: `python -m
paddle_tpu_torch.distributed.launch --elastic` and `--fleet_dir`, with
the ranks of tests/torch_elastic_worker.py (the fc regression elasticized
at logical dp 4, checkpoints every global step, one thread a rank).

  * `--elastic --nproc_per_node 2` (gloo): chaos SIGKILLs rank 1 after its
    2nd micro-step; the supervisor tears the pod down, re-forms it at
    world 1 (the largest power-of-two divisor of the logical world the
    survivor fills) with the elastic env contract and fresh rendezvous
    ports; the relaunched rank restores the world-2 checkpoint
    rank-merged and finishes.  Its losses and parameters are bitwise
    equal to an uninterrupted run; the journals show the kill, the
    merged restore and the re-anchor;
  * two `--fleet_dir` launchers (hosts 0 and 1, one rank each): chaos
    `lose_host` SIGKILLs host 1's launcher and trainer after 2 global
    steps; host 0's controller sees the membership go stale, tears its
    pod down, agrees members {0} and the restore step from the journals
    (the newest step both staged and one committed), relaunches, restores
    rank-merged and finishes bitwise equal to an uninterrupted run;
  * `elastic_world_size` is the JAX package's.
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import launch as jlaunch
from paddle_tpu_torch.distributed import launch as tlaunch
from paddle_tpu_torch.observability import read_rank_journals

import torch_elastic_worker as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_elastic_worker.py")
STEPS = 4


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """An uninterrupted run at world 1 in this process (one thread, as
    the ranks run): the start state and the bitwise oracle."""
    import paddle_tpu_torch
    from paddle_tpu_torch import static
    d = tmp_path_factory.mktemp("launch_ref")
    main, startup, _, _ = W.build_fc(paddle_tpu_torch)
    exe, scope = static.Executor(static.CPUPlace()), static.Scope()
    with static.scope_guard(scope):
        exe.run(startup)
        start = {p.name: scope.get(p.name).numpy()
                 for p in main.all_parameters()}
    np.savez(d / "start.npz", **start)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = W._run_case(1, {"steps": STEPS, "state": str(d /
                                                           "start.npz")})
    finally:
        torch.set_num_threads(threads)
    return str(d / "start.npz"), ref


def _check(rep, ref, first):
    assert rep["done"] and rep["resumed_global"] == first, rep
    assert sorted(map(int, rep["losses"])) == list(range(first, STEPS))
    for gi, lv in rep["losses"].items():
        assert np.float32(lv) == ref["losses"][int(gi)], gi
    for n, v in rep["params"].items():
        np.testing.assert_array_equal(np.asarray(v, np.float32), ref[n],
                                      err_msg=n)


def _env(base, **kw):
    env = dict(os.environ, **kw)
    env["PADDLE_TPU_JOURNAL_DIR"] = os.path.join(base, "journal")
    return env


def test_elastic_world_size_matches_jax():
    for s in range(0, 10):
        for n in (1, 2, 4, 8, 6):
            assert tlaunch.elastic_world_size(s, n) == \
                jlaunch.elastic_world_size(s, n)


def test_launch_elastic_reforms_and_finishes_bitwise(tmp_path, reference):
    base = str(tmp_path)
    os.link(reference[0], os.path.join(base, "start.npz"))
    p = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--elastic", "--max_restarts", "2", "--nproc_per_node", "2",
         "--term_grace", "3", "--journal_dir",
         os.path.join(base, "journal"), "--log_dir",
         os.path.join(base, "logs"), WORKER, base, str(STEPS)],
        cwd=REPO, env=_env(base, PADDLE_TPU_CHAOS="kill@2:rank=1"),
        capture_output=True, text=True, timeout=180)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "re-forming pod 2 -> 1 of logical 2" in p.stderr, p.stderr
    rep = json.load(open(os.path.join(base, "out_rank0_r1.json")))
    assert rep["world"] == 1 and rep["restart"] == 1
    assert rep["elastic_env"] == "1" and rep["logical_env"] == "2"
    _check(rep, reference[1], first=1)
    kinds = [e["kind"] for evs in read_rank_journals(
        os.path.join(base, "journal")).values() for e in evs]
    assert "chaos" in kinds and "restore_merged" in kinds
    assert "reanchor" in kinds


def test_fleet_launchers_lose_a_host_and_finish_bitwise(tmp_path,
                                                         reference):
    base = str(tmp_path)
    os.link(reference[0], os.path.join(base, "start.npz"))
    env = _env(base, PADDLE_TPU_CHAOS=f"lose_host@{2 * W.LOGICAL}:host=1")
    env.pop("PADDLE_TPU_FLEET_DIR", None)
    procs = []
    for h in (0, 1):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--elastic", "--ips", "127.0.0.1,127.0.0.1", "--host_rank",
             str(h), "--nproc_per_node", "1", "--fleet_dir",
             os.path.join(base, "fleet"), "--journal_dir",
             os.path.join(base, "journal"), "--member_timeout", "5",
             "--term_grace", "3", "--log_dir",
             os.path.join(base, f"logs{h}"), WORKER, base, str(STEPS)],
            cwd=REPO, env=env, stderr=subprocess.PIPE, text=True))
    try:
        rc0 = procs[0].wait(180)
        rc1 = procs[1].wait(30)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    err0 = procs[0].stderr.read()
    assert rc0 == 0, err0[-3000:]
    assert rc1 == -signal.SIGKILL  # host 1's launcher went down whole
    assert "host(s) lost [1]" in err0, err0
    from paddle_tpu_torch.distributed.fleet_control import read_commit
    commit = read_commit(os.path.join(base, "fleet"), 1)
    assert commit.members == [0] and commit.world == 1
    assert commit.restore_step is not None
    rep = json.load(open(os.path.join(base, "out_host0_e1.json")))
    first = rep["resumed_global"]
    assert first == 2, rep
    _check(rep, reference[1], first=first)
    from paddle_tpu_torch.distributed.fleet_control import \
        CONTROLLER_RANK_BASE
    journals = read_rank_journals(os.path.join(base, "journal"))
    assert "restore_merged" in [e["kind"] for e in journals[0]]
    reforms = [e for e in journals[CONTROLLER_RANK_BASE]  # host 0's
               if e["kind"] == "reform"]
    assert [(e["epoch"], e["members"]) for e in reforms] == \
        [(0, [0, 1]), (1, [0])]
