"""The port's host control plane against the JAX package on the CPU:
distributed/fleet_control.py, distributed/gloo.py, observability/ and
testing/chaos.py.

Records one package writes are read by the other's functions, and both
reach the same conclusions from the same directory:

  * journals (RunJournal lines, `read_rank_journals`,
    `reconstruct_timeline`) and heartbeats (`read_heartbeats`,
    `stalled_ranks`), each package's writer read by both readers;
  * membership records, proposals and commits; a two-host formation with
    one port controller and one JAX controller (threads) agrees, and both
    packages read the same commit; `newest_mutual_checkpoint_step` from
    the same journals; a fleet barrier across the packages; the env
    contract (`fleet_env`) of a commit;
  * the gloo FILE rendezvous: two processes pass a barrier and an
    all-gather, the role maker's included; the HTTP rendezvous over the
    PS tier's KV server, each package's Gloo on the other's server;
  * the chaos grammar parses to the same directives, and its hooks fire
    as in the JAX package (a kill in a subprocess, a torn save, an
    injected collective failure with its budget);
  * the metrics sidecar serves the port's monitor on 127.0.0.1, port 0.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from paddle_tpu.distributed import fleet_control as jfc
from paddle_tpu.observability import heartbeat as jhb
from paddle_tpu.observability import journal as jjr
from paddle_tpu.testing import chaos as jchaos

from paddle_tpu_torch.core import monitor
from paddle_tpu_torch.distributed import fleet_control as tfc
from paddle_tpu_torch.distributed import gloo as tgloo
from paddle_tpu_torch.observability import heartbeat as thb
from paddle_tpu_torch.observability import journal as tjr
from paddle_tpu_torch.observability import sidecar
from paddle_tpu_torch.testing import chaos as tchaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")

PAIRS = [("torch", "jax"), ("jax", "torch")]
MOD = {"torch": (tjr, thb, tfc), "jax": (jjr, jhb, jfc)}


def _story(jr, d, rank, run_id):
    j = jr.RunJournal(d, run_id=run_id, rank=rank)
    j.event("run_start", pid=1, world="2", restart="0")
    for s in (2, 4):
        j.event("step", step=s, wall_ms=1.5)
        j.event("checkpoint_save", step=s, bytes=10)
        if rank == 0:
            j.event("checkpoint_commit", step=s, path=f"step_{s}")
    j.event("chaos", directive="kill", step=5)
    j.event("reform", epoch=1, world=1, members=[0], restore_step=4)
    j.close()


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_journals_cross_packages(tmp_path, writer, reader):
    d = str(tmp_path)
    for r in (0, 1):
        _story(MOD[writer][0], d, r, f"run{r}")
    got = MOD[reader][0].read_rank_journals(d)
    want = MOD[writer][0].read_rank_journals(d)
    assert got == want and sorted(got) == [0, 1]
    for r in (0, 1):
        assert MOD[reader][0].reconstruct_timeline(got[r]) == \
            MOD[writer][0].reconstruct_timeline(got[r])
    assert MOD[reader][2].newest_mutual_checkpoint_step(d, [0, 1]) == 4 \
        == MOD[writer][2].newest_mutual_checkpoint_step(d, [0, 1])
    line = json.loads(open(os.path.join(d, "journal.rank1.jsonl"))
                      .readline())
    assert sorted(line) == ["kind", "pid", "rank", "restart", "run_id",
                            "seq", "t", "v", "world"]


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_heartbeats_cross_packages(tmp_path, writer, reader):
    d = str(tmp_path)
    hb = MOD[writer][1]
    hb.HeartbeatWriter(d, rank=0).beat(7, wall_ms=2.0)
    hb.HeartbeatWriter(d, rank=1).beat(3)
    path = hb.heartbeat_path(d, 1)
    rec = json.load(open(path))
    rec["t"] -= 1000  # rank 1 went quiet
    with open(path, "w") as f:
        json.dump(rec, f)
    got = MOD[reader][1].read_heartbeats(d)
    assert got == hb.read_heartbeats(d) and got[0]["step"] == 7
    assert MOD[reader][1].stalled_ranks(d, 30.0) == [1] == \
        hb.stalled_ranks(d, 30.0)


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_fleet_records_cross_packages(tmp_path, writer, reader):
    d = str(tmp_path)
    w, r = MOD[writer][2], MOD[reader][2]
    w.write_member(d, 0, capacity=1, epoch=0, ranks=[0])
    w.write_member(d, 1, capacity=1, epoch=0, ranks=[1], status="done")
    assert r.read_members(d) == w.read_members(d)
    assert sorted(r.live_members(d, timeout_s=60.0)) == [0] == \
        sorted(w.live_members(d, timeout_s=60.0))
    w.propose_reform(d, 0, epoch=1, members=[0], world=1, restore_step=4)
    assert r.read_proposals(d, 1) == w.read_proposals(d, 1)
    w._write_json(w._commit_path(d, 1), {"epoch": 1, "members": [0],
                                         "world": 1, "restore_step": 4})
    assert r.read_commit(d, 1) == w.read_commit(d, 1)
    assert r.read_commit(d, 1).restore_step == 4


def test_two_hosts_of_two_packages_agree(tmp_path):
    """Host 0's controller is the port's, host 1's the JAX package's:
    one formation, the same commit in both, and a barrier across them."""
    d = str(tmp_path)
    ctls = [tfc.FleetController(d, host=0, capacity=1, logical_world=2,
                                member_timeout_s=5.0,
                                agreement_timeout_s=20.0),
            jfc.FleetController(d, host=1, capacity=1, logical_world=2,
                                member_timeout_s=5.0,
                                agreement_timeout_s=20.0)]
    results = {}

    def run(h):
        results[h] = ctls[h].form(expect=[0, 1])

    threads = [threading.Thread(target=run, args=(h,)) for h in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert dict(results[0]) == dict(results[1])
    assert results[0].members == [0, 1] and results[0].world == 2
    assert dict(tfc.read_commit(d, 0)) == dict(jfc.read_commit(d, 0))
    env = ctls[0].env_for_workers(results[0])
    assert env == ctls[1].env_for_workers(results[1]) | {
        k: v for k, v in env.items() if "HOST" in k or "PID" in k}
    t_env, j_env = tfc.fleet_env(env), jfc.fleet_env(env)
    assert (t_env.rank, t_env.n_hosts, t_env.world, t_env.hosts) == \
        (j_env.rank, j_env.n_hosts, j_env.world, j_env.hosts)
    order = []
    bars = [tfc.FleetBarrier(d, 0, [0, 1], timeout_s=10.0),
            jfc.FleetBarrier(d, 1, [0, 1], timeout_s=10.0)]
    threads = [threading.Thread(target=lambda h=h: (bars[h](),
                                                    order.append(h)))
               for h in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(15)
    assert sorted(order) == [0, 1]
    for c in ctls:
        c.close()


def test_wedged_host_is_lost_in_both(tmp_path):
    d, hb = str(tmp_path / "fleet"), str(tmp_path / "hb")
    tfc.write_member(d, 0, capacity=1, epoch=0, ranks=[0])
    tfc.write_member(d, 1, capacity=1, epoch=0, ranks=[1])
    thb.HeartbeatWriter(hb, rank=0).beat(3)
    with open(thb.heartbeat_path(hb, 1), "w") as f:
        json.dump({"rank": 1, "step": 3, "t": time.time() - 1000}, f)
    for m in (tfc, jfc):
        assert sorted(m.live_members(d, timeout_s=60.0, heartbeat_dir=hb,
                                     stall_timeout_s=30.0)) == [0]


# ---------------------------------------------------------------------------
# gloo
# ---------------------------------------------------------------------------
def test_gloo_file_store_two_processes(tmp_path):
    procs = []
    for r in range(2):
        env = dict(os.environ, PADDLE_GLOO_RENDEZVOUS="2",
                   PADDLE_GLOO_FS_PATH=str(tmp_path / "store"),
                   PADDLE_TRAINER_ID=str(r), PADDLE_TRAINERS_NUM="2",
                   PADDLE_GLOO_RUN_ID="t1")
        src = (f"import sys; sys.path.insert(0, {REPO!r}); "
               f"sys.path.insert(0, {TESTS!r}); import torch_elastic_worker"
               f" as w; w.gloo_worker({str(tmp_path / f'r{r}.json')!r})")
        procs.append(subprocess.Popen([sys.executable, "-c", src], env=env))
    for p in procs:
        assert p.wait(60) == 0
    for r in range(2):
        out = json.load(open(tmp_path / f"r{r}.json"))
        assert out["rank"] == r and out["size"] == 2
        assert out["gathered"] == [{"rank": 0, "sq": 0},
                                   {"rank": 1, "sq": 1}]
        assert out["sum"] == [3.0]
        assert out["roles"] == ["worker0", "worker1"]


def test_gloo_http_store_waits_for_the_ps_tier(monkeypatch):
    """The HTTP rendezvous store is the PS tier's KV server: two ranks
    (threads) of each package pass a barrier and an all-gather over one
    server of the other package, as the JAX package's Gloo does over its
    own (tests/test_gloo.py); gloo_from_env builds it from the env
    contract, and without a rendezvous it is None."""
    import numpy as np
    from paddle_tpu.distributed import gloo as jgloo
    from paddle_tpu.distributed.ps.kv_server import KVServer as JServer
    from paddle_tpu_torch.distributed.ps.kv_server import KVServer
    for gmod, server in ((tgloo, JServer), (jgloo, KVServer)):
        srv = server("127.0.0.1:0", num_trainers=1)
        srv.serve_in_thread()
        try:
            host, port = srv.endpoint.rsplit(":", 1)
            got = {}

            def rank(r, gmod=gmod, host=host, port=port):
                g = gmod.Gloo()
                g.init(gmod.RENDEZVOUS.HTTP, "worker", r, 2,
                       kwargs={"http.host": host, "http.port": port,
                               "store.prefix": "t"})
                g.barrier()
                got[r] = (g.all_gather({"rank": r}),
                          g.all_reduce(np.full(3, r + 1.0), "sum"))

            ts = [threading.Thread(target=rank, args=(r,))
                  for r in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(60)
            for r in range(2):
                assert got[r][0] == [{"rank": 0}, {"rank": 1}]
                np.testing.assert_allclose(got[r][1], np.full(3, 3.0))
        finally:
            srv.stop()
    srv = KVServer("127.0.0.1:0", num_trainers=1)
    srv.serve_in_thread()
    try:
        monkeypatch.setenv("PADDLE_GLOO_RENDEZVOUS", "3")
        monkeypatch.setenv("PADDLE_GLOO_HTTP_ENDPOINT", srv.endpoint)
        monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
        g = tgloo.gloo_from_env()
        assert isinstance(g._store, tgloo._KVStore)
        assert g.all_gather("x") == ["x"]
    finally:
        srv.stop()
    monkeypatch.delenv("PADDLE_GLOO_RENDEZVOUS")
    assert tgloo.gloo_from_env() is None


# ---------------------------------------------------------------------------
# chaos
# ---------------------------------------------------------------------------
def _fields(ds):
    return [(d.kind, d.step, d.rank, int(d.sig), d.seconds, d.times)
            for d in ds]


def test_chaos_grammar_parses_as_jax():
    raw = ("kill@3:rank=1;kill@5:signal=term;lose_host@4:host=1;"
           "slow_save=0.25;torn_save@2;collective_fail@6:times=3:rank=0")
    assert _fields(tchaos._parse(raw)) == _fields(jchaos._parse(raw))
    for bad in ("explode@3",):
        with pytest.raises(ValueError) as want:
            jchaos._parse(bad)
        with pytest.raises(ValueError, match="unknown PADDLE_TPU_CHAOS"):
            tchaos._parse(bad)
        assert str(want.value).split(" (see")[0] in \
            str(pytest.raises(ValueError, tchaos._parse, bad).value)


def test_chaos_hooks_fire(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_CHAOS", "collective_fail@2:times=2")
    tchaos.reload()
    tchaos.collective_hook(1)
    for _ in range(2):
        with pytest.raises(tchaos.ChaosCollectiveError):
            tchaos.collective_hook(2)
    tchaos.collective_hook(2)  # the budget is spent
    monkeypatch.setenv("PADDLE_TPU_CHAOS", "")
    tchaos.reload()
    assert not tchaos.enabled()
    src = ("import sys; sys.path.insert(0, %r); "
           "from paddle_tpu_torch.testing import chaos; "
           "chaos.step_hook(1); chaos.step_hook(2); print('alive')" % REPO)
    p = subprocess.run([sys.executable, "-c", src], capture_output=True,
                       text=True, timeout=60,
                       env=dict(os.environ, PADDLE_TPU_CHAOS="kill@2"))
    assert p.returncode == -signal.SIGKILL and "alive" not in p.stdout
    # a torn save: the shard is staged, the process dies before the
    # manifest; the next manager sweeps the stage, the commit never shows
    src = ("import sys, torch; sys.path.insert(0, %r); "
           "from paddle_tpu_torch.checkpoint import CheckpointManager; "
           "m = CheckpointManager(%r); m.save(1, {'w': torch.ones(2)}, "
           "sync=True); m.save(2, {'w': torch.ones(2)}, sync=True)"
           % (REPO, str(tmp_path)))
    p = subprocess.run([sys.executable, "-c", src], capture_output=True,
                       text=True, timeout=60,
                       env=dict(os.environ, PADDLE_TPU_CHAOS="torn_save@2"))
    assert p.returncode == -signal.SIGKILL
    from paddle_tpu_torch.checkpoint import CheckpointManager
    with CheckpointManager(str(tmp_path)) as m:
        assert m.all_steps() == [1]


# ---------------------------------------------------------------------------
# the metrics sidecar
# ---------------------------------------------------------------------------
def test_metrics_sidecar_serves_the_monitor():
    monitor.stat_add("train.steps", 3)
    side = sidecar.MetricsSidecar(host="127.0.0.1", port=0).start()
    try:
        url = f"http://127.0.0.1:{side.port}"
        text = urllib.request.urlopen(url + "/metrics", timeout=10).read() \
            .decode()
        assert "train_steps" in text and 'rank="0"' in text
        health = json.loads(urllib.request.urlopen(url + "/healthz",
                                                   timeout=10).read())
        assert health["status"] == "ok"
    finally:
        side.stop()
