"""Data-parallel training in the port against the JAX package, on the CPU.

  * `insert_grad_allreduce` on a tiny bench BERT (plain, fp16_allreduce,
    applied twice) serializes equal to the JAX package's rewrite.
  * Static data parallel: 4 gloo ranks (`distributed.spawn`, a
    `file://` rendezvous) train `bench.build_bert_base` (2 layers, hidden
    64, seq 16, vocab 64, fp32, Adam, score-matrix attention) on one
    global batch of 8 for 5 steps (3 `Executor.run` calls of the
    CompiledProgram, then one `run_steps` call of 2) against the JAX
    package's `CompiledProgram.with_data_parallel(places=4 CPU devices)`
    for 5 `run` steps, the weights carried across with
    `io.load_params_from_numpy`; both fetch_aggregation modes.  Ranks 1-3
    start from perturbed weights, which the start broadcast must undo.
    Gates: every rank's persistables bitwise equal to rank 0's; losses
    rtol 1e-5 and parameters atol 2e-5 against the JAX package
    (test_torch_train.py's fp32 tolerances: Adam turns a ~1e-6 relative
    gradient difference on a near-zero gradient into a visible share of
    its lr step; measured: losses within 2.1e-7 relative, parameters
    within 2.3e-6).
  * Dygraph `DataParallel`: 2 gloo ranks train an MLP with Adam on
    halves of a global batch of 8 (scale_loss, apply_collective_grads)
    against one JAX dygraph process at the global batch, 3 steps:
    parameters atol 1e-6, the ranks bitwise equal.
  * The launchers: `spawn` and `python -m
    paddle_tpu_torch.distributed.launch` set the PADDLE_* contract, and
    a failing rank tears the pod down.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import jax

import bench
import paddle_tpu
import paddle_tpu.optimizer as jopt
import paddle_tpu.static as jstatic
from paddle_tpu import dygraph as jdg
from paddle_tpu.core.program import _reset_unique_names as jax_reset_names
from paddle_tpu.distributed.compiled_program import (
    insert_grad_allreduce as jax_insert)

import torch_dist_worker
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core.program import (_reset_unique_names as
                                           torch_reset_names)
from paddle_tpu_torch.distributed.compiled_program import (
    insert_grad_allreduce as torch_insert)
from paddle_tpu_torch.models import build_bert_pretrain
from test_torch_program import flash_mode
from test_torch_train_program import fused_mode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BERT = dict(vocab=64, seq=16, hidden=64, layers_n=2, heads=2)
GLOBAL_BATCH = 8
W = 4
RUN_STEPS, K = 3, 2


def _build_pair(use_amp=False):
    with flash_mode(False), fused_mode(False):
        jax_reset_names()
        ref = bench.build_bert_base(use_amp=use_amp, **BERT)
        torch_reset_names()
        port = build_bert_pretrain(use_amp=use_amp, **BERT)
    return ref, port


def _same_program(a, b):
    assert a.to_dict() == b.to_dict()
    assert a.serialize_to_string() == b.serialize_to_string()


@pytest.mark.parametrize("use_amp", [False, True])
@pytest.mark.parametrize("mode", ["plain", "fp16_allreduce", "twice",
                                  "unscaled"])
def test_insert_grad_allreduce_matches_jax(mode, use_amp):
    (jm, _, _), (tm, _, _) = _build_pair(use_amp)
    kw = {"fp16_allreduce": mode == "fp16_allreduce",
          "scale": mode != "unscaled"}
    jp, tp = jax_insert(jm, **kw), torch_insert(tm, **kw)
    if mode == "twice":  # idempotent: nothing more is inserted
        jp, tp = jax_insert(jp, **kw), torch_insert(tp, **kw)
    _same_program(tp, jp)
    from paddle_tpu.core.pass_framework import applied_passes as japplied
    from paddle_tpu_torch.core.pass_framework import applied_passes
    assert applied_passes(tp) == japplied(jp)
    types = [op.type for op in tp.global_block().ops]
    n_adam = types.count("adam")
    assert types.count("c_allreduce_sum") == n_adam
    assert types.count("scale_by_world_size") == \
        (0 if mode == "unscaled" else n_adam)


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    seq, vocab = BERT["seq"], BERT["vocab"]
    return {"ids": rng.randint(0, vocab, (GLOBAL_BATCH, seq)),
            "pos": np.tile(np.arange(seq), (GLOBAL_BATCH, 1)),
            "labels": rng.randint(0, vocab, (GLOBAL_BATCH, seq, 1))}


def _jax_dp(jm, js, jl, feed, agg, steps):
    """The JAX package's 4-device CompiledProgram: (startup weights,
    fetched losses, final persistables)."""
    jscope, jexe = jstatic.Scope(), jstatic.Executor()
    with jstatic.scope_guard(jscope):
        jexe.run(js)
        init = {n: np.asarray(jscope.find_var(n).get_tensor())
                for n in jscope.vars
                if jscope.find_var(n).get_tensor() is not None}
        bs = jstatic.BuildStrategy()
        bs.fetch_aggregation = agg
        cp = jstatic.CompiledProgram(jm, build_strategy=bs) \
            .with_data_parallel(loss_name=jl.name,
                                places=jax.devices()[:W])
        losses = [np.asarray(jexe.run(cp, feed=feed, fetch_list=[jl])[0])
                  for _ in range(steps)]
    final = {n: np.asarray(jscope.find_var(n).get_tensor()) for n in init}
    return init, losses, final, cp._get_program()


@pytest.mark.parametrize("agg", ["reduce", "concat"])
def test_static_data_parallel_matches_jax(tmp_path, agg):
    (jm, js, jl), (tm, _, _) = _build_pair()
    feed = {k: v.astype(np.int64) for k, v in _feed().items()}
    with flash_mode(False), fused_mode(False):
        init, jlosses, jfinal, jprog = _jax_dp(jm, js, jl, feed, agg,
                                               RUN_STEPS + K)
    np.savez(tmp_path / "init.npz", **init)
    np.savez(tmp_path / "feed.npz", **feed)
    cfg = {"bert": BERT, "weights": str(tmp_path / "init.npz"),
           "feed": str(tmp_path / "feed.npz"), "run_steps": RUN_STEPS,
           "k": K, "fetch_aggregation": agg, "scramble": True}
    tdist.spawn(torch_dist_worker.static_dp,
                args=(str(tmp_path / "rendezvous"), str(tmp_path), cfg),
                nprocs=W)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(W)]
    # the program each rank ran is the JAX package's rewrite
    assert list(ranks[0]["ops"]) == [op.type for op in
                                     jprog.global_block().ops]
    for r in range(1, W):
        for k, v in ranks[0].items():
            np.testing.assert_array_equal(ranks[r][k], v, err_msg=f"{k} {r}")
    got = ranks[0]
    losses = [got[f"loss/{i}"] for i in range(RUN_STEPS + K)]
    for i, (g, j) in enumerate(zip(losses, jlosses)):
        assert g.shape == j.shape, (i, g.shape, j.shape)
        np.testing.assert_allclose(g, j, rtol=1e-5, err_msg=f"step {i}")
    if agg == "concat":  # one loss a rank: each its own shard's
        assert losses[0].shape == (W,) and len(set(losses[0])) == W
    assert float(np.mean(losses[-1])) < float(np.mean(losses[0]))
    for n, ref in jfinal.items():
        np.testing.assert_allclose(got["var/" + n].astype(np.float64),
                                   ref.astype(np.float64), rtol=0,
                                   atol=2e-5, err_msg=n)


def _jax_mlp(weights, batches):
    jax_reset_names()
    with jdg.guard():
        m = jdg.Sequential(paddle_tpu.nn.Linear(6, 8), paddle_tpu.nn.Tanh(),
                           paddle_tpu.nn.Linear(8, 3))
        m.set_state_dict(weights)
        opt = jopt.Adam(0.01, parameters=m.parameters())
        for x, y in batches:
            loss = ((m(paddle_tpu.to_tensor(x)) - paddle_tpu.to_tensor(y))
                    ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
    return {k: np.asarray(v) for k, v in m.state_dict().items()}


def test_dygraph_data_parallel_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    weights = {"0.weight": rng.randn(6, 8).astype(np.float32) * 0.5,
               "0.bias": rng.randn(8).astype(np.float32) * 0.1,
               "2.weight": rng.randn(8, 3).astype(np.float32) * 0.5,
               "2.bias": rng.randn(3).astype(np.float32) * 0.1}
    batches = [(rng.randn(GLOBAL_BATCH, 6).astype(np.float32),
                rng.randn(GLOBAL_BATCH, 3).astype(np.float32))
               for _ in range(3)]
    data = {"w/" + k: v for k, v in weights.items()}
    for i, (x, y) in enumerate(batches):
        data[f"x{i}"], data[f"y{i}"] = x, y
    data["steps"] = np.int64(len(batches))
    np.savez(tmp_path / "data.npz", **data)
    tdist.spawn(torch_dist_worker.dygraph_dp,
                args=(str(tmp_path / "rendezvous"), str(tmp_path),
                      str(tmp_path / "data.npz")), nprocs=2)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for k, v in ranks[0].items():
        if k.startswith("param/"):
            np.testing.assert_array_equal(ranks[1][k], v, err_msg=k)
    want = _jax_mlp(weights, batches)
    assert sorted("param/" + k for k in want) == \
        sorted(k for k in ranks[0] if k.startswith("param/"))
    for k, v in want.items():
        np.testing.assert_allclose(ranks[0]["param/" + k], v, rtol=0,
                                   atol=1e-6, err_msg=k)


def test_spawn_sets_the_env_contract(tmp_path):
    tdist.spawn(torch_dist_worker.env_dump, args=(str(tmp_path),), nprocs=3,
                selected_devices="0,0,1")
    envs = [json.load(open(tmp_path / f"env{r}.json")) for r in range(3)]
    eps = envs[0]["PADDLE_TRAINER_ENDPOINTS"].split(",")
    assert len(set(eps)) == 3
    for r, env in enumerate(envs):
        assert env["PADDLE_TRAINER_ID"] == str(r)
        assert env["PADDLE_TRAINERS_NUM"] == "3"
        assert env["PADDLE_CURRENT_ENDPOINT"] == eps[r]
        assert env["PADDLE_TRAINER_ENDPOINTS"] == ",".join(eps)
        assert env["FLAGS_selected_gpus"] == "001"[r]
    with pytest.raises(ValueError, match="selected devices"):
        tdist.spawn(torch_dist_worker.env_dump, args=(str(tmp_path),),
                    nprocs=2, selected_devices="0")


def test_spawn_failing_rank_stops_the_others(tmp_path):
    t0 = time.time()
    with pytest.raises(RuntimeError, match="rank 2 fails on purpose"):
        tdist.spawn(torch_dist_worker.fail_or_wait, args=(2, str(tmp_path)),
                    nprocs=3)
    assert time.time() - t0 < 60  # the waiting ranks were terminated
    for r in (0, 1):
        pid = int(open(tmp_path / f"alive{r}").read())
        with pytest.raises(OSError):
            os.kill(pid, 0)


_SCRIPT = """
import json, os, sys, time
out = sys.argv[1]
r = os.environ["PADDLE_TRAINER_ID"]
keys = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_CURRENT_ENDPOINT",
        "PADDLE_TRAINER_ENDPOINTS", "FLAGS_selected_gpus")
with open(os.path.join(out, "env" + r + ".json"), "w") as f:
    json.dump({k: os.environ.get(k) for k in keys}, f)
if len(sys.argv) > 2:
    if r == sys.argv[2]:
        sys.exit(3)
    time.sleep(120)
"""


def _launch(tmp_path, *args, timeout=60):
    script = tmp_path / "train.py"
    script.write_text(_SCRIPT)
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch"]
        + list(args) + [str(script), str(tmp_path)]
        + (["1"] if "--fail" in args else []),
        cwd=REPO, capture_output=True, text=True, timeout=timeout)


def test_launch_sets_the_env_contract(tmp_path):
    p = _launch(tmp_path, "--nproc_per_node", "2", "--started_port",
                "36170", "--log_dir", str(tmp_path / "logs"))
    assert p.returncode == 0, p.stderr
    envs = [json.load(open(tmp_path / f"env{r}.json")) for r in range(2)]
    for r, env in enumerate(envs):
        assert env == {
            "PADDLE_TRAINER_ID": str(r), "PADDLE_TRAINERS_NUM": "2",
            "PADDLE_CURRENT_ENDPOINT": f"127.0.0.1:{36170 + r}",
            "PADDLE_TRAINER_ENDPOINTS": "127.0.0.1:36170,127.0.0.1:36171",
            "FLAGS_selected_gpus": str(r)}
    assert sorted(os.listdir(tmp_path / "logs")) == ["workerlog.0",
                                                     "workerlog.1"]


def test_launch_failing_rank_tears_the_pod_down(tmp_path):
    script = tmp_path / "train.py"
    script.write_text(_SCRIPT)
    t0 = time.time()
    p = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "3", "--term_grace", "2", str(script),
         str(tmp_path), "1"], cwd=REPO, capture_output=True, text=True,
        timeout=60)
    assert p.returncode == 1
    assert "exited non-zero {1: 3}" in p.stderr
    assert time.time() - t0 < 40  # not the ranks' 120 s sleep


@pytest.mark.parametrize("flag", ["--elastic", "--run_mode=ps"])
def test_launch_refuses_what_is_not_ported(tmp_path, flag, capsys,
                                           monkeypatch):
    from paddle_tpu_torch.distributed import launch
    if flag == "--elastic":
        # --elastic is ported; a multi-host pod without the fleet's
        # rendezvous dir is still refused, as in the JAX package
        monkeypatch.delenv("PADDLE_TPU_FLEET_DIR", raising=False)
        assert launch.main([flag, "--ips", "10.0.0.1,10.0.0.2",
                            "train.py"]) == 2
        assert "needs --fleet_dir" in capsys.readouterr().err
        return
    # --run_mode ps is ported: two servers and two trainers start with the
    # PS env contract (tests/test_torch_ps_runtime.py trains through it)
    script = tmp_path / "role.py"
    script.write_text(
        "import json, os, sys\n"
        "keys = ('TRAINING_ROLE', 'PADDLE_TRAINER_ID', 'PADDLE_PORT',\n"
        "        'PADDLE_PSERVERS_IP_PORT_LIST', 'PADDLE_TRAINERS_NUM')\n"
        "env = {k: os.environ.get(k) for k in keys}\n"
        "name = env['TRAINING_ROLE'] + env['PADDLE_TRAINER_ID']\n"
        "json.dump(env, open(os.path.join(sys.argv[1], name), 'w'))\n")
    assert launch.main([flag, "--server_num", "2", "--worker_num", "2",
                        str(script), str(tmp_path)]) == 0
    envs = {n: json.load(open(tmp_path / n))
            for n in ("PSERVER0", "PSERVER1", "TRAINER0", "TRAINER1")}
    servers = envs["PSERVER0"]["PADDLE_PSERVERS_IP_PORT_LIST"].split(",")
    assert len(servers) == 2
    for n, e in envs.items():
        assert e["PADDLE_TRAINERS_NUM"] == "2"
        assert e["PADDLE_PSERVERS_IP_PORT_LIST"] == ",".join(servers)
    assert [envs[f"PSERVER{i}"]["PADDLE_PORT"] for i in range(2)] == \
        [ep.split(":")[1] for ep in servers]


def test_compiled_program_refuses_what_is_not_ported():
    _, (tm, ts, tl) = _build_pair()
    exe = tstatic.Executor(tstatic.CPUPlace())
    scope = tstatic.Scope()
    feed = {k: v.astype(np.int64) for k, v in _feed().items()}
    with tstatic.scope_guard(scope):
        exe.run(ts)
        bs = tstatic.BuildStrategy()
        bs.sync_batch_norm = True
        cp = tstatic.CompiledProgram(tm, bs).with_data_parallel(
            loss_name=tl.name)
        with pytest.raises(NotImplementedError,
                           match="Queue 1, Distribution"):
            exe.run(cp, feed=feed, fetch_list=[tl])
        # tensor and sequence parallelism are ported: a degree the world
        # does not divide
        for knob in ("tensor_parallel_degree", "sequence_parallel_degree"):
            bs = tstatic.BuildStrategy()
            setattr(bs, knob, 2)
            with pytest.raises(ValueError, match="does not divide"):
                exe.run(tstatic.CompiledProgram(tm, bs).with_data_parallel(
                    loss_name=tl.name), feed=feed, fetch_list=[tl])
        # elastic programs are ported; under tensor parallelism they
        # still refuse
        tm._elastic_meta = {"logical_dp": 8}
        try:
            bs = tstatic.BuildStrategy()
            bs.tensor_parallel_degree = 2
            with pytest.raises(NotImplementedError, match="elastic"):
                exe.run_steps(tstatic.CompiledProgram(tm, bs)
                              .with_data_parallel(loss_name=tl.name),
                              feed={k: v[None] for k, v in feed.items()},
                              fetch_list=[tl])
        finally:
            del tm._elastic_meta
        with pytest.raises(ValueError, match="places"):
            exe.run(tstatic.CompiledProgram(tm).with_data_parallel(
                loss_name=tl.name, places=[0, 1]), feed=feed,
                fetch_list=[tl])


def test_world_of_one_compiled_program_equals_plain_run():
    """Outside a process group the CompiledProgram is the plain program
    plus identity allreduces (no scale at W = 1): run and run_steps give
    the plain Executor's losses to the last bit."""
    _, (tm, ts, tl) = _build_pair()
    feed = {k: v.astype(np.int64) for k, v in _feed().items()}
    out = {}
    for kind in ("plain", "compiled"):
        exe = tstatic.Executor(tstatic.CPUPlace())
        scope = tstatic.Scope()
        with tstatic.scope_guard(scope):
            exe.run(ts)
            prog = tm if kind == "plain" else tstatic.CompiledProgram(tm) \
                .with_data_parallel(loss_name=tl.name)
            losses = [exe.run(prog, feed=feed, fetch_list=[tl])[0]
                      for _ in range(2)]
            losses += list(exe.run_steps(
                prog, feed={k: np.stack([v] * 2) for k, v in feed.items()},
                fetch_list=[tl])[0])
        out[kind] = np.stack(losses)
    np.testing.assert_array_equal(out["compiled"], out["plain"])
