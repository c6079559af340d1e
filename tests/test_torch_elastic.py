"""Elastic data parallelism in the port (distributed/elastic.py, the two
ops of ops/kernels/collective.py, CompiledProgram's elastic schedule, the
executor's topology-shifted restore) against the JAX package on the CPU.

  * `elasticize` rewrites a program op for op as the JAX package does:
    the serialized main and startup programs and the meta are equal for
    the fc regression of the JAX tests, bench.py's CPU BERT shape with
    AMP on and off, and the ZeRO-1 composition; the refusals are the
    same;
  * `rebucket_feeds`, `rederive_schedule` and `micro_steps_per_global`
    give the JAX outputs; `elastic_commit_mask` and `c_elastic_fold`
    (pre_reduced too) match the JAX kernels off a mesh, exactly;
  * the fc regression at world 4 (spawned gloo ranks) gives the JAX
    CompiledProgram's global-step losses (4 devices) within rtol 1e-5;
  * the port is BITWISE equal to itself across worlds 1, 2 and 4, between
    `run_steps` and the looped form, and through a chaos kill at world 2,
    a resume at world 1 that is SIGTERM'd mid-window, and a regrow to
    world 2 (launched ranks, checkpoints every global step);
  * elastic x ZeRO-1 is allclose within 1e-6 across worlds 2 and 4 and to
    the plain program (the reduce-scatter sums in the backend's order);
  * one process is one rank: `reanchor_topology` re-derives the schedule
    for the process group's world and refuses another.

Workers: tests/torch_elastic_worker.py (one thread a rank).
"""
import contextlib
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax

import paddle_tpu
import paddle_tpu.static as jstatic
from paddle_tpu.distributed import elastic as jel
from paddle_tpu.distributed.compiled_program import \
    CompiledProgram as JCompiled
from paddle_tpu.ops.kernels import collective as jkc
from paddle_tpu.ops.registry import OpContext as JCtx

import paddle_tpu_torch
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed import elastic as tel
from paddle_tpu_torch.ops.registry import OpContext as TCtx, run_kernel

import torch_elastic_worker as W
from test_torch_run_steps import BENCH_CPU
from test_torch_train_program import build_both

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_elastic_worker.py")
STEPS = 4


# ---------------------------------------------------------------------------
# the rewrite
# ---------------------------------------------------------------------------
def _fc_pair(zero_stage=0):
    return (W.build_fc(paddle_tpu, zero_stage=zero_stage),
            W.build_fc(paddle_tpu_torch, zero_stage=zero_stage))


@pytest.mark.parametrize("zero_stage", [0, 1])
def test_fc_elastic_programs_serialize_equal(zero_stage):
    (jm, js, _, jmeta), (tm, ts, _, tmeta) = _fc_pair(zero_stage)
    assert tmeta == jmeta
    assert tmeta["zero_stage1"] == bool(zero_stage)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    assert tm.serialize_to_string() == jm.serialize_to_string()


@pytest.mark.parametrize("use_amp", [True, False])
def test_bench_elastic_programs_serialize_equal(use_amp):
    """bench.py's BERT step (CPU shape) elasticized at logical dp 4: 39
    folds (38 gradients and the loss) and one commit mask in both."""
    (jm, js, jl), (tm, ts, tl) = build_both(use_amp, kernels=False,
                                            **BENCH_CPU)
    jmeta = jel.elasticize(jm, js, 4, loss_name=jl)
    tmeta = tel.elasticize(tm, ts, 4, loss_name=tl)
    assert tmeta == jmeta
    types = [op.type for op in tm.global_block().ops]
    assert types.count("c_elastic_fold") == 39
    assert types.count("elastic_commit_mask") == 1
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()


def _refusal(pkg, case):
    main, startup, loss, _ = W.build_fc(pkg, elastic=False)
    el = tel if pkg is paddle_tpu_torch else jel
    if case == "not_pow2":
        el.elasticize(main, startup, 6, loss_name=loss)
    elif case == "twice":
        el.elasticize(main, startup, 4, loss_name=loss)
        el.elasticize(main, startup, 4, loss_name=loss)
    elif case == "no_minimize":
        st = paddle_tpu_torch.static if pkg is paddle_tpu_torch \
            else jstatic
        el.elasticize(st.Program(), st.Program(), 4)
    elif case in ("zero2", "zero3"):
        sh = (paddle_tpu_torch if pkg is paddle_tpu_torch
              else paddle_tpu).distributed.sharding
        sh.shard_optimizer_states(main, startup, dp_degree=4,
                                  stage=int(case[-1]))
        el.elasticize(main, startup, 4, loss_name=loss)
    elif case == "gradient_merge":
        st = paddle_tpu_torch.static if pkg is paddle_tpu_torch \
            else jstatic
        st.gradient_merge(main, 2, startup)
        el.elasticize(main, startup, 4, loss_name=loss)


@pytest.mark.parametrize("case", ["not_pow2", "twice", "no_minimize",
                                  "zero2", "zero3", "gradient_merge"])
def test_elasticize_refuses_as_jax(case):
    with pytest.raises(Exception) as want:
        _refusal(paddle_tpu, case)
    with pytest.raises(type(want.value)) as got:
        _refusal(paddle_tpu_torch, case)
    assert str(got.value) == str(want.value)


def test_schedule_helpers_match_jax():
    feed = {"x": np.arange(16.).reshape(8, 2), "y": np.ones((8, 1)),
            "lr": np.float32(0.1), "table": np.zeros((1024, 4))}
    for n, w in ((8, 2), (8, 8), (4, 1)):
        got, want = tel.rebucket_feeds(feed, n, w), \
            jel.rebucket_feeds(feed, n, w)
        assert len(got) == len(want)
        for g, r in zip(got, want):
            assert sorted(g) == sorted(r)
            for k in g:
                np.testing.assert_array_equal(g[k], r[k])
    for bad in ({"x": np.zeros((10, 2))}, {"x": np.zeros((8, 2)),
                                           "t": np.zeros((6, 2))}):
        with pytest.raises(ValueError) as want:
            jel.rebucket_feeds(bad, 8, 2)
        with pytest.raises(ValueError, match=str(want.value)[:30]):
            tel.rebucket_feeds(bad, 8, 2)
    for cv in (6, 7, 0, 13):
        extra = {"executor_step": 99, "dataset_position": 5,
                 "elastic": {"logical_dp": 8, "k": 2, "counter_value": cv}}
        for nw in (1, 2, 4, 8):
            with _quiet():
                assert tel.rederive_schedule(extra, nw) == \
                    jel.rederive_schedule(extra, nw)
    assert tel.rederive_schedule({}, 4) is None
    (jm, _, _, _), (tm, _, _, _) = _fc_pair()
    for w in (1, 2, 4):
        assert tel.micro_steps_per_global(tm, w) == \
            jel.micro_steps_per_global(jm, w)
    with pytest.raises(ValueError, match="not divisible"):
        tel.micro_steps_per_global(tm, 3)


@contextlib.contextmanager
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


@pytest.mark.parametrize("pre_reduced", [False, True])
def test_ops_match_jax_off_a_process_group(pre_reduced):
    """Off a process group / mesh both ops are the JAX ops: the mask is
    counter % N == 0 (a world of one walks all N micro-steps), the fold
    acc + x; bitwise."""
    rng = np.random.RandomState(3)
    x = rng.randn(5, 3).astype(np.float32)
    acc = rng.randn(5, 3).astype(np.float32)
    attrs = {"ring_id": 0, "logical_dp": 4, "pre_reduced": pre_reduced}
    want = jkc.c_elastic_fold({"X": jax.numpy.asarray(x),
                               "Acc": jax.numpy.asarray(acc)}, attrs,
                              JCtx(seed=0))["Out"]
    got = run_kernel("c_elastic_fold", {"X": torch.from_numpy(x),
                                        "Acc": torch.from_numpy(acc)},
                     attrs, TCtx(seed=0))["Out"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for c in range(9):
        cnt = np.array([c], np.int32)
        want = jkc.elastic_commit_mask({"X": jax.numpy.asarray(cnt)},
                                       {"logical_dp": 4}, JCtx(seed=0))
        got = run_kernel("elastic_commit_mask", {"X": torch.from_numpy(cnt)},
                         {"logical_dp": 4}, TCtx(seed=0))
        np.testing.assert_array_equal(got["Out"].numpy(),
                                      np.asarray(want["Out"]))


# ---------------------------------------------------------------------------
# training: spawned worlds against JAX and against each other
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def start_state(tmp_path_factory):
    """The JAX startup's parameters, the start of every run."""
    d = tmp_path_factory.mktemp("elastic_state")
    main, startup, _, _ = W.build_fc(paddle_tpu)
    scope, exe = jstatic.Scope(), jstatic.Executor()
    with jstatic.scope_guard(scope):
        exe.run(startup)
        state = {p.name: np.asarray(scope.get(p.name))
                 for p in main.all_parameters()}
    np.savez(d / "start.npz", **state)
    return str(d / "start.npz"), state


def _spawn(tmp_path_factory, start, cases, nprocs):
    d = tmp_path_factory.mktemp(f"elastic_w{nprocs}")
    cases = {n: dict(c, state=start[0]) for n, c in cases.items()}
    tdist.spawn(W.elastic_world, args=(str(d / "rendezvous"), str(d),
                                       cases), nprocs=nprocs)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(nprocs)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, start_state):
    """{world: rank 0's results} for the looped form at worlds 1, 2, 4,
    `run_steps` at 2, and elastic x ZeRO-1 at 2 and 4 (the ranks of a
    world checked equal to the last bit)."""
    cases = {1: {"run": dict(steps=STEPS)},
             2: {"run": dict(steps=STEPS),
                 "run_steps": dict(steps=STEPS, mode="run_steps"),
                 "zero1": dict(steps=STEPS, zero=1)},
             4: {"run": dict(steps=STEPS), "zero1": dict(steps=STEPS,
                                                         zero=1)}}
    out = {}
    for w, cs in cases.items():
        ranks = _spawn(tmp_path_factory, start_state, cs, w)
        for r in ranks[1:]:
            for k, v in ranks[0].items():
                np.testing.assert_array_equal(r[k], v, err_msg=k)
        out[w] = ranks[0]
    return out


def _jax_run(state, n_dev, zero_stage=0, elastic=True):
    main, startup, loss, meta = W.build_fc(paddle_tpu, zero_stage=zero_stage,
                                           elastic=elastic)
    scope, exe = jstatic.Scope(), jstatic.Executor()
    losses = []
    with jstatic.scope_guard(scope):
        exe.run(startup)
        for n, v in state.items():
            scope.set(n, jax.numpy.asarray(v))
        cp = JCompiled(main).with_data_parallel(
            loss_name=loss.name, places=jax.devices()[:n_dev])
        for f in W.feeds_for(STEPS):
            if elastic:
                for mf in jel.rebucket_feeds(f, W.LOGICAL, n_dev):
                    out = exe.run(cp, feed=mf, fetch_list=[meta["loss_avg"]])
            else:
                out = exe.run(cp, feed=f, fetch_list=[loss])
            losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
        params = {p.name: np.asarray(scope.get(p.name))
                  for p in main.all_parameters()}
    return np.asarray(losses), params


def test_world4_matches_jax(worlds, start_state):
    want, params = _jax_run(start_state[1], 4)
    got = worlds[4]
    np.testing.assert_allclose(got["run/losses"], want, rtol=1e-5)
    for n, v in params.items():
        np.testing.assert_allclose(got["run/" + n], v, rtol=1e-5,
                                   atol=1e-6, err_msg=n)


@pytest.mark.parametrize("other", [(2, "run"), (4, "run"),
                                   (2, "run_steps")])
def test_bitwise_across_worlds_and_run_steps(worlds, other):
    """Worlds 2 and 4, and run_steps at 2, against world 1: every
    global-step loss and every parameter to the last bit."""
    ref = worlds[1]
    w, case = other
    got = worlds[w]
    names = [k[len("run/"):] for k in ref if k.startswith("run/")]
    for n in names:
        np.testing.assert_array_equal(got[f"{case}/{n}"], ref[f"run/{n}"],
                                      err_msg=f"{case}@{w}: {n}")


def test_zero1_allclose_across_worlds(worlds, start_state):
    """elastic x ZeRO-1 at worlds 2 and 4 against the plain program (JAX,
    4 devices, no elastic): 1e-6, the JAX composition's contract."""
    plain, params = _jax_run(start_state[1], 4, elastic=False)
    for w in (2, 4):
        got = worlds[w]
        np.testing.assert_allclose(got["zero1/losses"], plain, rtol=1e-6,
                                   atol=1e-6)
        for n, v in params.items():
            np.testing.assert_allclose(got["zero1/" + n], v, rtol=1e-6,
                                       atol=1e-6, err_msg=f"{w}: {n}")


# ---------------------------------------------------------------------------
# kill, shrink, regrow through checkpoints (launched ranks)
# ---------------------------------------------------------------------------
def _launch(base, nproc, steps, chaos=None, timeout=120):
    env = dict(os.environ, PADDLE_TPU_JOURNAL_DIR=os.path.join(base,
                                                               "journal"))
    env.pop("PADDLE_TPU_CHAOS", None)
    if chaos:
        env["PADDLE_TPU_CHAOS"] = chaos
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", str(nproc), "--term_grace", "3",
         "--log_dir", os.path.join(base, f"logs{nproc}"), WORKER, base,
         str(steps)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=timeout)


def test_chaos_kill_shrink_regrow_bitwise(tmp_path, worlds, start_state):
    """World 2, rank 1 SIGKILLed after its 2nd micro-step (the end of
    global step 0, whose checkpoint both ranks staged and rank 0
    committed); world 1 resumes (a rank-merged load of the world-2
    checkpoint) and is SIGTERM'd after 3 micro-steps, mid-window (the
    preemption save rounds down, the window replays); world 2 regrows
    and finishes.  Every recomputed global-step loss and every final
    parameter equals the uninterrupted run's, bitwise."""
    base = str(tmp_path)
    np.savez(os.path.join(base, "start.npz"), **start_state[1])
    p = _launch(base, 2, STEPS, chaos="kill@2:rank=1")
    assert p.returncode == 1 and "{1: -9}" in p.stderr, p.stderr[-2000:]
    p = _launch(base, 1, STEPS, chaos="kill@3:signal=term")
    assert p.returncode == 1 and "{0: 143}" in p.stderr, p.stderr[-2000:]
    mid = json.load(open(os.path.join(base, "out_rank0_r0.json")))
    assert mid["world"] == 1 and mid["resumed_global"] == 1, mid
    p = _launch(base, 2, STEPS)
    assert p.returncode == 0, p.stderr[-3000:]
    ref = worlds[1]
    for r in (0, 1):
        c = json.load(open(os.path.join(base, f"out_rank{r}_r0.json")))
        assert c["done"] and c["world"] == 2 and c["resumed_global"] == 1, c
        for gi, lv in c["losses"].items():
            assert np.float32(lv) == ref["run/losses"][int(gi)], gi
        for n, v in c["params"].items():
            np.testing.assert_array_equal(np.asarray(v, np.float32),
                                          ref["run/" + n], err_msg=n)
    # the journals tell the story: the kill, the SIGTERM, the merged load
    from paddle_tpu_torch.observability import (read_rank_journals,
                                                reconstruct_timeline)
    events = read_rank_journals(os.path.join(base, "journal"))
    kinds = [e["kind"] for evs in events.values() for e in evs]
    assert "restore_merged" in kinds and kinds.count("chaos") == 2
    # rank 0 ran three incarnations (world 2, world 1, world 2)
    assert len(reconstruct_timeline(events[0])["incarnations"]) == 3


# ---------------------------------------------------------------------------
# one process is one rank
# ---------------------------------------------------------------------------
def test_reanchor_topology_is_the_process_world(start_state):
    """The port cannot change a live process's world (the JAX controller
    re-meshes in place): reanchor_topology re-derives the schedule for
    the process group's world (1 here, no group) and refuses another,
    naming the relaunch path."""
    main, startup, loss, meta = W.build_fc(paddle_tpu_torch)
    exe = tstatic.Executor(tstatic.CPUPlace())
    scope = tstatic.Scope()
    with tstatic.scope_guard(scope):
        exe.run(startup)
        cp = tstatic.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
        mf = W.feeds_for(1)[0]
        for part in tel.rebucket_feeds(mf, W.LOGICAL, 1)[:3]:
            exe.run(cp, feed=part, fetch_list=[meta["loss_avg"]])
        with _quiet():  # mid-window: rounds down, the window replays
            assert tel.reanchor_topology(exe, main, scope) == 0
        assert int(scope.get(meta["counter"])[0]) == 0
        assert exe._elastic_steps == 0 and exe._last_elastic_k == 4
        assert all(not scope.get(a).any() for a in meta["accs"])
        with pytest.raises(ValueError, match="relaunch"):
            tel.reanchor_topology(exe, main, scope, 2)
