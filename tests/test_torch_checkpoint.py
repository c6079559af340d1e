"""The port's checkpoint tier (checkpoint/, core/serialization.py's codec,
the executor's checkpoint hooks, incubate/checkpoint/) on the CPU.

  * atomic commit: a step dir holds its shard and manifest, no stage is
    left; an async save snapshots BY VALUE (the scope tensor written in
    place after `save` does not reach the shard);
  * verified load: a truncated shard and a bit-flipped shard are refused
    and the manager falls back to the previous step (warning + counter);
  * retention: keep-last-N and keep-every-M;
  * `load_merged`: two writer ranks reassemble (replicated tensors once,
    rank-private ones carried), diverged replicas refuse;
  * ZeRO-1: a sharded program's checkpoint restores into the plain
    program (unshard_state) and back (reshard_state), equal to the JAX
    package's conversion of the same state;
  * a SIGTERM'd training subprocess exits 143 and leaves a final
    checkpoint at the step it reached;
  * interchange: a step the JAX CheckpointManager saved from bench.py's
    CPU BERT program (seq 128, batch 4, 2 layers, hidden 256, vocab 1024,
    AMP on) restores through the port's `restore_from_checkpoint` with
    every tensor bitwise equal (a bf16 tensor too), and the port's save
    restores in the JAX package the same way; one further step from the
    restored state agrees within rtol 3e-3 (tests/test_torch_train.py's
    AMP bound);
  * incubate's CheckpointSaver / train_epoch_range resume an epoch loop.
"""
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

import paddle_tpu.static as jstatic
from paddle_tpu.checkpoint import CheckpointManager as JManager
from paddle_tpu.distributed import sharding as jsh

import paddle_tpu_torch
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.checkpoint import (CheckpointManager, CheckpointError,
                                         atomic_write)
from paddle_tpu_torch.core import monitor

from test_torch_run_steps import BENCH_CPU
from test_torch_train_program import build_both
from torch_dist_worker import build_zero_mlp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": torch.from_numpy(rng.randn(4, 3).astype(np.float32)),
            "b": torch.from_numpy(rng.randn(3).astype(np.float32)),
            "h": torch.from_numpy(rng.randn(2, 2).astype(np.float32))
            .bfloat16(),
            "n": torch.tensor([7], dtype=torch.int32)}


def _same(a, b):
    assert a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape)
    assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                       else a, b.view(torch.int16)
                       if b.dtype == torch.bfloat16 else b)


def test_atomic_commit_and_snapshot_by_value(tmp_path):
    st = _state()
    with CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(3, st, extra={"k": 1})
        st["w"].add_(1.0)  # the next step writes the scope tensor in place
        mgr.wait()
        assert mgr.all_steps() == [3] and mgr.latest_step() == 3
        names = sorted(os.listdir(tmp_path / "step_3"))
        assert names == ["manifest.json", "shard_00000.bin"]
        assert not [n for n in os.listdir(tmp_path) if n.startswith(".")]
        ck = mgr.load()
    assert ck.step == 3 and ck.extra == {"k": 1}
    want = _state()
    for n in want:
        _same(ck.state[n], want[n])
    man = json.load(open(tmp_path / "step_3" / "manifest.json"))
    assert man["tensors"]["h"]["dtype"] == "bfloat16"
    assert man["tensors"]["h"]["vdtype"] == "<u2"
    with atomic_write(str(tmp_path / "f.txt")) as f:
        f.write(b"x")
    assert open(tmp_path / "f.txt", "rb").read() == b"x"


@pytest.mark.parametrize("damage", ["truncate", "bitflip"])
def test_crc_fallback_to_previous_step(tmp_path, damage):
    with CheckpointManager(str(tmp_path), keep_last_n=3) as mgr:
        mgr.save(1, _state(1), sync=True)
        mgr.save(2, _state(2), sync=True)
    shard = tmp_path / "step_2" / "shard_00000.bin"
    data = bytearray(open(shard, "rb").read())
    if damage == "truncate":
        data = data[:len(data) // 2]
    else:
        data[5] ^= 0x10
    open(shard, "wb").write(bytes(data))
    before = monitor.stat_get("checkpoint.load_fallbacks")
    mgr = CheckpointManager(str(tmp_path))
    with pytest.warns(RuntimeWarning, match="falling back"):
        ck = mgr.load()
    mgr.close()
    assert ck.step == 1
    _same(ck.state["w"], _state(1)["w"])
    assert monitor.stat_get("checkpoint.load_fallbacks") == before + 1
    with pytest.raises(CheckpointError):
        CheckpointManager(str(tmp_path)).load(step=2)


def test_retention(tmp_path):
    with CheckpointManager(str(tmp_path), keep_last_n=2,
                           keep_every_m_steps=4) as mgr:
        for s in range(1, 10):
            mgr.save(s, _state(s))
        mgr.wait()
        assert mgr.all_steps() == [4, 8, 9]


def test_load_merged_two_writer_ranks(tmp_path):
    shared = _state(0)
    for r in (0, 1):
        m = CheckpointManager(str(tmp_path), rank=r, world_size=2)
        st = dict(shared, **{f"private{r}": torch.full((2,), float(r))})
        m.save(5, st)
        m.wait()
        if r == 0:
            m0 = m
        else:
            m.close()
    m0.commit(5)
    m0.close()
    one = CheckpointManager(str(tmp_path))  # a world of one resumes
    ck = one.load()
    assert ck.step == 5 and ck.extra["merged_from_world"] == 2
    for n in shared:
        _same(ck.state[n], shared[n])
    assert float(ck.state["private1"][0]) == 1.0
    # diverged replicas: refused, never laundered into a resume
    st = dict(_state(0))
    for r in (0, 1):
        m = CheckpointManager(str(tmp_path), rank=r, world_size=2)
        if r == 1:
            st = dict(st, w=st["w"] + 1)
        m.save(6, st, sync=True)
        if r == 0:
            m0 = m
        else:
            m.close()
    m0.commit(6)
    m0.close()
    with pytest.raises(CheckpointError, match="differ between writer"):
        one.load_merged(step=6)
    with pytest.warns(RuntimeWarning):
        assert one.load().step == 5  # the newest sound step
    one.close()


# ---------------------------------------------------------------------------
# ZeRO-1 layout conversion
# ---------------------------------------------------------------------------
def _zero_pair(shard):
    paddle_tpu_torch.core.program._reset_unique_names()
    return build_zero_mlp(paddle_tpu_torch, opt="adam", stage=1, dp=2,
                          shard=shard)


def _train_few(main, startup, loss, scope, exe, steps=2):
    rng = np.random.RandomState(0)
    with tstatic.scope_guard(scope):
        exe.run(startup)
        for _ in range(steps):
            exe.run(main, feed={"x": rng.rand(8, 8).astype(np.float32),
                                "y": rng.rand(8, 1).astype(np.float32)},
                    fetch_list=[loss])


def test_zero1_restore_unsharded_and_back(tmp_path):
    zmain, zstart, zloss, plan = _zero_pair(True)
    exe, scope = tstatic.Executor(tstatic.CPUPlace()), tstatic.Scope()
    _train_few(zmain, zstart, zloss, scope, exe)
    step, state, extra = exe.checkpoint_snapshot(zmain, scope)
    assert extra["zero_shard_plan"]["dp_degree"] == 2
    with CheckpointManager(str(tmp_path / "z")) as mgr:
        mgr.save(step, state, extra=extra, sync=True)
        pmain, pstart, ploss, _ = _zero_pair(False)
        pexe, pscope = tstatic.Executor(tstatic.CPUPlace()), tstatic.Scope()
        with tstatic.scope_guard(pscope):
            pexe.run(pstart)
        with pytest.warns(RuntimeWarning, match="converted"):
            assert pexe.restore_from_checkpoint(mgr, program=pmain,
                                                scope=pscope) == step
    np_state = {n: v.numpy() for n, v in state.items()}
    want = jsh.unshard_state(np_state, extra["zero_shard_plan"])
    for n, v in want.items():
        np.testing.assert_array_equal(pscope.get(n).numpy(), v, err_msg=n)
    # and back: the plain checkpoint restores into the sharded program
    step2, pstate, pextra = pexe.checkpoint_snapshot(pmain, pscope)
    with CheckpointManager(str(tmp_path / "p")) as mgr:
        mgr.save(step2, pstate, extra=pextra, sync=True)
        zexe2, zscope2 = tstatic.Executor(tstatic.CPUPlace()), \
            tstatic.Scope()
        with tstatic.scope_guard(zscope2):
            zexe2.run(zstart)
        with pytest.warns(RuntimeWarning, match="converted"):
            zexe2.restore_from_checkpoint(mgr, program=zmain, scope=zscope2)
    back = jsh.reshard_state({n: v.numpy() for n, v in pstate.items()},
                             jsh.ShardingPlan.from_dict(
                                 extra["zero_shard_plan"]))
    for n in plan.slot_var_names():
        np.testing.assert_array_equal(zscope2.get(n).numpy(), back[n],
                                      err_msg=n)
        np.testing.assert_array_equal(zscope2.get(n).numpy(),
                                      state[n].numpy(), err_msg=n)


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------
_PREEMPT = r"""
import sys, numpy as np
sys.path.insert(0, {repo!r}); sys.path.insert(0, {tests!r})
import torch; torch.set_num_threads(1)
import paddle_tpu_torch
from paddle_tpu_torch import static
from paddle_tpu_torch.checkpoint import CheckpointManager
from torch_dist_worker import build_zero_mlp
main, startup, loss, _ = build_zero_mlp(paddle_tpu_torch, opt="adam",
                                        shard=False)
exe, scope = static.Executor(static.CPUPlace()), static.Scope()
mgr = CheckpointManager({root!r})
mgr.install_preemption_handler()
rng = np.random.RandomState(0)
with static.scope_guard(scope):
    exe.run(startup)
    exe.enable_checkpointing(mgr, program=main, every_n_steps=100)
    for i in range(50):
        exe.run(main, feed={{"x": rng.rand(8, 8).astype(np.float32),
                            "y": rng.rand(8, 1).astype(np.float32)}},
                fetch_list=[loss])
print("not reached")
"""


def test_sigterm_exits_143_with_a_final_checkpoint(tmp_path):
    root = str(tmp_path / "ckpt")
    src = _PREEMPT.format(repo=REPO, tests=os.path.join(REPO, "tests"),
                          root=root)
    env = dict(os.environ, PADDLE_TPU_CHAOS="kill@3:signal=term")
    p = subprocess.run([sys.executable, "-c", src], env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 143, p.stderr[-2000:]
    assert "not reached" not in p.stdout
    with CheckpointManager(root) as mgr:
        # the startup run and 3 training runs: executor step 4
        assert mgr.latest_step() == 4
        ck = mgr.load()
    assert ck.extra["executor_step"] == 4


# ---------------------------------------------------------------------------
# interchange with the JAX package
# ---------------------------------------------------------------------------
BATCH = 4


def _bench_feed(seed):
    rng = np.random.RandomState(seed)
    seq, vocab = BENCH_CPU["seq"], BENCH_CPU["vocab"]
    return {"ids": rng.randint(0, vocab, (BATCH, seq)).astype(np.int64),
            "pos": np.tile(np.arange(seq), (BATCH, 1)).astype(np.int64),
            "labels": rng.randint(0, vocab, (BATCH, seq, 1))
            .astype(np.int64)}


@pytest.fixture(scope="module")
def bench_pair():
    return build_both(True, kernels=False, **BENCH_CPU)


def _jax_bits(v):
    a = np.asarray(v)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _torch_bits(t):
    return t.view(torch.int16).numpy().view(np.uint16) \
        if t.dtype == torch.bfloat16 else t.numpy()


def test_jax_checkpoint_restores_in_the_port_bitwise(tmp_path, bench_pair):
    (jm, js, jl), (tm, ts, tl) = bench_pair
    assert tm.fingerprint() == jm.fingerprint()
    jexe, jscope = jstatic.Executor(), jstatic.Scope()
    with jstatic.scope_guard(jscope):
        jexe.run(js)
        jexe.run(jm, feed=_bench_feed(0), fetch_list=[jl])
        step, state, extra = jexe.checkpoint_snapshot(jm, jscope)
        # host copies: the next step donates the scope's device buffers
        state = {n: np.array(v) for n, v in state.items()}
        state["bf16_probe"] = state[jm.all_parameters()[0].name].astype(
            ml_dtypes.bfloat16)
        with JManager(str(tmp_path)) as mgr:
            mgr.save(step, state, extra=extra, sync=True)
        want_loss = float(np.asarray(jexe.run(
            jm, feed=_bench_feed(1), fetch_list=[jl])[0]).reshape(-1)[0])
    texe, tscope = tstatic.Executor(tstatic.CPUPlace()), tstatic.Scope()
    with tstatic.scope_guard(tscope):
        texe.run(ts)
        with CheckpointManager(str(tmp_path)) as mgr, \
                warnings.catch_warnings():
            warnings.simplefilter("error")  # no chimera / conversion
            assert texe.restore_from_checkpoint(mgr, program=tm,
                                                scope=tscope) == step
        assert tscope.get("bf16_probe").dtype == torch.bfloat16
        for n, v in state.items():
            np.testing.assert_array_equal(_torch_bits(tscope.get(n)),
                                          _jax_bits(v), err_msg=n)
        got_loss = float(texe.run(tm, feed=_bench_feed(1),
                                  fetch_list=[tl])[0].reshape(-1)[0])
    np.testing.assert_allclose(got_loss, want_loss, rtol=3e-3)


def test_port_checkpoint_restores_in_jax_bitwise(tmp_path, bench_pair):
    (jm, js, jl), (tm, ts, tl) = bench_pair
    texe, tscope = tstatic.Executor(tstatic.CPUPlace()), tstatic.Scope()
    with tstatic.scope_guard(tscope):
        texe.run(ts)
        texe.run(tm, feed=_bench_feed(0), fetch_list=[tl])
        step, state, extra = texe.checkpoint_snapshot(tm, tscope)
        state["bf16_probe"] = state[tm.all_parameters()[0].name].bfloat16()
        with CheckpointManager(str(tmp_path)) as mgr:
            mgr.save(step, state, extra=extra, sync=True)
        want_loss = float(texe.run(tm, feed=_bench_feed(1),
                                   fetch_list=[tl])[0].reshape(-1)[0])
    jexe, jscope = jstatic.Executor(), jstatic.Scope()
    with jstatic.scope_guard(jscope):
        jexe.run(js)
        with JManager(str(tmp_path)) as mgr, warnings.catch_warnings():
            warnings.simplefilter("error")
            assert jexe.restore_from_checkpoint(mgr, program=jm,
                                                scope=jscope) == step
        assert jscope.get("bf16_probe").dtype == jnp.bfloat16
        for n, v in state.items():
            np.testing.assert_array_equal(_jax_bits(jscope.get(n)),
                                          _torch_bits(v), err_msg=n)
        got_loss = float(np.asarray(jexe.run(
            jm, feed=_bench_feed(1), fetch_list=[jl])[0]).reshape(-1)[0])
    np.testing.assert_allclose(got_loss, want_loss, rtol=3e-3)


# ---------------------------------------------------------------------------
# incubate's auto-checkpoint
# ---------------------------------------------------------------------------
def test_train_epoch_range_resumes(tmp_path, monkeypatch):
    """An epoch loop killed in epoch 1 resumes at epoch 1 with epoch 0's
    state and ends where an uninterrupted loop ends, bitwise."""
    from paddle_tpu_torch.incubate.checkpoint import auto_checkpoint as ac
    monkeypatch.setenv("PADDLE_RUNNING_ENV", "PADDLE_EDL_AUTO_CHECKPOINT")
    monkeypatch.setenv("PADDLE_EDL_HDFS_CHECKPOINT_PATH", str(tmp_path))
    main, startup, loss, _ = build_zero_mlp(paddle_tpu_torch, opt="adam",
                                            shard=False)
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(8, 8).astype(np.float32),
            "y": rng.rand(8, 1).astype(np.float32)}

    def run(job, stop_at=None):
        monkeypatch.setenv("PADDLE_JOB_ID", job)
        monkeypatch.setattr(ac, "g_checker", None)
        seen = []
        exe, scope = tstatic.Executor(tstatic.CPUPlace()), tstatic.Scope()
        with tstatic.scope_guard(scope):
            exe.run(startup)
            for ep in ac.train_epoch_range(3, save_checkpoint_inter=0):
                seen.append(ep)
                exe.run(main, feed=feed, fetch_list=[loss])
                if ep == stop_at:
                    break  # killed before the epoch's checkpoint
        return seen, {p.name: scope.get(p.name).clone()
                      for p in main.all_parameters()}

    assert run("a", stop_at=1)[0] == [0, 1]
    seen, resumed = run("a")
    assert seen == [1, 2]
    seen, straight = run("b")
    assert seen == [0, 1, 2]
    for n in straight:
        assert torch.equal(resumed[n], straight[n]), n
