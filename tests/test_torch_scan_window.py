"""The commit-tail hoist in the port (distributed/scan_window.py and the
hoisted window of CompiledProgram.run_steps) against the JAX package on
the CPU.

  * `split_commit_tail` splits the ZeRO x gradient-merge programs into
    body and tail programs that serialize equal to the JAX package's
    (k, counter and tail size equal too), and refuses (None) where the
    JAX package refuses; `mark_scan_hoist` records the same pass entry;
    `scan_window_wire_bytes` raises, naming its ROADMAP item;
  * at a world of one, `run_steps` K = 4 over a gm-2 window runs
    hoisted, and its losses and every persistable are bitwise those of
    PADDLE_TPU_SCAN_HOIST=0 and of K looped `run` calls (the JAX test
    tests/test_scan_smoke.py:61's contract), and within rtol 1e-5 of the
    JAX package's `run_steps`;
  * on 2 gloo ranks (ZeRO-2, gm 2, two calls of K = 4): hoisted and
    unhoisted give bitwise-equal losses and global state, the hoisted
    calls issue one publish all-gather per bucket a window (half the
    unhoisted's) and one merged allreduce a window, and both hold the
    JAX package's 2-device run_steps within rtol 1e-5.
"""
import json

import numpy as np
import pytest
import torch

import jax

import paddle_tpu
import paddle_tpu.static as jstatic
from paddle_tpu.core.program import _reset_unique_names as jax_reset
from paddle_tpu.distributed import scan_window as jsw
from paddle_tpu.distributed.compiled_program import \
    CompiledProgram as JCompiled

import paddle_tpu_torch
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core.pass_framework import applied_passes
from paddle_tpu_torch.core.program import _reset_unique_names as torch_reset
from paddle_tpu_torch.distributed import scan_window as tsw

import torch_dist_worker
from torch_dist_worker import build_zero_mlp
from test_torch_sharding import _state_after_startup

K, GM, CALLS = 4, 2, 2
SPLITS = {"zero2_adam": dict(opt="adam", stage=2, dp=2, gm=GM),
          "zero1_momentum": dict(opt="momentum", stage=1, dp=2, gm=4),
          "zero3_adam": dict(opt="adam", stage=3, dp=2, gm=GM),
          "plain_gm": dict(opt="adam", shard=False, gm=GM),
          "amp_zero2": dict(opt="adam", stage=2, dp=2, gm=GM, amp=True),
          "no_gm": dict(opt="adam", stage=2, dp=2)}


def _pair(**kw):
    jax_reset()
    ref = build_zero_mlp(paddle_tpu, **kw)
    torch_reset()
    port = build_zero_mlp(paddle_tpu_torch, **kw)
    return ref, port


@pytest.mark.parametrize("name", sorted(SPLITS))
def test_split_serializes_equal(name):
    ref, port = _pair(**SPLITS[name])
    js = jsw.split_commit_tail(ref[0], [ref[2].name])
    ts = tsw.split_commit_tail(port[0], [port[2].name])
    assert (js is None) == (ts is None)
    if js is None:
        assert name == "no_gm"
        with pytest.raises(ValueError, match="no hoistable commit tail"):
            tsw.mark_scan_hoist(port[0])
        return
    assert (ts.k, ts.counter, ts.n_tail_ops) == (js.k, js.counter,
                                                 js.n_tail_ops)
    assert ts.body.to_dict() == js.body.to_dict()
    assert ts.tail.to_dict() == js.tail.to_dict()
    # a fetch the commit writes refuses, in both
    tail_out = ts.tail.global_block().ops[-1].output_names()[0]
    assert tsw.split_commit_tail(port[0], [tail_out]) is None
    assert jsw.split_commit_tail(ref[0], [tail_out]) is None
    jsw.mark_scan_hoist(ref[0])
    tsw.mark_scan_hoist(port[0])
    assert port[0].to_dict() == ref[0].to_dict()
    assert [p for p in applied_passes(port[0])
            if p["pass"] == "scan_hoist"] == [
        {"pass": "scan_hoist", "k": js.k, "n_tail_ops": js.n_tail_ops}]


def test_wire_bytes_raises_naming_its_item():
    """scan_window_wire_bytes no longer raises: it prices the looped and
    the hoisted window with the verifier's entry_wire_bytes, equal to the
    JAX package's at every world."""
    ref, port = _pair(**SPLITS["zero2_adam"])
    for world in (2, 8):
        got = tsw.scan_window_wire_bytes(port[0], world)
        assert got == jsw.scan_window_wire_bytes(ref[0], world)
        assert got["k"] == GM and got["tail"] > 0
        assert got["per_step_hoisted"] < got["per_step_looped"]


def _feeds(calls, k=K, batch=8, seed=5):
    rng = np.random.RandomState(seed)
    return {f"{n}{c}": rng.rand(k, batch, d).astype(np.float32)
            for c in range(calls) for n, d in (("x", 8), ("y", 1))}


def _port_world1(kw, state, feeds, hoist, monkeypatch, looped=False):
    monkeypatch.setenv("PADDLE_TPU_SCAN_HOIST", "1" if hoist else "0")
    torch_reset()
    main, startup, loss, _ = build_zero_mlp(paddle_tpu_torch, **kw)
    cp = tstatic.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    exe, scope = tstatic.Executor(tstatic.CPUPlace()), tstatic.Scope()
    with tstatic.scope_guard(scope):
        exe.run(startup)
        for n, v in state.items():
            scope.set(n, torch.from_numpy(np.array(v)))
        losses = []
        for c in range(CALLS):
            if looped:
                for i in range(K):
                    lv, = exe.run(cp, feed={n: feeds[f"{n}{c}"][i]
                                            for n in ("x", "y")},
                                  fetch_list=[loss])
                    losses.append(np.asarray(lv, np.float32).reshape(()))
            else:
                lv, = exe.run_steps(cp, feed={n: feeds[f"{n}{c}"]
                                              for n in ("x", "y")},
                                    fetch_list=[loss])
                losses.extend(np.asarray(lv, np.float32).reshape(-1))
        hoisted = getattr(cp, "_last_hoisted", None)
        st = {n: v.numpy() for n, v in cp.global_state(scope).items()}
    return np.asarray(losses), st, hoisted, exe._step


def _jax_run_steps(kw, state, feeds, n_dev):
    jax_reset()
    main, startup, loss, _ = build_zero_mlp(paddle_tpu, **kw)
    cp = JCompiled(main).with_data_parallel(loss_name=loss.name,
                                            places=jax.devices()[:n_dev])
    scope, exe = jstatic.Scope(), jstatic.Executor()
    losses = []
    with jstatic.scope_guard(scope):
        exe.run(startup)
        for n, v in state.items():
            scope.set(n, v)
        for c in range(CALLS):
            lv, = exe.run_steps(cp, feed={n: feeds[f"{n}{c}"]
                                          for n in ("x", "y")},
                                fetch_list=[loss])
            losses.extend(np.asarray(lv).reshape(-1))
        st = {n: np.asarray(scope.find_var(n).get_tensor())
              for n in scope.vars
              if scope.find_var(n).get_tensor() is not None}
    return np.asarray(losses, np.float32), st


@pytest.mark.parametrize("name", ["zero2_adam", "plain_gm"])
def test_world1_hoisted_is_bitwise_unhoisted_and_looped(name, monkeypatch):
    kw = dict(SPLITS[name], dp=1) if "dp" in SPLITS[name] else SPLITS[name]
    jax_reset()
    state = _state_after_startup(build_zero_mlp(paddle_tpu, **kw))
    feeds = _feeds(CALLS)
    hl, hs, hoisted, hstep = _port_world1(kw, state, feeds, True,
                                          monkeypatch)
    ul, us, unhoisted, ustep = _port_world1(kw, state, feeds, False,
                                            monkeypatch)
    ll, ls, _, lstep = _port_world1(kw, state, feeds, True, monkeypatch,
                                    looped=True)
    assert hoisted is True and unhoisted is False
    assert hstep == ustep == lstep
    for other_l, other_s in ((ul, us), (ll, ls)):
        assert hl.tobytes() == other_l.tobytes()
        assert sorted(hs) == sorted(other_s)
        for n in hs:
            assert hs[n].tobytes() == other_s[n].tobytes(), n
    jl, js = _jax_run_steps(kw, state, feeds, 1)
    np.testing.assert_allclose(hl, jl, rtol=1e-5)
    for n, v in hs.items():
        np.testing.assert_allclose(v, np.asarray(js[n], v.dtype),
                                   rtol=2e-5, atol=2e-6, err_msg=n)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    d = tmp_path_factory.mktemp("scan2")
    kw = SPLITS["zero2_adam"]
    jax_reset()
    state = _state_after_startup(build_zero_mlp(paddle_tpu, **kw))
    feeds = _feeds(CALLS)
    np.savez(d / "state.npz", **state)
    np.savez(d / "feeds.npz", **feeds)
    cfg = {"build": kw, "state": str(d / "state.npz"),
           "feeds": str(d / "feeds.npz"), "calls": CALLS}
    tdist.spawn(torch_dist_worker.scan_window_train,
                args=(str(d / "rendezvous"), str(d), cfg), nprocs=2)
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]
    return kw, state, feeds, ranks


def test_dp2_hoisted_is_bitwise_unhoisted(world2):
    kw, _, _, ranks = world2
    for r in ranks:
        assert bool(r["hoisted/hoisted"]) and not bool(r["unhoisted/hoisted"])
        assert r["hoisted/losses"].tobytes() == \
            r["unhoisted/losses"].tobytes()
        for key, v in r.items():
            if key.startswith("hoisted/state/"):
                other = r["un" + key]
                assert v.tobytes() == other.tobytes(), key
    # the ranks agree to the bit
    assert ranks[0]["hoisted/losses"].tobytes() == \
        ranks[1]["hoisted/losses"].tobytes()


def test_dp2_hoist_runs_the_commit_collectives_once_a_window(world2):
    kw, _, _, ranks = world2
    torch_reset()
    main = build_zero_mlp(paddle_tpu_torch, **kw)[0]
    buckets = sum(op.type == "c_allgather"
                  for op in main.global_block().ops)
    assert buckets >= 1
    windows = CALLS * K // GM
    hoisted = json.loads(str(ranks[0]["hoisted/calls"]))
    unhoisted = json.loads(str(ranks[0]["unhoisted/calls"]))
    assert hoisted["c_allgather"] == buckets * windows
    assert unhoisted["c_allgather"] == buckets * CALLS * K
    # the body's reduce-scatter folds run every step in both
    assert hoisted["c_reducescatter"] == unhoisted["c_reducescatter"] == \
        CALLS * K * sum(op.type == "c_reducescatter"
                        for op in main.global_block().ops)


def test_dp2_run_steps_matches_jax(world2):
    kw, state, feeds, ranks = world2
    jl, js = _jax_run_steps(kw, state, feeds, 2)
    np.testing.assert_allclose(ranks[0]["hoisted/losses"], jl, rtol=1e-5)
    for key, v in ranks[0].items():
        if key.startswith("hoisted/state/"):
            n = key[len("hoisted/state/"):]
            np.testing.assert_allclose(v, np.asarray(js[n], np.float32),
                                       rtol=2e-5, atol=2e-6, err_msg=n)
