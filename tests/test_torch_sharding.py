"""ZeRO stages 1-3 in the port (distributed/sharding.py,
partition_spec.py, CompiledProgram's sharded state) against the JAX
package on the CPU.

  * `shard_optimizer_states` rewrites a program op for op as the JAX
    package does: the serialized main and startup programs and
    `ShardingPlan.to_dict()` are equal for stages 1/2/3 over sgd,
    momentum, adam, adamw and lamb, with bf16 AMP, with recompute, with
    small buckets, with gradient merge and with fp16_allreduce (also
    after the data-parallel rewrite, which skips the reduce-scattered
    gradients); the partition-spec rules and placements decide
    the same;
  * `unshard_state` / `reshard_state` give the JAX functions' arrays for
    every stage pair;
  * at a world of one (no process group: every collective the identity)
    the sharded program trains within rtol 1e-5 of the JAX package's
    over 20 steps;
  * on 2 and 4 gloo ranks (one `spawn` a world, every case in it) the
    gathered global state after 3 steps matches the JAX CompiledProgram
    at the same dp within rtol 2e-5 / atol 2e-6 (fp32; the sums run in
    another order than XLA's psum), the losses within rtol 1e-5, the
    ranks' gathered states equal to the last bit, and each rank's scope
    holds its shard only.
"""
import json

import numpy as np
import pytest

import jax

import paddle_tpu
import paddle_tpu.amp  # noqa: F401
import paddle_tpu.static as jstatic
from paddle_tpu.core.flags import set_flags as jax_set_flags
from paddle_tpu.core.program import _reset_unique_names as jax_reset
from paddle_tpu.distributed import partition_spec as jps
from paddle_tpu.distributed import sharding as jsh
from paddle_tpu.distributed.compiled_program import (
    CompiledProgram as JCompiled, BuildStrategy as JBuild)

import paddle_tpu_torch
import paddle_tpu_torch.amp  # noqa: F401
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.core.flags import set_flags as torch_set_flags
from paddle_tpu_torch.core.program import _reset_unique_names as torch_reset
from paddle_tpu_torch.distributed import partition_spec as tps
from paddle_tpu_torch.distributed import sharding as tsh
from paddle_tpu_torch.io import load_params_from_numpy

import torch_dist_worker
from torch_dist_worker import OPTIMIZERS, build_zero_mlp

STEPS = 3
RTOL, ATOL = 2e-5, 2e-6


def _pair(**kw):
    jax_reset()
    ref = build_zero_mlp(paddle_tpu, **kw)
    torch_reset()
    port = build_zero_mlp(paddle_tpu_torch, **kw)
    return ref, port


@pytest.mark.parametrize("opt", OPTIMIZERS)
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_sharded_programs_serialize_equal(opt, stage):
    ref, port = _pair(opt=opt, stage=stage, dp=4)
    assert port[0].to_dict() == ref[0].to_dict()
    assert port[1].to_dict() == ref[1].to_dict()
    assert port[3].to_dict() == ref[3].to_dict()
    assert port[3].buckets


@pytest.mark.parametrize("variant", ["amp", "small_buckets", "recompute",
                                     "gradient_merge", "fp16_allreduce"])
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_sharded_variants_serialize_equal(variant, stage):
    kw = {"amp": dict(amp=True), "small_buckets": dict(bucket=200),
          "recompute": {}, "gradient_merge": dict(gm=2),
          "fp16_allreduce": dict(fp16_allreduce=True)}[variant]
    if variant == "recompute":
        jax_set_flags({"recompute": "always"})
        torch_set_flags({"recompute": "always"})
    try:
        ref, port = _pair(opt="adam", stage=stage, dp=2, **kw)
    finally:
        jax_set_flags({"recompute": ""})
        torch_set_flags({"recompute": ""})
    assert port[0].to_dict() == ref[0].to_dict()
    assert port[1].to_dict() == ref[1].to_dict()
    assert port[3].to_dict() == ref[3].to_dict()
    if variant == "small_buckets":
        assert len(port[3].buckets) > 2
    if variant == "fp16_allreduce":  # the bucket reduce-scatter in bf16
        rs = [op for op in port[0].global_block().ops
              if op.type == "c_reducescatter"]
        assert rs and all(port[0].global_block().var(op.inputs["X"][0])
                          .dtype == "bfloat16" for op in rs)
    # a data-parallel rewrite skips the reduce-scattered gradients
    from paddle_tpu.distributed.compiled_program import \
        insert_grad_allreduce as jins
    from paddle_tpu_torch.distributed.compiled_program import \
        insert_grad_allreduce as tins
    assert tins(port[0]).to_dict() == jins(ref[0]).to_dict()


def test_bucket_env_and_idempotency(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SHARD_BUCKET_MB", "0.0002")
    ref, port = _pair(opt="momentum", stage=1, dp=2)
    assert port[3].to_dict() == ref[3].to_dict()
    assert len(port[3].buckets) > 1
    again = tsh.shard_optimizer_states(port[0], port[1], dp_degree=2)
    assert again.buckets == [] and port[0]._zero_shard_plan is port[3]
    assert tsh.predicted_shardable_slots(port[0]) == set()
    fresh = build_zero_mlp(paddle_tpu_torch, opt="adam", shard=False)
    jfresh = build_zero_mlp(paddle_tpu, opt="adam", shard=False)
    assert tsh.predicted_shardable_slots(fresh[0]) == \
        jsh.predicted_shardable_slots(jfresh[0])
    assert tsh.predicted_shardable_params(fresh[0]) == \
        jsh.predicted_shardable_params(jfresh[0])


def test_partition_rules_decide_the_same():
    names = ["param:fc_0.w_0", "slot:fc_0.w_0_moment1_0", "scalar:b1",
             "grad_acc:fc_0.w_0@GRAD", "param:col_parallel_fc_0.w_0",
             "param:row_parallel_fc_0.b_0", "other"]
    numels = {"scalar:b1": 1}
    for stage in range(4):
        j = jps.match_partition_rules(jps.zero_stage_rules(stage), names,
                                      numels)
        t = tps.match_partition_rules(tps.zero_stage_rules(stage), names,
                                      numels)
        assert t.specs == j.specs and t.unmatched == j.unmatched
    j = jps.match_partition_rules(jps.tensor_parallel_rules(), names)
    t = tps.match_partition_rules(tps.tensor_parallel_rules(), names)
    assert t.specs == j.specs
    ref, port = _pair(opt="adam", shard=False)
    for stage in (1, 2, 3):
        rules = [("^param:fc_0", ())]
        j = jps.build_sharding_specs(ref[0], stage, rules)
        t = tps.build_sharding_specs(port[0], stage, rules)
        assert t.specs == j.specs and t.unmatched == j.unmatched
    # a strict user rule claiming a var the pass cannot shard is refused
    torch_reset()
    fx = build_zero_mlp(paddle_tpu_torch, opt="adam", shard=False)
    fx[0].global_block().var("fc_0.w_0").attrs["dist_attr"] = ["tp", 1]
    with pytest.raises(ValueError, match="over-match refused"):
        tps.build_sharding_specs(fx[0], 3, [("^param:fc_0.w_0", ("dp",))])


def _jax_placement(spec):
    dims = [(i, a) for i, a in enumerate(tuple(spec)) if a is not None]
    return "replicated" if not dims else (dims[0][1], dims[0][0])


@pytest.mark.parametrize("tp", [1, 2])
def test_state_placements_match_jax_specs(tp):
    from jax.sharding import Mesh
    ref, port = _pair(opt="adam", stage=1, dp=2, tp=tp)
    names = sorted(v.name for v in port[0].global_block().vars.values()
                   if v.persistable)
    axes = ("dp", "tp") if tp > 1 else ("dp",)
    mesh = Mesh(np.array(jax.devices()[:2 * tp]).reshape(
        (2, tp) if tp > 1 else (2,)), axes)
    want = jps.state_partition_specs(ref[0], mesh, names)
    got = tps.state_partition_specs(
        port[0], tps.Mesh(dict(zip(axes, (2, tp)))), names)
    assert got == {n: _jax_placement(s) for n, s in want.items()}
    assert any(p != "replicated" for p in got.values())
    fw = jps.feed_partition_specs(ref[0], mesh, ["x", "y", "absent"])
    ft = tps.feed_partition_specs(port[0], tps.Mesh(dict(zip(axes, (2, tp)))),
                                  ["x", "y", "absent"])
    assert ft == {n: _jax_placement(s) for n, s in fw.items()}


def _jax_state(scope):
    return {n: np.asarray(scope.find_var(n).get_tensor())
            for n in scope.vars if scope.find_var(n).get_tensor() is not None}


def _state_after_startup(ref):
    scope, exe = jstatic.Scope(), jstatic.Executor()
    with jstatic.scope_guard(scope):
        exe.run(ref[1])
    return _jax_state(scope)


@pytest.mark.parametrize("src,dst", [(a, b) for a in (1, 2, 3)
                                     for b in (1, 2, 3)])
def test_unshard_reshard_equal_jax(src, dst):
    ref_a, port_a = _pair(opt="adam", stage=src, dp=2, bucket=300)
    ref_b, port_b = _pair(opt="adam", stage=dst, dp=2, bucket=300)
    state = _state_after_startup(ref_a)
    rng = np.random.RandomState(src * 3 + dst)
    state = {n: (rng.randn(*v.shape).astype(v.dtype)
                 if v.dtype.kind == "f" else v) for n, v in state.items()}
    ju = jsh.unshard_state(state, ref_a[3])
    tu = tsh.unshard_state(state, port_a[3].to_dict())
    assert sorted(ju) == sorted(tu)
    for n in ju:
        np.testing.assert_array_equal(np.asarray(tu[n]), np.asarray(ju[n]))
    jr = jsh.reshard_state(ju, ref_b[3])
    tr = tsh.reshard_state(tu, port_b[3])
    assert sorted(jr) == sorted(tr)
    for n in jr:
        np.testing.assert_array_equal(np.asarray(tr[n]), np.asarray(jr[n]))


def _feeds(steps, batch=8, seed=7):
    rng = np.random.RandomState(seed)
    out = {}
    for i in range(steps):
        out[f"x{i}"] = rng.rand(batch, 8).astype(np.float32)
        out[f"y{i}"] = rng.rand(batch, 1).astype(np.float32)
    return out


def test_world_of_one_trains_as_jax():
    """No process group: the collectives are the identity and the shard
    is the whole bucket; 20 stage-3 lamb steps and 20 stage-2 adam steps
    under gradient merge within rtol 1e-5 of the JAX package's."""
    feeds = _feeds(20, seed=3)
    for kw in (dict(opt="lamb", stage=3, dp=4),
               dict(opt="adam", stage=2, dp=4, gm=2)):
        ref, port = _pair(**kw)
        state = _state_after_startup(ref)
        jscope, jexe = jstatic.Scope(), jstatic.Executor()
        tscope, texe = tstatic.Scope(), tstatic.Executor(tstatic.CPUPlace())
        jl, tl = [], []
        with jstatic.scope_guard(jscope):
            jexe.run(ref[1])
            for n, v in state.items():
                jscope.set(n, v)
            for i in range(20):
                jl.append(jexe.run(ref[0], feed={"x": feeds[f"x{i}"],
                                                 "y": feeds[f"y{i}"]},
                                   fetch_list=[ref[2]])[0])
            jstate = _jax_state(jscope)
        with tstatic.scope_guard(tscope):
            texe.run(port[1])
            load_params_from_numpy(tscope, state, tstatic.CPUPlace())
            for i in range(20):
                tl.append(texe.run(port[0], feed={"x": feeds[f"x{i}"],
                                                  "y": feeds[f"y{i}"]},
                                   fetch_list=[port[2]])[0])
        np.testing.assert_allclose(np.ravel(tl), np.ravel(jl), rtol=1e-5)
        for n, v in jstate.items():
            np.testing.assert_allclose(tscope.vars[n].float().numpy(), v,
                                       rtol=1e-5, atol=1e-6, err_msg=n)


# -- multi-rank ----------------------------------------------------------
CASES2 = dict(
    [(f"{o}_s{s}", dict(opt=o, stage=s, dp=2))
     for o in OPTIMIZERS for s in (1, 2, 3)]
    + [("adam_s2_gm2", dict(opt="adam", stage=2, dp=2, gm=2)),
       ("adam_s3_small", dict(opt="adam", stage=3, dp=2, bucket=200)),
       ("adam_s1_amp", dict(opt="adam", stage=1, dp=2, amp=True))])
CASES4 = {f"{o}_s{s}": dict(opt=o, stage=s, dp=4)
          for o in ("adam", "lamb") for s in (1, 2, 3)}


def _jax_run(kw, state, feeds, n_dev):
    jax_reset()
    main, startup, loss, _ = build_zero_mlp(paddle_tpu, **kw)
    bs = JBuild()
    bs.tensor_parallel_degree = kw.get("tp", 1)
    cp = JCompiled(main).with_data_parallel(
        loss_name=loss.name, build_strategy=bs,
        places=jax.devices()[:n_dev])
    scope, exe = jstatic.Scope(), jstatic.Executor()
    losses = []
    with jstatic.scope_guard(scope):
        exe.run(startup)
        for n, v in state.items():
            scope.set(n, v)
        for i in range(STEPS):
            lv, = exe.run(cp, feed={"x": feeds[f"x{i}"], "y": feeds[f"y{i}"]},
                          fetch_list=[loss])
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
        return losses, _jax_state(scope)


def run_world(tmp_path_factory, cases, nprocs, tag):
    d = tmp_path_factory.mktemp(tag)
    feeds = _feeds(STEPS)
    np.savez(d / "feeds.npz", **feeds)
    cfgs, states = {}, {}
    for name, kw in cases.items():
        jax_reset()
        ref = build_zero_mlp(paddle_tpu, **kw)
        states[name] = _state_after_startup(ref)
        np.savez(d / f"{name}.npz", **states[name])
        cfgs[name] = {"build": kw, "state": str(d / f"{name}.npz"),
                      "feeds": str(d / "feeds.npz"), "steps": STEPS,
                      "feed_names": ["x", "y"]}
    tdist.spawn(torch_dist_worker.zero_train,
                args=(str(d / "rendezvous"), str(d), cfgs), nprocs=nprocs)
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(nprocs)]
    return feeds, states, ranks


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world(tmp_path_factory, CASES2, 2, "zero2")


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return run_world(tmp_path_factory, CASES4, 4, "zero4")


def _check_case(world, cases, name, n_dev):
    feeds, states, ranks = world
    kw = cases[name]
    want_losses, want = _jax_run(kw, states[name], feeds, n_dev)
    got = {k[len(name) + 7:]: v for k, v in ranks[0].items()
           if k.startswith(name + "/state/")}
    for r in ranks[1:]:  # the ranks' gathered states agree to the bit
        for n, v in got.items():
            np.testing.assert_array_equal(r[f"{name}/state/{n}"], v)
    # bf16 AMP: the two packages' bf16 products round differently, so
    # the tolerances of tests/test_torch_train.py's AMP parity
    lrtol, rtol, atol = (1e-2, 2e-2, 2e-3) if kw.get("amp") else \
        (1e-5, RTOL, ATOL)
    np.testing.assert_allclose(ranks[0][name + "/losses"], want_losses,
                               rtol=lrtol)
    assert sorted(got) == sorted(n for n in want if n in got)
    for n, v in want.items():
        if n in got:
            np.testing.assert_allclose(got[n], np.asarray(v, np.float32),
                                       rtol=rtol, atol=atol, err_msg=n)
    # each rank keeps its shard: the scope is smaller than the global one
    global_bytes = sum(v.nbytes for n, v in want.items() if n in got)
    torch_reset()
    main, _, _, plan = build_zero_mlp(paddle_tpu_torch, **kw)
    sharded = sum(want[n].nbytes for n in got
                  if main.global_block().var(n).attrs.get("dp_shard"))
    # (sgd at stages 1-2 has no sharded state: no slots, params whole)
    assert sharded or (kw["opt"] == "sgd" and kw["stage"] < 3)
    for r in ranks:
        assert int(r[name + "/scope_bytes"]) == \
            global_bytes - sharded + sharded // n_dev
    calls = json.loads(str(ranks[0][name + "/calls"]))
    rs = sum(1 for b in plan.buckets)
    assert calls.get("c_reducescatter") == rs
    if kw["stage"] < 3:
        assert calls.get("c_allgather") == rs
    else:
        assert calls.get("c_allgather") == 2 * len(plan.param_bucket_names())


@pytest.mark.parametrize("name", sorted(CASES2))
def test_two_ranks_match_jax(world2, name):
    _check_case(world2, CASES2, name, 2)


@pytest.mark.parametrize("name", sorted(CASES4))
def test_four_ranks_match_jax(world4, name):
    _check_case(world4, CASES4, name, 4)
