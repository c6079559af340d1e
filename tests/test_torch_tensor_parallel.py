"""Megatron tensor parallelism in the port (distributed/tensor_parallel.py,
models/static_lm.py, the tensor-parallel collective ops and
CompiledProgram's dp × tp world) against the JAX package on the CPU.

  * the five tensor-parallel ops (c_identity, mp_allreduce_sum,
    c_concat, c_split, c_embedding), forward and gradient, on 2 gloo
    ranks against the JAX ops under `shard_map` over a 2-device "tp"
    axis: gathers, slices and identities to the last bit, sums within
    rtol 1e-6;
  * `build_transformer_lm` at tp 1 and 2 and the Megatron layers
    serialize equal to the JAX package's programs (`built_tp_degree`
    reads the same degree);
  * the tp-2 language model on 2 ranks, and the dp2 × tp2 ZeRO-1
    regression (tests/test_tp_compose.py's composition) and language
    model on 4 ranks, train 3 steps as the JAX CompiledProgram on the
    same mesh: losses within rtol 1e-5, the gathered global state within
    rtol 2e-5 / atol 2e-6 (fp32; the language model's atol 5e-5, and its
    attention key biases 2 x the sum of the lrs: see `_check_tp`), the
    ranks' replicated parameters and
    gathered states equal to the last bit, and each tp-sharded weight at
    half its bytes in a rank's scope;
  * CompiledProgram still refuses sync_batch_norm and elastic programs
    under tensor parallelism,
    naming ROADMAP.md Queue 1, Distribution, and sequence parallelism
    together with tensor parallelism, as the JAX package does.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu
from paddle_tpu.core.pass_framework import built_tp_degree as jax_tp_degree
from paddle_tpu.core.program import _reset_unique_names as jax_reset
from paddle_tpu.ops.registry import OpContext, run_kernel
from paddle_tpu.utils.shard_map_compat import shard_map_unchecked

import paddle_tpu_torch
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core.pass_framework import built_tp_degree
from paddle_tpu_torch.core.program import _reset_unique_names as torch_reset

import torch_dist_worker
from torch_dist_worker import build_tp_lm, build_zero_mlp
from test_torch_program import flash_mode
from test_torch_sharding import (_check_case, _jax_state,
                                 _state_after_startup)

TP = 2


def _op_inputs():
    rng = np.random.RandomState(0)
    return {"x": rng.uniform(0.5, 1.5, (TP * 3, 4)).astype(np.float32),
            "g": rng.uniform(0.5, 1.5, (TP * 3, 4)).astype(np.float32),
            "g_wide": rng.uniform(0.5, 1.5, (TP * 3, 4 * TP))
            .astype(np.float32),
            "g_narrow": rng.uniform(0.5, 1.5, (TP * 3, 4 // TP))
            .astype(np.float32),
            "w": rng.randn(TP * 5, 3).astype(np.float32),
            "ids": rng.randint(0, TP * 5, (4, 2)).astype(np.int64),
            "g_emb": rng.uniform(0.5, 1.5, (4, 2, 3)).astype(np.float32)}


def _lm_feeds(steps, batch=4, seq=8, vocab=64, seed=11):
    rng = np.random.RandomState(seed)
    out = {}
    for i in range(steps):
        out[f"ids{i}"] = rng.randint(0, vocab, (batch, seq)).astype(np.int64)
        out[f"pos{i}"] = np.tile(np.arange(seq), (batch, 1)).astype(np.int64)
        out[f"labels{i}"] = rng.randint(0, vocab, (batch, seq, 1)) \
            .astype(np.int64)
    return out


CASES2 = {"lm_tp2": dict(tp=2, dp=1)}
CASES4 = {"mlp_dp2_tp2_zero1": dict(opt="adam", stage=1, dp=2, tp=2),
          "lm_dp2_tp2": dict(tp=2, dp=2),
          "lm_dp2_tp2_zero1": dict(tp=2, dp=2, stage=1)}
LM = {"lm_tp2", "lm_dp2_tp2", "lm_dp2_tp2_zero1"}


def _spawn_world(d, cases, nprocs):
    from test_torch_sharding import STEPS, _feeds
    feeds = dict(_feeds(STEPS))
    feeds.update(_lm_feeds(STEPS))
    np.savez(d / "feeds.npz", **feeds)
    cfgs, states = {}, {}
    for name, kw in cases.items():
        jax_reset()
        builder = build_tp_lm if name in LM else build_zero_mlp
        states[name] = _state_after_startup(builder(paddle_tpu, **kw))
        np.savez(d / f"{name}.npz", **states[name])
        cfgs[name] = {"build": kw, "state": str(d / f"{name}.npz"),
                      "feeds": str(d / "feeds.npz"), "steps": STEPS,
                      "model": "lm" if name in LM else "mlp",
                      "feed_names": ["ids", "pos", "labels"] if name in LM
                      else ["x", "y"]}
    tdist.spawn(torch_dist_worker.zero_train,
                args=(str(d / "rendezvous"), str(d), cfgs), nprocs=nprocs)
    return feeds, states, [dict(np.load(d / f"rank{r}.npz"))
                           for r in range(nprocs)]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One 2-rank world: the TP ops, then the tp-2 language model."""
    d = tmp_path_factory.mktemp("tp2")
    data = _op_inputs()
    np.savez(d / "ops.npz", **data)
    tdist.spawn(torch_dist_worker.tp_ops,
                args=(str(d / "rdv_ops"), str(d / "ops.npz"), str(d)),
                nprocs=TP)
    ops = [dict(np.load(d / f"rank{r}.npz")) for r in range(TP)]
    return data, ops, _spawn_world(d, CASES2, 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn_world(tmp_path_factory.mktemp("tp4"), CASES4, 4)


def _jax_tp(op, *xs, extra=None):
    """The JAX op (or its gradient op) over inputs split by rows on a
    2-device "tp" axis bound to ring 102."""
    mesh = Mesh(np.array(jax.devices()[:TP]), ("tp",))

    def f(*parts):
        ctx = OpContext(mesh_axes=("tp",), dist_info={102: "tp"})
        a = {"ring_id": 102}
        if op == "c_embedding":
            start = jax.lax.axis_index("tp") * (xs[0].shape[0] // TP)
            o = run_kernel("c_embedding", {"W": parts[0], "Ids": extra[0]},
                           dict(a, start_index=start), ctx)["Out"]
            _, vjp = jax.vjp(lambda w: run_kernel(
                "c_embedding", {"W": w, "Ids": extra[0]},
                dict(a, start_index=start), ctx)["Out"], parts[0])
            return o[None], vjp(extra[1])[0]
        fwd = run_kernel(op, {"X": parts[0]}, a, ctx)["Out"]
        grad = run_kernel(op + "_grad", {"X": parts[0], "Out": fwd,
                                         "Out@GRAD": parts[1]}, a,
                          ctx)["X@GRAD"]
        return fwd, grad
    out_specs = (P("tp"), P("tp"))
    g = shard_map_unchecked(f, mesh, in_specs=tuple(P("tp") for _ in xs),
                            out_specs=out_specs)
    return [np.asarray(r) for r in jax.jit(g)(*[jnp.asarray(x)
                                                  for x in xs])]


@pytest.mark.parametrize("op", ["c_identity", "mp_allreduce_sum",
                                "c_concat", "c_split", "c_embedding"])
def test_tp_op_matches_jax(world2, op):
    data, ops, _ = world2
    if op == "c_embedding":
        out, grad = _jax_tp(op, data["w"],
                            extra=(jnp.asarray(data["ids"]),
                                   jnp.asarray(data["g_emb"])))
        out = out.reshape((TP,) + data["g_emb"].shape)
        for r in range(TP):
            np.testing.assert_allclose(ops[r][op + "/out"], out[r],
                                       rtol=1e-6)
        np.testing.assert_allclose(
            np.concatenate([ops[r][op + "/grad"] for r in range(TP)]), grad,
            rtol=1e-6)
        return
    gname = {"c_concat": "g_wide", "c_split": "g_narrow"}.get(op, "g")
    out, grad = _jax_tp(op, data["x"], data[gname])
    got_out = np.concatenate([ops[r][op + "/out"] for r in range(TP)])
    got_grad = np.concatenate([ops[r][op + "/grad"] for r in range(TP)])
    exact = op in ("c_identity", "c_concat", "c_split")
    if exact:
        np.testing.assert_array_equal(got_out, out)
    else:
        np.testing.assert_allclose(got_out, out, rtol=1e-6)
    if op in ("mp_allreduce_sum", "c_split"):
        np.testing.assert_array_equal(got_grad, grad)
    else:
        np.testing.assert_allclose(got_grad, grad, rtol=1e-6)


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("flash", [False, True])
def test_static_lm_serializes_equal(tp, flash):
    from paddle_tpu.models import build_transformer_lm as jlm
    from paddle_tpu_torch.models import build_transformer_lm as tlm
    with flash_mode(flash):
        jax_reset()
        ref = jlm(96, 64, 2, 4, 16, tensor_parallel_degree=tp)
        torch_reset()
        port = tlm(96, 64, 2, 4, 16, tensor_parallel_degree=tp)
    assert port[0].to_dict() == ref[0].to_dict()
    assert port[1].to_dict() == ref[1].to_dict()
    assert built_tp_degree(port[0]) == jax_tp_degree(ref[0]) == \
        (tp if tp > 1 else 0)
    assert any(op.type == "flash_attention"
               for op in port[0].global_block().ops) == flash
    # sequence parallelism is ported (tests/test_torch_sequence_parallel.py)
    # but does not combine with tensor parallelism, as in the JAX package
    with pytest.raises(ValueError, match="cannot combine"):
        tlm(96, 64, 1, 4, 16, tensor_parallel_degree=2,
            sequence_parallel=True)


def test_tp_training_programs_serialize_equal():
    for kw in (dict(tp=2, dp=2), dict(tp=2, dp=2, stage=1)):
        jax_reset()
        ref = build_tp_lm(paddle_tpu, **kw)
        torch_reset()
        port = build_tp_lm(paddle_tpu_torch, **kw)
        assert port[0].to_dict() == ref[0].to_dict()
        assert port[1].to_dict() == ref[1].to_dict()
    jax_reset()
    ref = build_zero_mlp(paddle_tpu, opt="adam", stage=1, dp=2, tp=2)
    torch_reset()
    port = build_zero_mlp(paddle_tpu_torch, opt="adam", stage=1, dp=2, tp=2)
    assert port[0].to_dict() == ref[0].to_dict()
    assert port[3].to_dict() == ref[3].to_dict()


def _jax_tp_run(name, kw, state, feeds, names, n_dev):
    from paddle_tpu.distributed.compiled_program import (CompiledProgram,
                                                         BuildStrategy)
    import paddle_tpu.static as jstatic
    from test_torch_sharding import STEPS
    jax_reset()
    builder = build_tp_lm if name in LM else build_zero_mlp
    main, startup, loss, _ = builder(paddle_tpu, **kw)
    bs = BuildStrategy()
    bs.tensor_parallel_degree = kw["tp"]
    cp = CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, build_strategy=bs,
        places=jax.devices()[:n_dev])
    scope, exe = jstatic.Scope(), jstatic.Executor()
    losses = []
    with jstatic.scope_guard(scope):
        exe.run(startup)
        for n, v in state.items():
            scope.set(n, v)
        for i in range(STEPS):
            lv, = exe.run(cp, feed={n: feeds[f"{n}{i}"] for n in names},
                          fetch_list=[loss])
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
        return losses, _jax_state(scope)


def _check_tp(world, cases, name, n_dev):
    feeds, states, ranks = world
    kw = cases[name]
    names = ["ids", "pos", "labels"] if name in LM else ["x", "y"]
    want_losses, want = _jax_tp_run(name, kw, states[name], feeds, names,
                                    n_dev)
    np.testing.assert_allclose(ranks[0][name + "/losses"], want_losses,
                               rtol=1e-5)
    got = {k[len(name) + 7:]: v for k, v in ranks[0].items()
           if k.startswith(name + "/state/")}
    assert got and set(got) <= set(want)
    for r in ranks[1:]:
        for n, v in got.items():
            np.testing.assert_array_equal(r[f"{name}/state/{n}"], v)
    # the attention key bias's gradient is 0 in exact arithmetic (softmax
    # ignores a per-row constant), so Adam turns each package's rounding
    # noise into +-lr steps: that bias is held to 2 x the sum of the lrs
    # (tests/test_torch_dygraph_train.py's rule).  Adam's first steps are
    # ~lr x sign(g), so a weight whose gradient is near 0 moves by up to
    # lr x its gradient's relative rounding noise: the language model's
    # other state is held to atol 5e-5 (0.5% of lr; measured 2.3e-5 on 2
    # of 4096 elements of one MLP weight), the regression's to 2e-6
    k_bias = {f"col_parallel_fc_{4 * l + 1}.b_0" for l in range(2)} \
        if name in LM else set()
    for n, v in got.items():
        atol = 2 * 0.01 * len(want_losses) if n in k_bias else \
            5e-5 if name in LM else 2e-6
        np.testing.assert_allclose(v, np.asarray(want[n], np.float32),
                                   rtol=2e-5, atol=atol, err_msg=n)
    # a rank's scope: tp-sharded weights (and their moments) at 1/tp,
    # ZeRO buckets at 1/dp, everything else whole
    torch_reset()
    builder = build_tp_lm if name in LM else build_zero_mlp
    main = builder(paddle_tpu_torch, **kw)[0]
    from paddle_tpu_torch.distributed import partition_spec as tps
    places = tps.state_partition_specs(
        main, tps.Mesh({"dp": kw["dp"], "tp": kw["tp"]}), sorted(got))
    assert any(p != "replicated" and p[0] == "tp" for p in places.values())
    want_bytes = sum(want[n].nbytes // (1 if p == "replicated" else
                                        kw[p[0]])
                     for n, p in places.items())
    for r in ranks:
        assert int(r[name + "/scope_bytes"]) == want_bytes


@pytest.mark.parametrize("name", sorted(CASES2))
def test_tp2_lm_matches_jax(world2, name):
    _check_tp(world2[2], CASES2, name, 2)


@pytest.mark.parametrize("name", sorted(CASES4))
def test_dp2_tp2_matches_jax(world4, name):
    _check_tp(world4, CASES4, name, 4)


def test_compiled_program_refusals():
    main = build_zero_mlp(paddle_tpu_torch, opt="sgd", shard=False)[0]
    bs = tstatic.BuildStrategy()
    bs.sync_batch_norm = True
    cp = tstatic.CompiledProgram(main, build_strategy=bs) \
        .with_data_parallel()
    with pytest.raises(NotImplementedError, match="Queue 1, Distribution"):
        cp._get_program()
    # sequence parallelism is ported; with tensor parallelism it refuses,
    # as in the JAX package
    bs = tstatic.BuildStrategy()
    bs.sequence_parallel_degree = bs.tensor_parallel_degree = 2
    with pytest.raises(NotImplementedError, match="cannot both exceed 1"):
        tstatic.CompiledProgram(main, build_strategy=bs) \
            .with_data_parallel()._get_program()
    # elastic programs are ported, but not under tensor parallelism
    main._elastic_meta = {"logical_dp": 2}
    bs = tstatic.BuildStrategy()
    bs.tensor_parallel_degree = 2
    with pytest.raises(NotImplementedError, match="Queue 1, Distribution"):
        tstatic.CompiledProgram(main, build_strategy=bs) \
            .with_data_parallel()._get_program()
    bs = tstatic.BuildStrategy()
    bs.tensor_parallel_degree = 2
    main._elastic_meta = None
    with pytest.raises(ValueError, match="does not divide"):
        tstatic.CompiledProgram(main, build_strategy=bs) \
            .with_data_parallel()._get_program()
