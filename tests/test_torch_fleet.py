"""fleet's collective mode in the port against the JAX package: every
ported `DistributedStrategy` builds the same programs.

A tiny BERT forward (2 layers, hidden 32, seq 8, vocab 64; the bench
step's layers) is built with each package's static layers from the same
unique-name state, then `fleet.init(is_collective=True)`,
`fleet.distributed_optimizer(opt, strategy).minimize(loss)`.  Gates: the
main and startup programs equal as `to_dict()` and as serialized
strings, the applied meta-optimizers the same list, and
`insert_grad_allreduce` of the minimized program (what the
CompiledProgram runs, with its 1/W scale) equal too.  At a world of one
no process group is formed.  Strategies: amp, recompute, gradient_merge,
fp16_allreduce, lars, lamb, localsgd, adaptive_localsgd, dgc, and
combinations (amp with gradient merge and fp16 allreduce; amp with lamb,
where lamb wins and amp is dropped, as in the JAX package; sharding at
stages 1-3, with amp and gradient merge).  The strategies that are not
ported (pipeline, the parameter server) raise naming ROADMAP.md Queue 1,
Distribution.
"""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu.distributed.fleet as jfleet
from paddle_tpu.core.program import _reset_unique_names as jax_reset_names
from paddle_tpu.distributed.compiled_program import (
    insert_grad_allreduce as jax_insert)

import paddle_tpu_torch
import paddle_tpu_torch.distributed.fleet as tfleet
from paddle_tpu_torch.core.program import (_reset_unique_names as
                                           torch_reset_names)
from paddle_tpu_torch.distributed.compiled_program import (
    CompiledProgram, insert_grad_allreduce as torch_insert)
from test_torch_program import flash_mode
from test_torch_train_program import fused_mode

CFG = dict(vocab=64, seq=8, hidden=32, layers_n=2, heads=2)


def _adam(static):
    return static.Adam(learning_rate=1e-3)


def _momentum(static):
    return static.Momentum(learning_rate=1e-2, momentum=0.9)


def _set(**fields):
    def apply(s, ckpts):
        for k, v in fields.items():
            setattr(s, k, v)
    return apply


def _recompute(s, ckpts):
    s.recompute = True
    s.recompute_configs = {"checkpoints": ckpts}


STRATEGIES = {
    "amp": (_adam, _set(amp=True)),
    "recompute": (_adam, _recompute),
    "gradient_merge": (_adam, _set(gradient_merge=True,
                                   gradient_merge_configs={"k_steps": 2,
                                                           "avg": True})),
    "fp16_allreduce": (_adam, _set(fp16_allreduce=True)),
    "lars": (_momentum, _set(lars=True)),
    "lamb": (_adam, _set(lamb=True)),
    "localsgd": (_adam, _set(localsgd=True,
                             localsgd_configs={"k_steps": 4,
                                               "begin_step": 2})),
    "adaptive_localsgd": (_adam, _set(
        adaptive_localsgd=True,
        adaptive_localsgd_configs={"init_k_steps": 2, "begin_step": 1})),
    "dgc": (_momentum, _set(dgc=True, dgc_configs={
        "rampup_begin_step": 0, "rampup_step": 1, "sparsity": [0.99]})),
    "amp+gradient_merge+fp16_allreduce": (_adam, _set(
        amp=True, fp16_allreduce=True, gradient_merge=True,
        gradient_merge_configs={"k_steps": 2, "avg": True})),
    "amp+lamb": (_adam, _set(amp=True, lamb=True)),
    "sharding": (_adam, _set(sharding=True, sharding_configs={
        "stage": 1, "dp_degree": 2})),
    "sharding_stage3": (_adam, _set(sharding=True, sharding_configs={
        "stage": 3, "dp_degree": 4, "bucket_mb": 0.01})),
    "amp+sharding+gradient_merge": (_adam, _set(
        amp=True, sharding=True, sharding_configs={"stage": 2,
                                                   "dp_degree": 2},
        gradient_merge=True, gradient_merge_configs={"k_steps": 2,
                                                     "avg": True})),
    "none": (_adam, _set()),
}


def _build(pkg, fleet, make_opt, configure):
    """The forward, then fleet's minimize: (main, startup, loss, applied
    meta-optimizers)."""
    static = pkg.static
    layers, nets = static.layers, static.nets
    vocab, seq, hidden = CFG["vocab"], CFG["seq"], CFG["hidden"]
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        ids = layers.data("ids", [-1, seq], dtype="int64")
        pos = layers.data("pos", [-1, seq], dtype="int64")
        labels = layers.data("labels", [-1, seq, 1], dtype="int64")
        h = layers.elementwise_add(layers.embedding(ids, size=[vocab, hidden]),
                                   layers.embedding(pos, size=[seq, hidden]))
        h = layers.layer_norm(h, begin_norm_axis=2)
        ckpts = []
        for _ in range(CFG["layers_n"]):
            q = layers.fc(h, hidden, num_flatten_dims=2)
            k = layers.fc(h, hidden, num_flatten_dims=2)
            v = layers.fc(h, hidden, num_flatten_dims=2)
            ctx = nets.scaled_dot_product_attention(q, k, v,
                                                    num_heads=CFG["heads"])
            h = layers.layer_norm(layers.elementwise_add(
                h, layers.fc(ctx, hidden, num_flatten_dims=2)),
                begin_norm_axis=2)
            ffn = layers.fc(layers.fc(h, hidden * 4, num_flatten_dims=2,
                                      act="gelu"), hidden, num_flatten_dims=2)
            h = layers.layer_norm(layers.elementwise_add(h, ffn),
                                  begin_norm_axis=2)
            ckpts.append(h)
        loss = layers.mean(layers.softmax_with_cross_entropy(
            layers.fc(h, vocab, num_flatten_dims=2), labels))
        fleet.init(is_collective=True)
        strategy = fleet.DistributedStrategy()
        configure(strategy, ckpts[:-1])
        opt = fleet.distributed_optimizer(make_opt(static), strategy)
        opt.minimize(loss)
    return main, startup, loss, fleet.applied_meta_list()


def _both(name):
    make_opt, configure = STRATEGIES[name]
    with flash_mode(False), fused_mode(False):
        jax_reset_names()
        ref = _build(paddle_tpu, jfleet, make_opt, configure)
        torch_reset_names()
        port = _build(paddle_tpu_torch, tfleet, make_opt, configure)
    return ref, port


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_strategy_programs_match_jax(name):
    (jm, js, jl, jmeta), (tm, ts, tl, tmeta) = _both(name)
    assert tmeta == jmeta
    assert tl.name == jl.name
    for t, j in ((tm, jm), (ts, js),
                 (torch_insert(tm), jax_insert(jm))):
        assert t.to_dict() == j.to_dict()
        assert t.serialize_to_string() == j.serialize_to_string()
    if "localsgd" in name:
        # LocalSGD drops the graph-execution optimizer (as in the JAX
        # package): each rank runs the program itself, its parameter
        # averaging the only collective
        assert tfleet.main_program is tm
    else:
        assert isinstance(tfleet.main_program, CompiledProgram)
        assert tfleet.main_program._program is tm
    assert tfleet.startup_program is ts
    types = [op.type for op in tm.global_block().ops]
    expect = {"dgc": "dgc", "lars": "lars_momentum", "lamb": "lamb",
              "localsgd": "c_allreduce_sum", "amp": "cast"}
    if name in expect:
        assert expect[name] in types


def test_amp_and_lamb_resolve_as_jax():
    """AMP cannot compose with Lamb: the inner one (Lamb) wins."""
    (_, _, _, jmeta), (tm, _, _, tmeta) = _both("amp+lamb")
    assert "LambOptimizer" in tmeta and "AMPOptimizer" not in tmeta
    assert tmeta == jmeta


@pytest.mark.parametrize("what", ["sharding", "pipeline"])
def test_unported_strategies_raise(what):
    """The pipeline raises.  Sharding (ZeRO) is ported now: its case
    builds the JAX package's programs, its meta-optimizer in the chain."""
    if what == "sharding":
        (jm, js, _, jmeta), (tm, ts, _, tmeta) = _both("sharding")
        assert "ShardingOptimizer" in tmeta and tmeta == jmeta
        assert tm.to_dict() == jm.to_dict() and ts.to_dict() == js.to_dict()
        return

    def configure(s, ckpts):
        setattr(s, what, True)
    torch_reset_names()
    with flash_mode(False), pytest.raises(NotImplementedError,
                                          match="Queue 1, Distribution"):
        _build(paddle_tpu_torch, tfleet, _adam, configure)


def test_parameter_server_raises():
    from paddle_tpu_torch.distributed.fleet import (Role,
                                                    UserDefinedRoleMaker)
    tfleet.init(is_collective=True)
    for fn in (tfleet.init_worker, tfleet.init_server, tfleet.run_server,
               tfleet.stop_worker):
        with pytest.raises(NotImplementedError,
                           match="Queue 1, Distribution"):
            fn()
    with pytest.raises(NotImplementedError, match="Queue 1, Distribution"):
        UserDefinedRoleMaker(role=Role.SERVER)


def test_role_and_util_at_world_one(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "127.0.0.1:6170")
    tfleet.init(is_collective=True)
    assert tfleet.worker_num() == 1 and tfleet.worker_index() == 0
    assert tfleet.is_first_worker() and tfleet.is_worker()
    assert tfleet.worker_endpoints(to_string=True) == "127.0.0.1:6170"
    np.testing.assert_array_equal(tfleet.util.all_reduce(np.arange(3)),
                                  np.arange(3))
    assert tfleet.util.all_gather({"a": 1}) == [{"a": 1}]
    assert tfleet.util.get_file_shard(["a", "b", "c"]) == ["a", "b", "c"]
    tfleet.barrier_worker()


def test_localsgd_averages_across_ranks(tmp_path):
    """strategy.localsgd (k = 2, from step 1) on 2 gloo ranks with their
    own batches: after step 1 each rank keeps its own parameters, after
    step 2 both hold the mean of what each would have alone (the same
    program run per rank with no process group, where the average is the
    parameter itself): rtol 1e-6."""
    import torch_dist_worker as tw
    from paddle_tpu_torch import distributed as tdist
    rng = np.random.RandomState(2)
    main, _, _ = tw.build_localsgd(2)
    data = {"w/" + p.name: rng.randn(*p.shape).astype(np.float32)
            for p in main.all_parameters()}
    for r in range(2):
        for i in range(2):
            data[f"x{r}_{i}"] = rng.randn(3, 4).astype(np.float32)
            data[f"y{r}_{i}"] = rng.randn(3, 1).astype(np.float32)
    np.savez(tmp_path / "data.npz", **data)
    tdist.spawn(tw.localsgd_rank, args=(str(tmp_path / "rendezvous"),
                                        str(tmp_path),
                                        str(tmp_path / "data.npz")),
                nprocs=2)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    alone = [tw.localsgd_steps(str(tmp_path / "data.npz"), r)
             for r in range(2)]
    for k in ranks[0]:
        if k.startswith("step0/"):
            assert not np.array_equal(ranks[0][k], ranks[1][k]), k
            for r in range(2):
                np.testing.assert_allclose(ranks[r][k], alone[r][k],
                                           rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
            np.testing.assert_allclose(
                ranks[0][k], (alone[0][k] + alone[1][k]) / 2, rtol=1e-6,
                err_msg=k)
