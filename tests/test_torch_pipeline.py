"""The port's pipeline (paddle_tpu_torch/pipeline/) against the JAX
package's, on the CPU, mirroring tests/test_pipeline.py.

Both packages build the same two-stage programs (device_guard "xla:0" /
"xla:1", or "gpu:0" / "gpu:1" for the BERT); the program JSON, the stage
of every op and the per-stage op counts are equal.  The JAX pipeline pins
its stages on two of the eight virtual CPU devices, the port's stages
wrap onto the CPU.  Training runs from the JAX startup weights, copied
into the port's scope, on seeded numpy batches.

Tolerances: the fc regression's losses and weights within rtol 1e-4 /
atol 1e-5 of the JAX pipeline's (tests/test_pipeline.py's own tolerance
against the plain executor); the tiny flash BERT (2 layers, one a stage,
fp32, flash attention and fused cross-entropy on, Adam) within loss rtol
1e-5 and parameter atol 2e-5 (test_torch_train.py's fp32 tolerances: Adam
divides by sqrt(v)).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.amp
import paddle_tpu.pipeline
import paddle_tpu.static as jstatic
import paddle_tpu_torch
import paddle_tpu_torch.amp
import paddle_tpu_torch.pipeline
import paddle_tpu_torch.static as tstatic
from paddle_tpu.core.program import _reset_unique_names as jax_reset_names
from paddle_tpu_torch.core.program import (_reset_unique_names as
                                           torch_reset_names)
from paddle_tpu_torch.io import load_params_from_numpy
from test_torch_program import flash_mode
from test_torch_train_program import fused_mode

torch.set_num_threads(2)


def fc_model(pkg, make_opt, m):
    """tests/test_pipeline.py's two-stage fc regression, minimized by
    PipelineOptimizer(make_opt(static), m) (m None: the plain optimizer)."""
    static, layers = pkg.static, pkg.static.layers
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        with static.device_guard("xla:0"):
            x = layers.data("x", [-1, 8])
            y = layers.data("y", [-1, 1])
            h = layers.fc(x, size=16, act="relu")
        with static.device_guard("xla:1"):
            pred = layers.fc(h, size=1)
            loss = layers.mean(
                layers.square(layers.elementwise_sub(pred, y)))
        opt = make_opt(static)
        if m is not None:
            opt = pkg.pipeline.PipelineOptimizer(opt, num_microbatches=m)
        opt.minimize(loss)
    return main, startup, loss


def pp_bert(pkg, vocab=64, seq=16, hidden=32, layers_n=2, heads=2,
            stages=2, use_amp=False, m=2, lr=1e-3):
    """bench.build_bert_base's step cut into `stages` stages under
    device_guard: the embeddings and the first layers_n / stages layers
    on "gpu:0", ..., the MLM head and the loss on the last stage; Adam
    (AMP-decorated with use_amp) under PipelineOptimizer(m)."""
    static, layers, nets = pkg.static, pkg.static.layers, pkg.static.nets
    per = layers_n // stages
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        with static.device_guard("gpu:0"):
            ids = layers.data("ids", [-1, seq], dtype="int64")
            pos = layers.data("pos", [-1, seq], dtype="int64")
            labels = layers.data("labels", [-1, seq, 1], dtype="int64")
            emb = layers.embedding(ids, size=[vocab, hidden])
            pemb = layers.embedding(pos, size=[seq, hidden])
            h = layers.layer_norm(layers.elementwise_add(emb, pemb),
                                  begin_norm_axis=2)
        for i in range(layers_n):
            with static.device_guard(f"gpu:{min(i // per, stages - 1)}"):
                q = layers.fc(h, hidden, num_flatten_dims=2)
                k = layers.fc(h, hidden, num_flatten_dims=2)
                v = layers.fc(h, hidden, num_flatten_dims=2)
                ctx = nets.scaled_dot_product_attention(q, k, v,
                                                        num_heads=heads)
                attn_out = layers.fc(ctx, hidden, num_flatten_dims=2)
                h = layers.layer_norm(layers.elementwise_add(h, attn_out),
                                      begin_norm_axis=2)
                ffn = layers.fc(h, hidden * 4, num_flatten_dims=2,
                                act="gelu")
                ffn = layers.fc(ffn, hidden, num_flatten_dims=2)
                h = layers.layer_norm(layers.elementwise_add(h, ffn),
                                      begin_norm_axis=2)
        with static.device_guard(f"gpu:{stages - 1}"):
            logits = layers.fc(h, vocab, num_flatten_dims=2)
            loss = layers.mean(
                layers.softmax_with_cross_entropy(logits, labels))
        opt = static.Adam(learning_rate=lr)
        if use_amp:
            opt = pkg.amp.decorate(opt, init_loss_scaling=1.0,
                                   use_dynamic_loss_scaling=False,
                                   dest_dtype="bfloat16")
        if m is not None:
            opt = pkg.pipeline.PipelineOptimizer(opt, num_microbatches=m)
        opt.minimize(loss)
    return main, startup, loss


def build_pair(builder, *a, **kw):
    jax_reset_names()
    ref = builder(paddle_tpu, *a, **kw)
    torch_reset_names()
    port = builder(paddle_tpu_torch, *a, **kw)
    return ref, port


def _sgd(lr=0.05):
    return lambda static: static.SGD(learning_rate=lr)


def _jax_init(js):
    scope, exe = jstatic.Scope(), jstatic.Executor()
    with jstatic.scope_guard(scope):
        exe.run(js)
    return {n: np.asarray(scope.find_var(n).get_tensor())
            for n in scope.vars
            if scope.find_var(n).get_tensor() is not None}


def _train(pkg, program, init, feeds, fetch):
    """Run `program` once per feed from the weights `init`: (per-step
    fetches, final parameters)."""
    static = pkg.static
    if pkg is paddle_tpu:
        scope, exe = jstatic.Scope(), jstatic.Executor()
        with jstatic.scope_guard(scope):
            for n, v in init.items():
                scope.set(n, jnp.asarray(v))
            outs = [exe.run(program, feed=f, fetch_list=fetch)
                    for f in feeds]
    else:
        scope, exe = tstatic.Scope(), tstatic.Executor(tstatic.CPUPlace())
        load_params_from_numpy(scope, init, tstatic.CPUPlace())
        with tstatic.scope_guard(scope):
            outs = [exe.run(program, feed=f, fetch_list=fetch)
                    for f in feeds]
    prog = getattr(program, "_program", program)
    params = {p.name: np.asarray(static.as_numpy(scope.get(p.name))
                                 if pkg is paddle_tpu_torch
                                 else scope.get(p.name), np.float32)
              for p in prog.all_parameters()}
    return [[np.asarray(o) for o in out] for out in outs], params


def _fc_feed(seed=0, tile=True):
    rng = np.random.RandomState(seed)
    xb = rng.rand(4, 8).astype(np.float32)
    xb = np.tile(xb, (4, 1)) if tile else rng.rand(16, 8).astype(np.float32)
    return {"x": xb, "y": xb.sum(1, keepdims=True).astype(np.float32)}


def test_stages_and_program_equal():
    """The pipelined fc program serializes equal in both packages, every
    op lands on the same stage (backward ops on both stages) and the
    (stage, phase) op counts agree."""
    from paddle_tpu.core.program import OpRole
    from paddle_tpu.pipeline import assign_stages as jassign
    from paddle_tpu_torch.pipeline import assign_stages as tassign
    (jm, js, _), (tm, ts, _) = build_pair(fc_model, _sgd(), 4)
    assert tm.to_dict() == jm.to_dict() and ts.to_dict() == js.to_dict()
    jst, tst = jassign(jm.global_block()), tassign(tm.global_block())
    assert jst == tst and max(tst) == 1
    bwd = {s for op, s in zip(tm.global_block().ops, tst)
           if op.op_role & OpRole.Backward}
    assert bwd == {0, 1}
    jc = jm._pipeline_compiled.stage_op_counts()
    tc = tm._pipeline_compiled.stage_op_counts()
    assert jc == tc and all(c > 0 for c in tc["fwd"]), (jc, tc)


@pytest.mark.parametrize("tile", [True, False])
def test_pipeline_matches_jax_pipeline(tile):
    """3 pipelined SGD steps (M = 4) from the same weights: the port's
    losses and weights against the JAX pipeline's; on the tiled batch
    (identical micro-batches) also against the port's plain executor."""
    (jm, js, jl), (tm, ts, tl) = build_pair(fc_model, _sgd(), 4)
    init = _jax_init(js)
    feeds = [_fc_feed(tile=tile)] * 3
    jout, jw = _train(paddle_tpu, jm._pipeline_compiled, init, feeds,
                      [jl.name])
    tout, tw = _train(paddle_tpu_torch, tm._pipeline_compiled, init, feeds,
                      [tl.name])
    np.testing.assert_allclose([o[0] for o in tout], [o[0] for o in jout],
                               rtol=1e-4, atol=1e-5)
    assert tw.keys() == jw.keys()
    for n in tw:
        np.testing.assert_allclose(tw[n], jw[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)
    if tile:
        torch_reset_names()
        pm, _, pl = fc_model(paddle_tpu_torch, _sgd(), None)
        pout, pw = _train(paddle_tpu_torch, pm, init, feeds, [pl.name])
        np.testing.assert_allclose([o[0] for o in tout],
                                   [o[0] for o in pout], rtol=1e-4,
                                   atol=1e-5)
        for n in pw:
            np.testing.assert_allclose(tw[n], pw[n], rtol=1e-4, atol=1e-5)


def test_per_example_fetch_concatenates():
    """A per-example fetch (leading dim the micro-batch size) comes back
    concatenated to the mini-batch, equal to the JAX pipeline's; the loss
    is the micro-batch mean."""
    (jm, js, jl), (tm, ts, tl) = build_pair(fc_model, _sgd(0.01), 4)
    pred = next(op.inputs["X"][0] for op in tm.global_block().ops
                if op.type == "elementwise_sub")
    init = _jax_init(js)
    feed = _fc_feed(1, tile=False)
    jout, _ = _train(paddle_tpu, jm._pipeline_compiled, init, [feed],
                     [pred, jl.name])
    tout, _ = _train(paddle_tpu_torch, tm._pipeline_compiled, init, [feed],
                     [pred, tl.name])
    assert tout[0][0].shape == (16, 1) and tout[0][1].size == 1
    for t, j in zip(tout[0], jout[0]):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def test_fleet_pipeline_strategy():
    """strategy.pipeline: both packages choose FleetPipelineOptimizer and
    hand back a PipelineCompiledProgram of M = accumulate_steps, whose
    steps agree."""
    from paddle_tpu.distributed.fleet.base.fleet_base import Fleet as JF
    from paddle_tpu_torch.distributed.fleet.base.fleet_base import \
        Fleet as TF
    from paddle_tpu_torch.pipeline import PipelineCompiledProgram
    import paddle_tpu.distributed as jdist
    import paddle_tpu_torch.distributed as tdist

    def build(pkg, fleet_cls, dist):
        f = fleet_cls()
        f.init(is_collective=True)
        strategy = dist.fleet.DistributedStrategy()
        strategy.pipeline = True
        strategy.pipeline_configs = {"micro_batch": 2,
                                     "accumulate_steps": 2}
        static, layers = pkg.static, pkg.static.layers
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            with static.device_guard("xla:0"):
                x = layers.data("x", [-1, 8])
                y = layers.data("y", [-1, 1])
                h = layers.fc(x, size=16, act="relu")
            with static.device_guard("xla:1"):
                pred = layers.fc(h, size=1)
                loss = layers.mean(
                    layers.square(layers.elementwise_sub(pred, y)))
            f.distributed_optimizer(static.SGD(learning_rate=0.05),
                                    strategy)
            f.minimize(loss)
        return f, main, startup, loss

    jax_reset_names()
    jf, jm, js, jl = build(paddle_tpu, JF, jdist)
    torch_reset_names()
    tf, tm, ts, tl = build(paddle_tpu_torch, TF, tdist)
    assert "FleetPipelineOptimizer" in tf.applied_meta_list()
    assert tf.applied_meta_list() == jf.applied_meta_list()
    assert isinstance(tf.main_program, PipelineCompiledProgram)
    assert tf.main_program._M == jf.main_program._M == 2
    assert tm.to_dict() == jm.to_dict()
    init = _jax_init(js)
    feeds = [_fc_feed(2, tile=False)] * 3
    jout, jw = _train(paddle_tpu, jf.main_program, init, feeds, [jl.name])
    tout, tw = _train(paddle_tpu_torch, tf.main_program, init, feeds,
                      [tl.name])
    np.testing.assert_allclose([o[0] for o in tout], [o[0] for o in jout],
                               rtol=1e-4, atol=1e-5)
    for n in tw:
        np.testing.assert_allclose(tw[n], jw[n], rtol=1e-4, atol=1e-5)


def test_flash_bert_two_stages():
    """The tiny flash BERT (2 layers, 2 stages, fp32, Adam, M = 2), built
    like chip_smoke.py phase 17's BERT-base: the attention path (flash
    forward and backward, fused cross-entropy) runs in both stages'
    phases; 2 steps equal the JAX pipeline's (Pallas in interpret mode)."""
    with flash_mode(True), fused_mode(True):
        (jm, js, jl), (tm, ts, tl) = build_pair(pp_bert)
        assert tm.to_dict() == jm.to_dict()
        pp = tm._pipeline_compiled
        counts = pp.stage_op_counts()
        assert counts == jm._pipeline_compiled.stage_op_counts()
        stage_types = [{op.type for op in ph.ops}
                       for ph in pp._phases["fwd"]]
        assert all("flash_attention" in t for t in stage_types)
        assert "softmax_with_cross_entropy" in stage_types[1]
        rng = np.random.RandomState(3)
        feed = {"ids": rng.randint(0, 64, (4, 16)).astype(np.int64),
                "pos": np.tile(np.arange(16), (4, 1)).astype(np.int64),
                "labels": rng.randint(0, 64, (4, 16, 1)).astype(np.int64)}
        init = _jax_init(js)
        jout, jw = _train(paddle_tpu, jm._pipeline_compiled, init,
                          [feed] * 2, [jl.name])
        tout, tw = _train(paddle_tpu_torch, pp, init, [feed] * 2,
                          [tl.name])
    np.testing.assert_allclose([o[0] for o in tout], [o[0] for o in jout],
                               rtol=1e-5)
    for n in tw:
        np.testing.assert_allclose(tw[n], jw[n], atol=2e-5, err_msg=n)
