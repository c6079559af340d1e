"""Recompute (activation checkpointing) in the port, against the JAX
package on the CPU (mirrors tests/test_recompute_rewrite.py).

  * the rewritten programs (FLAGS_recompute="always", RecomputeOptimizer
    with manual checkpoints, `apply_recompute` on a finished program, and
    the bench program with flash and fused CE on) serialize equal to the
    JAX package's;
  * recompute changes no number in the port: the loss and every gradient
    equal to the plain backward's to the last bit (the replay runs the
    same kernels on the same values), in fp32 and with bf16 AMP, and
    against the JAX package's within the tolerances of
    tests/test_torch_train.py (fp32 rtol 1e-5 / atol 1e-6, AMP rtol 2e-2
    / atol 2e-3 on gradients);
  * the release plan frees the segments' activations in the forward (the
    backward reads their `@RC` replays), so the peak of live activation
    bytes falls;
  * a replayed dropout redraws the forward's mask (losses with and
    without recompute equal bit for bit), and run_steps (the CPU loop)
    equals run() calls;
  * FLAGS_recompute="always" equals manual checkpoints at
    `select_layer_checkpoints`' picks, and "auto" gives the plain program
    under an ample budget and the "always" one under a tight budget.
"""
import contextlib

import numpy as np
import pytest
import torch

import bench
import paddle_tpu
import paddle_tpu.amp  # noqa: F401
import paddle_tpu.static as jstatic
from paddle_tpu.core.flags import set_flags as jax_set_flags
from paddle_tpu.core.program import _reset_unique_names as jax_reset_names
import paddle_tpu_torch
import paddle_tpu_torch.amp  # noqa: F401
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core.flags import set_flags as torch_set_flags
from paddle_tpu_torch.core.program import (_reset_unique_names as
                                           torch_reset_names)
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.models import build_bert_pretrain
from paddle_tpu_torch.static import executor as texecutor
from test_torch_program import flash_mode
from test_torch_train_program import fused_mode

VOCAB, SEQ, HIDDEN, HEADS, LAYERS = 128, 16, 32, 2, 2
BATCH = 4


@contextlib.contextmanager
def recompute_flag(mode):
    jax_set_flags({"recompute": mode})
    torch_set_flags({"recompute": mode})
    try:
        yield
    finally:
        jax_set_flags({"recompute": ""})
        torch_set_flags({"recompute": ""})


def build_tiny(pkg, use_amp=False, lr=0.0, manual=False, dropout=0.0):
    """The bert-tiny MLM step of tests/test_recompute_rewrite.py from
    either package; `manual` checkpoints the layer entries through
    RecomputeOptimizer; `dropout` adds one upscale_in_train dropout a
    layer (after the attention)."""
    static = pkg.static
    layers, nets = static.layers, static.nets
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        ids = layers.data("ids", [-1, SEQ], dtype="int64")
        labels = layers.data("labels", [-1, SEQ, 1], dtype="int64")
        h = layers.embedding(ids, size=[VOCAB, HIDDEN])
        h = layers.layer_norm(h, begin_norm_axis=2)
        ckpts = []
        for _ in range(LAYERS):
            ckpts.append(h)
            q = layers.fc(h, HIDDEN, num_flatten_dims=2)
            k = layers.fc(h, HIDDEN, num_flatten_dims=2)
            v = layers.fc(h, HIDDEN, num_flatten_dims=2)
            ctx = nets.scaled_dot_product_attention(q, k, v,
                                                    num_heads=HEADS)
            if dropout:
                ctx = layers.dropout(
                    ctx, dropout, dropout_implementation="upscale_in_train")
            h = layers.layer_norm(layers.elementwise_add(h, ctx),
                                  begin_norm_axis=2)
            ffn = layers.fc(h, HIDDEN * 2, num_flatten_dims=2, act="gelu")
            h = layers.layer_norm(
                layers.elementwise_add(
                    h, layers.fc(ffn, HIDDEN, num_flatten_dims=2)),
                begin_norm_axis=2)
        logits = layers.fc(h, VOCAB, num_flatten_dims=2)
        loss = layers.mean(
            layers.softmax_with_cross_entropy(logits, labels))
        opt = static.SGD(learning_rate=lr)
        if manual:
            opt = static.RecomputeOptimizer(opt)
            opt._set_checkpoints(ckpts)
        if use_amp:
            opt = pkg.amp.decorate(opt, init_loss_scaling=1.0,
                                   use_dynamic_loss_scaling=False,
                                   dest_dtype="bfloat16")
        _, params_grads = opt.minimize(loss)
    return main, startup, loss, params_grads


def build_pair(**kw):
    with flash_mode(False):
        jax_reset_names()
        ref = build_tiny(paddle_tpu, **kw)
        torch_reset_names()
        port = build_tiny(paddle_tpu_torch, **kw)
    return ref, port


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"ids": rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int64),
            "labels": rng.randint(0, VOCAB,
                                  (BATCH, SEQ, 1)).astype(np.int64)}


def _barriers(program):
    return sum(op.type == "optimization_barrier"
               for op in program.global_block().ops)


def _jax_init(ref):
    scope, exe = jstatic.Scope(), jstatic.Executor()
    with jstatic.scope_guard(scope):
        exe.run(ref[1])
    return {n: np.asarray(scope.find_var(n).get_tensor())
            for n in scope.vars
            if scope.find_var(n).get_tensor() is not None}


def _jax_run(ref, init, feed):
    scope, exe = jstatic.Scope(), jstatic.Executor()
    with jstatic.scope_guard(scope):
        exe.run(ref[1])
        for n, v in init.items():
            scope.set(n, v)
        out = exe.run(ref[0], feed=feed,
                      fetch_list=[ref[2]] + [g for _, g in ref[3]])
    return [np.asarray(o) for o in out]


def _port_run(port, init, feed, steps=1):
    scope, exe = tstatic.Scope(), tstatic.Executor(tstatic.CPUPlace())
    with tstatic.scope_guard(scope):
        exe.run(port[1])
        load_params_from_numpy(scope, init, tstatic.CPUPlace())
        for _ in range(steps):
            out = exe.run(port[0], feed=feed, return_numpy=False,
                          fetch_list=[port[2]] + [g for _, g in port[3]])
    return out


@pytest.mark.parametrize("use_amp", [False, True])
def test_rewritten_programs_serialize_equal(use_amp):
    with recompute_flag("always"):
        ref, port = build_pair(use_amp=use_amp)
    # the last layer is the fresh segment, never replayed
    assert _barriers(port[0]) == LAYERS - 1
    assert port[0].to_dict() == ref[0].to_dict()
    assert port[1].to_dict() == ref[1].to_dict()
    assert port[0]._grad_map == ref[0]._grad_map
    # manual checkpoints through RecomputeOptimizer
    mref, mport = build_pair(use_amp=use_amp, manual=True)
    assert mport[0].to_dict() == mref[0].to_dict()


def test_always_equals_manual_checkpoints_at_the_picks():
    with recompute_flag("always"):
        _, auto = build_pair()
    _, manual = build_pair(manual=True)
    _, plain = build_pair()
    picks = tstatic.select_layer_checkpoints(plain[0])
    assert len(picks) == LAYERS
    assert auto[0].to_dict() == manual[0].to_dict()


def test_apply_recompute_on_a_finished_program():
    ref, port = build_pair(lr=0.05)
    jstatic.apply_recompute(ref[0])
    tstatic.apply_recompute(port[0])
    assert _barriers(port[0]) >= 1
    assert port[0].to_dict() == ref[0].to_dict()
    n_ops = len(port[0].global_block().ops)
    tstatic.apply_recompute(port[0])  # idempotent
    assert len(port[0].global_block().ops) == n_ops


def test_bench_program_with_kernels_serializes_equal():
    """The chip's program: bench.build_bert_base, flash and fused CE on,
    AMP, FLAGS_recompute="always"; every flash_attention op but the last
    layer's is replayed once."""
    cfg = dict(vocab=64, seq=32, hidden=64, layers_n=3, heads=4)
    with recompute_flag("always"), flash_mode(True), fused_mode(True):
        jax_reset_names()
        jm, js, _ = bench.build_bert_base(use_amp=True, **cfg)
        torch_reset_names()
        tm, ts, _ = build_bert_pretrain(use_amp=True, **cfg)
    assert tm.to_dict() == jm.to_dict() and ts.to_dict() == js.to_dict()
    types = [op.type for op in tm.global_block().ops]
    assert types.count("flash_attention") == 2 * cfg["layers_n"] - 1
    assert types.count("flash_attention_grad") == cfg["layers_n"]


@pytest.mark.parametrize("use_amp", [False, True])
def test_recompute_equals_plain_backward(use_amp):
    """Port: recompute against the plain backward, bit for bit; against
    the JAX package's recompute program, within tolerance."""
    ref_plain, plain = build_pair(use_amp=use_amp)
    init = _jax_init(ref_plain)
    feed = _feed()
    want = _port_run(plain, init, feed)
    with recompute_flag("always"):
        ref, port = build_pair(use_amp=use_amp)
    got = _port_run(port, init, feed)
    names = [p.name for p, _ in port[3]]
    assert names == [p.name for p, _ in plain[3]]
    for n, g, w in zip(["loss"] + names, got, want):
        assert torch.equal(g, w), n
    jax_out = _jax_run(ref, init, feed)
    rtol, atol = (2e-2, 2e-3) if use_amp else (1e-5, 1e-6)
    np.testing.assert_allclose(float(got[0].reshape(-1)[0]),
                               float(jax_out[0].reshape(-1)[0]),
                               rtol=1e-3 if use_amp else 1e-5)
    for n, g, j in zip(names, got[1:], jax_out[1:]):
        np.testing.assert_allclose(g.float().numpy().reshape(j.shape),
                                   j.astype(np.float32), rtol=rtol,
                                   atol=atol, err_msg=n)


def _peak_live_bytes(port, init, feed, monkeypatch):
    """The largest total size of the tensors in the executor's environment
    between two ops of one step (parameters included)."""
    peak = [0]
    run_op = texecutor._run_op

    def counting(op, env, ctx):
        run_op(op, env, ctx)
        peak[0] = max(peak[0], sum(v.numel() * v.element_size()
                                   for v in env.values()
                                   if isinstance(v, torch.Tensor)))
    monkeypatch.setattr(texecutor, "_run_op", counting)
    _port_run(port, init, feed)
    monkeypatch.setattr(texecutor, "_run_op", run_op)
    return peak[0]


def test_release_plan_frees_replayed_activations(monkeypatch):
    ref, plain = build_pair()
    init = _jax_init(ref)
    with recompute_flag("always"):
        _, port = build_pair()
    ops = port[0].global_block().ops
    first_bwd = next(i for i, op in enumerate(ops)
                     if op.type == "optimization_barrier")
    plan = texecutor._release_plan(port[0], [])
    freed_in_fwd = {n for dead in plan[:first_bwd] for n in dead}
    # every replayed activation's original dies in the forward
    rc = {n.split("@RC")[0] for op in ops for n in op.output_names()
          if "@RC" in n and "@RCB" not in n}
    ckpts = set(tstatic.select_layer_checkpoints(port[0]))
    assert rc - ckpts and (rc - ckpts) <= freed_in_fwd
    feed = _feed()
    assert _peak_live_bytes(port, init, feed, monkeypatch) < \
        _peak_live_bytes(plain, init, feed, monkeypatch)


def test_replayed_dropout_redraws_the_same_mask():
    """Dropout 0.1 after each attention, 3 SGD steps: recompute's losses
    and parameters equal the plain backward's bit for bit (the replayed
    dropout keeps its op_uid, so it redraws the forward's mask)."""
    ref, plain = build_pair(lr=0.1, dropout=0.1)
    init = _jax_init(ref)
    with recompute_flag("always"):
        _, port = build_pair(lr=0.1, dropout=0.1)
    types = [op.type for op in port[0].global_block().ops]
    assert types.count("dropout") == 2 * LAYERS - 1
    feeds = [_feed(s) for s in range(3)]
    out = {}
    for tag, prog in (("plain", plain), ("recompute", port)):
        scope, exe = tstatic.Scope(), tstatic.Executor(tstatic.CPUPlace())
        with tstatic.scope_guard(scope):
            exe.run(prog[1])
            load_params_from_numpy(scope, init, tstatic.CPUPlace())
            losses = [exe.run(prog[0], feed=f, return_numpy=False,
                              fetch_list=[prog[2]])[0] for f in feeds]
        out[tag] = (losses, {p.name: scope.vars[p.name]
                             for p in prog[0].all_parameters()})
    for a, b in zip(out["plain"][0], out["recompute"][0]):
        assert torch.equal(a, b)
    for n, t in out["plain"][1].items():
        assert torch.equal(out["recompute"][1][n], t), n


def test_run_steps_with_recompute_equals_run_calls():
    """K = 3 steps through run_steps (the CPU loop) against 3 run() calls
    from the same weights and step count, bit for bit."""
    ref, _ = build_pair()
    init = _jax_init(ref)
    with recompute_flag("always"):
        _, port = build_pair(lr=0.05)
    feeds = [_feed(s) for s in range(3)]
    stacked = {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}
    results = []
    for mode in ("run", "run_steps"):
        scope, exe = tstatic.Scope(), tstatic.Executor(tstatic.CPUPlace())
        with tstatic.scope_guard(scope):
            exe.run(port[1])
            load_params_from_numpy(scope, init, tstatic.CPUPlace())
            if mode == "run":
                losses = np.stack([exe.run(port[0], feed=f,
                                           fetch_list=[port[2]])[0]
                                   for f in feeds])
            else:
                (losses,) = exe.run_steps(port[0], feed=stacked,
                                          fetch_list=[port[2]])
        results.append((losses, {n: t.clone() for n, t in scope.vars.items()
                                 if t is not None}))
    np.testing.assert_array_equal(results[0][0], results[1][0])
    for n, t in results[0][1].items():
        assert torch.equal(results[1][1][n], t), n


def test_auto_mode_raises_naming_its_item(monkeypatch):
    """FLAGS_recompute="auto" no longer raises: it walks the plain
    backward on a clone and rewrites only over the budget, so an ample
    budget gives the plain program and a tight one the "always" program
    (JSON equal to the JAX package's builds)."""
    plain, _ = build_pair()
    with recompute_flag("always"):
        always, _ = build_pair()
    peak = tstatic.estimate_peak_bytes(plain[0], batch=1)
    for budget, want in ((4 * peak, plain), (peak // 4, always)):
        monkeypatch.setenv("PADDLE_TPU_HBM_BYTES", str(budget))
        with recompute_flag("auto"):
            torch_reset_names()
            with flash_mode(False):
                auto = build_tiny(paddle_tpu_torch)
        assert auto[0].to_dict() == want[0].to_dict()
    assert _barriers(auto[0]) == _barriers(always[0]) > 0
    # checkpoints=[] forces the plain backward whatever the flag says
    with recompute_flag("always"):
        main, startup = tstatic.Program(), tstatic.Program()
        with tstatic.program_guard(main, startup):
            x = tstatic.layers.data("x", [-1, 4])
            loss = tstatic.layers.mean(tstatic.layers.layer_norm(
                tstatic.layers.fc(x, 4), begin_norm_axis=1))
            tstatic.append_backward(loss, checkpoints=[])
    assert _barriers(main) == 0
