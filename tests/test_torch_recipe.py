"""The BERT pretraining recipe on the static step, end to end on the CPU,
in the port and in the JAX package.

The recipe is google-research/bert's (`bert_config.json`,
`optimization.py`): the `bench.build_bert_base` encoder with dropout 0.1
after the embedding layer_norm, on the attention weights, on the
attention output projection and on the FFN output (the last two before
their residual adds; all but the attention weights' `upscale_in_train`,
the attention weights' as `nets.scaled_dot_product_attention` emits it);
AdamW with decoupled weight decay 0.01, biases and layer_norm parameters
excluded through `apply_decay_param_fun`; `GradientClipByGlobalNorm(1.0)`;
lr 1e-4 with linear warmup, then polynomial decay with power 1; bf16 AMP
as bench.py decorates it; `static.gradient_merge(main, k, startup,
params_grads=...)`.  `build_recipe` builds it from whichever package it
is handed, so both programs come from the same code.

The two packages draw different dropout masks (threefry against Philox),
so the training comparison replaces, in memory and for the test only, the
JAX registry's `dropout` kernel with `jax_philox_dropout`: the port's
Philox-4x32-10 in jnp uint32 arithmetic from the traced (seed, uid),
shown equal to the port's plain version bit for bit.  No file of the JAX
package changes.

Tolerances, as tests/test_torch_train.py states them: fp32 losses rtol
1e-5, final persistables atol 2e-5 (Adam divides by sqrt(v), so a ~1e-6
relative gradient difference on a near-zero gradient is a visible share
of its lr step); AMP bf16 losses rtol 1e-3 and persistables atol 2e-3
(bf16 activations rounded at different places by XLA and by torch; an
Adam step moves a parameter by about lr whatever its gradient).  The
port against itself (run_steps against run(), the k-step commit) is exact.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.amp  # noqa: F401
import paddle_tpu.optimizer  # noqa: F401
import paddle_tpu.static as jstatic
import paddle_tpu_torch
import paddle_tpu_torch.amp  # noqa: F401
import paddle_tpu_torch.optimizer  # noqa: F401
from paddle_tpu.core.program import _reset_unique_names as jax_reset_names
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core.program import (_reset_unique_names as
                                           torch_reset_names)
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.ops import dropout as tdrop
from test_torch_program import flash_mode
from test_torch_train_program import fused_mode

CFG = dict(vocab=1024, seq=64, hidden=128, layers_n=2, heads=2)
BATCH = 2
STEPS = 6
TOL = {False: dict(loss=1e-5, param=2e-5), True: dict(loss=1e-3, param=2e-3)}


def no_decay(name):
    """BERT's exclude_from_weight_decay: biases and layer_norm parameters."""
    return not (name.endswith(".b_0") or name.startswith("layer_norm"))


def build_recipe(pkg, vocab=30522, seq=512, hidden=768, layers_n=12,
                 heads=12, attn_dropout=0.1, hidden_dropout=0.1,
                 use_amp=True, k_steps=2, warmup_steps=2, decay_steps=1000):
    """(main, startup, loss, lr scheduler, dropout Mask var names) of the
    recipe, built with `pkg` (paddle_tpu or paddle_tpu_torch)."""
    static, amp = pkg.static, pkg.amp
    layers, nets = static.layers, static.nets
    lr = pkg.optimizer.lr_scheduler

    def drop(x):
        return layers.dropout(x, hidden_dropout,
                              dropout_implementation="upscale_in_train")

    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        ids = layers.data("ids", [-1, seq], dtype="int64")
        pos = layers.data("pos", [-1, seq], dtype="int64")
        labels = layers.data("labels", [-1, seq, 1], dtype="int64")
        h = layers.elementwise_add(layers.embedding(ids, size=[vocab, hidden]),
                                   layers.embedding(pos, size=[seq, hidden]))
        h = drop(layers.layer_norm(h, begin_norm_axis=2))
        for _ in range(layers_n):
            q = layers.fc(h, hidden, num_flatten_dims=2)
            k = layers.fc(h, hidden, num_flatten_dims=2)
            v = layers.fc(h, hidden, num_flatten_dims=2)
            ctx = nets.scaled_dot_product_attention(
                q, k, v, num_heads=heads, dropout_rate=attn_dropout)
            attn_out = drop(layers.fc(ctx, hidden, num_flatten_dims=2))
            h = layers.layer_norm(layers.elementwise_add(h, attn_out),
                                  begin_norm_axis=2)
            ffn = layers.fc(h, hidden * 4, num_flatten_dims=2, act="gelu")
            ffn = drop(layers.fc(ffn, hidden, num_flatten_dims=2))
            h = layers.layer_norm(layers.elementwise_add(h, ffn),
                                  begin_norm_axis=2)
        logits = layers.fc(h, vocab, num_flatten_dims=2)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, labels))
        sched = lr.LinearWarmup(
            lr.PolynomialDecay(1e-4, decay_steps, end_lr=0.0, power=1.0),
            warmup_steps, 0.0, 1e-4)
        opt = static.optimizer.AdamW(
            learning_rate=sched, weight_decay=0.01,
            apply_decay_param_fun=no_decay,
            grad_clip=static.optimizer.GradientClipByGlobalNorm(1.0))
        if use_amp:
            opt = amp.decorate(opt, init_loss_scaling=1.0,
                               use_dynamic_loss_scaling=False,
                               dest_dtype="bfloat16")
        _, params_grads = opt.minimize(loss)
        static.gradient_merge(main, k_steps, startup,
                              params_grads=params_grads)
    masks = [op.outputs["Mask"][0] for op in main.global_block().ops
             if op.type == "dropout"]
    return main, startup, loss, sched, masks


def build_both(use_amp, attn_dropout, k_steps, **cfg):
    """(reference, port) recipes from the same unique-name state; flash on
    where the attention has no dropout (the score-matrix route carries
    it), the fused cross-entropy on, as bench.py's BENCH_FLASH=1 and
    BENCH_FUSED_CE=1 build them."""
    cfg = dict(CFG, **cfg)
    with flash_mode(True), fused_mode(True):
        jax_reset_names()
        ref = build_recipe(paddle_tpu, attn_dropout=attn_dropout,
                           use_amp=use_amp, k_steps=k_steps, **cfg)
        torch_reset_names()
        port = build_recipe(paddle_tpu_torch, attn_dropout=attn_dropout,
                            use_amp=use_amp, k_steps=k_steps, **cfg)
    return ref, port


# ---------------------------------------------------------------------------
# the port's Philox in jnp uint32 arithmetic, for the JAX registry
# ---------------------------------------------------------------------------
def _mulhilo(m, c):
    """(hi, lo) of the 32x32 product of the constant m and uint32 array c,
    from 16-bit halves (each partial product fits uint32)."""
    ml, mh = jnp.uint32(m & 0xFFFF), jnp.uint32(m >> 16)
    cl, ch = c & jnp.uint32(0xFFFF), c >> jnp.uint32(16)
    ll, lh, hl, hh = cl * ml, ch * ml, cl * mh, ch * mh
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    return hh + (lh >> 16) + (hl >> 16) + (mid >> 16), \
        (ll & 0xFFFF) | ((mid & 0xFFFF) << 16)


def jax_philox_draws(n, seed, uid):
    """tdrop.philox_draws in jnp: word e % 4 of philox((e // 4, 0, 0, 0),
    (seed mod 2^32, uid mod 2^32))."""
    g = jnp.arange((n + 3) // 4, dtype=jnp.uint32)
    c0, c1, c2, c3 = g, jnp.zeros_like(g), jnp.zeros_like(g), \
        jnp.zeros_like(g)
    k0 = jnp.asarray(seed).astype(jnp.uint32)
    k1 = jnp.uint32(int(uid) & 0xFFFFFFFF)
    for i in range(10):
        if i:
            k0, k1 = k0 + jnp.uint32(0x9E3779B9), k1 + jnp.uint32(0xBB67AE85)
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return jnp.stack([c0, c1, c2, c3], axis=1).reshape(-1)[:n]


def jax_philox_dropout(ins, attrs, ctx):
    """The JAX package's dropout kernel (paddle_tpu/ops/kernels/nn.py:481)
    with its keep mask drawn as the port draws it."""
    x = ins["X"]
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False) or ctx.is_test:
        out = x if impl == "upscale_in_train" \
            else x * jnp.asarray(1.0 - p, x.dtype)
        return {"Out": out, "Mask": jnp.ones_like(x, dtype=jnp.uint8)}
    uid = attrs.get("fwd_uid", attrs.get("op_uid", 0))
    seed = attrs.get("seed", 0) if attrs.get("fix_seed", False) else ctx.seed
    thr = tdrop.keep_threshold(p)
    keep = jnp.ones(x.shape, bool) if thr >= 2 ** 32 else \
        jax_philox_draws(x.size, seed, uid).reshape(x.shape) < jnp.uint32(thr)
    if impl == "upscale_in_train":
        out = jnp.where(keep, x / jnp.asarray(max(1.0 - p, 1e-8), x.dtype),
                        jnp.zeros_like(x))
    else:
        out = jnp.where(keep, x, jnp.zeros_like(x))
    return {"Out": out, "Mask": keep.astype(jnp.uint8)}


@pytest.fixture
def philox_in_jax(monkeypatch):
    monkeypatch.setattr(jreg.get_op_info("dropout"), "kernel",
                        jax_philox_dropout)


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_philox_dropout_matches_port_plain_bit_for_bit(dtype, impl):
    rng = np.random.RandomState(5)
    x = rng.randn(3, 7, 33).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for seed, uid, p in ((0, 0, 0.1), (2 ** 31 - 5, 1234, 0.5),
                         (77, 2 ** 32 - 1, 0.9)):
        attrs = {"dropout_prob": p, "op_uid": uid,
                 "dropout_implementation": impl}
        ref = jax_philox_dropout({"X": jx}, attrs,
                                 jreg.OpContext(seed=jnp.uint32(seed)))
        out, mask = tdrop.dropout_plain(tx, p, seed, uid,
                                        impl == "upscale_in_train")
        np.testing.assert_array_equal(np.asarray(ref["Mask"]), mask.numpy())
        np.testing.assert_array_equal(np.asarray(ref["Out"], np.float32),
                                      out.float().numpy())
        assert np.asarray(jax_philox_draws(x.size, seed, uid)).tolist() == \
            tdrop.philox_draws(x.size, seed, uid).tolist()


@pytest.mark.parametrize("k_steps", [1, 2])
@pytest.mark.parametrize("attn_dropout", [0.1, 0.0])
@pytest.mark.parametrize("use_amp", [False, True])
def test_recipe_program_serializes_equal(use_amp, attn_dropout, k_steps):
    (jm, js, jl, _, jmasks), (tm, ts, tl, _, tmasks) = build_both(
        use_amp, attn_dropout, k_steps)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    assert tm.serialize_to_string() == jm.serialize_to_string()
    assert ts.serialize_to_string() == js.serialize_to_string()
    assert tm._grad_map == jm._grad_map and tmasks == jmasks
    types = [op.type for op in tm.global_block().ops]
    n = CFG["layers_n"]
    assert types.count("dropout") == types.count("dropout_grad") == \
        1 + (3 if attn_dropout else 2) * n
    assert types.count("flash_attention") == (0 if attn_dropout else n)
    n_params = len(tm.all_parameters())
    assert types.count("adamw") + types.count("adam") == n_params
    assert types.count("adam") == sum(not no_decay(p.name)
                                      for p in tm.all_parameters())
    assert types.count("reduce_sum") == n_params  # the global norm
    assert ("cast" in types) == use_amp
    assert types.count("increment") == int(k_steps > 1)
    assert types.count("where") == (6 * n_params if k_steps > 1 else 0)


def _start(ref, port):
    """Both executors after their own startup, the port's scope holding the
    reference's weights; the persistable names."""
    jscope, jexe = jstatic.Scope(), jstatic.Executor()
    with jstatic.scope_guard(jscope):
        jexe.run(ref[1])
    init = {n: np.asarray(jscope.find_var(n).get_tensor())
            for n in jscope.vars
            if jscope.find_var(n).get_tensor() is not None}
    tscope, texe = tstatic.Scope(), tstatic.Executor(tstatic.CPUPlace())
    with tstatic.scope_guard(tscope):
        texe.run(port[1])
    load_params_from_numpy(tscope, init, tstatic.CPUPlace())
    return (jexe, jscope), (texe, tscope), init


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"ids": rng.randint(0, CFG["vocab"], (BATCH, CFG["seq"])),
            "pos": np.tile(np.arange(CFG["seq"]), (BATCH, 1)),
            "labels": rng.randint(0, CFG["vocab"], (BATCH, CFG["seq"], 1))}


@pytest.mark.parametrize("use_amp,attn_dropout", [(False, 0.1), (True, 0.0)])
def test_recipe_trains_like_reference(philox_in_jax, use_amp, attn_dropout):
    """6 steps with k = 2, the lr scheduler stepped after each: the loss
    trace and every persistable after the last step against the JAX
    executor's; on the port, the parameters unchanged after the first
    micro-step of each window and the gradient accumulators zero after its
    commit."""
    ref, port = build_both(use_amp, attn_dropout, 2)
    (jexe, jscope), (texe, tscope), init = _start(ref, port)
    feed = {k: v.astype(np.int64) for k, v in _feed().items()}
    params = [p.name for p in port[0].all_parameters()]
    accs = port[0]._gm_meta["accs"]
    jl, tl = [], []
    with fused_mode(True):
        for step in range(1, STEPS + 1):
            before = {n: tscope.vars[n].clone() for n in params}
            with jstatic.scope_guard(jscope):
                jl.append(float(np.asarray(jexe.run(
                    ref[0], feed=feed, fetch_list=[ref[2]])[0])
                    .reshape(-1)[0]))
                ref[3].step()
            with tstatic.scope_guard(tscope):
                tl.append(float(np.asarray(texe.run(
                    port[0], feed=feed, fetch_list=[port[2]])[0])
                    .reshape(-1)[0]))
                port[3].step()
            if step % 2:
                for n in params:
                    assert torch.equal(tscope.vars[n], before[n]), (step, n)
            else:
                assert all(not bool(tscope.vars[a].any()) for a in accs)
                assert any(not torch.equal(tscope.vars[n], before[n])
                           for n in params)
    tol = TOL[use_amp]
    assert np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=tol["loss"])
    for n in init:
        r = np.asarray(jscope.find_var(n).get_tensor(), np.float64)
        g = tscope.vars[n].double().numpy()
        np.testing.assert_allclose(g.reshape(r.shape), r, rtol=0,
                                   atol=tol["param"], err_msg=n)


@contextlib.contextmanager
def _scope(scope):
    with tstatic.scope_guard(scope):
        yield scope


def test_run_steps_cpu_loop_equals_run_calls():
    """K = 4 steps through run_steps against 4 run() calls from the same
    state and step count: the losses, the embedding dropout's masks (a new
    one every step) and every persistable, bit for bit."""
    _, port = build_both(False, 0.1, 2)
    main, startup, loss, _, masks = port
    exe, scope = tstatic.Executor(tstatic.CPUPlace()), tstatic.Scope()
    with _scope(scope):
        exe.run(startup)
    twin = tstatic.Scope()
    for n, t in scope.vars.items():
        twin.set(n, t.clone())
    twin_exe = tstatic.Executor(tstatic.CPUPlace())
    twin_exe._step = exe._step
    feed = _feed(1)
    stacked = {n: np.stack([v] * 4).astype(np.int64) for n, v in feed.items()}
    with fused_mode(True):
        with _scope(scope):
            got_loss, got_mask = exe.run_steps(main, feed=stacked,
                                               fetch_list=[loss, masks[0]])
        with _scope(twin):
            want = [twin_exe.run(main, feed={n: v[i] for n, v in
                                             stacked.items()},
                                 fetch_list=[loss, masks[0]])
                    for i in range(4)]
    np.testing.assert_array_equal(got_loss.reshape(4),
                                  np.float32([w[0] for w in want]).reshape(4))
    np.testing.assert_array_equal(got_mask, np.stack([w[1] for w in want]))
    assert all(not np.array_equal(got_mask[i], got_mask[i + 1])
               for i in range(3))
    assert exe._step == twin_exe._step
    for n, t in twin.vars.items():
        assert torch.equal(scope.vars[n], t), n
