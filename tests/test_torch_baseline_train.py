"""The BASELINE configs' training programs trained in the JAX package's
executor and in the port's, from the JAX startup weights (carried by
`io.load_params_from_numpy`) on one fixed numpy batch; compared are the
losses and, after the last step, every persistable: the parameters, the
optimizer's accumulators and the batch_norm running stats.
  * LeNet: 5 SGD steps, fp32, batch 4;
  * a mini ResNet built in both packages from the tools' `conv_bn` and
    `bottleneck` (which take the layers module as an argument): a 3x3
    conv_bn stem, the max pool, a bottleneck with a stride-2 downsample
    and one without, the global average pool and the fc; 3 Momentum
    steps in fp32 and in AMP bf16 (the bf16 gates are stated in
    `test_mini_resnet_amp_trains_as_the_reference`);
  * Transformer-big at the tool's CPU widths: 3 Adam steps, AMP bf16.
Tolerances: fp32 rtol 1e-5 on the losses and atol 1e-5 on the state.
Transformer-big AMP bf16: losses rtol 2e-3, the state atol 2e-3 (an Adam
step moves a parameter by about lr = 2e-4 whatever its gradient, so a
near-zero gradient whose sign flips under bf16 rounding moves it 2 lr a
step, 1.2e-3 over 3 steps).  Last, the executor's eager deletion, which
keeps these steps' memory to the live values.
"""
import numpy as np

import paddle_tpu.static as jstatic
from paddle_tpu import amp as jamp
from paddle_tpu.core.program import _reset_unique_names as jax_reset_names
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import models
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core.program import (_reset_unique_names as
                                           torch_reset_names)
from paddle_tpu_torch.io import load_params_from_numpy
from test_torch_vision_ops import contained_state  # noqa: F401
from test_torch_baseline_programs import (TRANSFORMER, bench_lenet,
                                          bench_resnet, bench_transformer,
                                          build_both)


def mini_resnet(static, layers, amp, helpers, use_amp):
    """A ResNet cut to two bottlenecks from the tool's own helpers
    (`helpers` is the module holding `conv_bn` and `bottleneck`)."""
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        im = layers.data("image", [-1, 3, 16, 16])
        label = layers.data("label", [-1, 1], dtype="int64")
        h = helpers.conv_bn(layers, im, 8, 3, act="relu")
        h = layers.pool2d(h, 3, pool_type="max", pool_stride=2,
                          pool_padding=1)
        h = helpers.bottleneck(layers, h, 4, 2, True)
        h = helpers.bottleneck(layers, h, 4, 1, False)
        h = layers.pool2d(h, pool_type="avg", global_pooling=True)
        logits = layers.fc(h, 10)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        opt = static.Momentum(learning_rate=0.1, momentum=0.9)
        if use_amp:
            opt = amp.decorate(opt, init_loss_scaling=1.0,
                               use_dynamic_loss_scaling=False,
                               dest_dtype="bfloat16")
        opt.minimize(loss)
    return main, startup, loss


def _train_both(ref, port, feed, steps):
    """(reference losses, port losses, reference scope, port scope) after
    `steps` runs from the reference's startup weights."""
    (jm, js, jl), (tm, _, tl) = ref, port
    jscope, jexe = jstatic.Scope(), jstatic.Executor()
    with jstatic.scope_guard(jscope):
        jexe.run(js)
    init = {n: np.asarray(jscope.find_var(n).get_tensor())
            for n in jscope.vars
            if jscope.find_var(n).get_tensor() is not None}
    tscope = tstatic.Scope()
    load_params_from_numpy(tscope, init, tstatic.CPUPlace())
    texe = tstatic.Executor(tstatic.CPUPlace())
    ref_l, got_l = [], []
    for _ in range(steps):
        with jstatic.scope_guard(jscope):
            (lv,) = jexe.run(jm, feed=feed, fetch_list=[jl])
        ref_l.append(float(np.asarray(lv).reshape(-1)[0]))
        with tstatic.scope_guard(tscope):
            (lv,) = texe.run(tm, feed=feed, fetch_list=[tl])
        got_l.append(float(np.asarray(lv).reshape(-1)[0]))
    return np.asarray(ref_l), np.asarray(got_l), jscope, tscope, init


def _assert_state_close(jscope, tscope, init, atol):
    """Every persistable within `atol` of the reference's; returns the
    names of those the steps left unchanged."""
    fixed = []
    for n, start in init.items():
        ref = np.asarray(jscope.find_var(n).get_tensor())
        got = tscope.vars[n].numpy()
        assert got.dtype == ref.dtype, n
        np.testing.assert_allclose(got.astype(np.float64),
                                   ref.astype(np.float64), rtol=0,
                                   atol=atol, err_msg=n)
        if np.array_equal(ref, start):
            fixed.append(n)
    return fixed


def _image_feed(batch, shape, classes, seed):
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(batch, *shape).astype(np.float32),
            "label": rng.randint(0, classes, (batch, 1)).astype(np.int64)}


def test_lenet_trains_as_the_reference():
    ref, port = build_both(bench_lenet.build_lenet, models.build_lenet)
    feed = _image_feed(4, (1, 28, 28), 10, 0)
    rl, gl, jscope, tscope, init = _train_both(ref, port, feed, 5)
    assert np.all(np.isfinite(gl)) and gl[-1] < gl[0]
    np.testing.assert_allclose(gl, rl, rtol=1e-5)
    assert _assert_state_close(jscope, tscope, init, 1e-5) == \
        ["learning_rate_0"]


def _mini_resnet_run(use_amp):
    import paddle_tpu.static.layers as jlayers
    import paddle_tpu_torch.static.layers as tlayers
    jax_reset_names()
    ref = mini_resnet(jstatic, jlayers, jamp, bench_resnet, use_amp)
    torch_reset_names()
    port = mini_resnet(tstatic, tlayers, tamp, models.baseline_static,
                       use_amp)
    assert port[0].to_dict() == ref[0].to_dict()
    assert port[1].to_dict() == ref[1].to_dict()
    return _train_both(ref, port, _image_feed(4, (3, 16, 16), 10, 1), 3)


def _state(scope, names, get):
    return {n: np.asarray(get(scope, n), np.float64) for n in names}


def test_mini_resnet_trains_as_the_reference():
    """fp32: 3 Momentum steps, losses rtol 1e-5, every parameter, velocity
    and running stat atol 1e-5 (all moved but the learning rate)."""
    rl, gl, jscope, tscope, init = _mini_resnet_run(False)
    assert np.all(np.isfinite(gl)) and gl[-1] < gl[0]
    np.testing.assert_allclose(gl, rl, rtol=1e-5)
    stats = [n for n in init if n.startswith("batch_norm")
             and n.endswith((".w_1", ".w_2"))]
    assert len(stats) == 2 * 8  # the stem, 3 + 1 and 3 in the blocks
    assert _assert_state_close(jscope, tscope, init, 1e-5) == \
        ["learning_rate_0"]


def test_mini_resnet_amp_trains_as_the_reference():
    """AMP bf16: 3 Momentum steps.  Elementwise parity does not hold here
    in either direction: bf16 rounding flips relu masks near zero and
    batch_norm over 16-64 values a channel amplifies it, so each
    package's step-1 gradients differ from the fp32 run's by 5-30%
    (measured, both packages alike).  So the port's bf16 error is held
    to the reference's own: the losses within rtol 1e-2 of the JAX
    package's (measured 5.2e-3 at step 3; each AMP trace is within 1e-2
    of the fp32 one), and the whole state after 3 steps (parameters,
    velocities, running stats) no further from the fp32 run's, in L2
    norm, than 1.5x the JAX package's AMP state is (measured 1.05x: 1.03
    against 0.98, in a state of norm 18)."""
    rl, gl, jscope, tscope, init = _mini_resnet_run(True)
    assert np.all(np.isfinite(gl)) and gl[-1] < gl[0]
    np.testing.assert_allclose(gl, rl, rtol=1e-2)
    _, _, fscope, _, _ = _mini_resnet_run(False)
    names = [n for n in init if n not in ("loss_scaling_0",
                                          "learning_rate_0")]
    jget = lambda sc, n: sc.find_var(n).get_tensor()  # noqa: E731
    fp32 = _state(fscope, names, jget)
    ref = _state(jscope, names, jget)
    got = _state(tscope, names, lambda sc, n: sc.vars[n].numpy())

    def dist(a):
        return np.sqrt(sum(((a[n] - fp32[n]) ** 2).sum() for n in names))

    assert 0 < dist(got) <= 1.5 * dist(ref), (dist(got), dist(ref))
    assert all(not np.array_equal(got[n], init[n]) for n in names)
    assert all(got[n].dtype == ref[n].dtype for n in names)


def test_transformer_big_trains_as_the_reference():
    ref, port = build_both(bench_transformer.build_transformer_big,
                           models.build_transformer_big, use_amp=True,
                           **TRANSFORMER)
    rng = np.random.RandomState(2)
    b, t, vocab = 2, TRANSFORMER["src_len"], TRANSFORMER["vocab"]
    feed = {"src_ids": rng.randint(0, vocab, (b, t)),
            "trg_ids": rng.randint(0, vocab, (b, t)),
            "labels": rng.randint(0, vocab, (b, t, 1)),
            "trg_bias": np.broadcast_to(
                np.triu(np.full((t, t), -1e9, np.float32), 1),
                (b, 1, t, t)).copy(),
            "src_pos": np.tile(np.arange(t), (b, 1)),
            "trg_pos": np.tile(np.arange(t), (b, 1))}
    feed = {k: v.astype(np.int64) if v.dtype.kind == "i" else v
            for k, v in feed.items()}
    rl, gl, jscope, tscope, init = _train_both(ref, port, feed, 3)
    assert np.all(np.isfinite(gl)) and gl[-1] < gl[0]
    np.testing.assert_allclose(gl, rl, rtol=2e-3)
    _assert_state_close(jscope, tscope, init, 2e-3)


def test_executor_drops_values_after_their_last_use():
    """The executor drops a value that is neither persistable nor fetched
    after the last op that reads or writes it (what keeps ResNet-50's
    static step at batch 128 inside the card): each such name once, at
    its last mention; fetched names, gradients fetched by name and the
    persistables stay, and a step fetching them runs."""
    from paddle_tpu_torch.static.executor import (_persistable_names,
                                                  _release_plan)
    torch_reset_names()
    main, startup, loss = models.build_lenet()
    grad = main._grad_map["conv2d_0.w_0"]
    plan = _release_plan(main, [loss.name, grad])
    ops = main.global_block().ops
    dropped = [n for dead in plan for n in dead]
    assert len(dropped) == len(set(dropped)) > 20
    assert not set(dropped) & (set(_persistable_names(main))
                               | {loss.name, grad})
    for i, dead in enumerate(plan):
        for n in dead:
            assert n in ops[i].input_names() + ops[i].output_names()
            assert all(n not in op.input_names() + op.output_names()
                       for op in ops[i + 1:])
    scope, exe = tstatic.Scope(), tstatic.Executor(tstatic.CPUPlace())
    feed = _image_feed(2, (1, 28, 28), 10, 3)
    with tstatic.scope_guard(scope):
        exe.run(startup)
        lv, gv = exe.run(main, feed=feed, fetch_list=[loss, grad])
    assert np.isfinite(lv).all() and gv.shape == (6, 1, 5, 5)
