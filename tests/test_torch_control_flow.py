"""Static control flow (static/control_flow.py and the ops of
ops/kernels/control.py and tensor_array.py), held against paddle_tpu:
each program below is built by both packages from one builder, and the
two must be equal as programs (`to_dict`, after both unique-name
counters are reset) and give the same fetches and gradients (1e-5; the
integer and boolean fetches exactly).  The bounded `while` gradient also
matches finite differences (2e-2 relative, float64 numpy reference), and
the unbounded one refuses, as in the JAX package.  Mirrors
tests/test_control_flow.py (not its StaticRNN cases: the rnn tier is not
ported)."""
from importlib import import_module

import numpy as np
import pytest

import paddle_tpu.static as jstatic
from paddle_tpu.core.program import _reset_unique_names as jreset

import paddle_tpu_torch.static as tstatic
from paddle_tpu_torch.core.program import _reset_unique_names as treset

PKGS = {"jax": (jstatic, jreset), "port": (tstatic, treset)}


def _layers(static):
    return import_module(static.__name__ + ".layers")


def _param(static, name, value, shape):
    helper = import_module(static.__name__ + ".layer_helper").LayerHelper
    return helper(name).create_parameter(
        static.ParamAttr(name=name,
                         initializer=static.initializer.Constant(value)),
        shape, "float32")


# ---------------------------------------------------------------------------
# builders: (static) -> (main, startup, fetch vars, grad var names)
# ---------------------------------------------------------------------------
def b_while_sum(static):
    layers = _layers(static)
    i = layers.fill_constant([1], "int64", 0)
    n = layers.fill_constant([1], "int64", 10)
    acc = layers.fill_constant([1], "float32", 0.0)
    cond = layers.less_than(i, n)
    w = layers.While(cond)
    with w.block():
        layers.assign(layers.elementwise_add(acc, layers.cast(i, "float32")),
                      output=acc)
        layers.increment(i, value=1)
        layers.less_than(i, n, cond=cond)
    total = layers.elementwise_add(acc, layers.fill_constant(
        [1], "float32", 0.0))
    return [total, i], {}


def b_while_matmul_power(static):
    layers = _layers(static)
    x = layers.data("x", [-1, 4])
    i = layers.fill_constant([1], "int64", 0)
    n = layers.fill_constant([1], "int64", 3)
    h = layers.elementwise_add(x, layers.fill_constant([1], "float32", 0.0))
    cond = layers.less_than(i, n)
    w = layers.While(cond)
    with w.block():
        layers.assign(layers.scale(h, scale=2.0), output=h)
        layers.increment(i, value=1)
        layers.less_than(i, n, cond=cond)
    return [h], {"x": np.random.RandomState(0).rand(2, 4).astype(
        np.float32)}


def _cond_builder(flag):
    def b(static):
        layers = _layers(static)
        x = layers.data("x", [-1, 1])
        pred = layers.greater_than(
            layers.reduce_sum(x), layers.fill_constant([1], "float32", 0.0))
        out = layers.cond(
            pred,
            lambda: layers.elementwise_add(
                x, layers.fill_constant([1], "float32", 4.0)),
            lambda: layers.elementwise_sub(
                x, layers.fill_constant([1], "float32", 5.0)))
        return [out], {"x": np.full((1, 1), flag, np.float32)}
    return b


def _case_builder(xv):
    def b(static):
        layers = _layers(static)
        x = layers.data("x", [-1, 1])
        s = layers.reduce_sum(x)

        def branch(v):
            return lambda: layers.fill_constant([1], "float32", v)

        out = layers.case(
            [(layers.less_than(s, layers.fill_constant([1], "float32", 0.0)),
              branch(-1.0)),
             (layers.less_than(s, layers.fill_constant([1], "float32",
                                                       10.0)),
              branch(1.0))],
            default=branch(99.0))
        return [out], {"x": np.full((1, 1), xv, np.float32)}
    return b


def _switch_case_builder(i):
    def b(static):
        layers = _layers(static)
        idx = layers.data("idx", [1], dtype="int64")
        out = layers.switch_case(
            idx,
            {0: lambda: layers.fill_constant([1], "float32", 10.0),
             1: lambda: layers.fill_constant([1], "float32", 20.0),
             2: lambda: layers.fill_constant([1], "float32", 30.0)})
        return [out], {"idx": np.array([i], np.int64)}
    return b


def b_tensor_array(static):
    layers = _layers(static)
    x = layers.data("x", [-1, 4])
    arr = layers.create_array("float32")
    i0 = layers.fill_constant([1], "int64", 0)
    i1 = layers.fill_constant([1], "int64", 1)
    layers.array_write(x, i0, array=arr, max_len=8)
    layers.array_write(layers.scale(x, scale=2.0), i1, array=arr)
    n = layers.array_length(arr)
    r0 = layers.array_read(arr, i0)
    r1 = layers.array_read(arr, i1)
    return [n, r0, r1], {"x": np.random.RandomState(1).rand(2, 4).astype(
        np.float32)}


def b_tensor_array_in_while(static):
    layers = _layers(static)
    x = layers.data("x", [-1, 2])
    arr = layers.create_array("float32")
    i = layers.fill_constant([1], "int64", 0)
    n = layers.fill_constant([1], "int64", 4)
    layers.array_write(x, i, array=arr, max_len=8)
    layers.increment(i, value=1)
    h = layers.elementwise_add(x, layers.fill_constant([1], "float32", 0.0))
    cond = layers.less_than(i, n)
    w = layers.While(cond)
    with w.block():
        layers.assign(layers.scale(h, scale=2.0), output=h)
        layers.array_write(h, i, array=arr)
        layers.increment(i, value=1)
        layers.less_than(i, n, cond=cond)
    n_out = layers.array_length(arr)
    last = layers.array_read(arr, layers.fill_constant([1], "int64", 3))
    return [n_out, last], {"x": np.ones((1, 2), np.float32)}


def b_nested_cond_in_while(static):
    layers = _layers(static)
    i = layers.fill_constant([1], "int64", 0)
    n = layers.fill_constant([1], "int64", 6)
    acc = layers.fill_constant([1], "float32", 0.0)
    two = layers.fill_constant([1], "int64", 2)
    cond_v = layers.less_than(i, n)
    w = layers.While(cond_v)
    with w.block():
        rem = layers.elementwise_mod(i, two)
        is_even = layers.equal(rem, layers.fill_constant([1], "int64", 0))
        delta = layers.cond(
            is_even,
            lambda: layers.fill_constant([1], "float32", 1.0),
            lambda: layers.fill_constant([1], "float32", 10.0))
        layers.assign(layers.elementwise_add(acc, delta), output=acc)
        layers.increment(i, value=1)
        layers.less_than(i, n, cond=cond_v)
    return [acc], {}


def _while_loss_builder(max_iters):
    def b(static):
        layers = _layers(static)
        x = layers.data("x", [2])
        w = _param(static, "w", 1.0, [2])
        s0 = layers.fill_constant([2], "float32", 0.0)
        (s_fin,) = layers.while_loop(
            lambda s: layers.less_than(
                layers.reduce_sum(s),
                layers.fill_constant([1], "float32", 10.0)),
            lambda s: layers.elementwise_add(
                s, layers.elementwise_mul(w, x)),
            [s0], max_iters=max_iters)
        loss = layers.reduce_sum(layers.elementwise_mul(s_fin, s_fin))
        grads = static.append_backward(loss)
        return [loss] + [g for _, g in grads], \
            {"x": np.array([1.5, 2.0], np.float32)}
    return b


def b_cond_grad(static):
    layers = _layers(static)
    x = layers.data("x", [-1, 2])
    x.stop_gradient = False
    pred = layers.greater_than(layers.reduce_sum(x),
                               layers.fill_constant([1], "float32", 0.0))
    y = layers.cond(pred,
                    lambda: layers.scale(x, scale=3.0),
                    lambda: layers.scale(x, scale=7.0))
    loss = layers.reduce_sum(y)
    grads = static.gradients([loss], [x])
    return [loss, grads[0]], {"x": -np.ones((1, 2), np.float32)}


CASES = {
    "while_sum": b_while_sum,
    "while_matmul_power": b_while_matmul_power,
    "cond_true": _cond_builder(1.0),
    "cond_false": _cond_builder(-1.0),
    "case_first": _case_builder(-5.0),
    "case_second": _case_builder(5.0),
    "case_default": _case_builder(50.0),
    "switch_case_0": _switch_case_builder(0),
    "switch_case_2": _switch_case_builder(2),
    "tensor_array": b_tensor_array,
    "tensor_array_in_while": b_tensor_array_in_while,
    "nested_cond_in_while": b_nested_cond_in_while,
    "bounded_while_grad": _while_loss_builder(16),
    "cond_grad": b_cond_grad,
}


def build(pkg, builder):
    static, reset = PKGS[pkg]
    reset()
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        fetch, feed = builder(static)
    return main, startup, fetch, feed


def run(pkg, main, startup, fetch, feed, steps=1):
    static, _ = PKGS[pkg]
    exe = static.Executor(static.CPUPlace()) if pkg == "port" \
        else static.Executor()
    scope = static.Scope()
    with static.scope_guard(scope):
        exe.run(startup)
        for _ in range(steps):
            out = exe.run(main, feed=feed, fetch_list=fetch)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("name", sorted(CASES))
def test_program_fetches_and_grads_equal_the_jax_packages(name):
    jm, js, jf, feed = build("jax", CASES[name])
    tm, ts, tf, _ = build("port", CASES[name])
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    ref = run("jax", jm, js, jf, feed)
    got = run("port", tm, ts, tf, feed)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          r.astype(np.int64))


def test_bounded_while_grad_matches_finite_differences():
    tm, ts, tf, feed = build("port", _while_loss_builder(16))
    lv, gw = run("port", tm, ts, tf, feed)
    xv = feed["x"].astype(np.float64)

    def run_loss(wv):
        s = np.zeros(2, np.float64)
        it = 0
        while s.sum() < 10 and it < 16:
            s = s + wv * xv
            it += 1
        return float((s * s).sum())

    eps = 1e-3
    w0 = np.ones(2, np.float64)
    for i in range(2):
        wp, wm = w0.copy(), w0.copy()
        wp[i] += eps
        wm[i] -= eps
        fd = (run_loss(wp) - run_loss(wm)) / (2 * eps)
        np.testing.assert_allclose(gw[i], fd, rtol=2e-2)
    assert float(lv) == pytest.approx(run_loss(w0), rel=1e-6)


def test_bounded_while_trains_and_truncates_like_the_jax_package():
    def b(static):
        layers = _layers(static)
        x = layers.data("x", [2])
        tgt = layers.data("tgt", [2])
        w = _param(static, "w2", 0.3, [2])
        s0 = layers.fill_constant([2], "float32", 0.0)
        (s_fin,) = layers.while_loop(
            lambda s: layers.less_than(
                layers.reduce_sum(s),
                layers.fill_constant([1], "float32", 3.0)),
            lambda s: layers.elementwise_add(
                s, layers.elementwise_mul(w, x)),
            [s0], max_iters=8)
        loss = layers.reduce_sum(
            layers.square(layers.elementwise_sub(s_fin, tgt)))
        static.SGD(learning_rate=0.05).minimize(loss)
        return [loss], {"x": np.array([1.0, 1.0], np.float32),
                        "tgt": np.array([2.0, 1.5], np.float32)}

    losses = {}
    for pkg in ("jax", "port"):
        m, s, f, feed = build(pkg, b)
        static, _ = PKGS[pkg]
        exe = static.Executor(static.CPUPlace()) if pkg == "port" \
            else static.Executor()
        scope = static.Scope()
        with static.scope_guard(scope):
            exe.run(s)
            losses[pkg] = [float(np.asarray(exe.run(
                m, feed=feed, fetch_list=f)[0])) for _ in range(12)]
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)
    assert losses["port"][-1] < losses["port"][0]


def test_unbounded_while_is_not_differentiable():
    tm, ts, tf, feed = build("port", _while_loss_builder(0))
    jm, js, jf, _ = build("jax", _while_loss_builder(0))
    # the carried vars keep stop_gradient=True: no parameter gradient
    assert len(tf) == len(jf) == 1
    assert tm.to_dict() == jm.to_dict()
    from paddle_tpu_torch.ops.registry import get_op_info
    with pytest.raises(ValueError, match="max_iters"):
        get_op_info("while_grad").kernel({}, {"max_iters": 0}, None)
    (lv,) = run("port", tm, ts, tf, feed)
    (rv,) = run("jax", jm, js, jf, feed)
    np.testing.assert_allclose(lv, rv, rtol=1e-6)


def test_switch_lr_warmup_equals_the_jax_packages():
    def b(static):
        layers = _layers(static)
        step = layers.create_global_var([1], 0.0, "float32",
                                        persistable=True, name="gstep")
        lr = layers.create_global_var([1], 0.0, "float32",
                                      persistable=True, name="lr")
        layers.increment(step, value=1)
        warm_end = layers.fill_constant([1], "float32", 3.0)
        with layers.Switch() as sw:
            with sw.case(layers.less_equal(step, warm_end)):
                layers.assign(layers.scale(step, scale=0.1), output=lr)
            with sw.default():
                layers.assign(layers.fill_constant([1], "float32", 1.0),
                              output=lr)
        return [lr], {}

    seen = {}
    for pkg in ("jax", "port"):
        m, s, f, feed = build(pkg, b)
        static, _ = PKGS[pkg]
        exe = static.Executor(static.CPUPlace()) if pkg == "port" \
            else static.Executor()
        scope = static.Scope()
        with static.scope_guard(scope):
            exe.run(s)
            seen[pkg] = [round(float(np.asarray(exe.run(
                m, fetch_list=f)[0]).reshape(())), 5) for _ in range(5)]
    assert seen["port"] == seen["jax"] == [0.1, 0.2, 0.3, 1.0, 1.0]


def test_run_steps_runs_a_while_program_step_by_step():
    """A program holding `while` reads its predicate on the host, so
    run_steps never captures it (the host-op check), on any device."""
    from paddle_tpu_torch.ops.kernels.distributed_ops import has_host_ops
    tm, ts, tf, feed = build("port", b_while_matmul_power)
    assert has_host_ops(tm)
    exe = tstatic.Executor(tstatic.CPUPlace())
    scope = tstatic.Scope()
    with tstatic.scope_guard(scope):
        exe.run(ts)
        out = exe.run_steps(tm, feed={"x": np.stack([feed["x"]] * 3)},
                            fetch_list=tf)
    np.testing.assert_allclose(out[0], np.stack([feed["x"] * 8.0] * 3),
                               rtol=1e-6)


def test_rnn_tier_refuses_naming_the_queue():
    layers = _layers(tstatic)
    with pytest.raises(NotImplementedError, match="Queue 1, The rest"):
        layers.StaticRNN()
    with pytest.raises(NotImplementedError, match="Queue 1, The rest"):
        tstatic.control_flow.lod_rank_table(None)
