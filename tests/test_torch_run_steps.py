"""Executor.run_steps of the port on the CPU: the reference's contract
(tests/test_run_steps.py) and parity with paddle_tpu's run_steps.

The reference scans K steps in one jitted dispatch; the port loops over
run() on the CPU and replays a captured CUDA graph on the card (those
cases are in tests/test_torch_cuda.py).  The contract is the same: every
feed has a leading steps axis, fetches come back stacked [K, ...], the
scope ends holding the K-th step's state, the per-step seeds follow K
run() calls, FLAGS_check_nan_inf raises after the K steps, and a short
final chunk adds no capture or trace.

Parity: the same program is built in both packages from the same
unique-name state, the reference's startup weights cross into the port
with `load_params_from_numpy`, and both run_steps take the same stacked
numpy feeds.  Tolerances: the fp32 fc regression, losses rtol 1e-5 and
parameters atol 2e-5 (Adam divides by sqrt(v): a ~1e-6 relative gradient
difference on a near-zero gradient is a visible share of its lr step);
the CPU bench shape (AMP bf16, 10 steps in two calls of 5), losses rtol
1e-3 (bf16 activations rounded at different places by XLA and by torch)
and parameters atol 4e-3: an Adam step moves a parameter by about lr =
1e-4 whatever its gradient, so a near-zero gradient whose sign differs
under bf16 rounding moves it by up to 2 lr a step, 2e-3 over 10 steps,
with a factor 2 of margin.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.static as jstatic
from paddle_tpu.core.flags import set_flags as jax_set_flags
from paddle_tpu.core.program import _reset_unique_names as jax_reset_names
from paddle_tpu.static import layers as jlayers
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.core.program import (_reset_unique_names as
                                           torch_reset_names)
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.static import layers as tlayers
from test_torch_train_program import build_both

BENCH_CPU = dict(vocab=1024, seq=128, hidden=256, layers_n=2, heads=4)
BENCH_BATCH = 2


def _fc_program(static, layers, lr=0.01):
    """x [-1, 8] -> fc 16 gelu -> fc 1; mean squared error against y,
    minimized by Adam."""
    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = 0
    with static.program_guard(main, startup):
        x = layers.data("x", [-1, 8])
        y = layers.data("y", [-1, 1])
        pred = layers.fc(layers.fc(x, 16, act="gelu"), 1)
        diff = layers.elementwise_add(pred, layers.scale(y, -1.0))
        loss = layers.mean(layers.elementwise_mul(diff, diff))
        static.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss


def _port_fc(lr=0.01):
    """The port's fc program, a CPU executor and a scope holding its
    startup weights."""
    torch_reset_names()
    main, startup, loss = _fc_program(tstatic, tlayers, lr)
    exe, scope = tstatic.Executor(tstatic.CPUPlace()), tstatic.Scope()
    with tstatic.scope_guard(scope):
        exe.run(startup)
    return main, loss, exe, scope


def _data(k, batch=4, seed=7):
    rng = np.random.RandomState(seed)
    xs = rng.rand(k, batch, 8).astype(np.float32)
    return xs, xs.sum(2, keepdims=True).astype(np.float32)


def _copy(scope):
    out = tstatic.Scope()
    for n, t in scope.vars.items():
        out.set(n, t.clone())
    return out


def test_run_steps_matches_sequential():
    """K steps in one call = K run() calls from the same state: the
    stacked losses, the state after the K-th step and the step count
    (which drives the per-step seeds)."""
    K = 6
    xs, ys = _data(K)
    main, loss, exe, scope = _port_fc()
    seq_scope, seq_exe = _copy(scope), tstatic.Executor(tstatic.CPUPlace())
    seq_exe._step = exe._step
    with tstatic.scope_guard(scope):
        (stacked,) = exe.run_steps(main, feed={"x": xs, "y": ys},
                                   fetch_list=[loss])
    with tstatic.scope_guard(seq_scope):
        seq = [float(seq_exe.run(main, feed={"x": xs[i], "y": ys[i]},
                                 fetch_list=[loss])[0]) for i in range(K)]
    assert isinstance(stacked, np.ndarray) and stacked.shape == (K,)
    np.testing.assert_array_equal(stacked, np.float32(seq))
    assert exe._step == seq_exe._step
    for n, t in seq_scope.vars.items():
        assert torch.equal(scope.vars[n], t), n
    with tstatic.scope_guard(scope):
        (tensors,) = exe.run_steps(main, feed={"x": xs[:2], "y": ys[:2]},
                                   fetch_list=[loss], return_numpy=False)
    assert isinstance(tensors, torch.Tensor) and tensors.shape == (2,)


def test_run_steps_state_carries_between_calls():
    K = 8
    xs, ys = _data(2 * K)
    main, loss, exe, scope = _port_fc(lr=0.05)
    with tstatic.scope_guard(scope):
        (l1,) = exe.run_steps(main, feed={"x": xs[:K], "y": ys[:K]},
                              fetch_list=[loss])
        (l2,) = exe.run_steps(main, feed={"x": xs[K:], "y": ys[K:]},
                              fetch_list=[loss])
    assert float(l2[-1]) < float(l1[0])


def test_run_steps_validates_feed_with_the_reference_messages():
    """Empty feed, mismatched steps axes and a scalar feed raise
    ValueError in both packages, with the same messages."""
    xs, ys = _data(3)
    jax_reset_names()
    jm, js, jl = _fc_program(jstatic, jlayers)
    jexe, jscope = jstatic.Executor(), jstatic.Scope()
    with jstatic.scope_guard(jscope):
        jexe.run(js)
    tm, tl, texe, tscope = _port_fc()
    for feed in ({}, {"x": xs, "y": ys[:2]},
                 {"x": xs, "y": np.float32(0.5)}):
        msgs = []
        for exe, guard, scope, main, loss in (
                (jexe, jstatic.scope_guard, jscope, jm, jl),
                (texe, tstatic.scope_guard, tscope, tm, tl)):
            with guard(scope), pytest.raises(ValueError) as err:
                exe.run_steps(main, feed=feed, fetch_list=[loss])
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1], msgs
    assert "scalar" in msgs[1]


def test_run_steps_honors_check_nan_inf():
    """FLAGS_check_nan_inf raises after the K steps on a non-finite fetch
    (naming the first micro-step that has one) or persistable; off, the
    same steps return the non-finite losses."""
    xs, ys = _data(4)
    xs[2, 0, 0] = np.inf
    main, loss, exe, scope = _port_fc()
    set_flags({"FLAGS_check_nan_inf": True})
    try:
        with tstatic.scope_guard(_copy(scope)):
            with pytest.raises(RuntimeError,
                               match="check_nan_inf.*micro-step 2"):
                exe.run_steps(main, feed={"x": xs, "y": ys},
                              fetch_list=[loss])
    finally:
        set_flags({"FLAGS_check_nan_inf": False})
    with tstatic.scope_guard(_copy(scope)):
        (lv,) = exe.run_steps(main, feed={"x": xs, "y": ys},
                              fetch_list=[loss])
    assert np.all(np.isfinite(lv[:2])) and not np.isfinite(lv[2])


def test_run_steps_short_final_chunk_no_capture():
    """A K' < K final chunk runs at its own length, with no capture or
    trace (on the card it replays the K-step call's graph), and the
    losses follow the all-sequential walk."""
    K = 6
    xs, ys = _data(K + 2)
    main, loss, exe, scope = _port_fc()
    seq_scope = _copy(scope)
    with tstatic.scope_guard(scope):
        (l1,) = exe.run_steps(main, feed={"x": xs[:K], "y": ys[:K]},
                              fetch_list=[loss])
        stats = exe.cache_stats()
        (l2,) = exe.run_steps(main, feed={"x": xs[K:], "y": ys[K:]},
                              fetch_list=[loss])
    assert l2.shape == (2,)
    assert exe.cache_stats() == stats == {"hits": 0, "misses": 0,
                                          "traces": 0}
    with tstatic.scope_guard(seq_scope):
        seq = [float(exe.run(main, feed={"x": xs[i], "y": ys[i]},
                             fetch_list=[loss])[0]) for i in range(K + 2)]
    np.testing.assert_array_equal(np.concatenate([l1, l2]), np.float32(seq))


def test_run_steps_refuses_what_is_not_a_program():
    main, loss, exe, scope = _port_fc()
    with pytest.raises(TypeError, match="takes a Program"):
        exe.run_steps(object(), feed={"x": np.zeros((1, 2, 8))})


def _ref_run_steps(jm, js, jl, chunks, flags=None):
    """paddle_tpu's run_steps over `chunks` (stacked feeds) from its
    startup weights: (stacked losses, startup weights, final state)."""
    jscope, jexe = jstatic.Scope(), jstatic.Executor()
    with jstatic.scope_guard(jscope):
        jexe.run(js)
        init = {n: np.asarray(jscope.find_var(n).get_tensor())
                for n in jscope.vars
                if jscope.find_var(n).get_tensor() is not None}
        losses = [np.asarray(jexe.run_steps(jm, feed=c,
                                            fetch_list=[jl])[0]).reshape(-1)
                  for c in chunks]
    final = {n: np.asarray(jscope.find_var(n).get_tensor()) for n in init}
    return np.concatenate(losses), init, final


def _port_run_steps(tm, tl, init, chunks):
    scope = tstatic.Scope()
    load_params_from_numpy(scope, init, tstatic.CPUPlace())
    exe = tstatic.Executor(tstatic.CPUPlace())
    with tstatic.scope_guard(scope):
        losses = [exe.run_steps(tm, feed=c, fetch_list=[tl])[0].reshape(-1)
                  for c in chunks]
    return np.concatenate(losses), scope


def _assert_params(final, scope, atol):
    for n, ref in final.items():
        got = scope.vars[n]
        got = got.float().numpy() if got.is_floating_point() \
            else got.numpy()
        np.testing.assert_allclose(got.astype(np.float64),
                                   ref.astype(np.float64), rtol=0, atol=atol,
                                   err_msg=n)


def test_run_steps_matches_reference_fc():
    """The fp32 fc regression: 2 calls of K = 4 in both packages."""
    xs, ys = _data(8)
    chunks = [{"x": xs[:4], "y": ys[:4]}, {"x": xs[4:], "y": ys[4:]}]
    jax_reset_names()
    jm, js, jl = _fc_program(jstatic, jlayers)
    torch_reset_names()
    tm, _, tl = _fc_program(tstatic, tlayers)
    assert tm.serialize_to_string() == jm.serialize_to_string()
    ref, init, final = _ref_run_steps(jm, js, jl, chunks)
    got, scope = _port_run_steps(tm, tl, init, chunks)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    _assert_params(final, scope, 2e-5)


def test_run_steps_matches_reference_cpu_bench_shape():
    """bench.py's CPU configuration (seq 128, batch 2, 2 layers, hidden
    256, vocab 1024, 4 heads, AMP bf16; score-matrix attention and the
    unfused cross-entropy, as bench.py picks them at seq 128): 10 steps
    as 2 calls of K = 5 in both packages, one fixed numpy feed per
    step."""
    (jm, js, jl), (tm, _, tl) = build_both(True, kernels=False, **BENCH_CPU)
    rng = np.random.RandomState(0)
    k, seq, vocab = 5, BENCH_CPU["seq"], BENCH_CPU["vocab"]
    chunks = [{"ids": rng.randint(0, vocab, (k, BENCH_BATCH, seq)),
               "pos": np.tile(np.arange(seq), (k, BENCH_BATCH, 1)),
               "labels": rng.randint(0, vocab, (k, BENCH_BATCH, seq, 1))}
              for _ in range(2)]
    chunks = [{n: v.astype(np.int64) for n, v in c.items()} for c in chunks]
    ref, init, final = _ref_run_steps(jm, js, jl, chunks)
    got, scope = _port_run_steps(tm, tl, init, chunks)
    assert got.shape == (10,) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=1e-3)
    _assert_params(final, scope, 4e-3)
