"""The Philox draws behind paddle_tpu_torch.tensor's random functions, on
the CPU (ops/random.py's plain versions, which the card's kernels equal:
tests/test_torch_cuda.py):

  * the formulas: the truncated normal's inverse CDF, the integers'
    multiply-shift (and the two-word modulo above a 2^32 span) and the
    Bernoulli test, rebuilt here in Python integers / float64 from the
    generator's 32-bit words (ops/dropout.py `philox_draws`): integers and
    Bernoulli bit for bit, the truncated normal within 2 fp32 ulps;
  * statistics at 5 sigma (the truncated normal's mean and variance
    against the closed form and against jax.random.truncated_normal's
    draws, the integers' and Bernoulli's means), the truncation bounds,
    randperm a permutation;
  * the ops in a static program: fresh draws on each step of
    `Executor.run_steps`, each step equal to an eager `run()` of that
    step; eager calls take new uids;
  * multinomial ignores `replacement` (samples with replacement) and
    samples from log(x + 1e-12), as the JAX op does.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.tensor as J

import paddle_tpu_torch as pt
import paddle_tpu_torch.static as tstatic
import paddle_tpu_torch.tensor as T
from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.core.program import _reset_unique_names as treset
from paddle_tpu_torch.dygraph import guard
from paddle_tpu_torch.ops import random as trandom
from paddle_tpu_torch.ops.dropout import philox_draws

from test_torch_gpt import jax_generator_restored  # noqa: F401

SIGMA = 5.0
# a standard normal truncated to [-2, 2]: variance 1 - 4 phi(2) / erf(sqrt 2)
_PHI2 = math.exp(-2.0) / math.sqrt(2.0 * math.pi)
TRUNC_VAR = 1.0 - 4.0 * _PHI2 / math.erf(math.sqrt(2.0))


@pytest.fixture(autouse=True)
def _cpu():
    torch.set_num_threads(2)
    with guard(CPUPlace()):
        yield


def _words(n, seed, uid, stream=0):
    if stream == 0:
        return [int(w) for w in philox_draws(n, seed, uid)]
    g = torch.arange((n + 3) // 4, dtype=torch.int64)
    zero = torch.zeros_like(g)
    from paddle_tpu_torch.ops.dropout import philox4x32
    ws = philox4x32(g & 0xFFFFFFFF, g >> 32, zero + stream, zero,
                    seed & 0xFFFFFFFF, uid & 0xFFFFFFFF)
    return [int(w) for w in torch.stack(ws, 1).reshape(-1)[:n]]


@pytest.mark.parametrize("low,high", [(0, 30522), (-7, 3), (5, 6),
                                      (0, 1 << 32), (-(1 << 40), 1 << 41)])
def test_randint_formula_bit_for_bit(low, high):
    n, seed, uid = 1001, 20260101, 33
    got = trandom.randint_plain((n,), torch.int64, low, high, seed, uid)
    w = _words(n, seed, uid)
    span = high - low
    if span <= 1 << 32:
        want = [low + ((x * span) >> 32) for x in w]
    else:
        h = _words(n, seed, uid, stream=1)
        want = [low + ((((hh & 0x7FFFFFFF) << 32) | x) % span)
                for x, hh in zip(w, h)]
    assert got.tolist() == want
    assert int(got.min()) >= low and int(got.max()) < high


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
def test_bernoulli_formula_bit_for_bit(dtype):
    g = torch.Generator().manual_seed(0)
    p = torch.rand(7, 33, generator=g).to(dtype)
    got = trandom.bernoulli_plain(p, 99, 5)
    assert got.dtype == dtype and got.shape == p.shape
    w = _words(p.numel(), 99, 5)
    pf = p.reshape(-1).to(torch.float32).tolist()
    want = [1.0 if (x >> 8) * 2.0 ** -24 < q else 0.0 for x, q in
            zip(w, pf)]
    assert got.reshape(-1).double().tolist() == want


def test_truncated_normal_formula_and_bounds():
    n, seed, uid = 4099, 7, 12
    got = trandom.random_plain((n,), torch.float32, trandom.TRUNC_NORMAL,
                               0.0, 1.0, seed, uid)
    a = float(np.float32(math.erf(math.sqrt(2.0))))
    want = []
    for x in _words(n, seed, uid):
        u = (x >> 8) * 2.0 ** -24
        t = float(np.float32(np.float32(2.0 * u - 1.0) * np.float32(a)))
        want.append(max(-2.0, min(2.0, math.sqrt(2.0) * _erfinv(t))))
    want = np.asarray(want, np.float32)
    ulp = np.finfo(np.float32).eps * np.maximum(np.abs(want), 1e-3)
    assert (np.abs(got.numpy() - want) <= 2 * ulp).all()
    assert float(got.min()) >= -2.0 and float(got.max()) <= 2.0
    # scaled: mean + std z, each step rounded in fp32
    s = trandom.random_plain((n,), torch.float32, trandom.TRUNC_NORMAL,
                             0.5, 0.02, seed, uid)
    np.testing.assert_array_equal(
        s.numpy(), (got.numpy() * np.float32(0.02)) + np.float32(0.5))


def _erfinv(t):
    """erfinv by Newton's method on math.erf (float64), independent of
    torch.special.erfinv."""
    if t == 0.0:
        return 0.0
    z = 0.0
    for _ in range(60):
        err = math.erf(z) - t
        z -= err / (2.0 / math.sqrt(math.pi) * math.exp(-z * z))
    return z


def test_truncated_normal_statistics_against_the_jax_op(
        jax_generator_restored):
    n = 200000
    z = trandom.truncated_normal((n,), torch.float32, 0.0, 1.0, 3, 1,
                                 "cpu").double()
    var_sd = math.sqrt(2.0 / n) * TRUNC_VAR * 1.2  # kurtosis below normal
    assert abs(float(z.mean())) < SIGMA * math.sqrt(TRUNC_VAR / n)
    assert abs(float(z.var()) - TRUNC_VAR) < SIGMA * var_sd
    # the JAX op's draws (threefry) at the same moments
    paddle_tpu.seed(5)
    from paddle_tpu.tensor._dispatch import dispatch as jdispatch
    jz = np.asarray(jdispatch(
        "truncated_gaussian_random", {},
        {"shape": [n], "dtype": "float32", "mean": 0.0,
         "std": 1.0}).numpy(), np.float64)
    assert jz.min() >= -2.0 and jz.max() <= 2.0
    assert abs(jz.var() - float(z.var())) < 2 * SIGMA * var_sd
    assert abs(jz.mean() - float(z.mean())) < 2 * SIGMA * math.sqrt(
        TRUNC_VAR / n)


def test_randint_bernoulli_randperm_statistics():
    n = 100000
    x = trandom.randint_plain((n,), torch.int64, 0, 10, 1, 2).double()
    assert abs(float(x.mean()) - 4.5) < SIGMA * math.sqrt(8.25 / n)
    counts = torch.bincount(x.long(), minlength=10).double()
    assert (abs(counts - n / 10) < SIGMA * math.sqrt(n * 0.09)).all()
    p = torch.full((n,), 0.15)
    b = trandom.bernoulli_plain(p, 1, 3).double()
    assert abs(float(b.mean()) - 0.15) < SIGMA * math.sqrt(0.1275 / n)
    perm = trandom.randperm(1000, torch.int64, 4, 5, "cpu")
    assert torch.equal(perm.sort().values, torch.arange(1000))
    assert not torch.equal(perm, torch.arange(1000))


def test_multinomial_ignores_replacement_as_the_jax_op(
        jax_generator_restored):
    probs = np.array([[0.0, 0.5, 0.5, 0.0], [0.0, 0.0, 1.0, 0.0]],
                     np.float32)
    paddle_tpu.seed(2)
    pt.seed(2)
    for replacement in (False, True):
        j = np.asarray(J.multinomial(paddle_tpu.to_tensor(probs), 6,
                                     replacement).numpy())
        t = T.multinomial(pt.to_tensor(probs), 6, replacement).numpy()
        # 6 samples from 2 categories: repeats, in both packages
        assert t.shape == j.shape == (2, 6)
        assert set(t[0]) <= {1, 2} and set(j[0]) <= {1, 2}
        assert (t[1] == 2).all() and (j[1] == 2).all()
    # sampling_id: one draw a row from log(x + 1e-12)
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        x = tstatic.data("x", [2, 4], "float32")
        from paddle_tpu_torch.tensor._dispatch import dispatch
        sid = dispatch("sampling_id", {"X": x})
    got = tstatic.Executor(CPUPlace()).run(main, feed={"x": probs},
                                           fetch_list=[sid])[0]
    assert got.shape == (2,) and got[1] == 2 and got[0] in (1, 2)
    # the frequencies follow the probabilities
    many = T.multinomial(pt.to_tensor(np.array([0.2, 0.3, 0.5], np.float32)),
                         60000).double()
    freq = torch.bincount(many.long(), minlength=3) / 60000.0
    assert (abs(freq - torch.tensor([0.2, 0.3, 0.5], dtype=torch.float64))
            < SIGMA * math.sqrt(0.25 / 60000)).all()


def _random_program():
    treset()
    main, startup = tstatic.Program(), tstatic.Program()
    pt.enable_static()
    try:
        with tstatic.program_guard(main, startup):
            p = tstatic.data("p", [4, 8], "float32")
            from paddle_tpu_torch.tensor._dispatch import dispatch
            outs = [T.randint(0, 100, [4, 8]), T.bernoulli(p),
                    dispatch("truncated_gaussian_random", {},
                             {"shape": [4, 8], "dtype": "float32",
                              "mean": 0.0, "std": 0.5}),
                    T.randperm(16), T.multinomial(p, 3)]
    finally:
        pt.disable_static()
    return main, startup, outs


def test_run_steps_draws_anew_each_step_as_eager_run():
    main, startup, outs = _random_program()
    names = [o.name for o in outs]
    feed = {"p": np.full((3, 4, 8), 0.5, np.float32)}
    exe = tstatic.Executor(CPUPlace())
    exe.run(startup)
    step0 = exe._step
    got = exe.run_steps(main, feed=feed, fetch_list=names)
    for g in got:
        g = np.asarray(g)
        assert not np.array_equal(g[0], g[1]) and \
            not np.array_equal(g[1], g[2])
    # the same steps through run(), from the same step count
    exe2 = tstatic.Executor(CPUPlace())
    exe2.run(startup)
    exe2._step = step0
    for s in range(3):
        one = exe2.run(main, feed={"p": feed["p"][s]}, fetch_list=names)
        for g, o in zip(got, one):
            np.testing.assert_array_equal(np.asarray(g)[s], np.asarray(o))
    z = np.asarray(got[2])
    assert z.min() >= -1.0 and z.max() <= 1.0


def test_eager_draws_take_new_uids():
    pt.seed(11)
    a = T.randint(0, 1000, [64]).numpy()
    b = T.randint(0, 1000, [64]).numpy()
    assert not np.array_equal(a, b)
    pt.seed(11)
    np.testing.assert_array_equal(T.randint(0, 1000, [64]).numpy(), a)
