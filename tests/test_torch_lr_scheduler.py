"""The port's learning-rate schedulers against the JAX package's: all 13
(`optimizer/lr_scheduler.py`) give the reference's lr sequence over 30
`step()` calls, the scope variable of a static program follows `step()`,
and an lr that a scheduler writes between two `Executor.run_steps` calls
holds for each call's K steps, as in the reference's scan.

Tolerances: the lr sequences rtol 1e-7 (the same host-side float64
formulas; the scope value is fp32, compared to the fp32 rounding of the
scheduler's value, exactly); the SGD regression under run_steps,
losses rtol 1e-6 (fp32 sums of squares up to ~20, summed in other orders)
and parameters atol 1e-6.
"""
import numpy as np
import pytest

import paddle_tpu.optimizer.lr_scheduler as jlr
import paddle_tpu.static as jstatic
from paddle_tpu.core.program import _reset_unique_names as jax_reset_names
import paddle_tpu_torch.optimizer.lr_scheduler as tlr
from paddle_tpu_torch import optimizer as toptimizer
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core.program import (_reset_unique_names as
                                           torch_reset_names)
from paddle_tpu_torch.io import load_params_from_numpy

STEPS = 30


def _lam(epoch):
    return 0.95 ** epoch


SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=8,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 12, 20],
                                                 [1.0, 0.5, 0.1, 0.01]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, gamma=0.2),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, 20, end_lr=0.001,
                                                   power=2.0),
    "PolynomialDecay_cycle": lambda m: m.PolynomialDecay(
        0.1, 7, end_lr=0.001, power=1.0, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(0.1, 10, 0.0, 0.1),
    "LinearWarmup_of_PolynomialDecay": lambda m: m.LinearWarmup(
        m.PolynomialDecay(1e-4, 20, end_lr=0.0, power=1.0), 5, 0.0, 1e-4),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.3, gamma=0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.2, [4, 9, 17],
                                                 gamma=0.5),
    "StepDecay": lambda m: m.StepDecay(0.2, step_size=6, gamma=0.3),
    "LambdaDecay": lambda m: m.LambdaDecay(0.4, _lam),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(0.1, T_max=12,
                                                             eta_min=0.01),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(0.1, factor=0.5,
                                                   patience=2, cooldown=1),
    "CosineDecay": lambda m: m.CosineDecay(0.1, step_each_epoch=3,
                                           epochs=10),
}


def _sequence(sched):
    metrics = 1.0 / (1.0 + np.arange(STEPS) % 7)  # plateaus and drops
    out = [sched()]
    for i in range(STEPS):
        if isinstance(sched, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
            sched.step(metrics[i])
        else:
            sched.step()
        out.append(sched())
    return np.asarray(out, np.float64)


def test_all_thirteen_schedulers_are_ported():
    # distinct classes (the 2.0-alpha "LR" names are aliases)
    classes = {getattr(jlr, n) for n in jlr.__all__} - {jlr.LRScheduler}
    assert len(classes) == 13
    assert {k.split("_")[0] for k in SCHEDULERS} == \
        {c.__name__ for c in classes}
    for n in jlr.__all__:
        assert getattr(tlr, n).__name__ == getattr(jlr, n).__name__
    assert toptimizer.lr is tlr


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_sequence_matches_reference(name):
    ref = _sequence(SCHEDULERS[name](jlr))
    got = _sequence(SCHEDULERS[name](tlr))
    np.testing.assert_allclose(got, ref, rtol=1e-7, atol=0)
    sched = SCHEDULERS[name](tlr)
    state = sched.state_dict()
    sched.step() if name != "ReduceOnPlateau" else sched.step(1.0)
    sched.set_state_dict(state)
    assert sched.state_dict() == state


def _sgd_program(static, lr_mod):
    """fc regression minimized by SGD whose lr is a StepDecay scheduler."""
    layers = static.layers
    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = 0
    with static.program_guard(main, startup):
        x = layers.data("x", [-1, 4])
        y = layers.data("y", [-1, 1])
        diff = layers.elementwise_add(layers.fc(x, 1), layers.scale(y, -1.0))
        loss = layers.mean(layers.elementwise_mul(diff, diff))
        sched = lr_mod.StepDecay(0.1, step_size=1, gamma=0.5)
        static.SGD(learning_rate=sched).minimize(loss)
    return main, startup, loss, sched


def test_scope_variable_follows_step_and_holds_over_run_steps():
    """The lr var is written by step(); under run_steps the K steps of a
    call read the value set before the call (parity with the reference's
    scanned run_steps over the same schedule)."""
    jax_reset_names()
    jm, js, jl, jsched = _sgd_program(jstatic, jlr)
    torch_reset_names()
    tm, ts, tl, tsched = _sgd_program(tstatic, tlr)
    assert tm.to_dict() == jm.to_dict() and ts.to_dict() == js.to_dict()
    lr_name = tsched._var.name
    jscope, jexe = jstatic.Scope(), jstatic.Executor()
    tscope, texe = tstatic.Scope(), tstatic.Executor(tstatic.CPUPlace())
    with jstatic.scope_guard(jscope):
        jexe.run(js)
    init = {n: np.asarray(jscope.find_var(n).get_tensor())
            for n in jscope.vars
            if jscope.find_var(n).get_tensor() is not None}
    with tstatic.scope_guard(tscope):
        texe.run(ts)
    load_params_from_numpy(tscope, init, tstatic.CPUPlace())
    rng = np.random.RandomState(4)
    xs = rng.randn(2, 3, 5, 4).astype(np.float32)
    ys = xs.sum(-1, keepdims=True).astype(np.float32)
    params = [p.name for p in tm.all_parameters()]
    for call in range(2):
        with tstatic.scope_guard(tscope):
            assert float(tscope.vars[lr_name]) == np.float32(tsched())
            before = {n: tscope.vars[n].clone() for n in params}
            (tloss,) = texe.run_steps(tm, feed={"x": xs[call],
                                                "y": ys[call]},
                                      fetch_list=[tl])
        with jstatic.scope_guard(jscope):
            (jloss,) = jexe.run_steps(jm, feed={"x": xs[call],
                                                "y": ys[call]},
                                      fetch_list=[jl])
        np.testing.assert_allclose(tloss, np.asarray(jloss), rtol=1e-6,
                                   atol=0)
        for n in params:
            np.testing.assert_allclose(
                tscope.vars[n].numpy(),
                np.asarray(jscope.find_var(n).get_tensor()), atol=1e-6,
                rtol=0, err_msg=n)
        # SGD moved every parameter by lr x (sum of 3 gradients), with the
        # lr of this call: the scope still holds it after the call
        assert float(tscope.vars[lr_name]) == np.float32(tsched())
        assert any(not np.array_equal(before[n].numpy(),
                                      tscope.vars[n].numpy())
                   for n in params)
        with tstatic.scope_guard(tscope):
            tsched.step()
        with jstatic.scope_guard(jscope):
            jsched.step()
    assert tsched() == 0.1 * 0.5 ** 2
