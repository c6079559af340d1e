"""The other optimizers on the CPU, the port against the JAX package: the
optimizer op kernels lars_momentum, adamax, adagrad, decayed_adagrad,
adadelta, rmsprop, ftrl, dpsgd, average_accumulates, proximal_gd and
proximal_adagrad; the static optimizer classes over them, EMA,
ModelAverage and Lookahead; the 2.0 optimizers Adamax, Adagrad, Adadelta
and RMSProp.

Inputs come from seeded numpy and go to both packages.  Tolerances:

  * one op at a time, fp32: rtol 1e-6, atol 1e-7 (the same formulas in
    the same order; XLA may fuse a multiply-add or sum a norm in another
    order, a few ulps), ftrl with lr_power != -0.5 rtol 5e-6 (XLA's CPU
    pow is exp(y log x)); after 5 Ftrl steps its accumulators rtol 1e-5;
  * 5 training steps of the fc regression of tests/test_torch_optimizers
    .py, programs serialized equal: losses and every persistable within
    atol 1e-6 (as that file); dpsgd's N(0, 1) noise is the port's Philox
    normal, put into the JAX registry's dpsgd kernel in memory for the
    test (`jax_philox_normal`: Box-Muller over the recipe test's jnp
    Philox), so both add the same noise to within its ulps;
  * the 2.0 optimizers on the dygraph MLP of test_torch_dygraph_train.py,
    3 steps: losses rtol 1e-6, accumulators and parameters atol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.optimizer as jopt
import paddle_tpu.static as jstatic
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.ops import random as trandom
from paddle_tpu_torch.ops.registry import OpContext as TCtx, get_op_info
import paddle_tpu_torch.dygraph as tdg
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.optimizer as topt
from test_torch_optimizers import (assert_state_close, batches, build_both,
                                   start_both)
from test_torch_recipe import jax_philox_draws
from test_torch_dygraph_train import _mlp_pair, assert_params_close

OP_TOL = dict(rtol=1e-6, atol=1e-7)
ATOL = 1e-6
STEPS = 5
SHAPE = (7, 5)


def jax_philox_normal(shape, seed, uid):
    """ops/random.py's normal (mean 0, std 1) in jnp: Box-Muller over the
    pairs of the port's Philox draws."""
    n = int(np.prod(shape))
    w = jax_philox_draws(n + (n & 1), seed, uid).reshape(-1, 2)
    u1 = ((w[:, 0] >> 8) + 1).astype(jnp.float32) * jnp.float32(2.0 ** -24)
    u2 = (w[:, 1] >> 8).astype(jnp.float32) * jnp.float32(2.0 ** -24)
    r = jnp.sqrt(jnp.log(u1) * jnp.float32(-2.0))
    theta = u2 * jnp.float32(2.0 * np.pi)
    z = jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], 1).reshape(-1)
    return z[:n].reshape(shape)


def jax_philox_dpsgd(ins, attrs, ctx):
    """The JAX package's dpsgd kernel (paddle_tpu/ops/kernels/optimizers.py
    :324) with its N(0, 1) drawn as the port draws it."""
    p = ins["Param"].astype(jnp.float32)
    g = ins["Grad"].astype(jnp.float32)
    clip = attrs.get("clip", 10.0)
    batch_size = attrs.get("batch_size", 16.0)
    sigma = attrs.get("sigma", 1.0)
    g_norm = jnp.sqrt(jnp.sum(jnp.square(g)))
    g = g * jnp.minimum(1.0, clip / jnp.maximum(g_norm, 1e-12))
    uid = attrs.get("fwd_uid", attrs.get("op_uid", 0))
    seed = attrs.get("seed", 0) or ctx.seed
    noise = sigma * clip * jax_philox_normal(g.shape, seed, uid)
    p_out = p - ins["LearningRate"].reshape(()).astype(jnp.float32) * (
        g + noise / batch_size)
    return {"ParamOut": p_out.astype(ins["Param"].dtype)}


@pytest.fixture
def philox_dpsgd_in_jax(monkeypatch):
    monkeypatch.setattr(jreg.get_op_info("dpsgd"), "kernel",
                        jax_philox_dpsgd)


def test_jax_philox_normal_matches_port_plain():
    """The injected jnp normal against the port's plain version: within a
    few fp32 ulps (both take log / cos / sin of the same fp32 values)."""
    for seed, uid in ((0, 0), (12345, 77), (2 ** 31 - 1, 2 ** 32 - 1)):
        want = trandom.random_plain(SHAPE, torch.float32, trandom.NORMAL,
                                    0.0, 1.0, seed, uid).numpy()
        got = np.asarray(jax_philox_normal(SHAPE, seed, uid))
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the op kernels, one step each
# ---------------------------------------------------------------------------
def _arrays(rng, **shapes):
    return {k: (rng.rand(*s).astype(np.float32) + (0.5 if pos else -0.5))
            for k, (s, pos) in shapes.items()}


def _ins(op, rng):
    lr = np.asarray([0.05], np.float32)
    m = SHAPE
    if op == "lars_momentum":
        return _arrays(rng, Param=(m, 0), Grad=(m, 0), Velocity=(m, 0)) | \
            {"LearningRate": lr}
    if op == "adamax":
        return _arrays(rng, Param=(m, 0), Grad=(m, 0), Moment=(m, 0),
                       InfNorm=(m, 1)) | {
            "LearningRate": lr, "Beta1Pow": np.asarray([0.81], np.float32)}
    if op in ("adagrad", "decayed_adagrad"):
        return _arrays(rng, Param=(m, 0), Grad=(m, 0), Moment=(m, 1)) | \
            {"LearningRate": lr}
    if op == "adadelta":
        return _arrays(rng, Param=(m, 0), Grad=(m, 0),
                       AvgSquaredGrad=(m, 1), AvgSquaredUpdate=(m, 1))
    if op == "rmsprop":
        return _arrays(rng, Param=(m, 0), Grad=(m, 0), MeanSquare=(m, 1),
                       MeanGrad=(m, 0), Moment=(m, 0)) | {"LearningRate": lr}
    if op == "ftrl":
        return _arrays(rng, Param=(m, 0), Grad=(m, 0),
                       SquaredAccumulator=(m, 1),
                       LinearAccumulator=(m, 0)) | {"LearningRate": lr}
    if op in ("proximal_gd",):
        return _arrays(rng, Param=(m, 0), Grad=(m, 0)) | {"LearningRate": lr}
    if op == "proximal_adagrad":
        return _arrays(rng, Param=(m, 0), Grad=(m, 0), Moment=(m, 1)) | \
            {"LearningRate": lr}
    raise KeyError(op)


OP_CASES = [
    ("lars_momentum", {"mu": 0.9, "lars_coeff": 0.001,
                       "lars_weight_decay": 0.0005}),
    ("lars_momentum", {"mu": 0.8, "lars_coeff": 0.01,
                       "lars_weight_decay": 0.0, "epsilon": 1e-5}),
    ("adamax", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    ("adagrad", {"epsilon": 1e-6}),
    ("decayed_adagrad", {"decay": 0.95, "epsilon": 1e-6}),
    ("adadelta", {"rho": 0.95, "epsilon": 1e-6}),
    ("rmsprop", {"decay": 0.95, "epsilon": 1e-6, "momentum": 0.0,
                 "centered": False}),
    ("rmsprop", {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5,
                 "centered": True}),
    ("ftrl", {"l1": 0.01, "l2": 0.02, "lr_power": -0.5}),
    # XLA's CPU pow is exp(y log x): a dozen ulps from torch.pow
    ("ftrl", {"l1": 0.0, "l2": 0.1, "lr_power": -0.3}, dict(rtol=5e-6)),
    ("proximal_gd", {"l1": 0.01, "l2": 0.02}),
    ("proximal_gd", {"l1": 0.0, "l2": 0.05}),
    ("proximal_adagrad", {"l1": 0.01, "l2": 0.02}),
    ("proximal_adagrad", {"l1": 0.0, "l2": 0.0}),
]


def _run_both(op, ins, attrs, seed=0):
    jout = jreg.get_op_info(op).kernel(
        {k: jnp.asarray(v) for k, v in ins.items()}, dict(attrs),
        jreg.OpContext(seed=seed))
    tout = get_op_info(op).kernel(
        {k: torch.from_numpy(np.asarray(v)) for k, v in ins.items()},
        dict(attrs), TCtx(seed=seed))
    return jout, tout


@pytest.mark.parametrize("i", range(len(OP_CASES)))
def test_op_matches_jax_kernel(i):
    op, attrs, *tol = OP_CASES[i]
    tol = dict(OP_TOL, **(tol[0] if tol else {}))
    jout, tout = _run_both(op, _ins(op, np.random.RandomState(i)), attrs)
    assert set(tout) == set(jout)
    for slot, jv in jout.items():
        jv, tv = np.asarray(jv), tout[slot].numpy()
        assert tv.shape == jv.shape and tv.dtype == jv.dtype, slot
        np.testing.assert_allclose(tv, jv, err_msg=f"{op}.{slot}", **tol)


def test_dpsgd_op_matches_jax_with_the_port_noise(philox_dpsgd_in_jax):
    rng = np.random.RandomState(3)
    ins = _arrays(rng, Param=(SHAPE, 0), Grad=(SHAPE, 0)) | \
        {"LearningRate": np.asarray([0.1], np.float32)}
    attrs = {"clip": 0.5, "batch_size": 4.0, "sigma": 1.0, "op_uid": 9}
    jout, tout = _run_both("dpsgd", ins, attrs, seed=21)
    np.testing.assert_allclose(tout["ParamOut"].numpy(),
                               np.asarray(jout["ParamOut"]), **OP_TOL)
    # a new step seed draws new noise; the same one the same noise
    again = get_op_info("dpsgd").kernel(
        {k: torch.from_numpy(v) for k, v in ins.items()}, dict(attrs),
        TCtx(seed=21))["ParamOut"]
    other = get_op_info("dpsgd").kernel(
        {k: torch.from_numpy(v) for k, v in ins.items()}, dict(attrs),
        TCtx(seed=22))["ParamOut"]
    assert torch.equal(again, tout["ParamOut"])
    assert not torch.equal(other, tout["ParamOut"])


def test_average_accumulates_matches_jax_over_windows():
    """12 steps with a window of 3 to 5 updates and the spill every
    16384: sums, counters and the window turnover equal."""
    rng = np.random.RandomState(4)
    state = {"in_sum_1": np.zeros(SHAPE, np.float32),
             "in_sum_2": np.zeros(SHAPE, np.float32),
             "in_sum_3": np.zeros(SHAPE, np.float32),
             "in_num_accumulates": np.zeros(1, np.int64),
             "in_old_num_accumulates": np.zeros(1, np.int64),
             "in_num_updates": np.asarray([16380], np.int64)}
    attrs = {"average_window": 0.5, "min_average_window": 3,
             "max_average_window": 5}
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    turned = 0
    for _ in range(12):
        p = rng.randn(*SHAPE).astype(np.float32)
        jo = jreg.get_op_info("average_accumulates").kernel(
            dict(jstate, param=jnp.asarray(p)), dict(attrs),
            jreg.OpContext())
        to = get_op_info("average_accumulates").kernel(
            dict(tstate, param=torch.from_numpy(p)), dict(attrs), TCtx())
        for slot, jv in jo.items():
            np.testing.assert_allclose(to[slot].numpy(), np.asarray(jv),
                                       err_msg=slot, **OP_TOL)
        turned += int(to["out_num_accumulates"][0] == 0)
        jstate = {"in" + k[3:]: v for k, v in jo.items()}
        tstate = {"in" + k[3:]: v for k, v in to.items()}
    assert turned >= 2


# ---------------------------------------------------------------------------
# the static classes, 5 steps against the JAX executor
# ---------------------------------------------------------------------------
CLASSES = {
    "lars_momentum": lambda s: s.optimizer.LarsMomentumOptimizer(0.1, momentum=0.9,
                                              lars_coeff=0.01),
    "adamax": lambda s: s.Adamax(0.01),
    "adagrad": lambda s: s.Adagrad(0.05, initial_accumulator_value=0.1),
    "decayed_adagrad": lambda s: s.DecayedAdagrad(0.02, decay=0.9),
    "adadelta": lambda s: s.Adadelta(1.0, rho=0.9),
    "rmsprop": lambda s: s.RMSProp(0.01, momentum=0.5, centered=True),
    "proximal_gd": lambda s: s.optimizer.ProximalGD(0.05, l1=0.001, l2=0.01),
    "proximal_adagrad": lambda s: s.optimizer.ProximalAdagrad(
        0.05, l1=0.001, l2=0.01),
    "ftrl": lambda s: s.Ftrl(0.05, l1=0.001, l2=0.01),
    "dpsgd": lambda s: s.Dpsgd(0.05, clip=1.0, batch_size=16.0,
                               sigma=0.5),
    "adam_clip_l2": lambda s: s.Adamax(
        0.01, regularization=s.L2Decay(0.01),
        grad_clip=s.GradientClipByGlobalNorm(0.5)),
}


def _train_both(ref, port, steps=STEPS, after=None):
    (jexe, jscope), (texe, tscope), names = start_both(ref, port)
    jl, tl = [], []
    for i, feed in enumerate(batches(steps)):
        with jstatic.scope_guard(jscope):
            jl.append(float(np.asarray(
                jexe.run(ref[0], feed=feed, fetch_list=[ref[2]])[0])))
        with tstatic.scope_guard(tscope):
            tl.append(float(np.asarray(
                texe.run(port[0], feed=feed, fetch_list=[port[2]])[0])))
        if after is not None:
            after(i, jscope, tscope)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)
    return (jexe, jscope), (texe, tscope), names


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_static_optimizer_trains_like_reference(case, philox_dpsgd_in_jax):
    ref, port = build_both(CLASSES[case])
    assert port[0].to_dict() == ref[0].to_dict()
    assert port[1].to_dict() == ref[1].to_dict()
    (_, jscope), (_, tscope), init = _train_both(ref, port)
    if case == "ftrl":
        # ftrl's step is (clip(lin, l1) - lin) / (sqrt(n) / lr + 2 l2):
        # the same few-ulp gradient differences move the accumulators by
        # a few 1e-6 relative after 5 steps
        for n in sorted(tscope.vars):
            np.testing.assert_allclose(
                tscope.vars[n].double().numpy(),
                np.asarray(jscope.find_var(n).get_tensor(), np.float64),
                rtol=1e-5, atol=ATOL, err_msg=n)
    else:
        assert_state_close(jscope, tscope, sorted(tscope.vars), ATOL)
    for p in port[0].all_parameters():  # every parameter was trained
        assert not np.array_equal(tscope.vars[p.name].numpy(),
                                  init[p.name]), p.name


def test_ema_shadows_apply_and_restore():
    """EMA (update after minimize) over 5 Momentum steps: the program and
    every shadow equal to the JAX package's; apply() puts the shadows in
    the parameters' place and restore() puts back the same tensors."""
    def make(s):
        opt = s.Momentum(0.05, momentum=0.9)
        return _EmaOpt(s, opt)
    ref, port = build_both(make)
    assert port[0].to_dict() == ref[0].to_dict()
    assert port[1].to_dict() == ref[1].to_dict()
    (jexe, jscope), (texe, tscope), names = _train_both(ref, port)
    assert_state_close(jscope, tscope, sorted(tscope.vars), ATOL)
    ema = port[3].ema
    assert len(ema._shadows) == len(port[0].all_parameters())
    params = {p.name: tscope.vars[p.name] for p in port[0].all_parameters()}
    with tstatic.scope_guard(tscope):
        ema.apply(texe)
        for p, s in ema._shadows:
            assert torch.equal(tscope.vars[p.name], tscope.vars[s.name])
            assert tscope.vars[p.name] is not tscope.vars[s.name]
        ema.restore(texe)
    for n, t in params.items():
        assert tscope.vars[n] is t


class _EmaOpt:
    """An optimizer whose minimize also appends an EMA update."""

    def __init__(self, s, opt):
        self._s, self._opt = s, opt

    def minimize(self, loss):
        out = self._opt.minimize(loss)
        self.ema = self._s.ExponentialMovingAverage(0.9)
        self.ema.update()
        return out


class _MaOpt(_EmaOpt):
    def minimize(self, loss):
        out = self._opt.minimize(loss)
        self.ma = self._s.ModelAverage(0.5, min_average_window=2,
                                       max_average_window=3)
        return out


def test_model_average_apply_and_restore():
    ref, port = build_both(lambda s: _MaOpt(s, s.SGD(0.1)))
    assert port[0].to_dict() == ref[0].to_dict()
    assert port[1].to_dict() == ref[1].to_dict()
    (jexe, jscope), (texe, tscope), names = _train_both(ref, port)
    assert_state_close(jscope, tscope, sorted(tscope.vars), ATOL)
    before = {p.name: tscope.vars[p.name].clone()
              for p in port[0].all_parameters()}
    with jstatic.scope_guard(jscope):
        ref[3].ma.apply(jexe)
        javg = {n: np.asarray(jscope.find_var(n).get_tensor())
                for n in before}
        ref[3].ma.restore(jexe)
    with tstatic.scope_guard(tscope):
        with port[3].ma.apply(texe):
            for n in before:
                np.testing.assert_allclose(tscope.vars[n].numpy(), javg[n],
                                           rtol=0, atol=ATOL, err_msg=n)
                assert not torch.equal(tscope.vars[n], before[n])
    for n, t in before.items():  # the context manager restored them
        assert torch.equal(tscope.vars[n], t)


class _LookaheadOpt:
    def __init__(self, s, inner):
        self._la = s.LookaheadOptimizer(inner, alpha=0.5, k=3)

    def minimize(self, loss):
        return self._la.minimize(loss)


def test_lookahead_syncs_every_k_steps():
    """Lookahead(Adam, alpha 0.5, k 3), 7 steps: every persistable equal
    to the JAX package's after each step; the slow weights equal the
    fast ones exactly after steps 3 and 6 and not between."""
    ref, port = build_both(lambda s: _LookaheadOpt(s, s.Adam(0.01)))
    assert port[0].to_dict() == ref[0].to_dict()
    assert port[1].to_dict() == ref[1].to_dict()
    params = [p.name for p in port[0].all_parameters()]
    slow = {p: next(n for n in port[0].global_block().vars
                    if n.startswith(p + "_slow")) for p in params}

    def check(i, jscope, tscope):
        synced = [torch.equal(tscope.vars[p], tscope.vars[s])
                  for p, s in slow.items()]
        assert all(synced) == ((i + 1) % 3 == 0), (i, synced)
        assert_state_close(jscope, tscope, sorted(tscope.vars), ATOL)
    _train_both(ref, port, steps=7, after=check)


# ---------------------------------------------------------------------------
# the 2.0 optimizers, against the JAX dygraph
# ---------------------------------------------------------------------------
OPTIMIZERS_20 = {
    "Adamax": lambda m, o: m.Adamax(0.01, parameters=o, weight_decay=0.01),
    "Adagrad": lambda m, o: m.Adagrad(0.05, parameters=o,
                                      initial_accumulator_value=0.1),
    "Adadelta": lambda m, o: m.Adadelta(1.0, rho=0.9, parameters=o),
    "RMSProp": lambda m, o: m.RMSProp(0.01, momentum=0.5, centered=True,
                                      parameters=o),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS_20))
def test_optimizer_20_matches_jax_dygraph(name):
    jm, tm = _mlp_pair()
    jo = OPTIMIZERS_20[name](jopt, jm.parameters())
    with tdg.guard(CPUPlace()):
        to = OPTIMIZERS_20[name](topt, tm.parameters())
    rng = np.random.RandomState(1)
    for _ in range(3):
        x = rng.randn(5, 6).astype(np.float32)
        y = rng.randn(5, 3).astype(np.float32)
        jl = ((jm(paddle_tpu.to_tensor(x)) - paddle_tpu.to_tensor(y)) ** 2) \
            .mean()
        jl.backward()
        jo.step()
        jo.clear_grad()
        tl = tnn.functional.mse_loss(tm(torch.from_numpy(x)),
                                     torch.from_numpy(y))
        tl.backward()
        to.step()
        to.clear_grad()
        np.testing.assert_allclose(float(tl), float(jl.numpy()), rtol=1e-6)
    jsd, tsd = jo.state_dict(), to.state_dict()
    assert list(tsd) == list(jsd) and len(jsd) > 0
    for k, v in jsd.items():
        np.testing.assert_allclose(tsd[k].numpy(), np.asarray(v),
                                   atol=ATOL, rtol=0, err_msg=k)
    assert_params_close(jm, tm, ATOL)
