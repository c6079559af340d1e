"""The port's static optimizers against the JAX package's on the CPU:
SGD, Momentum (plain and Nesterov), AdamW (with and without
`apply_decay_param_fun`) and Lamb (with and without
`exclude_from_weight_decay_fn`), the regularizers L1Decay / L2Decay and
the three gradient clips, each as a case of one parametrised test.

Each case builds the same small fc regression in both packages from the
same unique-name state (the programs must serialize equal), copies the
reference's startup weights into the port with `load_params_from_numpy`,
runs four `minimize` steps on the same numpy batches and compares the
losses and every persistable (parameters, moments, beta pows,
velocities) after the last step.  Tolerance: fp32, atol 1e-6 on
persistables and losses (the same formulas; XLA and torch sum the
reductions in other orders).
"""
import numpy as np
import pytest

import paddle_tpu.static as jstatic
from paddle_tpu.core.program import _reset_unique_names as jax_reset_names
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core.program import (_reset_unique_names as
                                           torch_reset_names)
from paddle_tpu_torch.io import load_params_from_numpy

STEPS = 4
ATOL = 1e-6


def _no_bias(name):
    return not name.endswith(".b_0")


def _is_bias(name):
    return name.endswith(".b_0")


CASES = {
    "sgd": lambda s: s.SGD(0.1),
    "momentum": lambda s: s.Momentum(0.05, momentum=0.9),
    "momentum_nesterov": lambda s: s.Momentum(0.05, momentum=0.9,
                                              use_nesterov=True),
    "adamw": lambda s: s.AdamW(0.01, weight_decay=0.1),
    "adamw_decay_fn": lambda s: s.AdamW(0.01, weight_decay=0.1,
                                        apply_decay_param_fun=_no_bias),
    "lamb": lambda s: s.Lamb(0.01, lamb_weight_decay=0.05),
    "lamb_exclude_fn": lambda s: s.Lamb(
        0.01, lamb_weight_decay=0.05, exclude_from_weight_decay_fn=_is_bias),
    "sgd_l2decay": lambda s: s.SGD(0.1, regularization=s.L2Decay(0.01)),
    "adam_l1decay": lambda s: s.Adam(0.01, regularization=s.L1Decay(0.01)),
    "sgd_clip_by_value": lambda s: s.SGD(
        0.1, grad_clip=s.GradientClipByValue(0.05)),
    "momentum_clip_by_norm": lambda s: s.Momentum(
        0.05, grad_clip=s.GradientClipByNorm(0.1)),
    "adam_clip_by_global_norm": lambda s: s.Adam(
        0.01, grad_clip=s.GradientClipByGlobalNorm(0.1)),
    "adamw_l2_global_clip": lambda s: s.AdamW(
        0.01, weight_decay=0.1, regularization=s.L2Decay(0.01),
        grad_clip=s.GradientClipByGlobalNorm(0.5)),
}


def fc_program(static, make_opt):
    """x [-1, 8] -> fc 16 gelu -> fc 1; mean squared error against y,
    minimized by `make_opt(static)`."""
    layers = static.layers
    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = 0
    with static.program_guard(main, startup):
        x = layers.data("x", [-1, 8])
        y = layers.data("y", [-1, 1])
        pred = layers.fc(layers.fc(x, 16, act="gelu"), 1)
        diff = layers.elementwise_add(pred, layers.scale(y, -1.0))
        loss = layers.mean(layers.elementwise_mul(diff, diff))
        opt = make_opt(static)
        opt.minimize(loss)
    return main, startup, loss, opt


def build_both(make_opt):
    jax_reset_names()
    ref = fc_program(jstatic, make_opt)
    torch_reset_names()
    port = fc_program(tstatic, make_opt)
    return ref, port


def batches(steps, seed=3):
    rng = np.random.RandomState(seed)
    xs = rng.randn(steps, 6, 8).astype(np.float32)
    return [{"x": x, "y": np.sin(x.sum(1, keepdims=True)).astype(np.float32)}
            for x in xs]


def start_both(ref, port):
    """Executors and scopes of both packages holding the reference's
    startup weights (the port runs its own startup first, so both
    executors have taken the same number of steps)."""
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


def assert_state_close(jscope, tscope, names, atol):
    for n in names:
        ref = np.asarray(jscope.find_var(n).get_tensor(), np.float64)
        got = tscope.vars[n].double().numpy()
        np.testing.assert_allclose(got.reshape(ref.shape), ref, rtol=0,
                                   atol=atol, err_msg=n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_reference(case):
    ref, port = build_both(CASES[case])
    assert port[0].to_dict() == ref[0].to_dict()
    assert port[1].to_dict() == ref[1].to_dict()
    (jexe, jscope), (texe, tscope), names = start_both(ref, port)
    jl, tl = [], []
    for feed in batches(STEPS):
        with jstatic.scope_guard(jscope):
            jl.append(float(np.asarray(
                jexe.run(ref[0], feed=feed, fetch_list=[ref[2]])[0])))
        with tstatic.scope_guard(tscope):
            tl.append(float(np.asarray(
                texe.run(port[0], feed=feed, fetch_list=[port[2]])[0])))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)
    assert_state_close(jscope, tscope, names, ATOL)
    for p in port[0].all_parameters():  # every parameter was trained
        assert not np.array_equal(tscope.vars[p.name].numpy(),
                                  names[p.name]), p.name


def test_decay_fn_picks_adam_or_adamw_per_parameter():
    _, (tm, _, _, _) = build_both(CASES["adamw_decay_fn"])
    kinds = {op.inputs["Param"][0]: op.type for op in tm.global_block().ops
             if op.type in ("adam", "adamw")}
    assert kinds == {n: ("adam" if n.endswith(".b_0") else "adamw")
                     for n in kinds} and len(kinds) == 4
    _, (tm, _, _, _) = build_both(CASES["lamb_exclude_fn"])
    wd = {op.inputs["Param"][0]: op.attrs["weight_decay"]
          for op in tm.global_block().ops if op.type == "lamb"}
    assert wd == {n: (0.0 if n.endswith(".b_0") else 0.05) for n in wd}


def test_set_lr_rewrites_the_scope_value():
    """set_lr after minimize writes the lr var in both packages; the next
    steps train with it (SGD, so the update is lr x grad)."""
    ref, port = build_both(CASES["sgd"])
    (jexe, jscope), (texe, tscope), names = start_both(ref, port)
    ref[3].set_lr(0.02, scope=jscope)
    port[3].set_lr(0.02, scope=tscope)
    assert port[3].get_lr() == ref[3].get_lr() == 0.02
    lr_name = port[3]._lr_var.name
    assert float(tscope.vars[lr_name]) == np.float32(0.02)
    for feed in batches(2, seed=5):
        with jstatic.scope_guard(jscope):
            jexe.run(ref[0], feed=feed)
        with tstatic.scope_guard(tscope):
            texe.run(port[0], feed=feed)
    assert_state_close(jscope, tscope, names, ATOL)
