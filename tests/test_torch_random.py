"""Graph-safe random ops and the backward's seeds, on the CPU.

  * the Philox draws of ops/random.py: the uniform equal bit for bit to a
    numpy float32 evaluation of its formula over dropout's Philox words,
    the normal within 4 fp32 ulps of numpy's (log / cos / sin round
    differently), both within 5 sigma of their distribution's mean and
    variance;
  * `uniform_random` / `gaussian_random` drawn from (seed attr or step
    seed, op uid): reproducible, independent per uid, and in a main
    program run by `run_steps` (the CPU loop) equal bit for bit to
    `run()` calls, each step drawing anew;
  * `fill_any_like` (the seed of a target with a dynamic shape),
    `gradients(target_gradients=...)` and `cast_model_to_fp16` against
    the JAX package: programs equal where the JAX package builds the
    same program, values fp32 atol 1e-6 (AMP bf16: rtol 2e-2 on the
    losses, the JAX package rounding its activations elsewhere).
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.amp  # noqa: F401
import paddle_tpu.static as jstatic
from paddle_tpu.core.program import _reset_unique_names as jax_reset_names
from paddle_tpu.ops import registry as jreg
import paddle_tpu_torch
import paddle_tpu_torch.amp  # noqa: F401
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core.program import (_reset_unique_names as
                                           torch_reset_names)
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.ops import dropout as tdrop
from paddle_tpu_torch.ops import random as trandom
from paddle_tpu_torch.ops.registry import OpContext as TCtx, get_op_info

F32 = np.float32


def _ulps(a, b):
    """Distance in fp32 ulps (ordered integer view)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("n", [1, 7, 4096, 10001])
def test_uniform_bits_match_their_formula(n):
    seed, uid = 123456789, 42
    w = tdrop.philox_draws(n, seed, uid).numpy()
    lo, hi = -0.3, 0.7
    span = F32(F32(hi) - F32(lo))
    want = (w >> 8).astype(F32) * F32(2.0 ** -24) * span + F32(lo)
    got = trandom.random_plain((n,), torch.float32, trandom.UNIFORM, lo, hi,
                               seed, uid).numpy()
    np.testing.assert_array_equal(got, want.astype(F32))
    assert (got >= lo).all() and (got < hi).all()
    bf = trandom.random_plain((n,), torch.bfloat16, trandom.UNIFORM, lo, hi,
                              seed, uid)
    assert torch.equal(bf, torch.from_numpy(got).to(torch.bfloat16))


def test_normal_matches_box_muller_within_ulps():
    n, seed, uid = 10001, 7, 3
    w = tdrop.philox_draws(n + 1, seed, uid).numpy().reshape(-1, 2)
    u1 = ((w[:, 0] >> 8) + 1).astype(F32) * F32(2.0 ** -24)
    u2 = (w[:, 1] >> 8).astype(F32) * F32(2.0 ** -24)
    r = np.sqrt(np.log(u1) * F32(-2.0))
    th = u2 * F32(2 * np.pi)
    want = np.stack([r * np.cos(th), r * np.sin(th)], 1).reshape(-1)[:n]
    got = trandom.random_plain((n,), torch.float32, trandom.NORMAL, 0.0,
                               1.0, seed, uid).numpy()
    assert _ulps(got, want.astype(F32)).max() <= 4
    scaled = trandom.random_plain((n,), torch.float32, trandom.NORMAL, 0.5,
                                  2.0, seed, uid).numpy()
    np.testing.assert_array_equal(scaled, (got * F32(2.0) + F32(0.5)))


@pytest.mark.parametrize("dist", [trandom.UNIFORM, trandom.NORMAL])
def test_draw_statistics_within_5_sigma(dist):
    n = 1 << 18
    a, b = (-1.0, 3.0) if dist == trandom.UNIFORM else (0.5, 2.0)
    x = trandom.random_plain((n,), torch.float32, dist, a, b, 99, 5) \
        .double().numpy()
    if dist == trandom.UNIFORM:
        mean, var = (a + b) / 2, (b - a) ** 2 / 12
        var_sd = (b - a) ** 2 * np.sqrt(1 / 180) / np.sqrt(n)
    else:
        mean, var = a, b * b
        var_sd = b * b * np.sqrt(2 / n)
    assert abs(x.mean() - mean) < 5 * np.sqrt(var / n)
    assert abs(x.var() - var) < 5 * var_sd


@pytest.mark.parametrize("op", ["uniform_random", "gaussian_random"])
def test_initializer_ops_key_on_seed_and_uid(op):
    kernel = get_op_info(op).kernel
    attrs = {"shape": [64, 32], "dtype": "float32", "min": -0.5,
             "max": 0.25, "mean": 1.0, "std": 2.0, "seed": 0, "op_uid": 3}
    a = kernel({}, attrs, TCtx(seed=5))["Out"]
    assert torch.equal(a, kernel({}, attrs, TCtx(seed=5))["Out"])
    assert not torch.equal(a, kernel({}, dict(attrs, op_uid=4),
                                     TCtx(seed=5))["Out"])
    assert not torch.equal(a, kernel({}, attrs, TCtx(seed=6))["Out"])
    # a nonzero seed attr wins over the step seed
    fixed = kernel({}, dict(attrs, seed=11), TCtx(seed=5))["Out"]
    assert torch.equal(fixed, kernel({}, dict(attrs, seed=11),
                                     TCtx(seed=6))["Out"])
    dist = trandom.UNIFORM if op == "uniform_random" else trandom.NORMAL
    want = trandom.random_plain(
        (64, 32), torch.float32, dist,
        -0.5 if dist == trandom.UNIFORM else 1.0,
        0.25 if dist == trandom.UNIFORM else 2.0, 5, 3)
    assert torch.equal(a, want)


def _random_program():
    """x [-1, 4] + uniform [4] * gaussian [4]: a main program that draws
    on every step."""
    layers = tstatic.layers
    main, startup = tstatic.Program(), tstatic.Program()
    main.random_seed = startup.random_seed = 3
    with tstatic.program_guard(main, startup):
        x = layers.data("x", [-1, 4])
        u = layers.uniform_random([4], min=-1.0, max=1.0)
        g = layers.gaussian_random([4], mean=0.0, std=1.0)
        out = layers.elementwise_add(x, layers.elementwise_mul(u, g))
    return main, startup, out, u, g


def test_random_ops_under_run_steps_equal_run_calls():
    main, _, out, u, g = _random_program()
    feeds = np.random.RandomState(0).randn(3, 2, 4).astype(F32)
    exe = tstatic.Executor(tstatic.CPUPlace())
    with tstatic.scope_guard(tstatic.Scope()):
        eager = [exe.run(main, feed={"x": f}, fetch_list=[out, u, g])
                 for f in feeds]
    exe2 = tstatic.Executor(tstatic.CPUPlace())
    with tstatic.scope_guard(tstatic.Scope()):
        stacked = exe2.run_steps(main, feed={"x": feeds},
                                 fetch_list=[out, u, g])
    for j in range(3):
        np.testing.assert_array_equal(stacked[j],
                                      np.stack([e[j] for e in eager]))
    assert not np.array_equal(stacked[1][0], stacked[1][1])  # new draws


def test_fill_any_like_matches_jax_and_seeds_dynamic_targets():
    import jax.numpy as jnp
    x = np.random.RandomState(1).randn(3, 5).astype(F32)
    for attrs in ({"value": 1.0}, {"value": 2.5, "dtype": "float32"},
                  {"value": 3.0, "dtype": -1}):
        want = jreg.get_op_info("fill_any_like").kernel(
            {"X": jnp.asarray(x)}, dict(attrs), jreg.OpContext())["Out"]
        got = get_op_info("fill_any_like").kernel(
            {"X": torch.from_numpy(x)}, dict(attrs), TCtx())["Out"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def build(static):
        layers = static.layers
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            xv = layers.data("x", [-1, 4])
            xv.stop_gradient = False
            h = layers.fc(xv, 4, act="gelu")
            (gx,) = static.gradients(h, xv)
        return main, startup, h, gx
    jax_reset_names()
    ref = build(jstatic)
    torch_reset_names()
    port = build(tstatic)
    assert port[0].to_dict() == ref[0].to_dict()
    assert "fill_any_like" in [op.type for op in port[0].global_block().ops]
    feed = {"x": np.random.RandomState(2).randn(3, 4).astype(F32)}
    _compare_runs(ref, port, feed, [3])


def _compare_runs(ref, port, feed, fetch_idx):
    jscope, jexe = jstatic.Scope(), jstatic.Executor()
    with jstatic.scope_guard(jscope):
        jexe.run(ref[1])
        init = {n: np.asarray(jscope.find_var(n).get_tensor())
                for n in jscope.vars
                if jscope.find_var(n).get_tensor() is not None}
        jout = jexe.run(ref[0], feed=feed,
                        fetch_list=[ref[i] for i in fetch_idx])
    tscope, texe = tstatic.Scope(), tstatic.Executor(tstatic.CPUPlace())
    with tstatic.scope_guard(tscope):
        texe.run(port[1])
        load_params_from_numpy(tscope, init, tstatic.CPUPlace())
        tout = texe.run(port[0], feed=feed,
                        fetch_list=[port[i] for i in fetch_idx])
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
    return tout


def test_target_gradients_seed_the_backward():
    """gradients(h, x, target_gradients=t) = d sum(h t) / dx: against the
    JAX package's gradients of sum(h * t) (the JAX package ignores
    target_gradients, so its program is built from the product)."""
    def build(static, seeded):
        layers = static.layers
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            xv = layers.data("x", [3, 4])
            xv.stop_gradient = False
            tg = layers.data("t", [3, 4])
            h = layers.fc(xv, 4, act="gelu")
            if seeded:
                (gx,) = static.gradients(h, xv, target_gradients=tg)
            else:
                (gx,) = static.gradients(
                    layers.reduce_sum(layers.elementwise_mul(h, tg)), xv)
        return main, startup, h, gx
    jax_reset_names()
    ref = build(jstatic, False)
    torch_reset_names()
    port = build(tstatic, True)
    ops = [op.type for op in port[0].global_block().ops]
    assert "assign" in ops and "fill_constant" not in ops
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(3, 4).astype(F32), "t": rng.randn(3, 4)
            .astype(F32)}
    _compare_runs(ref, port, feed, [3])


def test_target_gradients_seed_the_recomputed_backward():
    """With FLAGS_recompute="always" (the checkpoints: both layer_norm
    outputs), gradients(h, x, target_gradients=t) seeds the checkpointed
    backward with t: the program replays a segment (@RC names), its
    gradient equals the plain seeded backward's bit for bit, and the JAX
    package's d sum(h t) / dx within fp32 rtol 1e-5, atol 1e-6 (the
    product form sums in another order through two layer_norms)."""
    from paddle_tpu_torch.core.flags import set_flags

    def build(static, seeded):
        layers = static.layers
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            xv = layers.data("x", [3, 4])
            xv.stop_gradient = False
            tg = layers.data("t", [3, 4])
            h = layers.layer_norm(layers.fc(xv, 8, act="gelu"))
            h = layers.layer_norm(layers.fc(h, 8, act="gelu"))
            h = layers.fc(h, 4)
            if seeded:
                (gx,) = static.gradients(h, xv, target_gradients=tg)
            else:
                (gx,) = static.gradients(
                    layers.reduce_sum(layers.elementwise_mul(h, tg)), xv)
        return main, startup, h, gx
    jax_reset_names()
    ref = build(jstatic, False)
    torch_reset_names()
    plain = build(tstatic, True)
    torch_reset_names()
    set_flags({"recompute": "always"})
    try:
        port = build(tstatic, True)
    finally:
        set_flags({"recompute": ""})
    block = port[0].global_block()
    assert any("@RC" in n for op in block.ops for n in op.output_names())
    assert "assign" in [op.type for op in block.ops]
    rng = np.random.RandomState(4)
    feed = {"x": rng.randn(3, 4).astype(F32), "t": rng.randn(3, 4)
            .astype(F32)}
    jscope, jexe = jstatic.Scope(), jstatic.Executor()
    with jstatic.scope_guard(jscope):
        jexe.run(ref[1])
        init = {n: np.asarray(jscope.find_var(n).get_tensor())
                for n in jscope.vars
                if jscope.find_var(n).get_tensor() is not None}
        (want,) = jexe.run(ref[0], feed=feed, fetch_list=[ref[3]])
    got = []
    for prog in (plain, port):
        tscope, texe = tstatic.Scope(), tstatic.Executor(tstatic.CPUPlace())
        with tstatic.scope_guard(tscope):
            texe.run(prog[1])
            load_params_from_numpy(tscope, init, tstatic.CPUPlace())
            got.append(texe.run(prog[0], feed=feed, fetch_list=[prog[3]])[0])
    np.testing.assert_array_equal(got[1], got[0])
    np.testing.assert_allclose(got[1], np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_cast_model_to_fp16_programs_and_training():
    """O2: cast_model_to_fp16 on a small fc network's forward, then
    Adam: the programs equal the JAX package's; 3 steps of losses within
    rtol 2e-2 of its, finite, the low dtype in every white and gray op."""
    def build(pkg):
        static, layers = pkg.static, pkg.static.layers
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            x = layers.data("x", [-1, 16])
            y = layers.data("y", [-1, 1])
            h = layers.fc(layers.fc(x, 32, act="gelu"), 16, act="relu")
            pred = layers.fc(h, 1)
            loss = layers.mean(layers.square(
                layers.elementwise_sub(pred, y)))
            pkg.amp.cast_model_to_fp16(main)
            if loss.dtype != "float32":
                loss = layers.cast(loss, "float32")
            static.Adam(0.01).minimize(loss)
        return main, startup, loss
    jax_reset_names()
    ref = build(paddle_tpu)
    torch_reset_names()
    port = build(paddle_tpu_torch)
    assert port[0].to_dict() == ref[0].to_dict()
    assert port[1].to_dict() == ref[1].to_dict()
    mul_out = [port[0].global_block().var(op.outputs["Out"][0]).dtype
               for op in port[0].global_block().ops if op.type == "mul"]
    assert mul_out and set(mul_out) == {"bfloat16"}
    rng = np.random.RandomState(4)
    feed = {"x": rng.randn(8, 16).astype(F32),
            "y": rng.randn(8, 1).astype(F32)}
    jscope, jexe = jstatic.Scope(), jstatic.Executor()
    tscope, texe = tstatic.Scope(), tstatic.Executor(tstatic.CPUPlace())
    with jstatic.scope_guard(jscope):
        jexe.run(ref[1])
        init = {n: np.asarray(jscope.find_var(n).get_tensor())
                for n in jscope.vars
                if jscope.find_var(n).get_tensor() is not None}
        jl = [float(np.asarray(jexe.run(ref[0], feed=feed,
                                        fetch_list=[ref[2]])[0]))
              for _ in range(3)]
    with tstatic.scope_guard(tscope):
        texe.run(port[1])
        load_params_from_numpy(tscope, init, tstatic.CPUPlace())
        tl = [float(texe.run(port[0], feed=feed, fetch_list=[port[2]])[0])
              for _ in range(3)]
    assert np.isfinite(tl).all() and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
