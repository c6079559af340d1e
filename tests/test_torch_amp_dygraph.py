"""Dygraph AMP (`amp.auto_cast`, `GradScaler`) on the CPU, against the JAX
package.

  * the cast decision per op type at O1 and O2 (white, black, gray and
    unlisted ops; custom lists) equal to paddle_tpu's `amp_cast_inputs`;
  * which dtype reaches flash attention and the cross-entropy: under O1
    q, k and v are fp32 in both packages (the bf16 product of the white
    `matmul_v2` plus the fp32 bias of the gray `elementwise_add` promotes
    to fp32), and so are the MLM logits; under O2 all are bf16;
  * a tiny BertForPretraining (2 layers, dropout 0) trained 5 steps under
    O1 and under O2 with AdamW and a GradScaler (init 1024).  The JAX
    package's own dygraph AMP backward raises here: its tape hands a
    white op's bf16 input gradient on to the fp32 tensor the op's input
    was cast from, and that tensor's producer's vjp refuses the bf16
    cotangent (two Linear layers under O1 suffice; ROADMAP.md Queue 3).
    The `jax_amp_cotangents` fixture casts each cotangent to its tensor's
    dtype in the JAX tape, in memory (what the port's cast, a torch op,
    does in its backward), so the JAX package gives the reference.  Every
    loss
    rtol 2e-3 (O1) / 1e-2 (O2) and the final parameters atol 5e-3 (O1) /
    1e-2 (O2).  bf16 keeps 8 bits of mantissa (relative rounding 2^-9 =
    2e-3): O1 rounds only the matmul operands, O2 every activation, and
    XLA and torch round them at different places (XLA fuses; the port's
    O2 also sums the tied embedding's two gradients in fp32, the JAX
    package in bf16); an AdamW step moves a parameter by about lr = 1e-3
    whatever its gradient, so a near-zero gradient whose sign flips
    under rounding moves it by up to 2 lr a step (1e-2 over 5 steps);
    the attention key biases, whose exact gradient is 0, are held to that
    bound at O1 too (test_torch_dygraph_train.assert_params_close);
  * GradScaler: an overflowing scaled loss skips the step (parameters
    unchanged) and halves the scale, finite steps grow it after
    `incr_every_n_steps`, a second unscale_ raises, state_dict equal to
    the JAX package's along the way.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.optimizer as jopt
from paddle_tpu import amp as jamp
from paddle_tpu import dygraph as jdg
from paddle_tpu.ops import attention as jattn

import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import dygraph as tdg
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.amp.auto_cast import cast_for_op
from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.ops import attention as tattn
from test_torch_dygraph_train import (assert_loss_trace,
                                      assert_params_close, bert_batch,
                                      tiny_bert_pair)
from test_torch_gpt import jax_generator_restored  # noqa: F401

OPS = ["matmul_v2", "elementwise_add", "layer_norm", "reduce_mean",
       "softmax_with_cross_entropy", "lookup_table_v2", "gelu", "dropout",
       "scale", "reduce_sum", "tanh"]


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("custom", [False, True])
def test_cast_decisions_match_jax(level, custom):
    kw = dict(custom_white_list=["gelu"], custom_black_list=["matmul_v2"]) \
        if custom else {}
    x32 = np.ones((2, 3), np.float32)
    for dt in ("bfloat16", "float16"):
        for op in OPS:
            with jamp.auto_cast(level=level, dtype=dt, **kw):
                jd = str(jamp.amp_cast_inputs(op, {"X": x32})["X"].dtype)
            with tamp.auto_cast(level=level, dtype=dt, **kw):
                (t,) = cast_for_op(op, [torch.from_numpy(x32)])
                with_int = cast_for_op(op, [torch.ones(2, dtype=torch.int64)])
            assert str(t.dtype).replace("torch.", "") == jd, (op, level)
            assert with_int[0].dtype == torch.int64  # ids are never cast
    with tamp.auto_cast(level="O0"):
        assert cast_for_op("matmul_v2", [torch.ones(2)])[0].dtype == \
            torch.float32
    with pytest.raises(ValueError):
        with tamp.auto_cast(level="O3"):
            pass


@pytest.mark.parametrize("level,want", [("O1", "float32"),
                                        ("O2", "bfloat16")])
def test_dtypes_reaching_flash_and_the_logits(level, want, monkeypatch):
    seen = {"jax": [], "port": []}
    jflash, tflash = jattn.flash_attention, tattn.flash_attention

    def jrec(q, k, v, **kw):
        seen["jax"].append(str(q.dtype))
        return jflash(q, k, v, **kw)

    def trec(q, k, v, **kw):
        seen["port"].append(str(q.dtype).replace("torch.", ""))
        return tflash(q, k, v, **kw)

    monkeypatch.setattr(jattn, "flash_attention", jrec)
    monkeypatch.setattr(tattn, "flash_attention", trec)
    prev = (jattn._FLASH_STATE["mode"], tattn._FLASH_STATE["mode"])
    jattn.enable_flash_attention(True)
    tattn.enable_flash_attention(True)
    try:
        jm, tm, _, _ = tiny_bert_pair(seed=21)
        ids, _, _ = bert_batch(5)
        with jamp.auto_cast(level=level):
            js, _ = jm(paddle_tpu.to_tensor(ids))
        with tamp.auto_cast(level=level):
            ts, _ = tm(torch.from_numpy(ids))
    finally:
        jattn._FLASH_STATE["mode"], tattn._FLASH_STATE["mode"] = prev
    assert seen["jax"] == seen["port"] == [want] * 2
    assert js.dtype == ts.dtype.__str__().replace("torch.", "") == want


@pytest.fixture
def jax_amp_cotangents(monkeypatch):
    """The JAX tape's `_final_grad` with each gradient cast to the dtype
    of the tensor it belongs to."""
    from paddle_tpu.dygraph import engine as jengine
    final = jengine._final_grad

    def cast_final(t, gmap):
        g = final(t, gmap)
        return g if g is None else g.astype(t._value.dtype)

    monkeypatch.setattr(jengine, "_final_grad", cast_final)


def test_jax_dygraph_amp_backward_raises_unpatched():
    """The fault the fixture works around (two Linear layers, O1)."""
    paddle_tpu.seed(1)
    with jdg.guard():
        a, b = paddle_tpu.nn.Linear(4, 4), paddle_tpu.nn.Linear(4, 4)
    x = paddle_tpu.to_tensor(np.ones((2, 4), np.float32))
    with jamp.auto_cast(level="O1"):
        y = b(paddle_tpu.nn.functional.relu(a(x))).mean()
    with pytest.raises(ValueError, match="bfloat16"):
        y.backward()


def _amp_train(level, steps=5):
    jm, tm, jcrit, tcrit = tiny_bert_pair(seed=22)
    ids, lbl, nsp = bert_batch(6)
    jo = jopt.AdamW(1e-3, parameters=jm.parameters(), weight_decay=0.01,
                    grad_clip=jopt.ClipGradByGlobalNorm(1.0))
    with tdg.guard(CPUPlace()):
        to = topt.AdamW(1e-3, parameters=tm.parameters(), weight_decay=0.01,
                        grad_clip=topt.ClipGradByGlobalNorm(1.0))
    js, ts = jamp.GradScaler(init_loss_scaling=1024.0), \
        tamp.GradScaler(init_loss_scaling=1024.0)
    jin = [paddle_tpu.to_tensor(a) for a in (ids, lbl, nsp)]
    tin = [torch.from_numpy(a) for a in (ids, lbl, nsp)]
    ref, got = [], []
    for _ in range(steps):
        with jamp.auto_cast(level=level):
            jl = jcrit(*jm(jin[0]), jin[1], jin[2])
        js.scale(jl).backward()
        js.minimize(jo, jl)
        jo.clear_grad()
        with tamp.auto_cast(level=level):
            tl = tcrit(*tm(tin[0]), tin[1], tin[2])
        ts.scale(tl).backward()
        ts.minimize(to, tl)
        to.clear_grad()
        ref.append(float(np.asarray(jl.numpy(), np.float32)))
        got.append(float(tl.detach().float()))
    assert js.state_dict() == ts.state_dict()
    return jm, tm, ref, got


@pytest.mark.parametrize("level,loss_rtol,param_atol",
                         [("O1", 2e-3, 5e-3), ("O2", 1e-2, 1e-2)])
def test_bert_amp_training_matches_jax(level, loss_rtol, param_atol,
                                      jax_amp_cotangents):
    jm, tm, ref, got = _amp_train(level)
    assert_loss_trace(got, ref, rtol=loss_rtol)
    assert got[-1] < got[0]
    # master weights stay fp32
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert_params_close(jm, tm, param_atol, noise_atol=2 * 5 * 1e-3)


def test_grad_scaler_skips_on_inf_and_updates_the_scale():
    paddle_tpu.seed(3)
    with jdg.guard():
        jl = paddle_tpu.nn.Linear(4, 2)
    with tdg.guard(CPUPlace()):
        tl = tnn.Linear(4, 2)
        tl.set_state_dict(jl.state_dict())
        to = topt.SGD(0.1, parameters=tl.parameters())
    jo = jopt.SGD(0.1, parameters=jl.parameters())
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    js, ts = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    big = np.full((3, 4), 3e37, np.float32)  # the scaled loss overflows
    for step, xv in enumerate([x, big, x, x, x]):
        before = tl.weight.detach().clone()
        jloss = jl(paddle_tpu.to_tensor(xv)).sum()
        js.scale(jloss).backward()
        js.minimize(jo, js.scale(jloss))
        jo.clear_grad()
        tloss = tl(torch.from_numpy(xv)).sum()
        ts.scale(tloss).backward()
        ts.minimize(to, ts.scale(tloss))
        to.clear_grad()
        assert ts.state_dict() == js.state_dict(), step
        if step == 1:
            assert torch.equal(tl.weight, before)  # skipped
        else:
            assert not torch.equal(tl.weight, before)
        np.testing.assert_allclose(tl.weight.detach().numpy(),
                                   jl.weight.numpy(), rtol=1e-6, atol=1e-7)
    # 1024 -> 512 (inf) -> ... two good steps -> 1024 -> ... -> 1024
    assert ts.get_loss_scaling() == js.get_loss_scaling() == 1024.0
    # step / update pair, and a second unscale_ raises
    ts.scale(tl(torch.from_numpy(x)).sum()).backward()
    ts.unscale_(to)
    with pytest.raises(RuntimeError, match="already been called"):
        ts.unscale_(to)
    ts.step(to)
    ts.update()
    fresh = tamp.GradScaler()
    fresh.load_state_dict(ts.state_dict())
    assert fresh.state_dict() == ts.state_dict()
    off = tamp.GradScaler(enable=False)
    t = torch.ones(())
    assert off.scale(t) is t and not off.is_enable()
