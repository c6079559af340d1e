"""Dygraph training through the 2.0 API on the CPU, against the JAX package.

The same seeded numpy inputs go through paddle_tpu's dygraph (its own
tape) and the port's (torch autograd):

  * the engine cases of tests/test_dygraph.py (chain, diamond,
    accumulation and clear_grad, stop_gradient, no_grad, paddle.grad,
    no_grad_vars, hooks, backward twice): gradients rtol 1e-5, atol 1e-7
    (XLA and torch sum the products in different orders);
  * F.dropout's Out and Mask against the JAX registry's `dropout` with
    the port's Philox swapped in (tests/test_torch_recipe.py's
    `jax_philox_dropout`): equal to the last bit, and the gradient equal
    to grad * Mask / (1 - p);
  * the 2.0 optimizers' `state_dict()` after 3 steps of a two-layer MLP
    (SGD, Momentum, Adam, AdamW, Lamb, with coupled L2 decay and the
    global-norm clip where the optimizer takes them): the same keys
    (`{param.name}_{accumulator}`), values atol 1e-6;
  * a tiny `BertForPretraining` (2 layers, hidden 32, fp32, dropout 0)
    trained 30 steps with AdamW(weight decay 0.01), the global-norm clip
    (1.0) and LinearWarmup(PolynomialDecay): the loss trace rtol 1e-5 and
    every final parameter atol 1e-5, on the score-matrix route; 3 steps on
    the flash route (the JAX package's Pallas kernels in interpret mode,
    the port's plain versions), the same gates;
  * `hapi.Model.train_batch` equal to the bare loop to the last bit, and
    to the JAX package's `train_batch` within the fp32 gates.

Weights cross with `Layer.set_state_dict(jax_model.state_dict())` after
both unique-name counters are reset, so both packages name every
parameter alike.  The JAX package's `copy.deepcopy` of the first encoder
layer keeps its parameters' names, so its name-keyed optimizer would
share one accumulator among the copies; the port names copies
`<name>_deepcopy_<n>` (Paddle's rule), and `tiny_bert_pair` gives the
JAX copies the port's names before any optimizer is built (ROADMAP.md
Queue 3).
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.optimizer as jopt
from paddle_tpu import dygraph as jdg
from paddle_tpu.core.program import _reset_unique_names as jax_reset_names
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops import attention as jattn
from paddle_tpu.ops import registry as jreg

import paddle_tpu_torch
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import dygraph as tdg
from paddle_tpu_torch import hapi as thapi
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.core.program import (_reset_unique_names as
                                           torch_reset_names)
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import attention as tattn
from test_torch_gpt import jax_generator_restored  # noqa: F401

TINY = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
BATCH, SEQ = 4, 16


def assert_loss_trace(got, ref, rtol, atol=0.0):
    """The loss-trace comparer of the parity tests: the same number of
    steps, every loss finite, and each step within rtol (and atol) of the
    reference; names the first step that is not."""
    got = np.asarray(got, np.float64).reshape(-1)
    ref = np.asarray(ref, np.float64).reshape(-1)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.all(np.isfinite(got)) and np.all(np.isfinite(ref))
    bad = np.abs(got - ref) > atol + rtol * np.abs(ref)
    assert not bad.any(), (
        f"step {int(np.argmax(bad))}: {got[bad][0]} vs {ref[bad][0]} "
        f"(max rel diff {np.max(np.abs(got - ref) / np.abs(ref)):.3g})")


def tiny_bert_pair(seed=0, **over):
    """(JAX BertForPretraining, port BertForPretraining, criteria) with
    the same weights and the same parameter names."""
    cfg = dict(TINY, **over)
    jax_reset_names()
    paddle_tpu.seed(seed)
    with jdg.guard():
        jm = jbert.BertForPretraining(jbert.BertModel(
            jbert.BertConfig(**cfg)))
        jcrit = jbert.BertPretrainingCriterion(cfg["vocab_size"])
    torch_reset_names()
    with tdg.guard(CPUPlace()):
        tm = tbert.BertForPretraining(tbert.BertModel(
            tbert.BertConfig(**cfg)))
        tcrit = tbert.BertPretrainingCriterion(cfg["vocab_size"])
    jsd, tsd = jm.state_dict(), tm.state_dict()
    assert list(jsd) == list(tsd)
    missing, unexpected = tm.set_state_dict(jsd)
    assert missing == [] and unexpected == []
    for k, p in jsd.items():
        p.name = tsd[k].paddle_name
    return jm, tm, jcrit, tcrit


def bert_batch(seed=0, vocab=64):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, (BATCH, SEQ)).astype(np.int64),
            rng.randint(0, vocab, (BATCH, SEQ)).astype(np.int64),
            rng.randint(0, 2, (BATCH,)).astype(np.int64))


def _sched(pkg_lr, steps):
    return pkg_lr.LinearWarmup(pkg_lr.PolynomialDecay(1e-3, steps,
                                                      end_lr=0.0),
                               5, 0.0, 1e-3)


def _jax_train(jm, jcrit, batch, steps, opt):
    ids, lbl, nsp = (paddle_tpu.to_tensor(a) for a in batch)
    losses = []
    for _ in range(steps):
        scores, rel = jm(ids)
        loss = jcrit(scores, rel, lbl, nsp)
        loss.backward()
        opt.step()
        opt.clear_grad()
        opt._learning_rate.step()
        losses.append(float(np.asarray(loss.numpy())))
    return losses


def _port_train(tm, tcrit, batch, steps, opt, lrs=None):
    ids, lbl, nsp = (torch.from_numpy(a) for a in batch)
    losses = []
    for _ in range(steps):
        if lrs is not None:
            lrs.append(opt.get_lr())
        scores, rel = tm(ids)
        loss = tcrit(scores, rel, lbl, nsp)
        loss.backward()
        opt.step()
        opt.clear_grad()
        opt._learning_rate.step()
        losses.append(float(loss.detach()))
    return losses


def _adamw_pair(jm, tm, steps):
    jo = jopt.AdamW(learning_rate=_sched(jopt.lr, steps),
                    parameters=jm.parameters(), weight_decay=0.01,
                    grad_clip=jopt.ClipGradByGlobalNorm(1.0))
    with tdg.guard(CPUPlace()):
        to = topt.AdamW(learning_rate=_sched(topt.lr, steps),
                        parameters=tm.parameters(), weight_decay=0.01,
                        grad_clip=topt.ClipGradByGlobalNorm(1.0))
    return jo, to


def assert_params_close(jm, tm, atol, noise_atol=None):
    """Every parameter within atol of the JAX package's.  With
    `noise_atol`, the attention key biases are held to it instead: their
    gradient is 0 in exact arithmetic (a bias added to every key shifts a
    row of scores by one constant, which softmax ignores), so each
    package's is rounding noise, and Adam turns noise into steps of about
    lr whatever its size, maybe of opposite signs in the two packages:
    `noise_atol` is twice the sum of the lrs applied."""
    tsd = tm.state_dict()
    for k, p in jm.state_dict().items():
        tol = noise_atol if noise_atol is not None and \
            k.endswith("k_proj.bias") else atol
        np.testing.assert_allclose(tsd[k].detach().numpy(),
                                   np.asarray(p.numpy(), np.float32),
                                   atol=tol, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# the engine against the JAX tape
# ---------------------------------------------------------------------------
def _pair(a, stop_gradient=False):
    return (paddle_tpu.to_tensor(a, stop_gradient=stop_gradient),
            tdg.to_tensor(a, place=CPUPlace(), stop_gradient=stop_gradient))


def test_backward_chain_matches_jax_tape():
    rng = np.random.RandomState(0)
    xv, wv = rng.randn(4, 5).astype(np.float32), \
        rng.randn(5, 3).astype(np.float32)
    jx, tx = _pair(xv)
    jw, tw = _pair(wv)
    jdg.trace_op("tanh", {"X": paddle_tpu.matmul(jx, jw)}, {},
                 ["Out"]).mean().backward()
    tdg.backward(tnn.functional.tanh(paddle_tpu_torch.matmul(tx, tw))
                 .mean())
    np.testing.assert_allclose(tdg.gradient(tx), jx.gradient(), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tdg.gradient(tw), jw.gradient(), rtol=1e-5,
                               atol=1e-7)


def test_diamond_accumulation_and_clear_grad():
    jx, tx = _pair(np.ones(3, np.float32))
    for x, bwd in ((jx, lambda t: t.backward()), (tx, tdg.backward)):
        bwd(((x * 2.0) + (x * 3.0)).sum())   # diamond: 5 per element
        bwd((x * 3.0).sum())                 # accumulates: 8
    np.testing.assert_allclose(tdg.gradient(tx), jx.gradient(), rtol=1e-6)
    np.testing.assert_allclose(tdg.gradient(tx), [8.0] * 3)
    jx.clear_gradient()
    tdg.clear_grad(tx)
    assert jx.grad is None and tx.grad is None


def test_stop_gradient_and_no_grad():
    jx, tx = _pair(np.ones(3, np.float32))
    jy, ty = _pair(np.ones(3, np.float32), stop_gradient=True)
    ((jx + jy) * 2.0).sum().backward()
    tdg.backward(((tx + ty) * 2.0).sum())
    np.testing.assert_allclose(tdg.gradient(tx), jx.gradient())
    assert jy.gradient() is None and tdg.gradient(ty) is None
    with jdg.no_grad():
        jz = (jx * 2.0).sum()
    with tdg.no_grad():
        tz = (tx * 2.0).sum()
    assert jz.stop_gradient and not tz.requires_grad

    @tdg.no_grad()
    def f(x):
        return x * 2.0
    assert not f(tx).requires_grad
    with tdg.set_grad_enabled(False):
        assert not tdg.is_grad_enabled()
        with tdg.enable_grad():
            assert (tx * 2.0).requires_grad


def test_paddle_grad_and_no_grad_vars():
    jx, tx = _pair(np.array([2.0], np.float32))
    (jg,) = jdg.grad(jx * jx * jx, jx)
    (tg,) = paddle_tpu_torch.grad(tx * tx * tx, tx)
    np.testing.assert_allclose(tg.numpy(), jg.numpy(), rtol=1e-6)
    assert tx.grad is None and jx.grad is None
    jx, tx = _pair(np.ones(2, np.float32))
    jw, tw = _pair(np.full(2, 3.0, np.float32))
    (jg,) = jdg.grad((jx * jw).sum(), jx, no_grad_vars=[jw])
    (tg,) = tdg.grad((tx * tw).sum(), tx, no_grad_vars=[tw])
    np.testing.assert_allclose(tg.numpy(), jg.numpy())
    # an intermediate in no_grad_vars absorbs the gradient: x, reached
    # only through it, gets zeros; an input in no_grad_vars is unreachable
    for grad, x, w in ((jdg.grad, jx, jw), (tdg.grad, tx, tw)):
        h = x * 2.0
        (g,) = grad((h * 3.0).sum(), x, no_grad_vars=[h])
        np.testing.assert_array_equal(np.asarray(g.numpy()), [0.0, 0.0])
        with pytest.raises(RuntimeError, match="unreachable"):
            grad((x * w).sum(), [x, w], no_grad_vars=[w])
        assert grad((x * w).sum(), [x, w], no_grad_vars=[w],
                    allow_unused=True)[1] is None
    # create_graph: the gradient is on the tape (d/dx of 3x^2 = 6x)
    jx, tx = _pair(np.array([2.0], np.float32))
    (jg,) = jdg.grad(jx * jx * jx, jx, create_graph=True)
    (tg,) = tdg.grad(tx * tx * tx, tx, create_graph=True)
    jg.sum().backward()
    tdg.backward(tg.sum())
    np.testing.assert_allclose(tdg.gradient(tx), jx.gradient(), rtol=1e-6)


def test_hooks_and_backward_twice():
    jx, tx = _pair(np.ones(3, np.float32))
    jh = jx.register_hook(lambda g: g * 10.0)
    th = tdg.register_tensor_hook(tx, lambda g: g * 10.0)
    (jx * 1.0).sum().backward()
    tdg.backward((tx * 1.0).sum())
    np.testing.assert_allclose(tdg.gradient(tx), jx.gradient())
    jh.remove()
    th.remove()
    jx, tx = _pair(np.ones(2, np.float32))
    for x, bwd in ((jx, lambda t, **k: t.backward(**k)),
                   (tx, tdg.backward)):
        y = (x * 2.0).sum()
        bwd(y)
        with pytest.raises(RuntimeError, match="twice"):
            bwd(y)
        z = (x * 2.0).sum()
        bwd(z, retain_graph=True)
        bwd(z)
    np.testing.assert_allclose(tdg.gradient(tx), jx.gradient())
    np.testing.assert_allclose(tdg.gradient(tx), [6.0, 6.0])
    with pytest.raises(RuntimeError, match="stop_gradient"):
        tdg.backward(tdg.to_tensor(np.ones(2, np.float32), place=CPUPlace()))


def test_layer_containers_hooks_and_modes():
    with tdg.guard(CPUPlace()):
        seq = tdg.Sequential(tnn.Linear(4, 8), tnn.ReLU(), tnn.Linear(8, 2))
        plist = tdg.ParameterList([seq[0].weight, seq[2].weight])
    assert len(seq) == 3 and len(list(seq.parameters())) == 4
    assert len(plist) == 2 and plist[1] is seq[2].weight
    seen = []
    pre = seq.register_forward_pre_hook(lambda l, i: (i[0] * 2.0,))
    post = seq.register_forward_post_hook(
        lambda l, i, o: seen.append(o.shape) or o + 1.0)
    x = torch.ones(3, 4)
    y = seq(x)
    pre.remove()
    post.remove()
    np.testing.assert_allclose(y.detach().numpy(),
                               seq(x * 2.0).detach().numpy() + 1.0,
                               rtol=1e-6)
    assert seen == [torch.Size([3, 2])]
    seq.eval()
    assert not any(m.training for m in seq.sublayers(include_self=True))
    seq.train()
    assert all(m.training for m in seq.sublayers(include_self=True))
    tdg.backward(seq(x).sum())
    assert seq[0].weight.grad is not None
    seq.clear_gradients()
    assert all(p.grad is None for p in seq.parameters())


# ---------------------------------------------------------------------------
# F.dropout against the JAX registry's dropout with the port's Philox
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["upscale_in_train", "downgrade_in_infer"])
def test_dropout_matches_jax_with_philox_bit_for_bit(mode, monkeypatch):
    from test_torch_recipe import jax_philox_dropout
    monkeypatch.setattr(jreg.get_op_info("dropout"), "kernel",
                        jax_philox_dropout)
    x = np.random.RandomState(3).randn(4, 33).astype(np.float32)
    for s in (0, 77):
        paddle_tpu.seed(s)
        paddle_tpu_torch.seed(s)
        jx, tx = _pair(x)
        jout, jmask = jdg.trace_op(
            "dropout", {"X": jx},
            {"dropout_prob": 0.3, "dropout_implementation": mode},
            ["Out", "Mask"])
        tout, tmask = tnn.functional.dropout_with_mask(tx, 0.3, mode=mode)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask.numpy()))
        np.testing.assert_array_equal(tout.detach().numpy(), jout.numpy())
        g = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
        (jout * paddle_tpu.to_tensor(g)).sum().backward()
        tdg.backward((tout * torch.from_numpy(g)).sum())
        np.testing.assert_array_equal(tdg.gradient(tx), jx.gradient())
        q = 0.7 if mode == "upscale_in_train" else 1.0
        np.testing.assert_array_equal(
            tdg.gradient(tx),
            (torch.from_numpy(g) * tmask / torch.tensor(q)).numpy()
            if q != 1.0 else g * tmask.numpy())
    # eval, and p = 0 in training: no draw
    t = torch.from_numpy(x)
    assert tnn.functional.dropout(t, 0.0) is t
    assert tnn.functional.dropout(t, 0.3, training=False) is t


# ---------------------------------------------------------------------------
# optimizers: state_dict after 3 steps
# ---------------------------------------------------------------------------
def _mlp_pair():
    jax_reset_names()
    paddle_tpu.seed(5)
    with jdg.guard():
        jm = jdg.Sequential(paddle_tpu.nn.Linear(6, 8),
                            paddle_tpu.nn.Tanh(), paddle_tpu.nn.Linear(8, 3))
    torch_reset_names()
    with tdg.guard(CPUPlace()):
        tm = tdg.Sequential(tnn.Linear(6, 8), tnn.Tanh(), tnn.Linear(8, 3))
    tm.set_state_dict(jm.state_dict())
    return jm, tm


OPTIMIZERS = {
    "SGD": lambda m, o: m.SGD(0.1, parameters=o, weight_decay=0.01),
    "Momentum": lambda m, o: m.Momentum(
        0.1, parameters=o, use_nesterov=True,
        weight_decay=m.L2Decay(0.02) if hasattr(m, "L2Decay") else 0.02),
    "Adam": lambda m, o: m.Adam(0.01, parameters=o,
                                grad_clip=m.ClipGradByGlobalNorm(0.5)),
    "AdamW": lambda m, o: m.AdamW(0.01, parameters=o, weight_decay=0.05,
                                  grad_clip=m.ClipGradByNorm(0.3)),
    "Lamb": lambda m, o: m.Lamb(0.01, lamb_weight_decay=0.02,
                                parameters=o,
                                grad_clip=m.ClipGradByValue(0.05)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_state_dict_matches_jax(name):
    jm, tm = _mlp_pair()
    jo = OPTIMIZERS[name](jopt, jm.parameters())
    with tdg.guard(CPUPlace()):
        to = OPTIMIZERS[name](topt, tm.parameters())
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
        to.minimize(tl)
        to.clear_grad()
        np.testing.assert_allclose(float(tl), float(jl.numpy()), rtol=1e-6)
    jsd, tsd = jo.state_dict(), to.state_dict()
    assert list(tsd) == list(jsd)
    assert len(jsd) == {"SGD": 0, "Momentum": 4}.get(name, 16)
    for k, v in jsd.items():
        np.testing.assert_allclose(tsd[k].numpy(), np.asarray(v),
                                   atol=1e-6, rtol=0, err_msg=k)
    assert_params_close(jm, tm, 1e-6)
    # set_state_dict into a fresh optimizer restores every accumulator
    with tdg.guard(CPUPlace()):
        fresh = OPTIMIZERS[name](topt, tm.parameters())
    fresh.set_state_dict(tsd)
    tm(torch.ones(1, 6)).sum().backward()
    fresh.step()
    assert list(fresh.state_dict()) == list(tsd)


def test_optimizers_without_kernel_raise_and_lr_api():
    _, tm = _mlp_pair()
    with tdg.guard(CPUPlace()):
        # each names its ported kernel (tests/test_torch_optimizer_breadth
        # .py holds them against the JAX package)
        for cls, op in ((topt.Adamax, "adamax"), (topt.Adagrad, "adagrad"),
                        (topt.Adadelta, "adadelta"),
                        (topt.RMSProp, "rmsprop")):
            assert cls(parameters=tm.parameters())._op_type == op
        with pytest.raises(ValueError, match="parameters"):
            topt.SGD(0.1)
        o = topt.SGD(0.1, parameters=tm.parameters())
        o.set_lr(0.5)
        assert o.get_lr() == 0.5
        s = topt.AdamW(learning_rate=topt.lr.StepDecay(0.1, 2),
                       parameters=tm.parameters())
        with pytest.raises(RuntimeError, match="LRScheduler"):
            s.set_lr(0.2)


# ---------------------------------------------------------------------------
# BertForPretraining: 30 AdamW steps against the JAX package
# ---------------------------------------------------------------------------
def test_bert_pretraining_30_steps_matches_jax():
    """fp32, dropout 0, the score-matrix route (seq 16 is below the flash
    threshold): loss trace rtol 1e-5, final parameters atol 1e-5 (the
    attention key biases, whose exact gradient is 0, within the sum of
    the applied lrs, twice)."""
    steps = 30
    jm, tm, jcrit, tcrit = tiny_bert_pair(seed=11)
    jo, to = _adamw_pair(jm, tm, steps)
    batch = bert_batch(1)
    lrs = []
    ref = _jax_train(jm, jcrit, batch, steps, jo)
    got = _port_train(tm, tcrit, batch, steps, to, lrs)
    assert_loss_trace(got, ref, rtol=1e-5)
    assert got[-1] < got[0]
    assert_params_close(jm, tm, 1e-5, noise_atol=2 * sum(lrs))


def test_bert_pretraining_flash_route_matches_jax(monkeypatch):
    """3 steps with flash on in both packages (JAX: the Pallas kernels in
    interpret mode; port: the plain versions, counted)."""
    calls = []
    plain = tattn.flash_attention_plain
    monkeypatch.setattr(tattn, "flash_attention_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    prev = (jattn._FLASH_STATE["mode"], tattn._FLASH_STATE["mode"])
    jattn.enable_flash_attention(True)
    tattn.enable_flash_attention(True)
    try:
        jm, tm, jcrit, tcrit = tiny_bert_pair(seed=12)
        jo, to = _adamw_pair(jm, tm, 3)
        batch = bert_batch(2)
        ref = _jax_train(jm, jcrit, batch, 3, jo)
        got = _port_train(tm, tcrit, batch, 3, to)
    finally:
        jattn._FLASH_STATE["mode"], tattn._FLASH_STATE["mode"] = prev
    assert len(calls) == 3 * TINY["num_hidden_layers"]  # one a layer a step
    assert_loss_trace(got, ref, rtol=1e-5)
    assert_params_close(jm, tm, 1e-5)


def test_bert_eval_and_dropout_route():
    """In eval() the published dropout is off (outputs equal to the JAX
    package's, atol 1e-5); in train() the port draws its masks (Philox,
    keyed by the eager uid) and the loss still trains."""
    jm, tm, jcrit, tcrit = tiny_bert_pair(
        seed=13, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    ids, lbl, nsp = bert_batch(3)
    jm.eval()
    tm.eval()
    js, jr = jm(paddle_tpu.to_tensor(ids))
    with torch.no_grad():
        ts, tr = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(ts.numpy(), js.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tr.numpy(), jr.numpy(), atol=1e-5, rtol=0)
    tm.train()
    paddle_tpu_torch.seed(0)
    a = tm(torch.from_numpy(ids))[0]
    b = tm(torch.from_numpy(ids))[0]
    assert not torch.equal(a, b)  # a new uid, new masks
    with tdg.guard(CPUPlace()):
        opt = topt.AdamW(1e-3, parameters=tm.parameters())
    losses = []
    for _ in range(8):
        loss = tcrit(*tm(torch.from_numpy(ids)), torch.from_numpy(lbl),
                     torch.from_numpy(nsp))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# hapi.Model.train_batch
# ---------------------------------------------------------------------------
def test_hapi_train_batch_equals_bare_loop_and_jax():
    """2 train_batch steps: equal to the last bit (losses and parameters)
    to 2 bare-loop steps from the same state (the port), and within the
    fp32 gates of the JAX package's train_batch."""
    jm, tm, jcrit, tcrit = tiny_bert_pair(seed=14)
    _, bare_m, _, _ = tiny_bert_pair(seed=14)
    ids, lbl, nsp = bert_batch(4)

    def adamw(pkg, m):
        return pkg.AdamW(1e-3, parameters=m.parameters(), weight_decay=0.01,
                         grad_clip=pkg.ClipGradByGlobalNorm(1.0))

    jmodel = paddle_tpu.Model(jm)
    jmodel.prepare(adamw(jopt, jm), jcrit)
    with tdg.guard(CPUPlace()):
        tmodel = thapi.Model(tm)
        tmodel.prepare(adamw(topt, tm), tcrit)
        bare_opt = adamw(topt, bare_m)
    ref, got, bare = [], [], []
    for _ in range(2):
        ref += jmodel.train_batch([ids], [lbl, nsp])
        got += tmodel.train_batch([ids], [lbl, nsp])
        loss = tcrit(*bare_m(torch.from_numpy(ids)), torch.from_numpy(lbl),
                     torch.from_numpy(nsp))
        loss.backward()
        bare_opt.step()
        bare_opt.clear_grad()
        bare.append(float(loss))
    assert got == bare
    for (k, p), q in zip(tm.state_dict().items(),
                         bare_m.state_dict().values()):
        assert torch.equal(p, q), k
    assert_loss_trace(got, ref, rtol=1e-5)
    assert_params_close(jm, tm, 1e-5)
    assert len(tmodel.parameters()) == len(list(tm.parameters()))
    assert tmodel.eval_batch([ids], [lbl, nsp])[0] == pytest.approx(
        jmodel.eval_batch([ids], [lbl, nsp])[0], rel=1e-5)
    scores, rel = tmodel.predict_batch([ids])
    assert scores.shape == (BATCH, SEQ, TINY["vocab_size"])
    # fit / evaluate / predict / save / load / summary and use_jit are
    # ported (tests/test_torch_hapi.py holds them against the JAX package)
    assert tmodel.summary() == jmodel.summary()
