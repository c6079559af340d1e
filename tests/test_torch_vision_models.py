"""paddle.vision's LeNet and ResNet in dygraph, the port against the JAX
package: `vision.models.LeNet()` (1x28x28) and, in
test_torch_vision_resnet.py, `resnet18` at img 32 with 10 classes, built in both packages from the same unique-name state, the
JAX model's `state_dict()` (parameters, then the batch norms' `_mean` /
`_variance` buffers) carried into the port with `set_state_dict`.

  * the eval forward equal (1e-5), before training and after it (with
    the trained running stats);
  * 3 train-mode `optimizer.Momentum(0.01, 0.9)` steps on one fixed batch
    (`F.cross_entropy`, `loss.backward()`).  LeNet: losses rtol 1e-5,
    every parameter atol 1e-5.  resnet18: each step from the JAX
    package's state (fp32 alone parts two free-running runs of this
    model; the reason and the gates are in its test): losses rtol 1e-5,
    the `_mean` / `_variance` buffers rtol = atol = 1e-5, each update
    within a normalised 1e-3;
  * one `amp.auto_cast` O1 step (conv2d and the Linear products in bf16,
    batch_norm in fp32): LeNet's loss rtol 1e-5, resnet18's 3e-2, and the
    state after the step no further from the fp32 step's, in L2 norm,
    than 1.5x the JAX package's O1 state is (bf16 rounding flips relu
    masks and batch norm over a few values a channel amplifies it, the
    same gate as test_torch_baseline_programs.py's AMP ResNet).  The JAX
    package's dygraph AMP backward raises on these models (a white conv
    consumes another op's output; ROADMAP.md Queue 3), so its cotangents
    are cast in memory (`jax_amp_cotangents`);
  * `hapi.Model(LeNet()).train_batch` equal to the bare loop to the last
    bit, losses and parameters.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.optimizer as jopt
from paddle_tpu import amp as jamp
from paddle_tpu import dygraph as jdg
from paddle_tpu import vision as jvision
from paddle_tpu.core.program import _reset_unique_names as jax_reset_names

import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import dygraph as tdg
from paddle_tpu_torch import hapi as thapi
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import vision as tvision
from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.core.program import (_reset_unique_names as
                                           torch_reset_names)
from test_torch_amp_dygraph import jax_amp_cotangents  # noqa: F401
from test_torch_vision_ops import contained_state  # noqa: F401

MODELS = {"lenet": (lambda v: v.models.LeNet(), (1, 28, 28)),
          "resnet18": (lambda v: v.models.resnet18(num_classes=10),
                       (3, 32, 32))}
BATCH = 4
LR = 0.01


def vision_pair(name, seed=0):
    """(JAX model, port model) with the same weights, buffers and
    parameter names."""
    ctor, _ = MODELS[name]
    jax_reset_names()
    paddle_tpu.seed(seed)
    with jdg.guard():
        jm = ctor(jvision)
    torch_reset_names()
    with tdg.guard(CPUPlace()):
        tm = ctor(tvision)
    jsd, tsd = jm.state_dict(), tm.state_dict()
    assert list(jsd) == list(tsd)
    assert (sum(k.endswith(("_mean", "_variance")) for k in tsd)
            == (0 if name == "lenet" else 2 * 20))
    missing, unexpected = tm.set_state_dict(jsd)
    assert missing == [] and unexpected == []
    for k, p in jsd.items():
        if hasattr(tsd[k], "paddle_name"):
            assert p.name == tsd[k].paddle_name
    return jm, tm


def batch(name, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.rand(BATCH, *MODELS[name][1]).astype(np.float32),
            rng.randint(0, 10, (BATCH, 1)).astype(np.int64))


def _state(model):
    return {k: np.asarray(v.numpy() if hasattr(v, "numpy") and
                          not isinstance(v, torch.Tensor)
                          else v.detach().numpy(), np.float64)
            for k, v in model.state_dict().items()}


def _eval(jm, tm, x):
    jm.eval()
    tm.eval()
    ref = np.asarray(jm(paddle_tpu.to_tensor(x)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    jm.train()
    tm.train()
    return ref, got


def _sync(jm, tm, jo, to):
    """The port's model and optimizer set to the JAX package's state."""
    tm.set_state_dict(jm.state_dict())
    to.set_state_dict(jo.state_dict())


def _steps(jm, tm, x, y, steps, level=None, lr=LR, forced=False):
    """`steps` Momentum(lr, 0.9) steps in both packages (under
    auto_cast(level) when given).  With `forced`, each step of the port
    starts from the JAX package's state (parameters, buffers, velocities)
    and the port's update of each step is checked against the JAX
    package's.  Returns the two loss traces."""
    jo = jopt.Momentum(lr, 0.9, parameters=jm.parameters())
    with tdg.guard(CPUPlace()):
        to = topt.Momentum(lr, 0.9, parameters=tm.parameters())
    jx, jy = paddle_tpu.to_tensor(x), paddle_tpu.to_tensor(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    ref, got = [], []
    for _ in range(steps):
        if forced and ref:
            _sync(jm, tm, jo, to)
        before = _state(jm)
        with jamp.auto_cast(enable=level is not None, level=level or "O1"):
            jl = paddle_tpu.nn.functional.cross_entropy(jm(jx), jy)
        with tamp.auto_cast(enable=level is not None, level=level or "O1"):
            tl = tnn.functional.cross_entropy(tm(tx), ty)
        jl.backward()
        jo.step()
        jo.clear_grad()
        tl.backward()
        to.step()
        to.clear_grad()
        ref.append(float(np.asarray(jl.numpy(), np.float32)))
        got.append(float(tl.detach().float()))
        if forced:
            _assert_step_close(before, _state(jm), _state(tm))
    return np.asarray(ref), np.asarray(got)


def _assert_step_close(before, ref, got):
    """One step from the same state: the running stats (set by the
    forward alone) within rtol = atol = 1e-5, each parameter's update
    within a normalised max error of 1e-3 of the JAX package's."""
    for k, r in ref.items():
        if k.endswith(("_mean", "_variance")):
            np.testing.assert_allclose(got[k], r, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
            continue
        upd = r - before[k]
        err = np.abs(got[k] - r).max() / np.abs(upd).max()
        assert err <= 1e-3, (k, err)


def test_lenet_eval_forward_and_momentum_steps_match_jax():
    jm, tm = vision_pair("lenet")
    x, y = batch("lenet")
    ref, got = _eval(jm, tm, x)
    assert got.shape == (BATCH, 10)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    first = _state(tm)
    rl, gl = _steps(jm, tm, x, y, 3)
    assert np.all(np.isfinite(gl)) and gl[-1] < gl[0]
    np.testing.assert_allclose(gl, rl, rtol=1e-5)
    jst, tst = _state(jm), _state(tm)
    for k, v in tst.items():
        np.testing.assert_allclose(v, jst[k], rtol=0, atol=1e-5, err_msg=k)
        assert not np.array_equal(v, first[k]), k  # every entry moved
    ref, got = _eval(jm, tm, x)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def o1_step_check(name, loss_rtol):
    """One O1 step from the same weights in both packages: the losses
    within `loss_rtol`; then the state after it no further from the JAX
    package's fp32 step's, in L2 norm, than 1.5x the JAX O1 state is."""
    jm, tm = vision_pair(name, seed=2)
    init = _state(jm)
    x, y = batch(name, seed=3)
    rl, gl = _steps(jm, tm, x, y, 1, level="O1")
    assert np.isfinite(gl).all()
    np.testing.assert_allclose(gl, rl, rtol=loss_rtol)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    ref, got = _state(jm), _state(tm)
    jm.set_state_dict({k: v.astype(np.float32) for k, v in init.items()})
    tm.set_state_dict(jm.state_dict())
    _steps(jm, tm, x, y, 1)  # the fp32 step from the same weights
    fp32 = _state(jm)

    def dist(s):
        return np.sqrt(sum(((s[k] - fp32[k]) ** 2).sum() for k in s))

    assert 0 < dist(got) <= 1.5 * dist(ref), (dist(got), dist(ref))


def test_lenet_o1_step_matches_jax(jax_amp_cotangents):  # noqa: F811
    """conv2d and the Linear products round to bf16 the same way in both
    packages (measured: equal losses), so rtol 1e-5."""
    o1_step_check("lenet", 1e-5)


def test_hapi_train_batch_equals_bare_loop():
    _, tm = vision_pair("lenet", seed=4)
    _, bare = vision_pair("lenet", seed=4)
    x, y = batch("lenet", seed=5)
    with tdg.guard(CPUPlace()):
        model = thapi.Model(tm)
        model.prepare(topt.Momentum(LR, 0.9, parameters=tm.parameters()),
                      tnn.CrossEntropyLoss())
        opt = topt.Momentum(LR, 0.9, parameters=bare.parameters())
    got, want = [], []
    for _ in range(2):
        got += model.train_batch([x], [y])
        loss = tnn.functional.cross_entropy(bare(torch.from_numpy(x)),
                                            torch.from_numpy(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        want.append(float(loss.detach()))
    assert got == want and got[1] < got[0]
    for (k, p), q in zip(tm.state_dict().items(), bare.state_dict().values()):
        assert torch.equal(p, q), k


def test_pretrained_weights_raise_and_buffers_follow_the_layer():
    with pytest.raises(NotImplementedError, match="network"):
        tvision.models.resnet50(pretrained=True)
    with tdg.guard(CPUPlace()):
        bn = tnn.BatchNorm2D(3)
        bn.register_buffer("_scratch", np.ones(2, np.float32),
                           persistable=False)
    assert [k for k in bn.state_dict()] == ["weight", "bias", "_mean",
                                            "_variance"]
    assert bn._mean.dtype == torch.float32 and not bn._mean.requires_grad
    assert "_scratch" not in bn.state_dict()
    assert bn.to(torch.float64)._mean.dtype == torch.float64
