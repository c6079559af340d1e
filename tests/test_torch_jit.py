"""paddle_tpu_torch.jit (to_static, dy2static, save / load), held against
paddle_tpu.jit on the CPU.  For LeNet, small ResNets (basic and
bottleneck blocks with batch norm) and the tests/test_jit.py models, the
recorded program equals the JAX package's (`to_dict`, both unique-name
counters reset after the inputs are made), and outputs, parameter
gradients and the batch-norm running statistics match the JAX
StaticFunction's (1e-5, fp32).  The flash attention route raises under a
recorder in both packages.  Files written by `jit.save` of either package
load in the other (1e-5)."""
import os

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.nn as jnn
import paddle_tpu.tensor as jt
from paddle_tpu import jit as jjit
from paddle_tpu.core.program import _reset_unique_names as jreset
from paddle_tpu.vision.models import lenet as jlenet
from paddle_tpu.vision.models import resnet as jresnet

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.core.program import _reset_unique_names as treset
from paddle_tpu_torch.dygraph import guard
from paddle_tpu_torch.vision.models import lenet as tlenet
from paddle_tpu_torch.vision.models import resnet as tresnet

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    with guard(CPUPlace()):
        torch.set_num_threads(2)
        yield


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy())


def _pkg(which):
    if which == "jax":
        return paddle_tpu, jnn, jjit, jreset
    return pt, tnn, tjit, treset


# ---------------------------------------------------------------------------
# models, from either package
# ---------------------------------------------------------------------------
def small_net(which):
    paddle, nn, _, _ = _pkg(which)

    class SmallNet(nn.Layer):
        def __init__(self):
            super().__init__()
            self.l1 = nn.Linear(4, 8)
            self.l2 = nn.Linear(8, 1)

        def forward(self, x):
            return self.l2(paddle.nn.functional.relu(self.l1(x)))
    return SmallNet()


def two_head(which):
    _, nn, _, _ = _pkg(which)

    class TwoHead(nn.Layer):
        def __init__(self):
            super().__init__()
            self.a = nn.Linear(4, 2)
            self.b = nn.Linear(4, 3)

        def forward(self, x):
            return self.a(x), self.b(x)
    return TwoHead()


def lenet(which):
    mod = jlenet if which == "jax" else tlenet
    return mod.LeNet(num_classes=10)


def mini_resnet(which, bottleneck=False):
    """A narrow ResNet of the vision models' own blocks: stem conv / BN /
    relu / max pool, one block with a strided downsample, pool, fc."""
    _, nn, _, _ = _pkg(which)
    rmod = jresnet if which == "jax" else tresnet

    class MiniResNet(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2D(3, 4, 3, padding=1, bias_attr=False)
            self.bn1 = nn.BatchNorm2D(4)
            self.relu = nn.ReLU()
            self.maxpool = nn.MaxPool2D(kernel_size=3, stride=2, padding=1)
            if bottleneck:
                down = nn.Sequential(
                    nn.Conv2D(4, 8, 1, stride=2, bias_attr=False),
                    nn.BatchNorm2D(8))
                self.block = rmod.BottleneckBlock(4, 2, stride=2,
                                                  downsample=down)
            else:
                down = nn.Sequential(
                    nn.Conv2D(4, 8, 1, stride=2, bias_attr=False),
                    nn.BatchNorm2D(8))
                self.block = rmod.BasicBlock(4, 8, stride=2,
                                             downsample=down)
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
            self.fc = nn.Linear(8, 5)

        def forward(self, x):
            from importlib import import_module
            flatten = import_module(
                ("paddle_tpu" if which == "jax" else "paddle_tpu_torch")
                + ".tensor.manipulation").flatten
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
            x = self.avgpool(self.block(x))
            return self.fc(flatten(x, 1))
    return MiniResNet()


MODELS = {
    "small_net": (small_net, (3, 4)),
    "two_head": (two_head, (3, 4)),
    "lenet": (lenet, (2, 1, 28, 28)),
    "mini_resnet_basic": (lambda w: mini_resnet(w, False), (2, 3, 16, 16)),
    "mini_resnet_bottleneck": (lambda w: mini_resnet(w, True),
                               (2, 3, 16, 16)),
}


def build_pair(name):
    make, shape = MODELS[name]
    jreset()
    jm = make("jax")
    treset()
    tm = make("port")
    tm.set_state_dict({k: np.asarray(v.numpy())
                       for k, v in jm.state_dict().items()})
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    return jm, tm, x


def _outs(o):
    return list(o) if isinstance(o, (list, tuple)) else [o]


def _trace_pair(jf, tf, jargs, targs):
    jreset()
    jo = _outs(jf(*jargs))
    treset()
    to = _outs(tf(*targs))
    jcp = next(iter(jf._cache.values()))
    tcp = next(iter(tf._cache.values()))
    return jo, to, jcp, tcp


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_program_outputs_grads_and_bn_stats(name):
    jm, tm, x = build_pair(name)
    jm.train()
    tm.train()
    jx = paddle_tpu.to_tensor(x)
    tx = pt.to_tensor(x)
    jf = jjit.StaticFunction(jm.forward, layer=jm)
    tf = tjit.StaticFunction(tm.forward, layer=tm)
    jo, to, jcp, tcp = _trace_pair(jf, tf, [jx], [tx])
    assert tcp.program.to_dict() == jcp.program.to_dict()
    assert tcp.feed_names == jcp.feed_names
    assert tcp.fetch_names == jcp.fetch_names
    assert tcp.updates == jcp.updates
    for a, b in zip(to, jo):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    # gradients of sum(out^2) reach the parameters through the replay
    jl = jt.sum(jt.multiply(jo[0], jo[0]))
    tl = (to[0] * to[0]).sum()
    for jx_, tx_ in zip(jo[1:], to[1:]):
        jl = jt.add(jl, jt.sum(jt.multiply(jx_, jx_)))
        tl = tl + (tx_ * tx_).sum()
    jl.backward()
    tl.backward()
    jsd, tsd = jm.state_dict(), tm.state_dict()
    tparams = dict(tm.named_parameters())
    for k, jp in jm.named_parameters():
        tp = tparams[k]
        assert tp.grad is not None, k
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jp.grad),
                                   **TOL, err_msg=k)
    # a second replay updates the running statistics again
    jf(jx)
    tf(tx)
    for k in jsd:
        np.testing.assert_allclose(_np(tsd[k]), _np(jm.state_dict()[k]),
                                   **TOL, err_msg=k)
    # eval mode replays the same recorded program with the running stats
    jm.eval()
    tm.eval()
    np.testing.assert_allclose(_np(_outs(tf(tx))[0]), _np(_outs(jf(jx))[0]),
                               **TOL)
    assert len(tf._cache) == 1


def test_batchnorm_running_stats_follow_eager_across_replays():
    rng = np.random.RandomState(0)
    batches = [rng.rand(8, 3, 2, 2).astype(np.float32) * 4 - 1
               for _ in range(5)]

    def run(use_jit):
        pt.seed(0)
        bn = tnn.BatchNorm2D(3)
        bn.train()
        fwd = tjit.StaticFunction(lambda x: bn(x), layer=bn) if use_jit \
            else (lambda x: bn(x))
        for b in batches:
            y = fwd(pt.to_tensor(b))
        return bn._mean.numpy().copy(), bn._variance.numpy().copy(), _np(y)

    for a, b in zip(run(False), run(True)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# dy2static: the tests/test_jit.py functions, recorded by both packages
# ---------------------------------------------------------------------------
def f_tensor_if(x):
    if x.mean() > 0:
        y = x * 2.0
    else:
        y = x - 3.0
    return y


def f_branch_merge(x):
    scale = x * 0.0 + 1.0
    if x.sum() > 10.0:
        scale = scale * 5.0
        shift = x * 0.0 + 1.0
    else:
        shift = x * 0.0
    return x * scale + shift


def f_countdown(x):
    s = x * 0.0
    while x.sum() > 0:
        s = s + x
        x = x - 1.0
    return s


def f_decode(seed, buf, i):
    while i.sum() < 6:
        tok = (seed + i).sum() % 5.0
        if tok > 3.0:
            break
        buf = buf + tok
        i = i + 1
    return buf, i


def f_continue(x):
    s = x * 0.0
    k = x.sum() * 0.0
    while k < 5:
        k = k + 1
        if (k % 2) > 0:
            continue
        s = s + k
    return s


def f_for_range_tensor(n, x):
    acc = x * 0.0
    for _ in range(n):
        acc = acc + x
    return acc


def f_for_over_tensor(m):
    acc = m.sum(axis=0) * 0.0
    for row in m:
        acc = acc + row
    return acc


def f_nested_while(x):
    total = x * 0.0
    i = x.sum() * 0.0
    while i < 3:
        j = x.sum() * 0.0
        while j < 2:
            total = total + 1.0
            j = j + 1
        i = i + 1
    return total


def f_print_assert(x):
    if x.sum() > 0:
        x = x * 2.0
    print("val:", x)
    assert x.sum() > 0, "sum must be positive"
    return x + 1.0


def f_boolop(x, y):
    s = x * 0.0
    while x.sum() > 0 and y.sum() > 0:
        s = s + 1.0
        x = x - 1.0
        y = y - 1.0
    return s


F32 = np.float32
DY2ST = {
    "tensor_if": (f_tensor_if, [[np.full((2, 3), 1.0, F32)],
                                [np.full((2, 3), -1.0, F32)]]),
    "branch_merge": (f_branch_merge, [[np.full((2, 4), 9.0, F32)],
                                      [np.full((2, 4), 0.5, F32)]]),
    "countdown": (f_countdown, [[np.array([3.0, 2.0], F32)],
                                [np.array([5.0, 1.0], F32)]]),
    "decode_break": (f_decode, [[np.array([s], F32), np.zeros(4, F32),
                                 np.array([0.0], F32)] for s in (1.0, 2.0)]),
    "continue": (f_continue, [[np.array([0.0], F32)]]),
    "for_range_tensor": (f_for_range_tensor,
                         [[np.array(4, np.int32), np.array([1.5], F32)],
                          [np.array(7, np.int32), np.array([2.0], F32)]]),
    "for_over_tensor": (f_for_over_tensor,
                        [[np.arange(6, dtype=F32).reshape(3, 2)]]),
    "nested_while": (f_nested_while, [[np.array([0.0], F32)]]),
    "print_assert": (f_print_assert, [[np.array([1.0, 2.0], F32)]]),
    "boolop": (f_boolop, [[np.array([3.0], F32), np.array([1.0], F32)],
                          [np.array([1.0], F32), np.array([3.0], F32)]]),
}


def _int32(d):
    """The JAX package runs with 64-bit types off, so the int64 values of
    its eager trace (a Python loop counter lifted to a tensor) are int32
    arrays, and their vars say so; the port's are int64.  Only that
    differs: map the port's int64 vars to int32 before comparing."""
    for b in d["blocks"]:
        for v in b["vars"]:
            if v["dtype"] == "int64":
                v["dtype"] = "int32"
    return d


@pytest.mark.parametrize("name", sorted(DY2ST))
def test_dy2static_program_and_outputs_equal_the_jax_packages(name, capfd):
    fn, calls = DY2ST[name]
    jf, tf = jjit.to_static(fn), tjit.to_static(fn)
    for i, arrs in enumerate(calls):
        jargs = [paddle_tpu.to_tensor(a) for a in arrs]
        targs = [pt.to_tensor(a) for a in arrs]
        if i == 0:
            jo, to, jcp, tcp = _trace_pair(jf, tf, jargs, targs)
            assert _int32(tcp.program.to_dict()) == \
                _int32(jcp.program.to_dict())
        else:
            jo, to = _outs(jf(*jargs)), _outs(tf(*targs))
        for a, b in zip(to, jo):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6)
    assert len(tf._cache) == 1
    types = [op.type for b in tcp.program.blocks for op in b.ops]
    if name in ("tensor_if", "branch_merge", "print_assert"):
        assert "cond" in types
    if name in ("countdown", "decode_break", "continue", "for_range_tensor",
                "nested_while", "boolop"):
        assert "while" in types
    if name == "print_assert":
        assert "print" in types and "assert" in types
        assert "val:" in capfd.readouterr().out


def test_dy2static_assert_fires_on_replay():
    tf = tjit.to_static(f_print_assert)
    tf(pt.to_tensor(np.array([1.0, 2.0], F32)))
    with pytest.raises(AssertionError, match="sum must be positive"):
        tf(pt.to_tensor(np.array([-5.0, 1.0], F32)))


def test_dy2static_gradients_through_cond_equal_the_jax_packages():
    jm, tm, x = build_pair("small_net")

    def make(net, mean):
        def f(v):
            h = net.forward(v)
            if mean(h) > 0:
                return h * 2.0
            else:
                return h * 0.5
        return f

    jf = jjit.to_static(make(jm, jt.mean))
    tf = tjit.to_static(make(tm, lambda h: h.mean()))
    for xv in (x, -x * 5):
        jo = jf(paddle_tpu.to_tensor(xv))
        to = tf(pt.to_tensor(xv))
        np.testing.assert_allclose(_np(to), _np(jo), **TOL)
        jt.mean(jo).backward()
        to.mean().backward()
        tparams = dict(tm.named_parameters())
        for k, jp in jm.named_parameters():
            tp = tparams[k]
            np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jp.grad),
                                       **TOL)
            jp.clear_gradient()
            tp.grad = None


def test_unbounded_while_gradient_refuses():
    w = torch.nn.Parameter(torch.ones(2))

    def f(x):
        s = x * w
        while s.sum() < 10.0:
            s = s + s
        return s

    tf = tjit.to_static(f)
    out = tf(pt.to_tensor(np.array([1.0, 2.0], F32)))
    np.testing.assert_allclose(out.detach().numpy(), [4.0, 8.0])
    with pytest.raises(ValueError, match="max_iters"):
        out.sum().backward()


def test_flash_route_under_a_recorder_raises_in_both_packages():
    from test_torch_program import flash_mode
    x = np.random.RandomState(0).rand(2, 8, 16).astype(F32)
    with flash_mode(True):
        jreset()
        jmha = jnn.MultiHeadAttention(16, 2)
        treset()
        tmha = tnn.MultiHeadAttention(16, 2)
        jmha.eval()
        tmha.eval()
        with pytest.raises(NotImplementedError, match="flash_attention"):
            jjit.to_static(lambda q: jmha(q))(paddle_tpu.to_tensor(x))
        with pytest.raises(NotImplementedError, match="flash_attention"):
            tjit.to_static(lambda q: tmha(q))(pt.to_tensor(x))


def test_unrecordable_operation_raises_naming_it():
    tf = tjit.to_static(lambda x: x[0] * 2.0)
    with pytest.raises(NotImplementedError, match="getitem"):
        tf(pt.to_tensor(np.ones((2, 2), F32)))
    tf = tjit.to_static(lambda x: torch.sin(x))
    with pytest.raises(NotImplementedError, match="sin"):
        tf(pt.to_tensor(np.ones((2, 2), F32)))
    # outside a recorder nothing changed: plain torch
    assert torch.sin(pt.to_tensor(np.zeros(2, F32))).sum() == 0


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_jit_save_loads_in_the_other_package(tmp_path, writer):
    jm, tm, x = build_pair("mini_resnet_bottleneck")
    jm.eval()
    tm.eval()
    ref = _np(jm(paddle_tpu.to_tensor(x)))
    np.testing.assert_allclose(_np(tm(pt.to_tensor(x))), ref, **TOL)
    path = os.path.join(str(tmp_path), "model")
    spec = [jjit.InputSpec(list(x.shape), "float32")]
    if writer == "jax":
        jjit.save(jm, path, input_spec=spec)
        loaded = tjit.load(path)
        loaded.eval()
        got = _np(loaded(pt.to_tensor(x)))
    else:
        tjit.save(tm, path, input_spec=[tjit.InputSpec(list(x.shape))])
        loaded = jjit.load(path)
        loaded.eval()
        got = _np(_outs(loaded(paddle_tpu.to_tensor(x)))[0])
    np.testing.assert_allclose(got, ref, **TOL)


def test_jit_save_load_keeps_cond_and_finetunes(tmp_path):
    class CondNet(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = tnn.Linear(4, 4)

        def forward(self, x):
            h = self.lin(x)
            if h.mean() > 0:
                y = h * 2.0
            else:
                y = -h
            return y

    net = tjit.to_static(CondNet())
    x = pt.to_tensor(np.random.RandomState(0).rand(3, 4).astype(F32))
    ref = _np(net(x))
    path = os.path.join(str(tmp_path), "condnet")
    tjit.save(net, path, input_spec=[tjit.InputSpec([3, 4])])
    loaded = tjit.load(path)
    np.testing.assert_allclose(_np(loaded(x)), ref, rtol=1e-6)
    loaded.train()
    params = list(loaded.parameters())
    assert params and all(p.requires_grad for p in params)
    opt = pt.optimizer.Adam(learning_rate=0.05, parameters=params)
    y = pt.to_tensor(np.full((3, 4), 2.0, F32))
    losses = []
    for _ in range(30):
        loss = pt.nn.functional.mse_loss(loaded(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5


def test_traced_layer_and_knobs(tmp_path):
    _, tm, x = build_pair("small_net")
    out, traced = tjit.TracedLayer.trace(tm, [pt.to_tensor(x)])
    np.testing.assert_allclose(_np(traced([pt.to_tensor(x)])), _np(out))
    traced.save_inference_model(os.path.join(str(tmp_path), "traced"))
    loaded = tjit.load(os.path.join(str(tmp_path), "traced"))
    np.testing.assert_allclose(_np(loaded(pt.to_tensor(x))), _np(out),
                               rtol=1e-6)
    tjit.set_code_level(50)
    tjit.set_verbosity(1)
    assert tjit.ProgramTranslator.get_instance() is \
        tjit.ProgramTranslator.get_instance()
    assert tjit.not_to_static(len) is len
