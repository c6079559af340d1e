"""The port's dygraph `Layer` and `nn` layers (paddle_tpu_torch/dygraph,
paddle_tpu_torch/nn) on the CPU against paddle_tpu's: structured
state_dict names, Paddle's parameter shapes, the weight carry
(`set_state_dict` of the JAX layer's `state_dict()`), and Linear,
Embedding, LayerNorm and MultiHeadAttention outputs on the same numpy
inputs.  MultiHeadAttention is held on its score-matrix route (float and
bool masks, `Cache`, `StaticCache`) and on its flash route, where the
port runs the flash kernel's plain version and paddle_tpu the Pallas
kernel in interpret mode.

Tolerance: fp32 atol=rtol=1e-5 (the same ops in another summation
order)."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.dygraph as jdg
import paddle_tpu.nn as jnn
from paddle_tpu.models import GPTConfig as JGPTConfig, GPTModel as JGPTModel
from paddle_tpu.ops import attention as jattn
from paddle_tpu_torch import dygraph, nn
from paddle_tpu_torch.core import generator
from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.models import GPTConfig, GPTModel

from test_torch_gpt import TINY, jax_generator_restored  # noqa: F401
from test_torch_program import flash_mode

TOL = dict(rtol=1e-5, atol=1e-5)


def _both(make_jax, make_port):
    """The JAX layer (built under paddle_tpu.seed(0)) and the port's, with
    the JAX weights carried over."""
    paddle_tpu.seed(0)
    with jdg.guard():
        jl = make_jax()
    with dygraph.guard(CPUPlace()):
        tl = make_port()
    assert tl.set_state_dict(jl.state_dict()) == ([], [])
    return jl, tl


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_gpt_state_dict_names_and_shapes_equal_jax():
    """Same structured names, in the same (breadth-first) order, with the
    same shapes: Linear weights are [in, out], as Paddle's."""
    paddle_tpu.seed(0)
    with jdg.guard():
        jsd = JGPTModel(JGPTConfig(**TINY)).state_dict()
    with dygraph.guard(CPUPlace()):
        tsd = GPTModel(GPTConfig(**TINY)).state_dict()
    assert list(tsd) == list(jsd)
    for name in jsd:
        assert tuple(tsd[name].shape) == tuple(jsd[name].shape), name
    assert tuple(tsd["blocks.0.fc1.weight"].shape) == (32, 128)
    assert all(isinstance(p, torch.nn.Parameter) for p in tsd.values())


@pytest.mark.parametrize("layer", ["linear", "embedding", "layer_norm"])
def test_layers_match_jax(layer):
    if layer == "linear":
        jl, tl = _both(lambda: jnn.Linear(12, 7), lambda: nn.Linear(12, 7))
        x = _x(3, 5, 12)
    elif layer == "embedding":
        jl, tl = _both(lambda: jnn.Embedding(20, 6, padding_idx=3),
                       lambda: nn.Embedding(20, 6, padding_idx=3))
        x = np.random.RandomState(1).randint(0, 20, (4, 9)).astype(np.int64)
        x[0, 0] = 3  # the padding row reads as zeros
    else:
        jl, tl = _both(lambda: jnn.LayerNorm(12), lambda: nn.LayerNorm(12))
        with torch.no_grad():  # non-trivial scale and shift
            tl.weight.copy_(torch.from_numpy(_x(12, seed=2)))
            tl.bias.copy_(torch.from_numpy(_x(12, seed=3)))
        jl.set_state_dict({"weight": _x(12, seed=2), "bias": _x(12, seed=3)})
        x = _x(3, 5, 12) * 3 + 1
    want = jl(paddle_tpu.to_tensor(x)).numpy()
    got = tl(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if layer == "embedding":
        assert np.all(got[0, 0] == 0)


def _mha_pair():
    return _both(lambda: jnn.MultiHeadAttention(16, 4),
                 lambda: nn.MultiHeadAttention(16, 4))


@pytest.mark.parametrize("mask", ["float", "bool"])
def test_mha_masked_matches_jax(mask):
    jl, tl = _mha_pair()
    q, kv = _x(2, 5, 16, seed=4), _x(2, 7, 16, seed=5)
    if mask == "float":
        m = np.triu(np.full((5, 7), -1e9, np.float32), k=3)[None, None]
    else:  # True = keep
        m = np.random.RandomState(6).rand(2, 1, 5, 7) > 0.3
        m[..., 0] = True
    want = jl(paddle_tpu.to_tensor(q), paddle_tpu.to_tensor(kv),
              paddle_tpu.to_tensor(kv),
              attn_mask=paddle_tpu.to_tensor(m)).numpy()
    got = tl(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv),
             attn_mask=torch.from_numpy(m))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_mha_cache_matches_jax():
    """Prefill 4 tokens into an empty Cache, then one more token: outputs
    and the grown caches equal the JAX layer's."""
    jl, tl = _mha_pair()
    x0, x1 = _x(2, 4, 16, seed=7), _x(2, 1, 16, seed=8)
    causal = np.triu(np.full((4, 4), -1e9, np.float32), k=1)[None, None]
    jc = jl.gen_cache(paddle_tpu.to_tensor(x0))
    tc = tl.gen_cache(torch.from_numpy(x0))
    assert tc.k.shape == (2, 4, 0, 4)
    for x, m in ((x0, causal), (x1, np.zeros((1, 1, 1, 5), np.float32))):
        jo, jc = jl(paddle_tpu.to_tensor(x), attn_mask=paddle_tpu.to_tensor(m),
                    cache=jc)
        to, tc = tl(torch.from_numpy(x), attn_mask=torch.from_numpy(m),
                    cache=tc)
        assert isinstance(tc, nn.MultiHeadAttention.Cache)
        np.testing.assert_allclose(to.detach().numpy(), jo.numpy(), **TOL)
        np.testing.assert_allclose(tc.k.detach().numpy(), jc.k.numpy(),
                                   **TOL)
        np.testing.assert_allclose(tc.v.detach().numpy(), jc.v.numpy(),
                                   **TOL)
    assert tc.k.shape == (2, 4, 5, 4)


def test_mha_static_cache_matches_jax():
    """Cross-attention over a precomputed StaticCache of a memory."""
    jl, tl = _mha_pair()
    x, mem = _x(2, 3, 16, seed=9), _x(2, 6, 16, seed=10)
    jc = jl.gen_cache(paddle_tpu.to_tensor(mem),
                      type=jnn.MultiHeadAttention.StaticCache)
    tc = tl.gen_cache(torch.from_numpy(mem),
                      type=nn.MultiHeadAttention.StaticCache)
    np.testing.assert_allclose(tc.k.detach().numpy(), jc.k.numpy(), **TOL)
    want = jl(paddle_tpu.to_tensor(x), cache=jc).numpy()
    got = tl(torch.from_numpy(x), cache=tc)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_mha_flash_route_matches_pallas(monkeypatch):
    """Flash forced on, no mask: the JAX layer runs the Pallas flash
    kernel in interpret mode (S = 64 tiles), the port's the flash
    kernel's plain version (it would launch the Hopper kernel on a CUDA
    tensor) — counted by wrapping it.  Both equal the score-matrix route
    within fp32 tolerance."""
    from paddle_tpu_torch.ops import attention as tattn
    calls = []
    plain = tattn.flash_attention_plain

    def counted(*a, **k):
        calls.append(a[0].shape)
        return plain(*a, **k)

    monkeypatch.setattr(tattn, "flash_attention_plain", counted)
    jl, tl = _mha_pair()
    x = _x(2, 64, 16, seed=11)
    assert jattn._tiles_ok(64, 64, 256, 512)  # no fallback in the JAX op
    with flash_mode(True):
        want = jl(paddle_tpu.to_tensor(x)).numpy()
        got = tl(torch.from_numpy(x))
    assert calls == [(2, 4, 64, 4)]
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    with flash_mode(False):
        scores = tl(torch.from_numpy(x))
    assert len(calls) == 1
    torch.testing.assert_close(got, scores, **TOL)


def test_layer_api():
    """Paddle's Layer surface on the torch module: LayerList indexing,
    breadth-first named_sublayers as the JAX package's, train()/eval()
    reaching every sublayer, parameters(), set_state_dict's missing /
    unexpected report and shape check, bias_attr=False."""
    paddle_tpu.seed(0)
    with jdg.guard():
        jm = JGPTModel(JGPTConfig(**TINY))
    with dygraph.guard(CPUPlace()):
        tm = GPTModel(GPTConfig(**TINY))
        lin = nn.Linear(4, 3, bias_attr=False)
    assert [n for n, _ in tm.named_sublayers()] == \
        [n for n, _ in jm.named_sublayers()]
    assert len(tm.blocks) == 2 and tm.blocks[-1] is tm.blocks[1]
    with pytest.raises(IndexError):
        tm.blocks[2]
    assert len(list(tm.parameters())) == len(jm.parameters())
    tm.eval()
    assert not any(l.training for l in tm.sublayers())
    tm.train()
    assert all(l.training for l in tm.sublayers(include_self=True))
    sd = dict(jm.state_dict())
    sd.pop("wte.weight")
    sd["extra"] = np.zeros(1)
    assert tm.set_state_dict(sd) == (["wte.weight"], ["extra"])
    with pytest.raises(ValueError, match="shape"):
        tm.set_state_dict({"wpe.weight": np.zeros((2, 2), np.float32)})
    assert lin.bias is None and tuple(lin.weight.shape) == (4, 3)


def test_seed_and_rng_state_fix_the_draws():
    """paddle.seed fixes every eager initializer draw in order on one
    device type; get/set_rng_state replays the draws that followed the
    snapshot.  No draw touches torch's global RNG."""
    torch_state = torch.random.get_rng_state()
    with dygraph.guard(CPUPlace()):
        generator.seed(3)
        a = nn.Linear(5, 4).weight.detach().clone()
        snap = generator.get_rng_state()
        b = nn.Embedding(7, 4).weight.detach().clone()
        generator.seed(3)
        assert torch.equal(nn.Linear(5, 4).weight, a)
        generator.set_rng_state(snap)
        assert torch.equal(nn.Embedding(7, 4).weight, b)
        assert not torch.equal(nn.Linear(5, 4).weight, a)
    assert torch.equal(torch.random.get_rng_state(), torch_state)
    limit = np.sqrt(6.0 / (5 + 4))  # Xavier-uniform over [in, out]
    assert float(a.abs().max()) <= limit


def test_dygraph_place_and_to_tensor(monkeypatch):
    """to_tensor lands on the eager place; with no place set that is
    CUDAPlace(0), which raises without a GPU (no silent CPU); dropout in
    training draws a mask (the Philox kernel's plain version on a CPU
    tensor) and scales the kept elements by 1 / (1 - p)."""
    with dygraph.guard(CPUPlace()):
        t = dygraph.to_tensor([1.5, 2.0])
        assert t.device.type == "cpu" and t.dtype == torch.float32
        assert dygraph.to_tensor([1, 2]).dtype == torch.int64
        assert dygraph.to_tensor(np.zeros(2), stop_gradient=False) \
            .requires_grad
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dygraph.to_tensor([1.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nn.Linear(2, 2)
    kept = nn.functional.dropout(torch.ones(64), 0.5, training=True)
    assert set(kept.tolist()) == {0.0, 2.0}
    x = torch.ones(3)
    assert nn.functional.dropout(x, 0.5, training=False) is x
    torch.testing.assert_close(
        nn.functional.dropout(x, 0.5, training=False,
                              mode="downgrade_in_infer"), x * 0.5)
