"""The port's GPT (paddle_tpu_torch/models/gpt.py) on the CPU against
paddle_tpu's, at the serving tests' tiny size (vocab 64, hidden 32, 2
layers, 4 heads): the JAX model is built under `paddle_tpu.seed`, its
`state_dict()` carried into the port's model with `set_state_dict`, and
both get the same token ids (numpy, seeded).

Tolerances: logits atol=rtol=1e-5 (fp32, the same ops in another
summation order); decoding is held token-equal (greedy, sampling with the
same seed, beam search): with random weights the logit margins between
the top tokens are far above 1e-5 at these sizes."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.dygraph as jdg
from paddle_tpu.models import (GPTConfig as JGPTConfig,
                               GPTForGeneration as JGPTForGeneration,
                               GPTModel as JGPTModel)
from paddle_tpu_torch import dygraph
from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.models import GPTConfig, GPTForGeneration, GPTModel
from paddle_tpu_torch.nn import MultiHeadAttention


@pytest.fixture(autouse=True, scope="module")
def jax_generator_restored():
    """The JAX package's global generator as it was before the module: its
    models draw from it (and tiny_pair seeds it), and a later test in the
    same worker that builds a model without a seed would otherwise get
    other weights (ROADMAP.md Queue 3 item 2)."""
    from paddle_tpu.core import generator
    state = generator.get_rng_state()
    yield
    generator.set_rng_state(state)


TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_position=64, dropout=0.0)
TOL = dict(rtol=1e-5, atol=1e-5)


def tiny_pair(seed=0, **over):
    """(paddle_tpu GPTForGeneration, port GPTForGeneration) with the same
    weights: the JAX model's state_dict() carried into the port's (on the
    CPU)."""
    cfg = dict(TINY, **over)
    paddle_tpu.seed(seed)
    with jdg.guard():
        jm = JGPTForGeneration(JGPTModel(JGPTConfig(**cfg)))
    with dygraph.guard(CPUPlace()):
        tm = GPTForGeneration(GPTModel(GPTConfig(**cfg)))
    missing, unexpected = tm.set_state_dict(jm.state_dict())
    assert missing == [] and unexpected == []
    return jm, tm


def _ids(batch, seq, seed=0, vocab=64):
    return np.random.RandomState(seed).randint(2, vocab, (batch, seq)) \
        .astype(np.int64)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=7)


def test_logits_match_jax(pair):
    jm, tm = pair
    ids = _ids(3, 11, seed=1)
    want = jm.gpt(paddle_tpu.to_tensor(ids)).numpy()
    got = tm.gpt(torch.from_numpy(ids))
    assert got.shape == (3, 11, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_incremental_decode_with_cache_equals_full_forward(pair):
    """Prefill 6 tokens into fresh caches, then feed 3 more one at a time
    with pos_offset: every step's logits equal the full forward's at that
    position, and the caches grow one column a step."""
    _, tm = pair
    ids = _ids(2, 9, seed=2)
    with torch.inference_mode():
        full = tm.gpt(torch.from_numpy(ids))
        caches = tm.gpt.gen_cache(2)
        logits, caches = tm.gpt(torch.from_numpy(ids[:, :6]), cache=caches,
                                pos_offset=np.zeros(2, np.int64))
        torch.testing.assert_close(logits, full[:, :6], **TOL)
        for t in range(6, 9):
            step, caches = tm.gpt(
                torch.from_numpy(ids[:, t:t + 1]), cache=caches,
                pos_offset=np.full(2, t, np.int64),
                attn_mask=torch.zeros(1, 1, 1, t + 1))
            assert caches[0].k.shape == (2, 4, t + 1, 8)
            torch.testing.assert_close(step[:, 0], full[:, t], **TOL)


def test_cache_decode_matches_jax(pair):
    """The same incremental step through both packages' Cache path."""
    jm, tm = pair
    ids = _ids(2, 5, seed=3)
    jc = jm.gpt.gen_cache(2)
    jl, jc = jm.gpt(paddle_tpu.to_tensor(ids), cache=jc,
                    pos_offset=np.zeros(2, np.int64))
    with torch.inference_mode():
        tc = tm.gpt.gen_cache(2)
        tl, tc = tm.gpt(torch.from_numpy(ids), cache=tc,
                        pos_offset=np.zeros(2, np.int64))
    np.testing.assert_allclose(tl.numpy(), jl.numpy(), **TOL)
    for j, t in zip(jc, tc):
        assert isinstance(t, MultiHeadAttention.Cache)
        np.testing.assert_allclose(t.k.numpy(), j.k.numpy(), **TOL)
        np.testing.assert_allclose(t.v.numpy(), j.v.numpy(), **TOL)


@pytest.mark.parametrize("strategy,kw", [
    ("greedy_search", {}),
    ("sampling", {"top_k": 8, "temperature": 0.8, "seed": 11}),
    ("sampling", {"seed": 5}),
    ("beam_search", {"num_beams": 2}),
])
def test_generate_token_equal_to_jax(pair, strategy, kw):
    """Two rows (beam search: one row of two beams, the same [2, T] decode
    shapes, which the JAX package has compiled by then)."""
    jm, tm = pair
    ids = _ids(1 if strategy == "beam_search" else 2, 4, seed=4)
    want = np.asarray(jm.generate(ids, max_length=6,
                                  decode_strategy=strategy, **kw))
    got = tm.generate(ids, max_length=6, decode_strategy=strategy, **kw)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_generate_rejects_as_jax(pair):
    jm, tm = pair
    for m in (jm, tm):
        with pytest.raises(ValueError, match="unknown decode_strategy"):
            m.generate(_ids(1, 3), decode_strategy="nucleus")
        with pytest.raises(ValueError, match="exceeds max_position"):
            m.generate(_ids(1, 60), max_length=8)


def test_gpt_forward_stays_on_the_model_device_and_eval_mode(pair):
    """The mask is cached per (length, device) on the model's device,
    and a model with dropout in train mode draws a new attention-dropout
    mask every call (the Philox kernel's plain version here) until
    eval(), after which it is deterministic."""
    _, tm = pair
    m = tm.gpt._mask(5)
    assert m.device == tm.gpt.device and m is tm.gpt._mask(5)
    assert torch.equal(m, torch.full((5, 5), -1e9).triu(1))
    _, drop = tiny_pair(seed=1, dropout=0.1)
    ids = torch.from_numpy(_ids(1, 3))
    a, b = drop.gpt(ids), drop.gpt(ids)
    assert a.shape == (1, 3, 64) and not torch.equal(a, b)
    drop.eval()
    assert drop.gpt(ids).shape == (1, 3, 64)
    assert torch.equal(drop.gpt(ids), drop.gpt(ids))
