"""Speculative decoding in the port (serving/speculative.py and the
engine's W-wide verify step) on the CPU: the cases of
tests/test_speculative.py run on the port's engine, and the port's spec
engine token-equal to the JAX package's spec engine on the same tiny LM
(the JAX weights carried into the port's model).

Cases: the acceptance matrix; validation; scripted drafts forced to
accept or reject (page-table truncation, token equality either way, the
step and rollback counts); a full-depth stamp accepting every proposal;
a shallow stamp's rejections staying token-equal; a sampling row riding
the spec batch at width one (its RNG stream untouched); the pool drained
after mixed radix and spec churn.

Tolerance: token EQUALITY (greedy verification emits the target's own
argmax chain; the tiny LM's logits agree with the JAX model's within
fp32 rounding, tests/test_torch_gpt.py, and its margins are far above
it)."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.dygraph as jdg
from paddle_tpu.models import (GPTConfig as JGPTConfig,
                               GPTForGeneration as JGPTForGeneration,
                               GPTModel as JGPTModel)
from paddle_tpu.serving import (ContinuousBatchingEngine as JEngine,
                                PagedKVPool as JPool,
                                SpeculativeDecoder as JSpec,
                                stamp_draft as jstamp)
from paddle_tpu_torch import dygraph
from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.models import GPTConfig, GPTForGeneration, GPTModel
from paddle_tpu_torch.serving import (ContinuousBatchingEngine, PagedKVPool,
                                      RadixPrefixCache, SpeculativeDecoder,
                                      longest_accepted, metrics,
                                      stamp_draft)

CFG = dict(vocab_size=48, hidden_size=16, num_layers=2, num_heads=2,
           max_position=64, dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def contained_state():
    """Two torch threads while the module runs (six test workers share the
    CPU), the previous count and the JAX package's generator restored
    after."""
    from paddle_tpu.core import generator
    rng, threads = generator.get_rng_state(), torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    generator.set_rng_state(rng)


@pytest.fixture(scope="module")
def lms():
    """(JAX tiny LM, port tiny LM) with the same weights."""
    paddle_tpu.seed(1234)
    with jdg.guard():
        jm = JGPTForGeneration(JGPTModel(JGPTConfig(**CFG)))
        jm.eval()
    with dygraph.guard(CPUPlace()):
        tm = GPTForGeneration(GPTModel(GPTConfig(**CFG))).eval()
    missing, unexpected = tm.set_state_dict(jm.state_dict())
    assert missing == [] and unexpected == []
    return jm, tm


def _pool():
    return PagedKVPool(2, 2, 8, page_tokens=4, num_pages=64, device="cpu")


def _run(engine, prompts, **kw):
    engine.start()
    try:
        futs = [engine.submit(p, **kw) for p in prompts]
        return [np.asarray(f.result(timeout=120)) for f in futs]
    finally:
        engine.stop()


def _ref(model, prompt, max_new):
    pool = _pool()
    (out,) = _run(ContinuousBatchingEngine(model, max_slots=2,
                                           kv_pool=pool), [prompt],
                  max_length=max_new)
    pool.assert_drained()
    return out


def test_longest_accepted_matrix():
    assert longest_accepted([3, 4, 5], [3, 4, 5, 6]) == 3
    assert longest_accepted([9, 4, 5], [3, 4, 5, 6]) == 0
    assert longest_accepted([3, 9, 5], [3, 4, 5, 6]) == 1
    assert longest_accepted([], [3]) == 0


def test_decoder_validation():
    class _Cfg:
        vocab_size, max_position, eos_id, num_layers = 48, 64, 1, 2
        num_heads, hidden_size = 2, 16

    class _M:
        config = _Cfg()

    with pytest.raises(ValueError, match="k must be"):
        SpeculativeDecoder(_M(), k=0)
    spec = SpeculativeDecoder(_M(), k=4)

    class _Other:
        vocab_size, max_position, eos_id = 99, 64, 1
    with pytest.raises(ValueError, match="vocab_size"):
        spec.geometry_check(_Other())


class _ScriptedDecoder(SpeculativeDecoder):
    """Proposals scripted from a known greedy reference: every proposal on
    the target's chain ("accept") or off it ("reject").  No draft model
    runs, so the test isolates the ENGINE's verify / rollback."""

    def __init__(self, model, script, mode, k=3):
        super().__init__(model, k=k)
        self.script = [int(t) for t in script]
        self.mode = mode
        self.calls = 0

    def open(self, slot, prompt_tokens):
        pass

    def close(self, slot):
        pass

    def commit(self, slot, committed, pending):
        pass

    def propose(self, slot, committed, pending, n=None):
        self.calls += 1
        n = self.k if n is None else min(int(n), self.k)
        pos = len(committed) + 1
        out = self.script[pos:pos + n]
        if self.mode == "reject":
            out = [(t + 1) % self.config.vocab_size for t in out]
        return out


def _counters():
    return {n: metrics.counter(n) for n in (
        "spec.accepted", "spec.proposed", "spec.rollback_cols",
        "spec.steps", "gen.tokens")}


def _delta(before):
    return {n: metrics.counter(n) - v for n, v in before.items()}


@pytest.mark.parametrize("mode", ["accept", "reject"])
def test_scripted_accept_reject_token_equal(lms, mode):
    _, tm = lms
    prompt = np.random.RandomState(7).randint(2, 48, (6,)).astype(np.int64)
    ref = _ref(tm, prompt, 6)
    pool = _pool()
    spec = _ScriptedDecoder(tm, ref, mode, k=3)
    before = _counters()
    (out,) = _run(ContinuousBatchingEngine(tm, max_slots=2, kv_pool=pool,
                                           speculative=spec), [prompt],
                  max_length=6)
    np.testing.assert_array_equal(out, ref)
    d = _delta(before)
    assert spec.calls > 0 and d["spec.proposed"] > 0
    if mode == "accept":
        assert d["spec.accepted"] == d["spec.proposed"]
        assert d["spec.rollback_cols"] == 0
        assert d["spec.steps"] < 6
    else:
        assert d["spec.accepted"] == 0
        assert d["spec.rollback_cols"] == d["spec.proposed"]
        assert d["spec.steps"] == 6 - 1
    pool.assert_drained()


def test_stamped_draft_full_depth_accepts_all(lms):
    _, tm = lms
    prompt = np.random.RandomState(8).randint(2, 48, (6,)).astype(np.int64)
    ref = _ref(tm, prompt, 6)
    pool = _pool()
    spec = SpeculativeDecoder(stamp_draft(tm, num_layers=2), k=3)
    before = _counters()
    (out,) = _run(ContinuousBatchingEngine(tm, max_slots=2, kv_pool=pool,
                                           speculative=spec), [prompt],
                  max_length=6)
    np.testing.assert_array_equal(out, ref)
    d = _delta(before)
    assert d["spec.accepted"] == d["spec.proposed"] > 0
    assert d["gen.tokens"] / max(1, d["spec.steps"]) > 1.0
    assert spec.draft_tokens > 0 and spec.open_slots == 0
    pool.assert_drained()


def test_shallow_stamp_rejections_stay_token_equal(lms):
    _, tm = lms
    rng = np.random.RandomState(9)
    prompts = [rng.randint(2, 48, (n,)).astype(np.int64) for n in (5, 9)]
    refs = [_ref(tm, p, 6) for p in prompts]
    # the 1-layer stamp (the tiny LM soon repeats a token, which it may
    # guess), then a 1-layer draft with its own random weights, which
    # really rejects
    for copy_weights in (True, False):
        pool = _pool()
        before = _counters()
        draft = stamp_draft(tm, num_layers=1, copy_weights=copy_weights)
        outs = _run(ContinuousBatchingEngine(
            tm, max_slots=2, kv_pool=pool,
            speculative=SpeculativeDecoder(draft, k=4)), prompts,
            max_length=6)
        for out, ref in zip(outs, refs):
            np.testing.assert_array_equal(out, ref)
        d = _delta(before)
        if not copy_weights:
            assert d["spec.rollback_cols"] > 0
        pool.assert_drained()


def test_sampling_rides_spec_batch_at_width_one(lms):
    _, tm = lms
    prompt = np.random.RandomState(10).randint(2, 48, (5,)).astype(np.int64)
    kw = dict(max_length=6, decode_strategy="sampling", top_k=5, seed=21)
    (ref,) = _run(ContinuousBatchingEngine(tm, max_slots=2,
                                           kv_pool=_pool()), [prompt], **kw)
    pool = _pool()
    spec = SpeculativeDecoder(stamp_draft(tm, num_layers=2), k=3)
    eng = ContinuousBatchingEngine(tm, max_slots=2, kv_pool=pool,
                                   speculative=spec)
    (out,) = _run(eng, [prompt], **kw)
    np.testing.assert_array_equal(out, ref)
    assert spec.draft_tokens == 0
    # a spec step downloads the argmax of every (row, position) and the
    # sampling row's position-0 logits only (48 fp32)
    for st in eng.step_log:
        assert st["d2h_bytes"] == st["rows"] * st["width"] * 8 + \
            st["sampling_rows"] * 48 * 4
    pool.assert_drained()


def test_pool_drained_after_mixed_radix_spec_churn(lms):
    _, tm = lms
    rng = np.random.RandomState(11)
    pool = PagedKVPool(2, 2, 8, page_tokens=4, num_pages=32, device="cpu")
    radix = RadixPrefixCache(pool, low_watermark=3, high_watermark=6)
    spec = SpeculativeDecoder(stamp_draft(tm, num_layers=1), k=3)
    eng = ContinuousBatchingEngine(tm, max_slots=2, kv_pool=pool,
                                   prefix_cache=radix, speculative=spec)
    head = rng.randint(2, 48, (8,)).astype(np.int64)
    prompts = [np.concatenate([head, [2 + i]]).astype(np.int64) if i % 2
               else rng.randint(2, 48, (4 + i,)).astype(np.int64)
               for i in range(8)]
    _run(eng, prompts, max_length=5)
    assert pool.pages_retained > 0
    pool.assert_drained()
    radix.clear()
    pool.assert_drained()
    assert pool.pages_free == pool.num_pages
    assert spec.open_slots == 0


@pytest.mark.parametrize("draft_layers", [1, 2])
def test_spec_engine_token_equal_to_jax_spec_engine(lms, draft_layers):
    """The same prompts (greedy and sampling, more requests than slots,
    a shared head) through the JAX spec engine and the port's, each with
    its own stamp of the same weights."""
    jm, tm = lms
    rng = np.random.RandomState(12)
    head = rng.randint(2, 48, (6,))
    prompts = [np.concatenate([head, rng.randint(2, 48, (n,))])
               .astype(np.int64) for n in (1, 3, 5)] + \
        [rng.randint(2, 48, (7,)).astype(np.int64)]
    kws = [dict(max_length=8), dict(max_length=6),
           dict(max_length=7, decode_strategy="sampling", top_k=6, seed=4),
           dict(max_length=9)]

    def serve(engine):
        engine.start()
        try:
            futs = [engine.submit(p, **kw) for p, kw in zip(prompts, kws)]
            return [np.asarray(f.result(timeout=120)) for f in futs]
        finally:
            engine.stop()

    want = serve(JEngine(jm, max_slots=2,
                         kv_pool=JPool(2, 2, 8, page_tokens=4,
                                       num_pages=64),
                         prefix_cache="auto",
                         speculative=JSpec(jstamp(jm, draft_layers), k=4)))
    tpool = _pool()
    got = serve(ContinuousBatchingEngine(
        tm, max_slots=2, kv_pool=tpool, prefix_cache="auto",
        speculative=SpeculativeDecoder(stamp_draft(tm, draft_layers), k=4)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    tpool.assert_drained()
