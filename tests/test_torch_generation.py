"""The port's continuous-batching engine and `/generate`
(paddle_tpu_torch/serving/generation.py, inference/server.py) on the CPU
against paddle_tpu's, with the tiny GPT of tests/test_torch_gpt.py (the
JAX weights carried into the port's model):

* the fixed-slot engine, and the paged engine with the radix prefix
  cache (`prefix_cache="auto"`), are token-equal to the JAX engine on the
  same prompts: more requests than slots (churn), a shared prompt head
  (prefix sharing, then radix hits on a second wave), greedy and
  sampling (same seeds);
* both give the same rejections (bad strategy, over-long prompt, a
  request no pool could hold, a full queue, a request past its deadline,
  a stopped engine);
* `/generate` end to end on `CPUPlace()` answers the same reply bodies as
  the JAX server, and the same error status and type.

Token equality: the logits agree within fp32 rounding (test_torch_gpt)
and the random weights leave margins far above it.  Everything the
model reads stays on its device: the engine moves only ids, lengths and
what the sampler reads (checked per decode step)."""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu.inference.server import InferenceServer as JServer
from paddle_tpu.serving import (BatcherStoppedError as JStopped,
                                ContinuousBatchingEngine as JEngine,
                                DeadlineExceededError as JDeadline,
                                QueueFullError as JQueueFull)
from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.inference.server import InferenceServer
from paddle_tpu_torch.serving import (BatcherStoppedError,
                                      ContinuousBatchingEngine,
                                      DeadlineExceededError, QueueFullError,
                                      budget_drift)

from test_torch_gpt import jax_generator_restored, tiny_pair  # noqa: F401
from test_torch_predictor import save_reference_model

PLAN = dict(num_layers=2, num_heads=4, head_dim=8, page_tokens=4, pages=48,
            max_slots=3, max_context=64)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=3)


def _prompts(seed=0):
    rng = np.random.RandomState(seed)
    head = rng.randint(2, 64, (8,))
    waves = []
    for _ in range(2):
        waves.append([np.concatenate([head, rng.randint(2, 64, (n,))])
                      .astype(np.int64) for n in (1, 3, 6)] +
                     [rng.randint(2, 64, (n,)).astype(np.int64)
                      for n in (2, 5)])
    return waves


KW = [dict(max_length=4), dict(max_length=6),
      dict(max_length=5, decode_strategy="sampling", top_k=8,
           temperature=0.8, seed=9),
      dict(max_length=3), dict(max_length=6, decode_strategy="sampling",
                               seed=2)]


def _serve(engine, waves):
    """Each wave's five requests submitted together (three slots: two
    wait for a free slot), the second wave after the first retired."""
    engine.start()
    try:
        outs = []
        for wave in waves:
            futs = [engine.submit(p, **kw) for p, kw in zip(wave, KW)]
            outs.append([f.result(timeout=120) for f in futs])
    finally:
        engine.stop()
    return outs


def _same(a, b):
    for wa, wb in zip(a, b):
        for x, y in zip(wa, wb):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_fixed_and_paged_engines_token_equal_to_jax(pair):
    jm, tm = pair
    waves = _prompts()
    want = _serve(JEngine(jm, max_slots=3, kv_pool=dict(PLAN),
                          prefix_cache="auto"), waves)
    fixed = ContinuousBatchingEngine(tm, max_slots=3)
    _same(_serve(fixed, waves), want)
    paged = ContinuousBatchingEngine(tm, kv_pool=dict(PLAN),
                                     prefix_cache="auto")
    assert paged.max_slots == 3 and paged.kv_pool.k.device.type == "cpu"
    _same(_serve(paged, waves), want)
    # the second wave's shared head came from the radix tree, and the
    # first wave's from live prefix sharing
    assert paged.prefix_cache.hits > 0 and \
        paged.prefix_cache.hit_tokens >= 8
    assert paged.kv_pool.prefix_hits > 0
    paged.kv_pool.assert_drained()
    assert budget_drift(paged.kv_pool, tm) == []
    # greedy rows equal per-sequence generate()
    for p, kw, out in zip(waves[0], KW, want[0]):
        if kw.get("decode_strategy") is None:
            ref = tm.generate(p[None], max_length=kw["max_length"])[0]
            np.testing.assert_array_equal(out, ref)
    # what crossed per decode step, in one int64 copy up: ids and lengths
    # (2 x 3 slots), the active and the sampling rows and, paged, the
    # page-index table (3 slots x lpad / 4-token pages); down: the rows'
    # argmax and each sampling row's 64 fp32 logits
    for eng, page_tokens in ((fixed, None), (paged, PLAN["page_tokens"])):
        for st in eng.step_log:
            pages = 3 * -(-st["lpad"] // page_tokens) if page_tokens else 0
            assert st["h2d_bytes"] == 8 * (2 * 3 + st["rows"] +
                                           st["sampling_rows"] + pages)
            assert st["d2h_bytes"] == st["rows"] * 8 + \
                st["sampling_rows"] * 64 * 4
        assert any(st["sampling_rows"] for st in eng.step_log)
        assert eng.kv_buckets <= 6 and len(eng.request_log) == 10


def test_engine_rejections_match_jax(pair, monkeypatch):
    jm, tm = pair
    small = dict(PLAN, pages=4)
    for eng_cls, m, stopped, deadline, full in (
            (JEngine, jm, JStopped, JDeadline, JQueueFull),
            (ContinuousBatchingEngine, tm, BatcherStoppedError,
             DeadlineExceededError, QueueFullError)):
        eng = eng_cls(m, kv_pool=dict(small))
        with pytest.raises(ValueError, match="beam search is whole"):
            eng.submit([2, 3], decode_strategy="beam_search")
        with pytest.raises(ValueError, match="exceeds max_position"):
            eng.submit(list(range(2, 62)), max_length=8)
        with pytest.raises(ValueError, match="can never fit"):
            eng.submit(list(range(2, 14)), max_length=8)
        with pytest.raises(stopped):
            eng.submit([2, 3], max_length=2)    # not started
        eng.start()
        try:
            with pytest.raises(deadline):
                eng.submit([2, 3], max_length=2, timeout_s=0.0) \
                    .result(timeout=60)
            eng.max_queue = 0
            with pytest.raises(full) as ei:
                eng.submit([2, 3], max_length=2)
            assert ei.value.retry_after_s > 0
        finally:
            eng.stop()
        with pytest.raises(stopped):
            eng.submit([2, 3], max_length=2)
        eng.kv_pool.assert_drained()
    with pytest.raises(ValueError, match="beam search is whole"):
        ContinuousBatchingEngine(tm).submit([2], decode_strategy="beam_search")
    # what this slice ported builds now; what is left raises, naming the
    # ROADMAP item that holds it
    spec = ContinuousBatchingEngine(tm, kv_pool=dict(PLAN),
                                    speculative="auto")
    assert spec.speculative.k == 4 and \
        spec.speculative.config.num_layers == 2
    int8 = ContinuousBatchingEngine(tm, weight_dtype="int8")
    assert int8.weight_dtype == "int8" and \
        type(int8._model.blocks[0].fc1).__name__ == "Int8Linear"
    with pytest.raises(ValueError, match="requires paged KV"):
        ContinuousBatchingEngine(tm, speculative="auto")
    with pytest.raises(ValueError, match="weight_dtype mismatch"):
        ContinuousBatchingEngine(tm, kv_pool=dict(PLAN, weight_dtype="int8"),
                                 weight_dtype="float32")
    # tp-sharded decode is ported (tests/test_torch_tp_decode.py): off a
    # process group the world is 1, which tp 2 does not divide
    for kw in ({"tp_degree": 2}, {"kv_pool": dict(PLAN, tp_degree=2)}):
        with pytest.raises(ValueError, match="does not divide"):
            ContinuousBatchingEngine(tm, **kw)
    # kv_pool="auto" sizes the pool with static.page_budget from the
    # memory budget: the same plan as the JAX engine's, and no drift
    monkeypatch.setenv("PADDLE_TPU_HBM_BYTES", str(16 * 2 ** 20))
    auto, jauto = (ContinuousBatchingEngine(tm, kv_pool="auto"),
                   JEngine(jm, kv_pool="auto"))
    assert auto.kv_pool.plan == jauto._pool.plan
    assert auto.kv_pool.num_pages == auto.kv_pool.plan["pages"] > 0
    assert budget_drift(auto.kv_pool, tm) == []
    with pytest.raises(ValueError, match="geometry mismatch"):
        ContinuousBatchingEngine(tm, kv_pool=dict(PLAN, num_heads=2,
                                                  head_dim=16))


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_generate_endpoint_replies_equal_jax_server(pair, tmp_path):
    """Three concurrent posts (one of two sequences, one sampling) and
    two malformed ones, to both servers: equal status codes and bodies
    (errors: equal status and type)."""
    jm, tm = pair
    model_dir = str(tmp_path / "bert")
    save_reference_model(model_dir, flash=False)
    waves = _prompts(seed=5)
    bodies = [
        {"input_ids": [waves[0][0].tolist(), waves[0][3].tolist()],
         "max_length": 4},
        {"input_ids": waves[0][1].tolist(), "max_length": 5,
         "decode_strategy": "sampling", "top_k": 8, "seed": 4},
        {"input_ids": waves[1][2].tolist(), "max_length": 6},
        {"input_ids": [2, 3], "decode_strategy": "beam_search"},
        {"ids": [2, 3]},
    ]
    replies = {}
    for name, srv in (
            ("jax", JServer(model_dir, generator=jm, gen_kv_pool=dict(PLAN),
                            gen_prefix_cache="auto")),
            ("port", InferenceServer(model_dir, place=CPUPlace(),
                                     generator=tm, gen_kv_pool=dict(PLAN),
                                     gen_prefix_cache="auto"))):
        srv.start()
        try:
            base = f"http://{srv.host}:{srv.port}/generate"
            got = [None] * len(bodies)

            def client(i):
                got[i] = _post(base, bodies[i])

            ts = [threading.Thread(target=client, args=(i,))
                  for i in range(3)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
            for i in range(3, len(bodies)):
                client(i)
            stats = srv.stats()
        finally:
            srv.stop()
        replies[name] = got
        assert stats["kv_pool"]["pages_total"] == PLAN["pages"]
        assert srv.engine.kv_pool.stats()["pages_reserved"] == 0
        srv.engine.kv_pool.assert_drained()
    for (jc, jb), (tc, tb) in zip(replies["jax"], replies["port"]):
        assert tc == jc
        if jc == 200:
            assert tb == jb
        else:
            assert tb["type"] == jb["type"]
    assert [c for c, _ in replies["port"]] == [200, 200, 200, 400, 400]
