"""int8 serving in the port on the CPU: int8 KV pages
(``PagedKVPool(kv_dtype="int8")``) and int8 decode matmuls
(``serving/int8_decode.py``: ``Int8Linear``, ``quantize_decode_model``),
against the JAX package's.

Pool cases (tests/test_int8_serving.py:37-125 on the port): gather
returns fp32 within the quantization error; copy-on-write copies the
scale rows and isolates the sharers; requantize-on-grow never clips;
truncate rides page ids unchanged.  Beside each, the port's int8 slabs
and scale sidecars are BITWISE the JAX pool's after the same writes (the
same rint(x / scale) and rint(q * old / new) in fp32; the port's
requantize-on-grow is branch-free, the identity where the scale did not
grow).  Engine: on the tiny GPT (weights pinned by
``paddle_tpu.seed(1234)``, as the JAX package's int8 tests pin them),
the int8 engine over int8 pages is token-equal to the fp32 engine and to
the JAX package's int8 engine (docs/serving.md's contract: EQUALITY);
``Int8Linear``'s int8 weights and scales are bitwise the JAX package's.
Tolerances otherwise: gathers within absmax / 127 (+1e-7) of the fp32
input, as the JAX tests."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.dygraph as jdg
from paddle_tpu.models import (GPTConfig as JGPTConfig,
                               GPTForGeneration as JGPTForGeneration,
                               GPTModel as JGPTModel)
from paddle_tpu.serving import (ContinuousBatchingEngine as JEngine,
                                PagedKVPool as JPool)
from paddle_tpu.serving.int8_decode import (
    quantize_decode_model as jquantize)
from paddle_tpu_torch import dygraph
from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.models import GPTConfig, GPTForGeneration, GPTModel
from paddle_tpu_torch.serving import (ContinuousBatchingEngine, Int8Linear,
                                      PagedKVPool, budget_drift,
                                      quantize_decode_model)

CFG = dict(vocab_size=48, hidden_size=16, num_layers=2, num_heads=4,
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


def _pools(pages=16, T=4, L=2, H=2, Dh=4):
    geom = dict(num_layers=L, num_heads=H, head_dim=Dh, page_tokens=T,
                num_pages=pages, kv_dtype="int8")
    return JPool(**geom), PagedKVPool(device="cpu", **geom)


def _rand_kv(rng, L, H, n, Dh, scale=1.0):
    return ((rng.randn(L, H, n, Dh) * scale).astype(np.float32),
            (rng.randn(L, H, n, Dh) * scale).astype(np.float32))


def _same_slabs(jp, tp):
    for a, b in ((jp.k, tp.k), (jp.v, tp.v), (jp.k_scale, tp.k_scale),
                 (jp.v_scale, tp.v_scale)):
        assert a.dtype == b.numpy().dtype and \
            a.tobytes() == b.numpy().tobytes()


def _gather(pool, table):
    k, v = pool.gather(table)
    return (k.numpy(), v.numpy()) if isinstance(k, torch.Tensor) \
        else (k, v)


def test_int8_pool_gather_returns_fp32_within_quant_error():
    jp, tp = _pools()
    assert tp.is_quantized and tp.k.dtype == torch.int8
    rng = np.random.RandomState(0)
    prompt = rng.randint(2, 30, (7,)).astype(np.int64)
    k, v = _rand_kv(rng, 2, 2, 7, 4)
    jt, tt = jp.open_sequence(prompt, k, v), tp.open_sequence(prompt, k, v)
    _same_slabs(jp, tp)
    kg, vg = _gather(tp, tt)
    assert kg.dtype == np.float32 and vg.dtype == np.float32
    tol = np.abs(k).max() / 127.0 + 1e-7
    np.testing.assert_allclose(kg, k, atol=tol)
    np.testing.assert_allclose(vg, v, atol=tol)
    jk, jv = jp.gather(jt)
    assert kg.tobytes() == jk.tobytes() and vg.tobytes() == jv.tobytes()
    st = tp.stats()
    assert st["kv_dtype"] == "int8" and st["quant_scale_clips"] == 0
    # int8 data plus the fp32 scale rows of K and V, per layer and head
    assert tp.page_bytes == jp.page_bytes == 2 * 2 * 2 * 4 * 4 + 2 * 2 * 2 * 4
    # the batched gather dequantizes the same way
    idx = torch.as_tensor(tp.page_index([tt], 8))
    kb, vb = tp.gather_batch(idx, 7)
    assert kb[:, 0].numpy().tobytes() == kg.tobytes()
    tp.close_sequence(tt)
    tp.assert_drained()


def test_int8_cow_copies_scales_and_isolates_sharers():
    jp, tp = _pools()
    rng = np.random.RandomState(2)
    prompt = rng.randint(2, 30, (6,)).astype(np.int64)
    k, v = _rand_kv(rng, 2, 2, 6, 4)
    kc, vc = _rand_kv(rng, 2, 2, 1, 4, scale=10.0)
    tables = {}
    for pool in (jp, tp):
        t1 = pool.open_sequence(prompt, k, v)
        t2 = pool.open_sequence(prompt, k.copy(), v.copy())
        k1_before, _ = _gather(pool, t1)
        pool.append_column(t2, kc[:, :, 0], vc[:, :, 0])
        assert pool.cow_copies == 1 and t1.pages[1] != t2.pages[1]
        k1_after, _ = _gather(pool, t1)
        np.testing.assert_array_equal(k1_before, k1_after)
        k2g, _ = _gather(pool, t2)
        np.testing.assert_allclose(k2g[:, :, 6], kc[:, :, 0],
                                   atol=10.0 / 127.0 + 1e-7)
        tables[id(pool)] = (t1, t2)
    _same_slabs(jp, tp)
    for t in tables[id(tp)]:
        tp.close_sequence(t)
    tp.assert_drained()


def test_int8_requantize_on_grow_never_clips():
    jp, tp = _pools()
    rng = np.random.RandomState(3)
    prompt = rng.randint(2, 30, (3,)).astype(np.int64)
    k, v = _rand_kv(rng, 2, 2, 3, 4, scale=0.1)
    kc, vc = _rand_kv(rng, 2, 2, 1, 4, scale=50.0)   # 500x hotter
    tables = []
    for pool in (jp, tp):
        t = pool.open_sequence(prompt, k, v, reserved=2)
        pool.append_column(t, kc[:, :, 0], vc[:, :, 0])
        tables.append(t)
    assert tp.quant_scale_clips == jp.quant_scale_clips == 0
    _same_slabs(jp, tp)
    kg, _ = _gather(tp, tables[1])
    tol = np.abs(kc).max() / 127.0 + 1e-7
    np.testing.assert_allclose(kg[:, :, :3], k, atol=tol)
    np.testing.assert_allclose(kg[:, :, 3], kc[:, :, 0], atol=tol)
    # a colder column next (it opens the second page), then one into that
    # page: no growth, the resident column stays bit for bit
    small = (kc[:, :, 0] * 0.01, vc[:, :, 0] * 0.01)
    for pool, t in zip((jp, tp), tables):
        pool.append_column(t, *small)
    before = tp.k.clone()
    for pool, t in zip((jp, tp), tables):
        pool.append_column(t, small[0] * 0.5, small[1] * 0.5)
    pid = tables[1].pages[1]
    assert torch.equal(tp.k[:, pid, :, 0], before[:, pid, :, 0])
    _same_slabs(jp, tp)
    tp.close_sequence(tables[1])
    tp.assert_drained()


def test_int8_truncate_rides_page_id_plumbing():
    jp, tp = _pools()
    rng = np.random.RandomState(4)
    prompt = rng.randint(2, 30, (5,)).astype(np.int64)
    k, v = _rand_kv(rng, 2, 2, 5, 4)
    kc, vc = _rand_kv(rng, 2, 2, 2, 4)
    t = tp.open_sequence(prompt, k, v)
    tp.append_column(t, kc[:, :, 0], vc[:, :, 0])
    tp.append_column(t, kc[:, :, 1], vc[:, :, 1])
    tp.truncate(t, 5)
    assert t.length == 5
    kg, _ = _gather(tp, t)
    assert kg.shape[2] == 5
    np.testing.assert_allclose(kg, k, atol=np.abs(k).max() / 127.0 + 1e-7)
    tp.close_sequence(t)
    tp.assert_drained()


def test_int8_plan_and_drift():
    plan = dict(num_layers=2, num_heads=2, head_dim=4, page_tokens=4,
                pages=8, max_slots=2, max_context=32, kv_dtype="int8")
    pool = PagedKVPool.from_plan(plan, device="cpu")
    assert pool.is_quantized and budget_drift(pool) == []
    pool.plan = dict(plan, kv_dtype="float32")
    assert budget_drift(pool)[0].startswith("kv_dtype: pool stores int8")


@pytest.fixture(scope="module")
def lms():
    """(JAX tiny GPT, port tiny GPT) with the same weights, pinned as the
    JAX package's int8 tests pin them."""
    paddle_tpu.seed(1234)
    with jdg.guard():
        jm = JGPTForGeneration(JGPTModel(JGPTConfig(**CFG)))
        jm.eval()
    with dygraph.guard(CPUPlace()):
        tm = GPTForGeneration(GPTModel(GPTConfig(**CFG))).eval()
    missing, unexpected = tm.set_state_dict(jm.state_dict())
    assert missing == [] and unexpected == []
    return jm, tm


def test_int8_linear_weights_bitwise_and_float_model_untouched(lms):
    jm, tm = lms
    before = {n: t.clone() for n, t in tm.gpt.state_dict().items()}
    with jdg.guard():
        jq = jquantize(jm)
    tq = quantize_decode_model(tm)
    assert tq is not tm.gpt and tq.device == tm.gpt.device
    n = 0
    for jb, tb in zip(jq.blocks, tq.blocks):
        for path in ("attn.q_proj", "attn.k_proj", "attn.v_proj",
                     "attn.out_proj", "fc1", "fc2"):
            jl, tl = jb, tb
            for part in path.split("."):
                jl, tl = getattr(jl, part), getattr(tl, part)
            assert isinstance(tl, Int8Linear)
            for buf in ("weight_int8", "weight_scale"):
                a = np.asarray(getattr(jl, buf).numpy())
                b = getattr(tl, buf).numpy()
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
            n += 1
    assert n == 6 * CFG["num_layers"]
    for name, t in tm.gpt.state_dict().items():
        assert torch.equal(t, before[name]), name
    # the op the Linear runs, against the JAX Int8Linear's
    x = np.random.RandomState(6).randn(3, 5, CFG["hidden_size"]) \
        .astype(np.float32)
    want = jq.blocks[0].fc1(paddle_tpu.to_tensor(x)).numpy()
    got = tq.blocks[0].fc1(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_int8_engine_token_equal_to_fp32_and_jax_int8_engine(lms):
    jm, tm = lms
    rng = np.random.RandomState(5)
    prompts = [rng.randint(2, 48, (n,)).astype(np.int64)
               for n in (3, 5, 7, 4)]
    plan = dict(num_layers=2, num_heads=4, head_dim=4, page_tokens=4,
                pages=48, max_slots=2, max_context=64)

    def serve(engine):
        engine.start()
        try:
            futs = [engine.submit(p, max_length=6) for p in prompts]
            return [np.asarray(f.result(timeout=120)) for f in futs]
        finally:
            engine.stop()

    fp32 = serve(ContinuousBatchingEngine(tm, kv_pool=dict(plan)))
    plan8 = dict(plan, kv_dtype="int8", weight_dtype="int8")
    eng = ContinuousBatchingEngine(tm, kv_pool=dict(plan8))
    assert eng.weight_dtype == "int8" and eng.kv_pool.is_quantized
    outs = serve(eng)
    with jdg.guard():
        want = serve(JEngine(jm, max_slots=2,
                             kv_pool=JPool.from_plan(dict(plan8))))
    for i, (a, b, c) in enumerate(zip(outs, fp32, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"prompt {i} vs fp32")
        np.testing.assert_array_equal(a, c, err_msg=f"prompt {i} vs JAX")
    assert eng.kv_pool.stats()["quant_scale_clips"] == 0
    eng.kv_pool.assert_drained()
