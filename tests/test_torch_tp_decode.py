"""tp-sharded decode in the port (serving/tp_decode.py, the engine, pool
and server wiring) against the JAX package on the CPU.

  * `build_decode_program` serializes equal to the JAX package's for a
    prefill, a decode and a speculative-verify bucket at tp 1, 2 and 4,
    and with the `freeze_weights_int8` stamp;
  * one 2-rank gloo world (a leader and a follower): the leader's
    forward over fixed caches matches the JAX `TPShardedDecoder` on a
    2-device mesh (logits and the rebuilt caches within 1e-5); its
    engine, with a tp-2 pool, the radix cache and a 1-layer draft
    (accepts and rollbacks), replies token-equal to the port's tp-1
    paged engine, in fp32 and with int8 weights; both pools drain; each
    rank holds half the sharded weight bytes and receives half the K/V
    cache bytes of a tp-1 feed;
  * the engine, the pool and the server take tp_degree > 1; a tp degree
    the world does not divide raises.
"""
import json

import numpy as np
import pytest
import torch

import jax

import paddle_tpu
import paddle_tpu.dygraph as jdg
from paddle_tpu.core.program import _reset_unique_names as jax_reset
from paddle_tpu.models import (GPTConfig as JGPTConfig,
                               GPTForGeneration as JGPTForGeneration,
                               GPTModel as JGPTModel)
from paddle_tpu.serving import tp_decode as jtp

from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch import dygraph
from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.core.program import _reset_unique_names as torch_reset
from paddle_tpu_torch.models import GPTConfig, GPTForGeneration, GPTModel
from paddle_tpu_torch.serving import (ContinuousBatchingEngine, PagedKVPool,
                                      tp_decode)

import torch_dist_worker
from test_torch_gpt import jax_generator_restored  # noqa: F401

CFG = dict(vocab_size=48, hidden_size=16, num_layers=2, num_heads=4,
           max_position=64, dropout=0.0)
PLAN = dict(num_layers=2, num_heads=4, head_dim=4, page_tokens=4, pages=64,
            max_slots=2, max_context=64)
BUCKETS = [(1, 0, 8), (2, 16, 1), (2, 16, 3)]
MAX_LENGTH = 6


def _pair(seed=5):
    paddle_tpu.seed(seed)
    with jdg.guard():
        jm = JGPTForGeneration(JGPTModel(JGPTConfig(**CFG)))
    jm.eval()
    with dygraph.guard(CPUPlace()):
        tm = GPTForGeneration(GPTModel(GPTConfig(**CFG)))
    tm.set_state_dict(jm.state_dict())
    tm.eval()
    return jm, tm


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("bucket", BUCKETS)
def test_decode_program_serializes_equal(tp, bucket):
    jax_reset()
    ref = jtp.build_decode_program(JGPTConfig(**CFG), *bucket, tp)
    torch_reset()
    port = tp_decode.build_decode_program(GPTConfig(**CFG), *bucket, tp)
    assert port[0].to_dict() == ref[0].to_dict()
    assert port[1:] == ref[1:]


@pytest.mark.parametrize("tp", [1, 2])
def test_int8_stamped_program_serializes_equal(tp):
    from paddle_tpu.slim.quantization import freeze_weights_int8 as jfreeze
    from paddle_tpu.static.executor import Scope as JScope
    from paddle_tpu_torch.slim.quantization import freeze_weights_int8
    from paddle_tpu_torch.static import Scope
    jm, tm = _pair()
    jsd, tsd = jm.gpt.state_dict(), tm.gpt.state_dict()
    jscope, tscope = JScope(), Scope()
    for pname, key in tp_decode._param_map(GPTConfig(**CFG)).items():
        jscope.set(pname, np.asarray(jsd[key].numpy(), np.float32))
        tscope.set(pname, tsd[key].detach().float())
    jax_reset()
    ref = jtp.build_decode_program(JGPTConfig(**CFG), 2, 16, 1, tp)[0]
    n_ref = jfreeze(ref, jscope)
    torch_reset()
    port = tp_decode.build_decode_program(GPTConfig(**CFG), 2, 16, 1, tp)[0]
    assert freeze_weights_int8(port, tscope) == n_ref == 6 * 2
    assert port.to_dict() == ref.to_dict()
    for n in tscope.keys():
        if n.endswith((".int8", ".deq_scale")):
            np.testing.assert_array_equal(tscope.get(n).numpy(),
                                          np.asarray(jscope.get(n)))


def _prompts():
    rng = np.random.RandomState(17)
    head = rng.randint(2, 48, (8,)).astype(np.int64)
    prompts = [np.concatenate([head, rng.randint(2, 48, (3,))
                               .astype(np.int64)]) for _ in range(2)]
    prompts += [rng.randint(2, 48, (n,)).astype(np.int64) for n in (3, 6)]
    prompts.append(prompts[0].copy())
    return prompts


def _step_cases():
    """A prefill (lc 0, W 8, the causal mask) and a decode / verify step
    over random caches (lc 16, W 1 and 3, padding columns masked)."""
    rng = np.random.RandomState(3)
    cases = {}
    H, Dh = CFG["num_heads"], CFG["hidden_size"] // CFG["num_heads"]
    for name, B, lc, W in (("prefill", 1, 0, 8), ("decode", 2, 16, 1),
                           ("verify", 2, 16, 3)):
        d = {"ids": rng.randint(2, 48, (B, W)).astype(np.int64),
             "off": np.array([lc - 5, lc - 2][:B], np.int64) if lc
             else np.zeros(B, np.int64)}
        mask = np.zeros((B, 1, W, lc + W), np.float32)
        if lc:
            for b in range(B):
                mask[b, 0, :, int(d["off"][b]):lc] = -1e9
            mask[..., lc:] = np.triu(np.full((W, W), -1e9, np.float32), 1)
        else:
            mask = np.triu(np.full((W, W), -1e9, np.float32), 1)
        d["mask"] = mask
        for li in range(CFG["num_layers"]):
            for kv in "kv":
                d[f"{kv}{li}"] = rng.randn(B, H, lc, Dh).astype(np.float32)
        cases[name] = d
    return cases


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpdec")
    jm, tm = _pair()
    np.savez(d / "w.npz", **{k: np.asarray(v.numpy()) for k, v in
                             jm.gpt.state_dict().items()})
    cases = _step_cases()
    np.savez(d / "step.npz", **{f"{c}/{k}": v for c, kv in cases.items()
                                for k, v in kv.items()})
    cfg = {"model": CFG, "weights": str(d / "w.npz"),
           "step": str(d / "step.npz"), "step_cases": sorted(cases),
           "plan": PLAN, "tp": 2, "max_length": MAX_LENGTH,
           "prompts": [p.tolist() for p in _prompts()]}
    tdist.spawn(torch_dist_worker.tp_decode,
                args=(str(d / "rendezvous"), str(d), cfg), nprocs=2)
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]
    return jm, tm, cases, ranks


def test_tp2_forward_matches_jax(world):
    jm, _, cases, ranks = world
    from paddle_tpu.nn import MultiHeadAttention as JMHA
    dec = jtp.TPShardedDecoder(jm, 2, places=jax.devices()[:2])
    for name, c in cases.items():
        cache = [JMHA.Cache(paddle_tpu.to_tensor(c[f"k{li}"]),
                            paddle_tpu.to_tensor(c[f"v{li}"]))
                 for li in range(CFG["num_layers"])]
        logits, caches = dec.forward(c["ids"], cache=cache,
                                     pos_offset=c["off"],
                                     attn_mask=c["mask"])
        np.testing.assert_allclose(ranks[0][name + "/logits"],
                                   logits.numpy(), rtol=1e-5, atol=1e-5)
        for li, jc in enumerate(caches):
            np.testing.assert_allclose(ranks[0][f"{name}/k{li}"],
                                       jc.k.numpy(), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(ranks[0][f"{name}/v{li}"],
                                       jc.v.numpy(), rtol=1e-5, atol=1e-5)


def _tp1_replies(tm):
    pool = PagedKVPool.from_plan(PLAN, device="cpu")
    eng = ContinuousBatchingEngine(tm, max_slots=2, kv_pool=pool).start()
    try:
        replies = [np.asarray(eng.submit(p, max_length=MAX_LENGTH)
                              .result(timeout=120)) for p in _prompts()]
    finally:
        eng.stop()
    pool.assert_drained()
    return replies


@pytest.mark.parametrize("weights", ["float32", "int8"])
def test_tp2_engine_token_equal(world, weights):
    """The equality matrix of the JAX package's tp test in one drain per
    weight dtype: greedy decode, a radix-hit resume on the page-aligned
    shared head, and speculative verify with rollbacks, all through the
    leader's engine, equal to the tp-1 paged engine token for token."""
    _, tm, _, ranks = world
    ref = _tp1_replies(tm)
    for i, want in enumerate(ref):
        np.testing.assert_array_equal(ranks[0][f"{weights}/reply{i}"], want,
                                      err_msg=f"prompt {i} diverged")
    counts = json.loads(str(ranks[0][weights + "/counts"]))
    assert counts["tp_degree"] == 2 and counts["weight_dtype"] == weights
    assert counts["radix_hits"] >= 1
    assert counts["accepted"] >= 1 and counts["rollback_cols"] >= 1
    assert counts["page_bytes_per_chip"] * 2 == counts["page_bytes"]
    # the follower ran every step the leader ran, and left on its stop
    assert int(ranks[1][weights + "/followed"]) == counts["steps"]


def test_tp2_halves_the_weight_and_cache_bytes(world):
    _, tm, cases, ranks = world
    cfg = GPTConfig(**CFG)
    h, f, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    # q/k/v/out and fc1/fc2 weights with the column-parallel biases
    sharded = L * (4 * h * h + 3 * h + 2 * h * f + f) * 4
    for r in range(2):
        assert int(ranks[r]["float32/shard_bytes"]) * 2 == sharded
    # the follower received its head slice of every cached K and V
    cache = sum(cases[n][f"{kv}{li}"].nbytes for n in ("decode", "verify")
                for kv in "kv" for li in range(L))
    assert int(ranks[0]["decode/sent"]) * 2 == sum(
        cases["decode"][f"{kv}{li}"].nbytes for kv in "kv"
        for li in range(L))
    assert int(ranks[1]["float32/bytes_received"]) >= cache // 2


def test_engine_pool_and_server_take_tp_degree(tmp_path):
    _, tm = _pair()
    pool = PagedKVPool.from_plan(dict(PLAN, tp_degree=2), device="cpu")
    assert pool.tp_degree == 2 and \
        pool.page_bytes_per_chip * 2 == pool.page_bytes
    assert pool.stats()["tp_degree"] == 2
    # outside a process group the world is 1, which tp 2 does not divide
    with pytest.raises(ValueError, match="does not divide"):
        ContinuousBatchingEngine(tm, kv_pool=pool)
    with pytest.raises(ValueError, match="tp_degree mismatch"):
        ContinuousBatchingEngine(tm, kv_pool=pool, tp_degree=1)
