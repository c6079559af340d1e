"""The port's planner against the JAX package's, on the CPU.

Both packages plan the same program under the same
``PADDLE_TPU_PEAK_FLOPS``, ``PADDLE_TPU_ICI_BYTES_PER_S`` and
``PADDLE_TPU_HBM_BYTES``, with ``PADDLE_TPU_ROOFLINE_CALIBRATION=0``:
`plan_program` must choose the same knobs, with `predicted_step_ms`
equal to 1e-9 relative, and price every lattice point the same (peak
bytes, fits, FLOPs, wire bytes, verdict).  The budgets are picked away
from the band between the JAX package's fits threshold (1.10 times the
budget) and the port's (the budget over `DEVICE_SLACK`, the card's
measured / walked peak), where the two may differ by design.  `apply_plan` gives equal programs that verify clean, and a
hand-edit after it draws V504.  `page_budget` returns the JAX package's
dict for every sizing option, and `budget_drift` re-derives it.

Off the card the port has no default peak or budget: the planner raises
without the env, and no calibration is loaded unless the env names one.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.static.planner as jpl
import paddle_tpu_torch.static.planner as tpl
from test_torch_layout_analysis import b_lm
from test_torch_gpt import jax_generator_restored  # noqa: F401
from test_torch_verifier import JAX, PORT

torch.set_num_threads(2)

ENV = {"PADDLE_TPU_PEAK_FLOPS": "100e12",
       "PADDLE_TPU_ICI_BYTES_PER_S": "100e9",
       "PADDLE_TPU_HBM_BYTES": str(16 * 2 ** 30),
       "PADDLE_TPU_ROOFLINE_CALIBRATION": "0"}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)


def _bench(P):
    """A fresh (mutable) build of the small bench program (AMP, flash,
    fused CE) in package P: (main, startup, loss)."""
    import bench
    from paddle_tpu_torch.models import build_bert_pretrain
    from test_torch_program import flash_mode
    from test_torch_train_program import SMALL, fused_mode
    with flash_mode(True), fused_mode(True):
        P.reset()
        if P is JAX:
            return bench.build_bert_base(use_amp=True, **SMALL)
        return build_bert_pretrain(use_amp=True, **SMALL)


_TRACE = ("batch", "remat", "dp_shard", "zero_stage", "grad_merge",
          "bucket_mb", "ring", "tp_degree", "scan_hoist", "peak_bytes",
          "fits", "flops", "wire_bytes", "wire_bytes_per_axis",
          "effective_global_batch", "verdict")


def _same_plan(jp, tp):
    assert tp.knobs == jp.knobs
    assert tp.predicted_step_ms == pytest.approx(jp.predicted_step_ms,
                                                 rel=1e-9)
    assert len(tp.trace) == len(jp.trace)
    for jc, tc in zip(jp.trace, tp.trace):
        assert {k: tc.get(k) for k in _TRACE} == \
            {k: jc.get(k) for k in _TRACE}
        assert tc["step_ms"] == pytest.approx(jc["step_ms"], rel=1e-9)


def _slack_safe(trace, budget):
    """No candidate's peak between the two packages' fits thresholds
    (the JAX package grants 1.10 on the budget, the port charges the
    walk DEVICE_SLACK): there their verdicts differ by design."""
    from paddle_tpu_torch.static.memory_analysis import DEVICE_SLACK
    lo, hi = sorted((budget / DEVICE_SLACK, budget * 1.10))
    return all(not (lo < c["peak_bytes"] <= hi) for c in trace)


# the default lattice (remat, ZeRO dp 8 at stages 1-3, gradient merge
# 1-2 with and without the hoist) and a pinned point with small buckets
KNOBS = {
    "default": None,
    "zero_small_buckets": {"remat": (True,), "grad_merge": (2,),
                           "dp_shard": (8,), "bucket_mb": (1,)},
}


@pytest.mark.parametrize("name", sorted(KNOBS))
def test_plan_matches_and_applies_clean(name):
    knobs = KNOBS[name]
    plans, built = [], []
    for P in (JAX, PORT):
        m, s, loss = _bench(P)
        plan = P.static.plan_program(m, s, world=8, batch=8, knobs=knobs)
        P.static.apply_plan(m, s, plan)
        plans.append(plan)
        built.append((m, s, loss))
    _same_plan(*plans)
    assert _slack_safe(plans[1].trace, plans[1].hbm_budget_bytes)
    (jm, js, _), (tm, ts, tl) = built
    assert tm.to_dict() == jm.to_dict() and ts.to_dict() == js.to_dict()
    rep = PORT.static.check_program(tm, level="collective", startup=ts,
                                    fetch_list=[tl], raise_on_error=True)
    assert not rep.diagnostics, rep.render()
    assert PORT.has_applied(tm, "auto_parallel_plan")
    for cand in plans[1].trace:
        if cand["fits"]:
            assert cand["verdict"].startswith("verified"), cand


def test_tight_budget_picks_remat_in_both():
    """A budget neither package's plain program fits and both packages'
    recompute fits: bench.py's program at seq 128, 4 layers, the
    score-matrix attention, batch 32 (remat saves 2.7x of the peak)."""
    import bench
    from paddle_tpu_torch.models import build_bert_pretrain
    from paddle_tpu_torch.static.memory_analysis import DEVICE_SLACK
    from test_torch_program import flash_mode
    from test_torch_train_program import fused_mode
    cfg = dict(vocab=64, seq=128, hidden=64, layers_n=4, heads=4)
    built = {}
    with flash_mode(False), fused_mode(True):
        for P in (JAX, PORT):
            P.reset()
            built[P.name] = (bench.build_bert_base if P is JAX
                             else build_bert_pretrain)(use_amp=True, **cfg)
    m = built[PORT.name][0]
    plain = PORT.static.estimate_peak_bytes(m, batch=32)
    remat = PORT.static.estimate_peak_bytes(
        PORT.static.apply_recompute(m.clone()), batch=32)
    assert remat * DEVICE_SLACK < plain / 1.10
    tight = int((remat * DEVICE_SLACK + plain / 1.10) / 2)
    plans = [P.static.plan_program(*built[P.name][:2], world=1, batch=32,
                                   knobs={"grad_merge": (1,)},
                                   hbm_budget=tight)
             for P in (JAX, PORT)]
    _same_plan(*plans)
    assert _slack_safe(plans[1].trace, tight)
    assert plans[1].predicted_fits and plans[1].knobs["remat"] is True
    assert not next(c for c in plans[1].trace if not c["remat"])["fits"]


def test_tp_lattice_from_model_config_matches():
    geom = dict(vocab_size=64, hidden=32, num_layers=2, num_heads=4,
                seq_len=8, learning_rate=1e-2)
    knobs = {"batch": (8,), "grad_merge": (1,), "zero_stage": (1,),
             "tp_degree": (0, 2)}
    plans = []
    for P in (JAX, PORT):
        main = b_lm(P)
        plans.append(P.static.plan_program(
            main, None, world=8, knobs=dict(knobs), model_config=geom))
    _same_plan(*plans)
    assert 2 in plans[1].build_variants
    tp_cands = [c for c in plans[1].trace if c["tp_degree"] == 2]
    assert tp_cands and all(c["wire_bytes_per_axis"].get("mp", 0) > 0
                            for c in tp_cands if c["fits"])
    (jv, tv) = (plans[0].build_variants[2], plans[1].build_variants[2])
    assert tv[0].to_dict() == jv[0].to_dict()


def test_plan_drift_v504():
    m, s, _ = _bench(PORT)
    plan = PORT.static.plan_program(m, s, world=1, batch=8,
                                    knobs={"remat": (False,),
                                           "grad_merge": (1,)})
    PORT.static.apply_plan(m, s, plan)
    assert "V504" not in PORT.static.check_program(
        m, level="collective", startup=s).codes()
    PORT.static.gradient_merge(m, 4, s)   # never planned
    drifted = PORT.static.check_program(m, level="collective", startup=s)
    assert any(d.code == "V504" and "grad_merge" in d.message
               for d in drifted.errors), drifted.render()


def test_defaults_off_the_card(monkeypatch):
    """No peak without the env off the card (the planner raises rather
    than price compute at 0), the data-sheet interconnect default, and
    no calibration unless the env names one."""
    assert tpl.ici_bytes_per_chip() == 100e9
    monkeypatch.delenv("PADDLE_TPU_ICI_BYTES_PER_S")
    assert tpl.ici_bytes_per_chip() == tpl.DEFAULT_ICI_BYTES_PER_S == 450e9
    monkeypatch.delenv("PADDLE_TPU_ROOFLINE_CALIBRATION")
    assert tpl.default_calibration() is None
    if not torch.cuda.is_available():
        monkeypatch.delenv("PADDLE_TPU_PEAK_FLOPS")
        m, s, _ = _bench(PORT)
        with pytest.raises(RuntimeError, match="PADDLE_TPU_PEAK_FLOPS"):
            PORT.static.plan_program(m, s, world=1, batch=8)


def test_calibration_fit_and_load_match(tmp_path, monkeypatch):
    pairs = [{"compute_ms": c, "wire_overlap_ms": w, "wire_serial_ms": s,
              "measured_ms": m, "world": wd}
             for c, w, s, m, wd in ((1.0, 0.5, 0.2, 3.0, 1),
                                    (2.0, 0.4, 0.1, 4.5, 1),
                                    (4.0, 2.0, 1.0, 9.0, 8),
                                    (8.0, 1.0, 0.5, 15.0, 8))]
    jc, tc = jpl.calibrate(pairs), tpl.calibrate(pairs)
    assert tc.to_dict() == jc.to_dict()
    path = tmp_path / "fit.json"
    tc.save(str(path))
    monkeypatch.setenv("PADDLE_TPU_ROOFLINE_CALIBRATION", str(path))
    loaded = tpl.default_calibration()
    if tc.residual_pct < tpl.DEFAULT_CALIBRATION_RESIDUAL_PCT:
        assert loaded is not None and loaded.to_dict() == tc.to_dict()
    else:
        assert loaded is None


_CFG = {"vocab_size": 64, "hidden_size": 32, "num_layers": 2,
        "num_heads": 4, "max_position": 128}

PAGE_CASES = {
    "fp32": dict(page_tokens=16, max_context=128, hbm_bytes=4 * 2 ** 20),
    "int8_kv": dict(page_tokens=16, max_context=128,
                    hbm_bytes=4 * 2 ** 20, weight_bytes=0,
                    kv_dtype="int8"),
    "tp2_int8": dict(page_tokens=16, max_context=128, hbm_bytes=256 * 1024,
                     tp_degree=2, kv_dtype="int8"),
    "int8_weights": dict(page_tokens=8, max_context=64,
                         hbm_bytes=2 * 2 ** 20, weight_dtype="int8"),
    "draft": dict(page_tokens=4, max_context=64, hbm_bytes=2 * 2 ** 20,
                  draft_layers=1, max_slots_cap=8, headroom=0.1),
    "env_budget": dict(page_tokens=16),
}
ENV_PAGE_BUDGET = str(3 * 2 ** 20)


@pytest.mark.parametrize("name", sorted(PAGE_CASES))
def test_page_budget_matches_and_drift_rederives(name, monkeypatch):
    from paddle_tpu_torch.serving import PagedKVPool, budget_drift
    monkeypatch.setenv("PADDLE_TPU_HBM_BYTES", ENV_PAGE_BUDGET)
    kw = PAGE_CASES[name]
    got = tpl.page_budget(config=dict(_CFG), **kw)
    assert got == jpl.page_budget(config=dict(_CFG), **kw)
    pool = PagedKVPool.from_plan(dict(got), device="cpu")
    assert budget_drift(pool) == []
    # a hand-resized pool or a hand-edited watermark is drift
    pool.num_pages += 1
    assert any(d.startswith("pages: pool has")
               for d in budget_drift(pool))
    pool.num_pages -= 1
    pool.plan["retained_watermarks"]["low"] += 1
    assert any("retained_watermarks.low" in d for d in budget_drift(pool))


def test_page_budget_from_a_model_matches():
    from test_torch_gpt import tiny_pair
    jm, tm = tiny_pair(seed=3)
    kw = dict(page_tokens=4, max_context=32, hbm_bytes=2 * 2 ** 20)
    assert tpl.page_budget(tm, **kw) == jpl.page_budget(jm, **kw)
    assert tpl.page_budget(tm, **kw)["weight_bytes"] == sum(
        int(np.prod(p.shape)) * 4 for p in tm.parameters())
