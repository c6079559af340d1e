"""The port's liveness walk against the JAX package's, byte for byte, and
FLAGS_recompute="auto" as a whole against the JAX package's.

Each program is built in both packages (equal program JSON);
`analyze_program` must give the same peak bytes, per-phase peaks,
persistable / slot / parameter bytes, peak op and top live vars, with and
without the ZeRO and tensor-parallel predictions; the alias, fusable and
grad-release tables are the same, and so is every (grad op, slot)
release verdict the registry drives.  Both packages run under the same
``PADDLE_TPU_HBM_BYTES`` (the port has no default budget off the card).

The slice: bench.py's CPU shape (seq 128, batch 2, 2 layers, hidden 256,
vocab 1024, AMP) built under FLAGS_recompute="auto" with a budget on
each side of the walker's peak gives the JAX package's plain or
"always" program (the JAX "auto" program up to the gradient suffixes its
estimate consumed), and three trained steps stay within
tests/test_torch_train.py's loss tolerance of the JAX package's (rtol
3e-3).
"""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu.static.memory_analysis as jma
import paddle_tpu_torch.static.memory_analysis as tma
from paddle_tpu.core.flags import set_flags as jax_set_flags
from paddle_tpu_torch.core.flags import set_flags as torch_set_flags
from paddle_tpu_torch.io import load_params_from_numpy
from test_torch_layout_analysis import b_lm
from test_torch_verifier import JAX, PORT, build_sharded

torch.set_num_threads(2)

VOCAB, SEQ, HIDDEN, HEADS = 128, 16, 32, 2
BUDGET = str(16 * 2 ** 30)


@pytest.fixture(autouse=True)
def _budget(monkeypatch):
    monkeypatch.setenv(tma.HBM_BUDGET_ENV, BUDGET)


@contextlib.contextmanager
def both_flags(**flags):
    """Set FLAGS_* in both packages, restoring the defaults after."""
    jax_set_flags(flags)
    torch_set_flags(flags)
    try:
        yield
    finally:
        reset = {k: ("" if isinstance(v, str) else 0)
                 for k, v in flags.items()}
        jax_set_flags(reset)
        torch_set_flags(reset)


def toy_transformer(P, layers_n=2, remat=False):
    """tests/test_memory_analysis.py's toy transformer in package P."""
    P.reset()
    L, nets = P.layers, P.static.nets
    with both_flags(recompute="always" if remat else ""):
        main, startup = P.static.Program(), P.static.Program()
        with P.static.program_guard(main, startup):
            ids = L.data("ids", [-1, SEQ], dtype="int64")
            labels = L.data("labels", [-1, SEQ, 1], dtype="int64")
            h = L.embedding(ids, size=[VOCAB, HIDDEN])
            h = L.layer_norm(h, begin_norm_axis=2)
            for _ in range(layers_n):
                q = L.fc(h, HIDDEN, num_flatten_dims=2)
                k = L.fc(h, HIDDEN, num_flatten_dims=2)
                v = L.fc(h, HIDDEN, num_flatten_dims=2)
                ctx = nets.scaled_dot_product_attention(q, k, v,
                                                        num_heads=HEADS)
                h = L.layer_norm(L.elementwise_add(h, ctx),
                                 begin_norm_axis=2)
                ffn = L.fc(h, HIDDEN * 2, num_flatten_dims=2, act="gelu")
                h = L.layer_norm(L.elementwise_add(
                    h, L.fc(ffn, HIDDEN, num_flatten_dims=2)),
                    begin_norm_axis=2)
            logits = L.fc(h, VOCAB, num_flatten_dims=2)
            loss = L.mean(L.softmax_with_cross_entropy(logits, labels))
            P.static.Adam(learning_rate=1e-3).minimize(loss)
    return main


_BENCH = {}


def bench_program(P, use_amp, kernels, **cfg):
    """bench.py's pretraining program in package P, built once a
    configuration (callers only read it)."""
    from test_torch_train_program import build_both
    key = (use_amp, kernels, tuple(sorted(cfg.items())))
    if key not in _BENCH:
        (jm, _, _), (tm, _, _) = build_both(use_amp, kernels, **cfg)
        _BENCH[key] = (jm, tm)
    return _BENCH[key][0 if P is JAX else 1]


PROGRAMS = {
    "toy": (toy_transformer, {}),
    "toy_remat": (lambda P: toy_transformer(P, remat=True), {}),
    "toy_dp8_stage1": (toy_transformer, dict(dp_shard=8, zero_stage=1)),
    "toy_dp8_stage3": (toy_transformer, dict(dp_shard=8, zero_stage=3)),
    "bench_fp32": (lambda P: bench_program(P, False, True), {}),
    "bench_amp": (lambda P: bench_program(P, True, True), {}),
    "bench_amp_unfused": (lambda P: bench_program(P, True, False), {}),
    "zero3_applied": (lambda P: build_sharded(P, stage=3)[0], {}),
    "zero2_gm_applied": (lambda P: build_sharded(P, stage=2, gm=2)[0], {}),
    "tp_lm": (b_lm, dict(tp_degree=2)),
}

_COMPARED = ("batch", "dp_shard", "tp_degree", "persistable_bytes",
             "optimizer_slot_bytes", "parameter_bytes",
             "activation_peak_bytes", "peak_bytes", "phase_peaks",
             "peak_op_index", "peak_op_type", "top_live", "n_ops",
             "n_unknown_vars", "budget_bytes")


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_analyze_program_matches_byte_for_byte(name):
    build, kw = PROGRAMS[name]
    jm, tm = build(JAX), build(PORT)
    assert tm.to_dict() == jm.to_dict()
    for batch in (1, 8):
        jr = JAX.static.analyze_program(jm, batch=batch, **kw)
        tr = PORT.static.analyze_program(tm, batch=batch, **kw)
        assert {k: tr[k] for k in _COMPARED} == \
            {k: jr[k] for k in _COMPARED}
        assert tr["peak_bytes"] == max(tr["phase_peaks"].values())
    assert PORT.static.estimate_peak_bytes(tm, batch=4) == \
        JAX.static.estimate_peak_bytes(jm, batch=4)
    if "tp_degree" in kw:
        assert tma.mp_sharded_vars(tm, 2) == jma.mp_sharded_vars(jm, 2)


def test_release_tables_and_verdicts_match():
    for table in ("_ALIAS_OPS", "_FUSABLE_OPS", "_GRAD_RELEASED_INPUTS",
                  "_GRAD_KEPT_OUTPUTS", "_DERIVED_MARKERS",
                  "_ATTENTION_CORE_OPS"):
        assert getattr(tma, table) == getattr(jma, table), table
    # every (op, slot) use in the bench programs gets the same verdict
    for use_amp in (False, True):
        jm, tm = (bench_program(P, use_amp, True) for P in (JAX, PORT))
        for jop, top in zip(jm.global_block().ops, tm.global_block().ops):
            for slot in top.inputs:
                assert tma._use_released(top.type, slot) == \
                    jma._use_released(jop.type, slot), (top.type, slot)


def test_budget_slack_and_no_card(monkeypatch):
    """The budget comes from the env or the card; with neither the port
    raises (no default constant).  `fits` holds peak x DEVICE_SLACK to
    the budget."""
    main = toy_transformer(PORT)
    peak = PORT.static.estimate_peak_bytes(main, batch=8)
    monkeypatch.setenv(tma.HBM_BUDGET_ENV, str(peak * 4))
    rep = PORT.static.analyze_program(main, batch=8)
    assert rep["fits"] is True and rep["budget_bytes"] == peak * 4
    assert rep["fits_budget_bytes"] == int(peak * 4 / tma.DEVICE_SLACK)
    monkeypatch.setenv(tma.HBM_BUDGET_ENV, str(peak // 4))
    assert PORT.static.analyze_program(main, batch=8)["fits"] is False
    monkeypatch.delenv(tma.HBM_BUDGET_ENV)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="PADDLE_TPU_HBM_BYTES"):
            PORT.static.hbm_budget_bytes()
        # an explicit budget needs neither
        assert PORT.static.analyze_program(main, batch=8,
                                           budget_bytes=peak)["fits"] \
            == (peak * tma.DEVICE_SLACK <= peak)


def test_memory_report_estimate():
    main = toy_transformer(PORT)
    exe = PORT.static.Executor(PORT.static.CPUPlace())
    rep = exe.memory_report(main, batch=16)
    assert rep["peak_bytes"] == PORT.static.estimate_peak_bytes(main,
                                                                batch=16)
    assert rep["device"] is None and rep["estimate"]["batch"] == 16


BENCH_CPU = dict(vocab=1024, seq=128, hidden=256, layers_n=2, heads=4)
BATCH = 2


def _auto_build(P, budget, monkeypatch):
    from test_torch_train_program import build_both
    monkeypatch.setenv(tma.HBM_BUDGET_ENV, str(budget))
    with both_flags(recompute="auto", hbm_assume_batch=BATCH):
        (jm, js, jl), (tm, ts, tl) = build_both(True, kernels=False,
                                                **BENCH_CPU)
    return (jm, js, jl), (tm, ts, tl)


def _canon_grad_names(d):
    """A program dict with every gradient's unique suffix renumbered in
    order of first appearance (per base var): two programs that differ
    only in which ``x@GRAD_<n>`` suffixes the name counters handed out
    compare equal."""
    import json
    import re
    seen = {}

    def renum(m):
        base, n = m.group(1), m.group(2)
        idx = seen.setdefault(base, {})
        return f"{base}@GRAD_{idx.setdefault(n, len(idx))}"
    text = re.sub(r"([^\"\s@]+)@GRAD_(\d+)", renum,
                  json.dumps(d, sort_keys=True))
    return json.loads(text)


def test_recompute_auto_matches_reference_on_both_sides_of_the_budget(
        monkeypatch):
    from test_torch_train_program import build_both
    from test_torch_dygraph_train import assert_loss_trace
    (jp, _, _), (tp, _, _) = build_both(True, kernels=False, **BENCH_CPU)
    with both_flags(recompute="always"):
        (ja, _, _), (ta, _, _) = build_both(True, kernels=False,
                                            **BENCH_CPU)
    assert ta.to_dict() == ja.to_dict() != tp.to_dict()
    peak = PORT.static.estimate_peak_bytes(tp, batch=BATCH)
    # an ample budget leaves the program plain, a tight one rewrites it
    # at the layer checkpoints exactly as "always" does.  The port's
    # estimate leaves the unique-name counters untouched, the JAX
    # package's advances them (its "auto" program names each gradient
    # one suffix later), so the port's "auto" program is the JAX
    # package's plain / "always" build, and the JAX "auto" program is
    # that build up to those suffixes and nothing else
    for budget, want in ((4 * peak, jp), (peak // 4, ja)):
        (jm, js, jl), (tm, ts, tl) = _auto_build(PORT, budget, monkeypatch)
        assert tm.to_dict() == want.to_dict()
        assert jm.to_dict() != want.to_dict()
        assert _canon_grad_names(jm.to_dict()) == \
            _canon_grad_names(tm.to_dict())
    assert "optimization_barrier" in {op.type
                                      for op in tm.global_block().ops}
    # three trained steps of the rewritten program against the reference
    rng = np.random.RandomState(3)
    seq, vocab = BENCH_CPU["seq"], BENCH_CPU["vocab"]
    feed = {"ids": rng.randint(0, vocab, (BATCH, seq)),
            "pos": np.tile(np.arange(seq), (BATCH, 1)),
            "labels": rng.randint(0, vocab, (BATCH, seq, 1))}
    feed = {k: v.astype(np.int64) for k, v in feed.items()}
    jscope, jexe = JAX.static.Scope(), JAX.static.Executor()
    with JAX.static.scope_guard(jscope):
        jexe.run(js)
    init = {n: np.asarray(jscope.find_var(n).get_tensor())
            for n in jscope.vars
            if jscope.find_var(n).get_tensor() is not None}
    tscope = PORT.static.Scope()
    load_params_from_numpy(tscope, init, PORT.static.CPUPlace())
    texe = PORT.static.Executor(PORT.static.CPUPlace())
    ref, got = [], []
    with JAX.static.scope_guard(jscope):
        for _ in range(3):
            (lv,) = jexe.run(jm, feed=feed, fetch_list=[jl])
            ref.append(float(np.asarray(lv).reshape(-1)[0]))
    with PORT.static.scope_guard(tscope):
        for _ in range(3):
            (lv,) = texe.run(tm, feed=feed, fetch_list=[tl])
            got.append(float(np.asarray(lv).reshape(-1)[0]))
    assert_loss_trace(got, ref, rtol=3e-3)
