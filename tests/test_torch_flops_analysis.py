"""The port's FLOPs walk against the JAX package's, exactly.

Each program is built in both packages (equal program JSON);
`analyze_flops` must give the same total, `by_class`, `phase_flops` and
per-op rows at every batch, and the cost tables are the JAX package's.
(chip_smoke.py phase 18 holds the walk at BERT-base's published width to
bench.py's analytic count.)  The peak rate is the env's, else the H100's
data-sheet figure on a card, else 0.
"""
import pytest
import torch

import paddle_tpu.static.flops_analysis as jfa
import paddle_tpu_torch.static.flops_analysis as tfa
from test_torch_layout_analysis import b_lm
from test_torch_memory_analysis import bench_program, toy_transformer
from test_torch_verifier import JAX, PORT, build_sharded

torch.set_num_threads(2)

PROGRAMS = {
    "toy": toy_transformer,
    "toy_remat": lambda P: toy_transformer(P, remat=True),
    "bench_fp32": lambda P: bench_program(P, False, True),
    "bench_amp": lambda P: bench_program(P, True, True),
    "bench_amp_unfused": lambda P: bench_program(P, True, False),
    "zero3": lambda P: build_sharded(P, stage=3)[0],
    "tp_lm": b_lm,
}

_KEYS = ("total_flops", "by_class", "phase_flops", "per_op")


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_analyze_flops_matches_exactly(name):
    jm, tm = PROGRAMS[name](JAX), PROGRAMS[name](PORT)
    assert tm.to_dict() == jm.to_dict()
    for batch in (1, 4):
        jr = JAX.static.analyze_flops(jm, batch=batch)
        tr = PORT.static.analyze_flops(tm, batch=batch)
        assert {k: tr[k] for k in _KEYS} == {k: jr[k] for k in _KEYS}
        assert tr == jr
    assert PORT.static.estimate_step_flops(tm, batch=4) == \
        JAX.static.estimate_step_flops(jm, batch=4)


def test_cost_tables_match():
    for table in ("_MATMUL_OPS", "_ATTENTION_OPS", "_EMBEDDING_OPS",
                  "_CONV_OPS", "_OPTIMIZER_FLOPS_PER_ELEM",
                  "_ELEMENTWISE_FLOPS_PER_ELEM", "_FREE_OPS"):
        assert getattr(tfa, table) == getattr(jfa, table), table
    assert tfa.INT8_MXU_RATE == 2.0


def test_peak_flops(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "123e9")
    assert tfa.peak_flops_per_chip() == 123e9
    monkeypatch.delenv("PADDLE_TPU_PEAK_FLOPS")
    assert tfa.peak_flops_per_chip() == (
        tfa.H100_BF16_DENSE_PEAK_FLOPS if torch.cuda.is_available()
        else 0.0)
    assert tfa.H100_BF16_DENSE_PEAK_FLOPS == 989e12
