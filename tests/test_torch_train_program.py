"""The BERT pretraining program built in both packages serializes equal.

`paddle_tpu_torch.models.build_bert_pretrain` against `bench.build_bert_base`
(the JAX package's): the encoder, vocab fc, cross-entropy and mean, then
append_backward (grad ops and `sum` accumulation), Adam and, with
use_amp=True, the bf16 AMP rewrite (casts, loss scaling,
check_finite_and_unscale).  Main and startup programs must be equal as
`to_dict()` and as `serialize_to_string()`, with flash and fused CE on (the
bench's BENCH_FLASH=1 / BENCH_FUSED_CE=1 switches) and with both off.
"""
import contextlib

import pytest

import bench
from paddle_tpu.core.program import _reset_unique_names as jax_reset_names
from paddle_tpu.ops import fused_xent as jfx
from paddle_tpu_torch.core.program import (_reset_unique_names as
                                           torch_reset_names)
from paddle_tpu_torch.models import build_bert_pretrain
from paddle_tpu_torch.ops import fused_xent as tfx
from test_torch_program import flash_mode

SMALL = dict(vocab=64, seq=32, hidden=64, layers_n=2, heads=4)


@contextlib.contextmanager
def fused_mode(on):
    """Set both packages' FLAGS_fused_xent, restoring it afterwards."""
    prev = (jfx.fused_xent_enabled(), tfx.fused_xent_enabled())
    jfx.enable_fused_xent(on)
    tfx.enable_fused_xent(on)
    try:
        yield
    finally:
        jfx.enable_fused_xent(prev[0])
        tfx.enable_fused_xent(prev[1])


def build_both(use_amp, kernels=True, **cfg):
    """(reference (main, startup, loss), port (main, startup, loss)) from
    the same unique-name state."""
    cfg = dict(SMALL, **cfg)
    with flash_mode(kernels), fused_mode(kernels):
        jax_reset_names()
        ref = bench.build_bert_base(use_amp=use_amp, **cfg)
        torch_reset_names()
        port = build_bert_pretrain(use_amp=use_amp, **cfg)
    return ref, port


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("use_amp", [False, True])
def test_pretrain_program_serializes_equal(use_amp, kernels):
    (jm, js, jl), (tm, ts, tl) = build_both(use_amp, kernels)
    assert jl.name == tl.name
    types = [op.type for op in tm.global_block().ops]
    assert types.count("flash_attention_grad") == \
        (SMALL["layers_n"] if kernels else 0)
    assert ("cast" in types) == use_amp
    assert "adam" in types and "softmax_with_cross_entropy_grad" in types
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    assert tm.serialize_to_string() == jm.serialize_to_string()
    assert ts.serialize_to_string() == js.serialize_to_string()
    assert tm._grad_map == jm._grad_map


def test_bench_op_counts():
    """The bench step's op mix at a small shape: 163 ops with AMP off, 230
    with AMP on (31 casts and their grads, check_finite_and_unscale, the
    loss-scaling multiply)."""
    for use_amp, n in ((False, 163), (True, 230)):
        _, (tm, ts, _) = build_both(use_amp, layers_n=2)
        types = [op.type for op in tm.global_block().ops]
        assert len(types) == n
        assert types.count("adam") == 38
        assert types.count("check_finite_and_unscale") == int(use_amp)
        assert {op.type for op in ts.global_block().ops} == \
            {"fill_constant", "uniform_random"}


def test_recompute_is_refused(monkeypatch):
    """Nothing is refused any more: FLAGS_recompute="auto" walks the
    plain backward and rewrites only over the memory budget (here an
    ample one, so the backward stays plain); checkpoints= and
    Adam(lazy_mode=True) build (tests/test_torch_recompute.py and
    tests/test_torch_sparse.py hold them against the JAX package)."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.static import layers
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = layers.data("x", [-1, 4])
        h = layers.layer_norm(layers.fc(x, 4), begin_norm_axis=1)
        loss = layers.mean(layers.fc(h, 1))
        probe = main.clone()
        static.append_backward(probe.global_block().var(loss.name))
        monkeypatch.setenv("PADDLE_TPU_HBM_BYTES", str(
            100 * static.estimate_peak_bytes(probe, batch=1)))
        set_flags({"recompute": "auto"})
        try:
            auto = main.clone()
            static.append_backward(auto.global_block().var(loss.name))
        finally:
            set_flags({"recompute": ""})
        # the plain backward (the names differ: the probe's backward
        # took the first unique suffixes)
        assert [op.type for op in auto.global_block().ops] == \
            [op.type for op in probe.global_block().ops]
        assert "optimization_barrier" not in \
            [op.type for op in auto.global_block().ops]
        pg = static.append_backward(loss, checkpoints=[h])
    assert pg and "optimization_barrier" not in \
        [op.type for op in main.global_block().ops]  # h's segment is fresh
    opt = static.Adam(1e-3, lazy_mode=True)
    assert opt._lazy_mode
