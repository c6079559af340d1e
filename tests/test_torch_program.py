"""The small BERT encoder program built in both packages serializes equal.

paddle_tpu builds the forward part of `bench.build_bert_base` (stopped at
the final layer_norm); the port builds it with
`paddle_tpu_torch.models.build_bert_base(use_amp=False)`.  With flash on
and with flash off, the main and startup programs' `to_dict()` must be
equal: op types, attrs, var names, shapes and dtypes.
"""
import contextlib

import pytest

from paddle_tpu.core.program import _reset_unique_names as jax_reset_names
from paddle_tpu.ops import attention as jattn
from paddle_tpu_torch.core.program import (_reset_unique_names as
                                           torch_reset_names)
from paddle_tpu_torch.models import build_bert_base
from paddle_tpu_torch.ops import attention as tattn

SMALL = dict(vocab=64, seq=32, hidden=64, layers_n=2, heads=4)


def build_ref_bert(vocab, seq, hidden, layers_n, heads):
    """bench.build_bert_base's forward part, in paddle_tpu."""
    import paddle_tpu.static as static
    from paddle_tpu.static import layers, nets

    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        ids = layers.data("ids", [-1, seq], dtype="int64")
        pos = layers.data("pos", [-1, seq], dtype="int64")
        emb = layers.embedding(ids, size=[vocab, hidden])
        pemb = layers.embedding(pos, size=[seq, hidden])
        h = layers.elementwise_add(emb, pemb)
        h = layers.layer_norm(h, begin_norm_axis=2)
        for _ in range(layers_n):
            q = layers.fc(h, hidden, num_flatten_dims=2)
            k = layers.fc(h, hidden, num_flatten_dims=2)
            v = layers.fc(h, hidden, num_flatten_dims=2)
            ctx = nets.scaled_dot_product_attention(q, k, v, num_heads=heads)
            attn_out = layers.fc(ctx, hidden, num_flatten_dims=2)
            h = layers.layer_norm(layers.elementwise_add(h, attn_out),
                                  begin_norm_axis=2)
            ffn = layers.fc(h, hidden * 4, num_flatten_dims=2, act="gelu")
            ffn = layers.fc(ffn, hidden, num_flatten_dims=2)
            h = layers.layer_norm(layers.elementwise_add(h, ffn),
                                  begin_norm_axis=2)
    return main, startup, h


@contextlib.contextmanager
def flash_mode(on):
    """Force both packages' flash dispatch, restoring it afterwards."""
    prev = (jattn._FLASH_STATE["mode"], tattn._FLASH_STATE["mode"])
    jattn.enable_flash_attention(on)
    tattn.enable_flash_attention(on)
    try:
        yield
    finally:
        jattn._FLASH_STATE["mode"], tattn._FLASH_STATE["mode"] = prev


def build_both(flash, **cfg):
    """(reference (main, startup, out), port (main, startup, out)), built
    from the same unique-name state so var names line up."""
    cfg = dict(SMALL, **cfg)
    with flash_mode(flash):
        jax_reset_names()
        ref = build_ref_bert(**cfg)
        torch_reset_names()
        port = build_bert_base(use_amp=False, **cfg)
    return ref, port


@pytest.mark.parametrize("flash", [True, False])
def test_bert_program_serializes_equal(flash):
    (jm, js, jh), (tm, ts, th) = build_both(flash)
    assert jh.name == th.name
    types = [op.type for op in tm.global_block().ops]
    assert ("flash_attention" in types) == flash
    assert ("softmax" in types) != flash
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    assert tm.serialize_to_string() == jm.serialize_to_string()


def test_program_json_round_trip_between_packages():
    from paddle_tpu.core.program import Program as JProgram
    from paddle_tpu_torch.core.program import Program as TProgram
    (jm, _, _), (tm, _, _) = build_both(True)
    assert TProgram.parse_from_string(jm.serialize_to_string()).to_dict() \
        == jm.to_dict()
    assert JProgram.parse_from_string(tm.serialize_to_string()).to_dict() \
        == tm.to_dict()
    # the binary form crosses too (tests/test_torch_serialization.py
    # holds it message by message)
    assert TProgram.parse_from_string(
        jm.serialize_to_string(format="proto")).to_dict() == jm.to_dict()
    assert JProgram.parse_from_string(
        tm.serialize_to_string(format="proto")).to_dict() == tm.to_dict()


def test_builder_refuses_unported_options():
    with pytest.raises(NotImplementedError, match="AMP"):
        build_bert_base(**SMALL)
    # ring attention is ported (tests/test_torch_sequence_parallel.py):
    # use_ring builds, with a ring_attention op a layer
    main = build_bert_base(use_amp=False, use_ring=True, **SMALL)[0]
    assert [op.type for op in main.global_block().ops].count(
        "ring_attention") == SMALL["layers_n"]
