"""BERT-base programs of the repository's bench.py (JAX package).

  * `build_bert_pretrain` is the counterpart of `bench.build_bert_base`
    whole: the encoder, the vocab fc, softmax_with_cross_entropy, mean,
    then Adam (bf16 AMP with `use_amp=True`) through minimize.  It returns
    (main, startup, loss).
  * `build_bert_base` is its forward part only, stopped at the final
    layer_norm: the sequence output [B, seq, hidden] that a BERT encoder
    server returns (the serving slice).

Same signatures and layer calls as bench.py.  Build under
`ops.attention.enable_flash_attention(True)` to emit the flash_attention
op (or with flash off for the score-matrix graph), and with
`ops.fused_xent.enable_fused_xent(True)` for the fused cross-entropy, as
bench.py's BENCH_FLASH=1 and BENCH_FUSED_CE=1 switches do.

Published BERT-base width: vocab 30522, seq 512, hidden 768, 12 layers,
12 heads (head_dim 64), intermediate 3072 (4 x hidden).
"""
from __future__ import annotations

__all__ = ["build_bert_base", "build_bert_pretrain"]


def _encoder(ids, pos, vocab, seq, hidden, layers_n, heads, use_ring):
    from ..static import layers, nets
    emb = layers.embedding(ids, size=[vocab, hidden])
    pemb = layers.embedding(pos, size=[seq, hidden])
    h = layers.elementwise_add(emb, pemb)
    h = layers.layer_norm(h, begin_norm_axis=2)
    for _ in range(layers_n):
        q = layers.fc(h, hidden, num_flatten_dims=2)
        k = layers.fc(h, hidden, num_flatten_dims=2)
        v = layers.fc(h, hidden, num_flatten_dims=2)
        ctx = nets.scaled_dot_product_attention(
            q, k, v, num_heads=heads, sequence_parallel=use_ring)
        attn_out = layers.fc(ctx, hidden, num_flatten_dims=2)
        h = layers.layer_norm(layers.elementwise_add(h, attn_out),
                              begin_norm_axis=2)
        ffn = layers.fc(h, hidden * 4, num_flatten_dims=2, act="gelu")
        ffn = layers.fc(ffn, hidden, num_flatten_dims=2)
        h = layers.layer_norm(layers.elementwise_add(h, ffn),
                              begin_norm_axis=2)
    return h


def build_bert_pretrain(vocab=30522, seq=512, hidden=768, layers_n=12,
                        heads=12, batch=8, use_amp=True, use_ring=False):
    """bench.build_bert_base: returns (main, startup, loss).  Feeds: ids,
    pos [B, seq] int64 and labels [B, seq, 1] int64.  `batch` is accepted
    for signature parity (the batch dim is dynamic); `use_ring=True`
    emits the ring_attention op for every layer's attention (run it under
    a CompiledProgram with BuildStrategy.sequence_parallel_degree)."""
    from .. import amp, static
    from ..static import layers

    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        ids = layers.data("ids", [-1, seq], dtype="int64")
        pos = layers.data("pos", [-1, seq], dtype="int64")
        labels = layers.data("labels", [-1, seq, 1], dtype="int64")
        h = _encoder(ids, pos, vocab, seq, hidden, layers_n, heads, use_ring)
        logits = layers.fc(h, vocab, num_flatten_dims=2)
        loss = layers.mean(
            layers.softmax_with_cross_entropy(logits, labels))
        opt = static.Adam(learning_rate=1e-4)
        if use_amp:
            # bf16 compute, fp32 master weights; bf16 shares fp32's
            # exponent range, so no dynamic loss scaling
            opt = amp.decorate(opt, init_loss_scaling=1.0,
                               use_dynamic_loss_scaling=False,
                               dest_dtype="bfloat16")
        opt.minimize(loss)
    return main, startup, loss


def build_bert_base(vocab=30522, seq=512, hidden=768, layers_n=12, heads=12,
                    batch=8, use_amp=True, use_ring=False):
    """The forward part of bench.build_bert_base (build_bert_pretrain is
    the whole): returns (main, startup, sequence_output).  `batch` is
    accepted for signature parity; `use_amp=True` raises (the encoder is
    served in fp32); `use_ring=True` emits the ring_attention op."""
    from .. import static
    from ..static import layers

    if use_amp:
        raise NotImplementedError(
            "build_bert_base(use_amp=True): the encoder program is served "
            "in fp32; build_bert_pretrain holds the AMP training program")
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        ids = layers.data("ids", [-1, seq], dtype="int64")
        pos = layers.data("pos", [-1, seq], dtype="int64")
        h = _encoder(ids, pos, vocab, seq, hidden, layers_n, heads, use_ring)
    return main, startup, h
