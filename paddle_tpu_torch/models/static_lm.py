"""Static-graph transformer LM builder with optional tensor parallelism.

Counterpart of paddle_tpu/models/static_lm.py; it builds the JAX
package's program op for op.  The tensor-parallel and the
sequence-parallel programs run under CompiledProgram with one process a
rank.  The text below is the JAX package's.

The v5e-32-scale rehearsal config: assembles embedding → N pre-LN
transformer blocks → LM head as ONE static Program.  With
`tensor_parallel_degree > 1` every block uses the Megatron layers
(distributed/tensor_parallel.py): column/row-parallel attention + MLP,
weights annotated for the "tp" mesh axis — run it under
CompiledProgram(BuildStrategy.tensor_parallel_degree=tp) or through
fleet's DistributedStrategy.tensor_parallel.

(The dygraph model families live in models/gpt.py / models/bert.py; this
is the static counterpart the ERNIE-style pretrain configs use.)
"""
from __future__ import annotations

from ..static import layers

__all__ = ["build_transformer_lm"]


def build_transformer_lm(vocab_size, hidden, num_layers, num_heads, seq_len,
                         tensor_parallel_degree=1,
                         sequence_parallel=False):
    """Returns (main_program, startup_program, loss, logits); feeds are
    int64 `ids` [batch, seq_len], `pos` [batch, seq_len] (position ids,
    typically np.tile(np.arange(seq_len), (batch, 1))), and `labels`
    [batch, seq_len, 1].

    Attention is BIDIRECTIONAL (BERT/ERNIE-style MLM rehearsal — the
    bench's north-star config): feed masked-token labels, not shifted
    next-token labels.  For causal decoding use models.GPTModel.

    ``sequence_parallel=True`` routes every layer's attention through
    the `ring_attention` op: run the program via
    ``CompiledProgram(BuildStrategy.sequence_parallel_degree=n)`` and
    the sequence dim shards over the "sp" mesh axis with K/V rotating
    around the ring (the long-context path — no S² scores tensor).  On
    a single device the op degrades to plain attention, so the same
    program also runs for CPU debugging.  Composes with
    FLAGS_recompute auto-remat (checkpoints select at layer boundaries
    around the ring op like any attention core)."""
    from .. import static
    from ..distributed.tensor_parallel import (parallel_attention,
                                               col_parallel_fc,
                                               row_parallel_fc)
    from ..static import nets

    tp = max(1, int(tensor_parallel_degree))
    if sequence_parallel and tp > 1:
        raise ValueError("sequence_parallel and tensor_parallel_degree>1 "
                         "cannot combine in one program (mesh has one "
                         "model axis; see CompiledProgram._get_mesh)")
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        ids = layers.data("ids", [-1, seq_len], dtype="int64")
        pos = layers.data("pos", [-1, seq_len], dtype="int64")
        labels = layers.data("labels", [-1, seq_len, 1], dtype="int64")
        h = layers.elementwise_add(
            layers.embedding(ids, size=[vocab_size, hidden]),
            layers.embedding(pos, size=[seq_len, hidden]))
        for _ in range(num_layers):
            a_in = layers.layer_norm(h, begin_norm_axis=2)
            if tp > 1:
                attn = parallel_attention(a_in, hidden, num_heads, tp)
            else:
                q = layers.fc(a_in, hidden, num_flatten_dims=2)
                k = layers.fc(a_in, hidden, num_flatten_dims=2)
                v = layers.fc(a_in, hidden, num_flatten_dims=2)
                ctx = nets.scaled_dot_product_attention(
                    q, k, v, num_heads=num_heads,
                    sequence_parallel=sequence_parallel)
                attn = layers.fc(ctx, hidden, num_flatten_dims=2)
            h = layers.elementwise_add(h, attn)
            m_in = layers.layer_norm(h, begin_norm_axis=2)
            if tp > 1:
                m = col_parallel_fc(m_in, hidden * 4, num_flatten_dims=2,
                                    act="gelu", tp_degree=tp)
                m = row_parallel_fc(m, hidden, num_flatten_dims=2,
                                    tp_degree=tp)
            else:
                m = layers.fc(m_in, hidden * 4, num_flatten_dims=2,
                              act="gelu")
                m = layers.fc(m, hidden, num_flatten_dims=2)
            h = layers.elementwise_add(h, m)
        h = layers.layer_norm(h, begin_norm_axis=2)
        logits = layers.fc(h, vocab_size, num_flatten_dims=2)
        loss = layers.mean(
            layers.softmax_with_cross_entropy(logits, labels))
    return main, startup, loss, logits
