"""Composite nets of paddle_tpu/static/nets.py: the image builders
`simple_img_conv_pool` (conv2d then pool2d) and `img_conv_group` (conv2d
[+ batch_norm [+ dropout]] a filter count, then pool2d), and the
attention builders.

`attention_core` emits the `flash_attention` op when
`ops.attention.use_flash_for(seq)` holds and there is no attention
dropout, else the score-matrix graph (scale -> matmul -> softmax ->
[dropout] -> matmul), exactly as the JAX package does.
`scaled_dot_product_attention(sequence_parallel=True)` emits the
`ring_attention` op.
"""
from __future__ import annotations

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group",
           "scaled_dot_product_attention", "attention_core"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    conv_out = layers.conv2d(input, num_filters, filter_size,
                             stride=conv_stride, padding=conv_padding,
                             dilation=conv_dilation, groups=conv_groups,
                             param_attr=param_attr, bias_attr=bias_attr,
                             act=act)
    return layers.pool2d(conv_out, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride, pool_padding=pool_padding,
                         global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    tmp = input
    if isinstance(conv_num_filter, int):
        conv_num_filter = [conv_num_filter]
    n = len(conv_num_filter)

    def _expand(v):
        return v if isinstance(v, (list, tuple)) else [v] * n

    padding = _expand(conv_padding)
    fsize = _expand(conv_filter_size)
    with_bn = _expand(conv_with_batchnorm)
    drop = _expand(conv_batchnorm_drop_rate)
    pattr = param_attr if isinstance(param_attr, (list, tuple)) \
        else [param_attr] * n
    for i in range(n):
        local_act = conv_act if not with_bn[i] else None
        tmp = layers.conv2d(tmp, conv_num_filter[i], fsize[i],
                            padding=padding[i], param_attr=pattr[i],
                            act=local_act)
        if with_bn[i]:
            tmp = layers.batch_norm(tmp, act=conv_act)
            if drop[i] > 0:
                tmp = layers.dropout(tmp, dropout_prob=drop[i])
    return layers.pool2d(tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def attention_core(q, k, v, d_key, dropout_rate=0.0, merge_shape=None):
    """Attention over already-head-split [b, h, t, d] tensors; dispatches
    to the flash op when enabled.  Returns merged [b, t, h*d]."""
    from ..ops.attention import use_flash_for
    seq = q.shape[2] if q.shape is not None and len(q.shape) > 2 else None
    seq = seq if isinstance(seq, int) and seq > 0 else None
    if use_flash_for(seq) and not dropout_rate:
        helper = layers.LayerHelper("flash_attention")
        ctx = helper.create_variable_for_type_inference(q.dtype)
        ctx.shape = tuple(q.shape)
        helper.append_op("flash_attention",
                         inputs={"Q": [q], "K": [k], "V": [v]},
                         outputs={"Out": [ctx]}, attrs={"causal": False})
    else:
        scaled = layers.scale(q, scale=d_key ** -0.5)
        logits = layers.matmul(scaled, k, transpose_y=True)
        weights = layers.softmax(logits)
        if dropout_rate:
            weights = layers.dropout(weights, dropout_prob=dropout_rate)
        ctx = layers.matmul(weights, v)
    ctx = layers.transpose(ctx, [0, 2, 1, 3])  # [b, t, h, d]
    if merge_shape is None:
        t, h, d = ctx.shape[1], ctx.shape[2], ctx.shape[3]
        merge_shape = (t, h * d)
    out = layers.reshape(ctx, [-1, merge_shape[0], merge_shape[1]])
    out.shape = (-1,) + tuple(merge_shape)
    return out


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0, sequence_parallel=False,
                                 causal=False):
    """Multi-head attention built from primitive ops (fluid nets.py:503).

    ``sequence_parallel=True`` emits the `ring_attention` op on the
    merged-head [b, t, h*d] tensors instead of the score-matrix graph:
    under a CompiledProgram whose BuildStrategy sets
    ``sequence_parallel_degree`` each rank holds a sequence shard and K/V
    rotate around the ring of its sp group; outside a process group the
    op is plain attention, so the same program runs on one device."""
    if sequence_parallel:
        if dropout_rate:
            raise ValueError(
                "scaled_dot_product_attention(sequence_parallel=True) "
                "does not support attention-probability dropout — the "
                "probs are never materialized")
        from ..ops.attention import SP_RING_ID
        helper = layers.LayerHelper("ring_attention")
        out = helper.create_variable_for_type_inference(queries.dtype)
        out.shape = tuple(queries.shape) if queries.shape else None
        helper.append_op("ring_attention",
                         inputs={"Q": [queries], "K": [keys],
                                 "V": [values]},
                         outputs={"Out": [out]},
                         attrs={"causal": bool(causal),
                                "ring_id": SP_RING_ID,
                                "num_heads": int(num_heads)})
        return out
    if causal:
        raise NotImplementedError(
            "causal masking is only wired for the sequence_parallel "
            "(ring_attention) path; the score-matrix graph here is the "
            "bidirectional BERT/ERNIE form")
    d_key = queries.shape[-1] // num_heads

    def _split_heads(x):
        if num_heads == 1:
            return x
        t, c = x.shape[1], x.shape[2]
        x = layers.reshape(x, [-1, t, num_heads, c // num_heads])
        return layers.transpose(x, [0, 2, 1, 3])  # [b, h, t, d]

    q, k, v = _split_heads(queries), _split_heads(keys), _split_heads(values)
    if num_heads == 1:
        scaled = layers.scale(q, scale=d_key ** -0.5)
        logits = layers.matmul(scaled, k, transpose_y=True)
        weights = layers.softmax(logits)
        if dropout_rate:
            weights = layers.dropout(weights, dropout_prob=dropout_rate)
        return layers.matmul(weights, v)
    return attention_core(q, k, v, d_key, dropout_rate)
