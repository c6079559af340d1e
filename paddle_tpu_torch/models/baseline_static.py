"""The training programs of three BASELINE.md configs, built with the
port's static layers (counterparts of the JAX package's
tools/bench_lenet.py, tools/bench_resnet.py and tools/bench_transformer.py,
with their signatures and layer calls, so both packages build the same
programs):

  * `build_lenet`: MNIST LeNet-5 (conv-pool x 2, fc x 3, softmax
    cross-entropy), fp32, SGD 0.01; `use_amp` is accepted and ignored, as
    in the tool;
  * `build_resnet50`: ResNet-50 v1.5 on ImageNet (stride 2 on the 3x3 of
    a bottleneck), `conv_bn` and `bottleneck` take the layers module as
    their first argument, Momentum 0.1 / 0.9, bf16 AMP by default;
  * `build_transformer_big`: WMT14 en-de Transformer-big ("Attention Is
    All You Need" big: 6 + 6 post-norm layers, d 1024, 16 heads, FFN
    4096), the score-matrix attention with a fed causal bias, label
    smoothing 0.1 over a one-hot target, soft-label cross-entropy, Adam
    2e-4, bf16 AMP by default.

Each returns (main, startup, loss).  The tools' synthetic data
(`np.random.RandomState(0)`) needs no download.
"""
from __future__ import annotations

__all__ = ["build_lenet", "build_resnet50", "build_transformer_big",
           "conv_bn", "bottleneck"]


def build_lenet(use_amp=False):
    from .. import static
    from ..static import layers

    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        im = layers.data("image", [-1, 1, 28, 28])
        lbl = layers.data("label", [-1, 1], dtype="int64")
        h = layers.conv2d(im, 6, 5, padding=2, act="relu")
        h = layers.pool2d(h, 2, pool_type="max", pool_stride=2)
        h = layers.conv2d(h, 16, 5, act="relu")
        h = layers.pool2d(h, 2, pool_type="max", pool_stride=2)
        h = layers.fc(h, 120, act="relu")
        h = layers.fc(h, 84, act="relu")
        logits = layers.fc(h, 10)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, lbl))
        static.SGD(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def conv_bn(layers, x, filters, ksize, stride=1, act=None):
    y = layers.conv2d(x, filters, ksize, stride=stride,
                      padding=(ksize - 1) // 2, bias_attr=False)
    return layers.batch_norm(y, act=act)


def bottleneck(layers, x, filters, stride, downsample):
    out = conv_bn(layers, x, filters, 1, act="relu")
    out = conv_bn(layers, out, filters, 3, stride=stride, act="relu")
    out = conv_bn(layers, out, filters * 4, 1)
    if downsample:
        x = conv_bn(layers, x, filters * 4, 1, stride=stride)
    return layers.relu(layers.elementwise_add(out, x))


def build_resnet50(batch, img=224, classes=1000, use_amp=True):
    from .. import amp, static
    from ..static import layers

    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        im = layers.data("image", [-1, 3, img, img])
        label = layers.data("label", [-1, 1], dtype="int64")
        h = conv_bn(layers, im, 64, 7, stride=2, act="relu")
        h = layers.pool2d(h, 3, pool_type="max", pool_stride=2,
                          pool_padding=1)
        for stage, (filters, blocks) in enumerate(
                [(64, 3), (128, 4), (256, 6), (512, 3)]):
            for b in range(blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                h = bottleneck(layers, h, filters, stride, b == 0)
        h = layers.pool2d(h, pool_type="avg", global_pooling=True)
        logits = layers.fc(h, classes)
        loss = layers.mean(
            layers.softmax_with_cross_entropy(logits, label))
        opt = static.Momentum(learning_rate=0.1, momentum=0.9)
        if use_amp:
            opt = amp.decorate(opt, init_loss_scaling=1.0,
                               use_dynamic_loss_scaling=False,
                               dest_dtype="bfloat16")
        opt.minimize(loss)
    return main, startup, loss


def _mha(layers, q_in, kv_in, d_model, heads, bias=None):
    """Multi-head attention from raw static layers; `bias` is an additive
    [-1, 1, Tq, Tk] feed (None: unmasked)."""
    dk = d_model // heads

    def split_heads(x, t):
        y = layers.reshape(x, [-1, t, heads, dk])
        y.shape = (-1, t, heads, dk)
        return layers.transpose(y, [0, 2, 1, 3])

    tq, tk = q_in.shape[1], kv_in.shape[1]
    q = split_heads(layers.fc(q_in, d_model, num_flatten_dims=2), tq)
    k = split_heads(layers.fc(kv_in, d_model, num_flatten_dims=2), tk)
    v = split_heads(layers.fc(kv_in, d_model, num_flatten_dims=2), tk)
    logits = layers.matmul(layers.scale(q, scale=dk ** -0.5), k,
                           transpose_y=True)
    if bias is not None:
        logits = layers.elementwise_add(logits, bias)
    ctx = layers.matmul(layers.softmax(logits), v)
    ctx = layers.transpose(ctx, [0, 2, 1, 3])
    ctx = layers.reshape(ctx, [-1, tq, d_model])
    ctx.shape = (-1, tq, d_model)
    return layers.fc(ctx, d_model, num_flatten_dims=2)


def _block_post(layers, x, sub):
    return layers.layer_norm(layers.elementwise_add(x, sub),
                             begin_norm_axis=2)


def _ffn(layers, x, d_model, d_inner):
    h = layers.fc(x, d_inner, num_flatten_dims=2, act="relu")
    return layers.fc(h, d_model, num_flatten_dims=2)


def build_transformer_big(src_len, trg_len, vocab=32000, d_model=1024,
                          heads=16, n_layers=6, d_inner=4096,
                          use_amp=True):
    from .. import amp, static
    from ..static import layers

    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        src = layers.data("src_ids", [-1, src_len], dtype="int64")
        trg = layers.data("trg_ids", [-1, trg_len], dtype="int64")
        lbl = layers.data("labels", [-1, trg_len, 1], dtype="int64")
        causal = layers.data("trg_bias", [-1, 1, trg_len, trg_len])
        spos = layers.data("src_pos", [-1, src_len], dtype="int64")
        tpos = layers.data("trg_pos", [-1, trg_len], dtype="int64")

        enc = layers.elementwise_add(
            layers.embedding(src, size=[vocab, d_model]),
            layers.embedding(spos, size=[src_len, d_model]))
        for _ in range(n_layers):
            enc = _block_post(layers, enc,
                              _mha(layers, enc, enc, d_model, heads))
            enc = _block_post(layers, enc, _ffn(layers, enc, d_model,
                                                d_inner))

        dec = layers.elementwise_add(
            layers.embedding(trg, size=[vocab, d_model]),
            layers.embedding(tpos, size=[trg_len, d_model]))
        for _ in range(n_layers):
            dec = _block_post(layers, dec,
                              _mha(layers, dec, dec, d_model, heads,
                                   bias=causal))
            dec = _block_post(layers, dec,
                              _mha(layers, dec, enc, d_model, heads))
            dec = _block_post(layers, dec, _ffn(layers, dec, d_model,
                                                d_inner))

        logits = layers.fc(dec, vocab, num_flatten_dims=2)
        smoothed = layers.label_smooth(
            layers.one_hot(layers.reshape(lbl, [-1, trg_len]), vocab),
            epsilon=0.1)
        loss = layers.mean(layers.softmax_with_cross_entropy(
            logits, smoothed, soft_label=True))
        opt = static.Adam(learning_rate=2e-4)
        if use_amp:
            opt = amp.decorate(opt, init_loss_scaling=1.0,
                               use_dynamic_loss_scaling=False,
                               dest_dtype="bfloat16")
        opt.minimize(loss)
    return main, startup, loss
