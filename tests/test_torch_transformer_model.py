"""models.transformer (the seq2seq Transformer over nn.Transformer) and
the nn decoder classes, the port against the JAX package on the CPU, at
d_model 64, 4 heads, 2 + 2 layers, vocab 97 (shared embeddings, dropout
0), the JAX model's weights carried over with `set_state_dict`:

  * logits, `CrossEntropyCriterion`'s label-smoothed loss and every
    parameter's gradient (rtol 1e-5, atol 1e-5 of each tensor's largest
    magnitude, fp32), with flash off (every attention on
    the score matrix) and on (the encoder self-attention and the decoder
    cross-attention through the flash kernels' plain versions / the JAX
    package's Pallas kernels in interpret mode), and with a source
    padding mask;
  * the decoder's incremental caches (a `Cache` for self-attention, a
    `StaticCache` for cross-attention) step by step against the full
    causal decode, in both packages;
  * `beam_search` (beam 4, 2 source rows) tokens equal to the JAX
    package's, flash on and off.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.nn as jnn
from paddle_tpu import dygraph as jdg
from paddle_tpu.core.program import _reset_unique_names as jreset
from paddle_tpu.models import transformer as jtr

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import dygraph as tdg
from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.core.program import _reset_unique_names as treset
from paddle_tpu_torch.models import transformer as ttr

from test_torch_gpt import jax_generator_restored  # noqa: F401
from test_torch_program import flash_mode

TOL = dict(rtol=1e-5, atol=1e-5)


def close(got, want, what=""):
    """rtol 1e-5 and atol 1e-5 of the tensor's largest magnitude (the
    logits reach ~15: products of 64 terms of the N(0, 1) embeddings
    scaled by sqrt(64), summed in another order)."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(want).max()),
        err_msg=what)
CFG = dict(src_vocab_size=97, trg_vocab_size=97, max_length=32, d_model=64,
           n_head=4, num_encoder_layers=2, num_decoder_layers=2,
           d_inner_hid=128, dropout=0.0)
B, S, T = 2, 12, 9


@pytest.fixture(autouse=True)
def _cpu(jax_generator_restored):  # noqa: F811
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with tdg.guard(CPUPlace()):
        yield
    torch.set_num_threads(threads)


def model_pair(seed=0):
    jreset()
    paddle_tpu.seed(seed)
    with jdg.guard():
        jm = jtr.transformer_base(**CFG)
    treset()
    tm = ttr.transformer_base(**CFG)
    jsd, tsd = jm.state_dict(), tm.state_dict()
    assert list(jsd) == list(tsd)
    assert tm.set_state_dict(jsd) == ([], [])
    return jm, tm


def _batch(seed=1):
    r = np.random.RandomState(seed)
    return (r.randint(2, 97, (B, S)).astype(np.int64),
            r.randint(2, 97, (B, T)).astype(np.int64),
            r.randint(2, 97, (B, T)).astype(np.int64))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.numpy())


@pytest.mark.parametrize("flash,pad", [(False, False), (True, False),
                                       (False, True)])
def test_logits_loss_and_gradients_match_jax(flash, pad):
    jm, tm = model_pair()
    src, trg, lbl = _batch()
    mask = np.ones((B, S), np.float32)
    mask[1, 8:] = 0.0
    with flash_mode(flash), jdg.guard():
        jargs = [paddle_tpu.to_tensor(a) for a in (src, trg)]
        if pad:
            jargs.append(paddle_tpu.to_tensor(mask))
        jlog = jm(*jargs)
        jloss = jtr.CrossEntropyCriterion(0.1, pad_id=0)(
            jlog, paddle_tpu.to_tensor(lbl))
        jloss.backward()
    with flash_mode(flash):
        targs = [torch.from_numpy(a) for a in (src, trg)]
        if pad:
            targs.append(torch.from_numpy(mask))
        tlog = tm(*targs)
        tloss = ttr.CrossEntropyCriterion(0.1, pad_id=0)(
            tlog, torch.from_numpy(lbl))
        tloss.backward()
    close(_np(tlog), _np(jlog), "logits")
    np.testing.assert_allclose(float(tloss.detach()), float(_np(jloss)),
                               rtol=1e-5)
    tparams = dict(tm.named_parameters())
    n = 0
    for k, jp in jm.named_parameters():
        if jp.grad is None:
            continue
        close(tparams[k].grad.numpy(), np.asarray(jp.grad), k)
        n += 1
    assert n == len(tparams)


def _incremental(nn, model, trg_emb, memory, to_t):
    """Decoder outputs one step at a time through the caches."""
    dec = model.transformer.decoder
    static = [layer.cross_attn.gen_cache(memory, type=nn.MultiHeadAttention
                                         .StaticCache)
              for layer in dec.layers]
    cache = [(layer.self_attn.gen_cache(memory), s)
             for layer, s in zip(dec.layers, static)]
    outs = []
    for t in range(trg_emb.shape[1]):
        out, new = dec(trg_emb[:, t:t + 1], memory, None, None, cache)
        assert all(len(c) == 1 for c in new)  # the StaticCache is dropped
        cache = [(c[0], s) for c, s in zip(new, static)]
        outs.append(_np(out))
    return np.concatenate(outs, axis=1)


def test_decoder_caches_match_the_full_decode():
    jm, tm = model_pair()
    src, trg, _ = _batch()
    with jdg.guard():
        jmem = jm.transformer.encoder(
            jm.pos_enc(jm.src_emb(paddle_tpu.to_tensor(src))), None)
        jt = jm.pos_enc(jm.trg_emb(paddle_tpu.to_tensor(trg)))
        jinc = _incremental(jnn, jm, jt, jmem, paddle_tpu.to_tensor)
    with torch.no_grad():
        tmem = tm.transformer.encoder(
            tm.pos_enc(tm.src_emb(torch.from_numpy(src))), None)
        tt = tm.pos_enc(tm.trg_emb(torch.from_numpy(trg)))
        full = tm.transformer.decoder(tt, tmem,
                                      tm._causal_mask(T, tt.device), None)
        tinc = _incremental(tnn, tm, tt, tmem, torch.from_numpy)
    close(tinc, _np(full))
    close(tinc, jinc)


@pytest.mark.parametrize("flash", [False, True])
def test_beam_search_tokens_equal_jax(flash):
    jm, tm = model_pair(seed=3)
    src = _batch(seed=4)[0]
    with flash_mode(flash), jdg.guard():
        want = jm.beam_search(paddle_tpu.to_tensor(src), beam_size=4,
                              max_len=8)
    with flash_mode(flash):
        got = tm.beam_search(torch.from_numpy(src), beam_size=4, max_len=8)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.shape[0] == B and got.shape[1] > 1


def test_transformer_big_widths():
    """transformer_big's published widths: d_model 1024, 16 heads, d_inner
    4096, dropout 0.3, 6 + 6 layers, one shared embedding (checked on
    the config, without building the 32000-vocab model)."""
    cfg = ttr.TransformerConfig(**dict(
        src_vocab_size=32000, trg_vocab_size=32000, d_model=1024, n_head=16,
        d_inner_hid=4096, dropout=0.3))
    assert (cfg.num_encoder_layers, cfg.num_decoder_layers) == (6, 6)
    jcfg = jtr.TransformerConfig(**dict(
        src_vocab_size=32000, trg_vocab_size=32000, d_model=1024, n_head=16,
        d_inner_hid=4096, dropout=0.3))
    assert vars(cfg) == vars(jcfg)


def test_decoder_layer_returns_only_the_self_attention_cache_item_60():
    """Queue 3 item 60: given (Cache, StaticCache), a decoder layer
    returns (out, (new Cache,)), the cross-attention's StaticCache left
    out, in both packages, so the caller pairs the new Cache with its
    StaticCache again for the next step (test above)."""
    jm, tm = model_pair()
    mem = np.random.RandomState(5).randn(B, S, 64).astype(np.float32)
    tgt = np.random.RandomState(6).randn(B, 1, 64).astype(np.float32)
    for nn, m, wrap in ((jnn, jm, paddle_tpu.to_tensor),
                        (tnn, tm, torch.from_numpy)):
        layer = m.transformer.decoder.layers[0]
        with jdg.guard():
            memory = wrap(mem)
            cache = (layer.self_attn.gen_cache(memory),
                     layer.cross_attn.gen_cache(
                         memory, type=nn.MultiHeadAttention.StaticCache))
            _, new = layer(wrap(tgt), memory, None, None, cache)
        assert len(new) == 1
        assert isinstance(new[0], nn.MultiHeadAttention.Cache)
        assert tuple(new[0].k.shape) == (B, 4, 1, 16)
