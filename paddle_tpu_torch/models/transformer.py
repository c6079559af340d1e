"""Transformer seq2seq (the WMT en-de "transformer-big" family) in
dygraph: counterpart of paddle_tpu/models/transformer.py, on the port's
`nn.Transformer` (so each attention keeps its flash / score-matrix route
choice), with the same parameter names (`state_dict()` equals the JAX
model's, `_tied_out` first: the shared embedding is the generator) and
the same `beam_search` contract.

On the device: the forward runs where the model's parameters are; the
sinusoidal table is a non-persistable buffer built on the host once; the
causal mask (-1e9 above the diagonal) is made on the ids' device.
`beam_search` runs the encoder once, tiles its memory per beam, and
each step runs the whole decoder over the candidates (no cache, as in
the JAX package) under `torch.no_grad()`; only the last position's
logits go to the host, where `models/_decode.beam_search_loop` drives
the registered `beam_search` op."""
from __future__ import annotations

import numpy as np
import torch

from .. import nn
from ..dygraph.layers import Layer
from ..tensor.linalg import matmul

__all__ = ["TransformerConfig", "PositionalEncoding", "TransformerModel",
           "CrossEntropyCriterion", "transformer_base", "transformer_big"]


class TransformerConfig:
    def __init__(self, src_vocab_size=30000, trg_vocab_size=30000,
                 max_length=256, d_model=512, n_head=8, num_encoder_layers=6,
                 num_decoder_layers=6, d_inner_hid=2048, dropout=0.1,
                 weight_sharing=True, bos_id=0, eos_id=1):
        self.src_vocab_size = src_vocab_size
        self.trg_vocab_size = trg_vocab_size
        self.max_length = max_length
        self.d_model = d_model
        self.n_head = n_head
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        self.d_inner_hid = d_inner_hid
        self.dropout = dropout
        self.weight_sharing = weight_sharing
        self.bos_id = bos_id
        self.eos_id = eos_id


class PositionalEncoding(Layer):
    def __init__(self, d_model, max_len=1024, dropout=0.1):
        super().__init__()
        pe = np.zeros((max_len, d_model), np.float32)
        pos = np.arange(max_len, dtype=np.float32)[:, None]
        div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                     * -(np.log(10000.0) / d_model))
        pe[:, 0::2] = np.sin(pos * div)
        pe[:, 1::2] = np.cos(pos * div)
        self.register_buffer("pe", pe, persistable=False)
        self.dropout = nn.Dropout(dropout)
        self.scale = float(np.sqrt(d_model))

    def forward(self, x):
        seq = x.shape[1]
        return self.dropout(x * self.scale + self.pe[:seq])


class TransformerModel(Layer):
    """Embeddings + nn.Transformer + the generator tied to the target
    embedding."""

    def __init__(self, cfg: TransformerConfig = None, **kw):
        super().__init__()
        cfg = cfg or TransformerConfig(**kw)
        self.config = cfg
        self.src_emb = nn.Embedding(cfg.src_vocab_size, cfg.d_model)
        if cfg.weight_sharing and cfg.src_vocab_size == cfg.trg_vocab_size:
            self.trg_emb = self.src_emb
        else:
            self.trg_emb = nn.Embedding(cfg.trg_vocab_size, cfg.d_model)
        self.pos_enc = PositionalEncoding(cfg.d_model, cfg.max_length,
                                          cfg.dropout)
        self.transformer = nn.Transformer(
            d_model=cfg.d_model, nhead=cfg.n_head,
            num_encoder_layers=cfg.num_encoder_layers,
            num_decoder_layers=cfg.num_decoder_layers,
            dim_feedforward=cfg.d_inner_hid, dropout=cfg.dropout)
        self._tied_out = self.trg_emb.weight

    def _causal_mask(self, seq, device):
        m = np.triu(np.full((seq, seq), -1e9, np.float32), k=1)
        return torch.as_tensor(m, device=device)

    def forward(self, src_ids, trg_ids, src_pad_mask=None):
        """Logits [B, T, V]."""
        src = self.pos_enc(self.src_emb(src_ids))
        trg = self.pos_enc(self.trg_emb(trg_ids))
        tgt_mask = self._causal_mask(trg_ids.shape[1], trg_ids.device)
        memory_mask = None
        if src_pad_mask is not None:
            am = src_pad_mask.to(torch.float32)
            memory_mask = (am[:, None, None, :] - 1.0) * 1e4
        out = self.transformer(src, trg, src_mask=memory_mask,
                               tgt_mask=tgt_mask, memory_mask=memory_mask)
        return matmul(out, self._tied_out, transpose_y=True)

    def beam_search(self, src_ids, beam_size=1, max_len=None,
                    length_penalty=0.0):
        """Beam-search decode over the `beam_search` op (beam_size=1 is
        greedy): [batch, T] token ids, the best hypothesis of each row."""
        from ._decode import beam_search_loop
        cfg = self.config
        W = max(1, int(beam_size))
        max_len = max_len or min(cfg.max_length, src_ids.shape[1] * 2)
        batch = src_ids.shape[0]
        device = self._tied_out.device
        with torch.no_grad():
            src_ids = torch.as_tensor(src_ids, device=device)
            memory = self.transformer.encoder(
                self.pos_enc(self.src_emb(src_ids)), None)
            mem = memory.repeat_interleave(W, dim=0)

            def step_logits(trg):
                ids = torch.as_tensor(trg, device=device)
                t = self.pos_enc(self.trg_emb(ids))
                out = self.transformer.decoder(
                    t, mem, self._causal_mask(trg.shape[1], device), None)
                logits = matmul(out[:, -1:], self._tied_out,
                                transpose_y=True)
                return logits[:, 0].float().cpu().numpy()

            init = np.full((batch, 1), cfg.bos_id, np.int64)
            return beam_search_loop(step_logits, init, W, cfg.eos_id,
                                    max_len - 1, length_penalty)


class CrossEntropyCriterion(Layer):
    """Label-smoothed cross entropy over the tokens that are not `pad_id`
    (the transformer's training loss)."""

    def __init__(self, label_smooth_eps=0.1, pad_id=-100):
        super().__init__()
        self.eps = label_smooth_eps
        self.pad_id = pad_id

    def forward(self, logits, labels):
        from ..nn import functional as F
        vocab = logits.shape[-1]
        flat = logits.reshape(-1, vocab)
        lab = labels.reshape(-1).long()
        logp = F.log_softmax(flat, axis=-1)
        nll = -logp.gather(1, lab[:, None])[:, 0]
        if self.eps > 0:
            smooth = -logp.mean(dim=-1)
            nll = (1 - self.eps) * nll + self.eps * smooth
        mask = (lab != self.pad_id).to(torch.float32)
        return (nll * mask).sum() / (mask.sum() + 1e-9)


def transformer_base(**kw):
    return TransformerModel(TransformerConfig(**kw))


def transformer_big(**kw):
    kw.setdefault("d_model", 1024)
    kw.setdefault("n_head", 16)
    kw.setdefault("d_inner_hid", 4096)
    kw.setdefault("dropout", 0.3)
    return TransformerModel(TransformerConfig(**kw))
