"""BERT / ERNIE encoder family for dygraph pretraining.

Counterpart of paddle_tpu/models/bert.py: the public BERT / ERNIE-1.0
architecture (post-LN transformer encoder, learned position embeddings,
MLM + NSP heads) over the port's `nn` layers.  The MLM decoder is tied to
the word embedding (`BertLMPredictionHead._tied` is that parameter, so
`state_dict()` lists it first, as `cls._tied`, as the JAX package's
does).  Every arithmetic op is the port's counterpart of the op the JAX
package traces (tensor.math / tensor.linalg), so `amp.auto_cast` casts as
there.  The encoder's attention takes the flash kernels where the JAX
package takes its Pallas ones (nn/layer/transformer.py).
"""
from __future__ import annotations

import torch

from .. import nn
from ..dygraph.layers import Layer
from ..dygraph.tensor import astype
from ..tensor import math as M
from ..tensor.linalg import matmul

__all__ = ["BertConfig", "BertEmbeddings", "BertPooler", "BertModel",
           "BertForPretraining", "BertPretrainingCriterion", "ErnieModel",
           "ErnieForPretraining", "bert_base", "bert_large", "ernie_base"]


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act="gelu",
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 initializer_range=0.02, pad_token_id=0):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.initializer_range = initializer_range
        self.pad_token_id = pad_token_id


class BertEmbeddings(Layer):
    """word + position + token-type embeddings, LN, dropout."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(
            cfg.type_vocab_size, cfg.hidden_size)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        seq = input_ids.shape[-1]
        if position_ids is None:
            position_ids = torch.arange(
                seq, dtype=torch.int64, device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros(
                (1, seq), dtype=torch.int64, device=input_ids.device)
        emb = M.add(M.add(self.word_embeddings(input_ids),
                          self.position_embeddings(position_ids)),
                    self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertPooler(Layer):
    def __init__(self, hidden_size):
        super().__init__()
        self.dense = nn.Linear(hidden_size, hidden_size)
        self.activation = nn.Tanh()

    def forward(self, hidden_states):
        return self.activation(self.dense(hidden_states[:, 0]))


class BertModel(Layer):
    """Embeddings + TransformerEncoder + pooler."""

    def __init__(self, cfg: BertConfig = None, **kw):
        super().__init__()
        cfg = cfg or BertConfig(**kw)
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg)
        enc_layer = nn.TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation=cfg.hidden_act,
            attn_dropout=cfg.attention_probs_dropout_prob,
            act_dropout=0.0)
        self.encoder = nn.TransformerEncoder(enc_layer,
                                             cfg.num_hidden_layers)
        self.pooler = BertPooler(cfg.hidden_size)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        if attention_mask is not None and attention_mask.dim() == 2:
            # [B, S] padding mask -> additive [B, 1, 1, S]
            am = astype(attention_mask, "float32")
            attention_mask = M.multiply(
                M.subtract(am[:, None, None, :], 1.0), 1e4)
        emb = self.embeddings(input_ids, token_type_ids, position_ids)
        seq_out = self.encoder(emb, src_mask=attention_mask)
        pooled = self.pooler(seq_out)
        return seq_out, pooled


class BertLMPredictionHead(Layer):
    """MLM head: transform + LN + decoder tied to the word embeddings."""

    def __init__(self, cfg: BertConfig, embedding_weights=None):
        super().__init__()
        self.transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.activation = nn.GELU()
        self.layer_norm = nn.LayerNorm(cfg.hidden_size)
        self._tied = embedding_weights  # the word embedding [V, H]
        self.decoder_bias = self.create_parameter(
            [cfg.vocab_size], is_bias=True)

    def forward(self, hidden):
        h = self.layer_norm(self.activation(self.transform(hidden)))
        return M.add(matmul(h, self._tied, transpose_y=True),
                     self.decoder_bias)


class BertForPretraining(Layer):
    """MLM + NSP heads over BertModel."""

    def __init__(self, bert: BertModel):
        super().__init__()
        self.bert = bert
        cfg = bert.config
        self.cls = BertLMPredictionHead(
            cfg, bert.embeddings.word_embeddings.weight)
        self.seq_relationship = nn.Linear(cfg.hidden_size, 2)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq_out, pooled = self.bert(input_ids, token_type_ids,
                                    position_ids, attention_mask)
        prediction_scores = self.cls(seq_out)
        seq_relationship_score = self.seq_relationship(pooled)
        return prediction_scores, seq_relationship_score


class BertPretrainingCriterion(Layer):
    """masked-LM + NSP loss."""

    def __init__(self, vocab_size):
        super().__init__()
        self.vocab_size = vocab_size
        self.ce = nn.CrossEntropyLoss(reduction="none")

    def forward(self, prediction_scores, seq_relationship_score,
                masked_lm_labels, next_sentence_labels=None,
                masked_lm_weights=None):
        logits = prediction_scores.reshape(-1, self.vocab_size)
        labels = masked_lm_labels.reshape(-1)
        mlm_loss = self.ce(logits, labels)
        if masked_lm_weights is not None:
            w = astype(masked_lm_weights.reshape(-1), "float32")
            mlm_loss = M.divide(M.sum(M.multiply(mlm_loss, w)),
                                M.add(M.sum(w), 1e-6))
        else:
            mlm_loss = M.mean(mlm_loss)
        if next_sentence_labels is None:
            return mlm_loss
        nsp_loss = M.mean(self.ce(seq_relationship_score,
                                  next_sentence_labels.reshape(-1)))
        return M.add(mlm_loss, nsp_loss)


# ERNIE-1.0 shares the BERT architecture (its phrase / entity masking is
# a property of the data pipeline, not of the model)
ErnieModel = BertModel
ErnieForPretraining = BertForPretraining


def bert_base(**kw):
    return BertModel(BertConfig(**kw))


def bert_large(**kw):
    kw.setdefault("hidden_size", 1024)
    kw.setdefault("num_hidden_layers", 24)
    kw.setdefault("num_attention_heads", 16)
    kw.setdefault("intermediate_size", 4096)
    return BertModel(BertConfig(**kw))


def ernie_base(**kw):
    kw.setdefault("vocab_size", 18000)
    return ErnieModel(BertConfig(**kw))
