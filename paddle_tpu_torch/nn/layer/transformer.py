"""paddle.nn transformer layers (counterpart of
paddle_tpu/nn/layer/transformer.py): MultiHeadAttention (`:39`), with its
`Cache` (incremental decode: new K/V columns appended) and `StaticCache`
(precomputed K/V, cross-attention) and `gen_cache`;
TransformerEncoderLayer (post-LN, or pre-LN with `normalize_before`) and
TransformerEncoder, which deep-copies the first layer for the others
(`:188-190`: every layer starts from the same weights).

Attention takes one of two routes, chosen as the JAX package chooses
them (`:88-104`):
  * flash — when `ops.attention.use_flash_for(L)` holds, there is no
    mask, no attention weights are asked for and attention dropout is off
    (or the layer is in eval): the port's `flash_attention` over the
    [B, H, L, Dh] head-split views, differentiable, so a CUDA tensor runs
    the Hopper flash forward, dQ and dK/dV kernels (a CPU tensor their
    plain versions).  No AMP cast is applied to it (the JAX package
    traces it as a raw function): under O1 q, k and v are fp32 (a bf16
    product plus an fp32 bias), under O2 bf16.  Under a `to_static`
    recorder it raises, as the JAX package's raw-function trace does;
  * score matrix — otherwise: softmax(q k^T / sqrt(Dh) + mask) v, with
    dropout on the attention weights in training.  GPT always passes a
    mask and takes this route.
A bool or integer mask (1 = keep) becomes an additive one of 0 / -1e4,
as in the JAX package.  TransformerDecoderLayer (self-attention,
cross-attention over `memory`, feed-forward; `cache` a (Cache,
StaticCache) pair for incremental decoding: it returns (out,
(new Cache,)), the cross-attention's StaticCache left out, as in the JAX
package, ROADMAP.md Queue 3), TransformerDecoder and Transformer (an
encoder and a decoder of deep-copied layers, a final LayerNorm with
`normalize_before`) are copies of the JAX package's `:208-324`, on this
MultiHeadAttention, so every attention keeps its route choice.
`SwitchMoE` is the switch Mixture-of-Experts block (incubate/moe.py).
"""
from __future__ import annotations

import collections
import copy

import torch

from ...dygraph.layers import Layer, LayerList
from ...tensor import math as M
from ...tensor.linalg import matmul
from .. import functional as F
from .common import Dropout, Linear
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer", "SwitchMoE"]


def _convert_attention_mask(attn_mask, dtype):
    if attn_mask is None:
        return None
    if attn_mask.dtype in (torch.bool, torch.int32, torch.int64):
        # True/1 = keep: additive 0 where kept, -1e4 where dropped
        return M.scale(M.scale(attn_mask.to(dtype), -1.0, 1.0), -1e4)
    return attn_mask


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        assert self.head_dim * num_heads == embed_dim
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _shape(self, x):
        # [B, L, D] -> [B, H, L, Dh] (a view)
        b, l = x.shape[0], x.shape[1]
        return x.reshape(b, l, self.num_heads, self.head_dim) \
            .permute(0, 2, 1, 3)

    def _merge(self, out):
        # [B, H, L, Dh] -> [B, L, D]
        b, l = out.shape[0], out.shape[2]
        return out.permute(0, 2, 1, 3).reshape(b, l, self.embed_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value

        q = self._shape(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], dim=2)
                v = torch.cat([cache.v, v], dim=2)
                cache = self.Cache(k, v)

        from ...ops.attention import flash_attention, use_flash_for
        if use_flash_for(int(q.shape[2])) and attn_mask is None and \
                not self.need_weights and \
                not (self.dropout and self.training):
            from ...dygraph.tracer import recording, refuse
            if recording():
                # the JAX package's trace_jax site: a raw function the
                # to_static recorder cannot capture
                refuse("flash_attention")
            out = self.out_proj(self._merge(flash_attention(q, k, v)))
            if isinstance(cache, self.Cache):
                return out, cache
            return out

        scores = M.scale(matmul(q, k, transpose_y=True),
                         scale=self.head_dim ** -0.5)
        mask = _convert_attention_mask(attn_mask, scores.dtype)
        if mask is not None:
            scores = M.add(scores, mask)
        weights = F.softmax(scores, axis=-1)
        if self.dropout:
            weights = F.dropout(weights, self.dropout,
                                training=self.training)
        out = self.out_proj(self._merge(matmul(weights, v)))
        outs = [out]
        if self.need_weights:
            outs.append(weights)
        if isinstance(cache, self.Cache):
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)

    def gen_cache(self, key, value=None, type=None):
        if type == MultiHeadAttention.StaticCache:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value if value is not None else key))
            return self.StaticCache(k, v)
        b = key.shape[0]
        shape = (b, self.num_heads, 0, self.head_dim)
        return self.Cache(
            torch.zeros(shape, dtype=key.dtype, device=key.device),
            torch.zeros(shape, dtype=key.dtype, device=key.device))


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self._activation = activation

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = M.add(residual, self.dropout1(src))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        act = getattr(F, self._activation)
        src = self.linear2(self.act_dropout(act(self.linear1(src))))
        src = M.add(residual, self.dropout2(src))
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer] +
            [copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, new_cache = mod(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self._activation = activation

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = M.add(residual, self.dropout1(tgt))
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
            if isinstance(tgt, tuple):
                tgt = tgt[0]
        tgt = M.add(residual, self.dropout2(tgt))
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        act = getattr(F, self._activation)
        tgt = self.linear2(self.act_dropout(act(self.linear1(tgt))))
        tgt = M.add(residual, self.dropout3(tgt))
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental_cache,))


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer] +
            [copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask,
                                        memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        from ...tensor.creation import ones, tril
        return tril(ones([length, length]))


class SwitchMoE(Layer):
    """Switch (top-1) Mixture-of-Experts feed-forward block (the JAX
    package's `:338`): the switch_moe op's core (incubate/moe.py), with
    `ep_ring_id` naming the ring of the expert group.

    forward(x [..., d_model]) -> (out [..., d_model], aux_loss scalar);
    add `aux_weight * aux_loss` to the training loss."""

    def __init__(self, d_model, d_hidden, num_experts,
                 capacity_factor=1.25, ep_ring_id=None, weight_attr=None,
                 name=None):
        super().__init__()
        from ...static.initializer import Normal
        from ...static.param_attr import ParamAttr
        self.capacity_factor = capacity_factor
        self.ep_ring_id = ep_ring_id

        def _sub_attr(suffix):
            return ParamAttr.derive(weight_attr, suffix)

        self.gate_w = self.create_parameter(
            [d_model, num_experts], attr=_sub_attr("_gate"),
            default_initializer=Normal(0.0, 0.02))
        self.w1 = self.create_parameter([num_experts, d_model, d_hidden],
                                        attr=_sub_attr("_w1"))
        self.b1 = self.create_parameter([num_experts, d_hidden],
                                        is_bias=True)
        self.w2 = self.create_parameter([num_experts, d_hidden, d_model],
                                        attr=_sub_attr("_w2"))
        self.b2 = self.create_parameter([num_experts, d_model],
                                        is_bias=True)

    def forward(self, x):
        from ...ops.kernels.sparse_feature import switch_moe_nd
        return switch_moe_nd(x, self.gate_w, self.w1, self.b1, self.w2,
                             self.b2, self.capacity_factor, self.ep_ring_id)
