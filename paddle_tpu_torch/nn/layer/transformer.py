"""paddle.nn MultiHeadAttention (counterpart of
paddle_tpu/nn/layer/transformer.py:39), with its `Cache` (incremental
decode: new K/V columns appended) and `StaticCache` (precomputed K/V,
cross-attention) and `gen_cache`.

Two routes, chosen as the JAX package chooses them (`:88-104`):
  * flash — when `ops.attention.use_flash_for(L)` holds, there is no
    mask, no attention weights are asked for and dropout is off: the
    port's `flash_attention` over the [B, H, L, Dh] head-split views, so
    a CUDA tensor runs the Hopper flash kernel (a CPU tensor its plain
    version);
  * score matrix — otherwise: softmax(q k^T / sqrt(Dh) + mask) v with
    torch matmuls.  GPT always passes a mask and takes this route.
A bool or integer mask (1 = keep) becomes an additive one of 0 / -1e4,
as in the JAX package.  The encoder / decoder classes wait for ROADMAP
Queue 1 item 5.
"""
from __future__ import annotations

import collections

import torch

from ...dygraph.layers import Layer
from .. import functional as F
from .common import Linear

__all__ = ["MultiHeadAttention"]


def _convert_attention_mask(attn_mask, dtype):
    if attn_mask is None:
        return None
    if attn_mask.dtype in (torch.bool, torch.int32, torch.int64):
        # True/1 = keep: additive 0 where kept, -1e4 where dropped
        return (attn_mask.to(dtype) - 1.0) * 1e4
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
            out = self.out_proj(self._merge(flash_attention(q, k, v)))
            if isinstance(cache, self.Cache):
                return out, cache
            return out

        scores = torch.matmul(q, k.transpose(-1, -2)) * \
            (self.head_dim ** -0.5)
        mask = _convert_attention_mask(attn_mask, scores.dtype)
        if mask is not None:
            scores = scores + mask
        weights = F.softmax(scores, axis=-1)
        if self.dropout:
            weights = F.dropout(weights, self.dropout,
                                training=self.training)
        out = self.out_proj(self._merge(torch.matmul(weights, v)))
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
