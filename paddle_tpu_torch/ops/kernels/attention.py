"""Attention ops for the static graph: flash_attention, ring_attention,
multihead_matmul and fused_embedding_eltwise_layernorm.  Counterparts of
the ops of the same names in paddle_tpu/ops/kernels/attention.py."""
from __future__ import annotations

import math

import torch

from ..registry import register_op
from ..attention import (flash_attention, reference_attention, ring_attention,
                         use_flash_for, SP_RING_ID)
from . import collective as _kc
from .nn import _embedding


def _infer_flash(ins, attrs):
    q = ins["Q"]
    return {"Out": torch.empty(q.shape, dtype=q.dtype, device="meta")}


@register_op("flash_attention", inputs=["Q", "K", "V"], outputs=["Out"],
             grad="auto", infer_shape=_infer_flash)
def flash_attention_op(ins, attrs, ctx):
    """Q/K/V: [B, H, S, D].  CUDA tensors launch the Hopper kernel
    (csrc/flash_attn_fwd.cu), CPU tensors run its plain version.  The
    grad op flash_attention_grad replays this under torch.func.vjp, which
    reaches the backward kernels (csrc/flash_attn_bwd.cu) through the
    autograd Function of ops/attention.py.  Refuses to run under a bound
    sequence-parallel ring, where shard-local attention would be silently
    wrong (the ring_attention op is the one for it)."""
    if ins["Q"].device.type != "meta" and \
            _kc.bound_group(SP_RING_ID) is not None:
        raise RuntimeError(
            "flash_attention op under a sequence-parallel mesh would "
            "attend only within the local shard; use the ring_attention "
            "op (ring_id=SP_RING_ID) instead")
    return {"Out": flash_attention(ins["Q"], ins["K"], ins["V"],
                                   causal=attrs.get("causal", False))}


@register_op("ring_attention", inputs=["Q", "K", "V"], outputs=["Out"],
             grad="auto", side_effect=True, infer_shape=_infer_flash)
def ring_attention_op(ins, attrs, ctx):
    """Sequence-parallel attention over the group bound to ``ring_id``
    (SP_RING_ID under a CompiledProgram with sequence_parallel_degree).
    Q/K/V: [B, S, H*D] with attr num_heads; the head split and merge
    happen inside the op, where the shapes are the local shard's.  Off a
    bound ring it is plain attention (a world of one): the flash op's
    kernel on CUDA, its plain version on the CPU.  The derived gradient
    replays the forward ring under torch.func.vjp, then runs the reverse
    ring (ops/attention.py)."""
    q, k, v = ins["Q"], ins["K"], ins["V"]
    h = int(attrs.get("num_heads", 1))
    causal = bool(attrs.get("causal", False))

    def split(x):
        b, s, hd = x.shape
        return x.reshape(b, s, h, hd // h).permute(0, 2, 1, 3)

    qh, kh, vh = split(q), split(k), split(v)
    group = None if q.device.type == "meta" else \
        _kc.bound_group(attrs.get("ring_id", SP_RING_ID))
    if group is None:
        out = flash_attention(qh, kh, vh, causal=causal)
    else:
        out = ring_attention(qh, kh, vh, group, causal=causal)
    b, hh, s, d = out.shape
    return {"Out": out.permute(0, 2, 1, 3).reshape(b, s, hh * d)}


@register_op("multihead_matmul",
             inputs=["Input", "WQ", "BQ?", "WK", "BK?", "WV", "BV?",
                     "BiasQK?"],
             outputs=["Out"], grad=None)
def multihead_matmul_op(ins, attrs, ctx):
    """The op multihead_matmul_fuse_pass writes for the score-matrix
    attention idiom: Q/K/V projections + attention, Input [B, L, D] ->
    Out [B, L, D].  Flash when there is no mask, the static length clears
    use_flash_for and alpha is 1/sqrt(d), as in paddle_tpu."""
    x = ins["Input"]
    h = int(attrs["head_number"])
    b, l, d = x.shape

    def proj(w, bias):
        y = torch.matmul(x, w)
        if bias is not None:
            y = y + bias.reshape(1, 1, -1)
        return y.reshape(b, l, h, -1).permute(0, 2, 1, 3)

    q = proj(ins["WQ"], ins.get("BQ"))
    k = proj(ins["WK"], ins.get("BK"))
    v = proj(ins["WV"], ins.get("BV"))
    scale = float(attrs.get("alpha", 1.0 / math.sqrt(q.shape[-1])))
    bias_qk = ins.get("BiasQK")
    if bias_qk is None and use_flash_for(l) and \
            abs(scale - 1.0 / math.sqrt(q.shape[-1])) < 1e-9:
        out = flash_attention(q, k, v)
    else:
        if bias_qk is not None:
            # broadcastable to [B, H, L, L]
            if bias_qk.dim() <= 2:
                while bias_qk.dim() < 4:
                    bias_qk = bias_qk[None]
            elif bias_qk.dim() == 3:
                bias_qk = bias_qk[:, None]
        out = reference_attention(q, k, v, bias=bias_qk, scale=scale)
    return {"Out": out.permute(0, 2, 1, 3).reshape(b, l, d)}


@register_op("fused_embedding_eltwise_layernorm",
             inputs=["Ids*!", "Embs*", "Scale?", "Bias?"],
             outputs=["Out"], grad=None)
def fused_embedding_eltwise_layernorm_op(ins, attrs, ctx):
    """BERT's input block as one op (written by the inference pass
    embedding_eltwise_layernorm_fuse_pass): the sum of N embedding
    lookups, then a layer_norm over the last axis.  Per-leaf attrs
    (leaf_types, padding_idxs) keep each lookup's semantics."""
    embs = ins["Embs"]
    if len(ins["Ids"]) != len(embs):
        raise ValueError(
            f"fused_embedding_eltwise_layernorm: {len(ins['Ids'])} Ids "
            f"inputs for {len(embs)} embedding tables")
    leaf_types = list(attrs.get("leaf_types",
                                ["lookup_table_v2"] * len(embs)))
    pads = list(attrs.get("padding_idxs", [-1] * len(embs)))
    total = None
    for i, (ids, emb) in enumerate(zip(ins["Ids"], embs)):
        if leaf_types[i] == "lookup_table" and ids.shape[-1] == 1:
            ids = ids.squeeze(-1)
        g = _embedding(emb, ids, {"padding_idx": pads[i]})
        total = g if total is None else total + g
    eps = float(attrs.get("epsilon", 1e-5))
    xf = total.float()
    m = xf.mean(dim=-1, keepdim=True)
    v = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - m) * torch.rsqrt(v + eps)
    if ins.get("Scale") is not None:
        y = y * ins["Scale"].float()
    if ins.get("Bias") is not None:
        y = y + ins["Bias"].float()
    return {"Out": y.to(total.dtype)}
