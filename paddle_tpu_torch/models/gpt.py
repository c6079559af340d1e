"""GPT-style decoder-only language model + generation API.

Counterpart of paddle_tpu/models/gpt.py, on the port's dygraph `Layer`
and `nn` layers.  The same pre-norm blocks, tied LM head and parameter
names (`GPTModel.state_dict()` equals the JAX model's names and shapes,
so `set_state_dict` carries its weights over), and the same `generate()`
contract: greedy / sampling / beam search.

On the device: every tensor of the forward lives on the model's device
(its parameters'); the causal mask is cached per (length, device); ids,
positions and `pos_offset` are moved there once.  `generate()` runs
under `torch.inference_mode()` and reads to the host only the last
position's logits the sampler needs (one [batch, vocab] copy per step;
beam search hands them to the `beam_search` op on the host, as the JAX
package does).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import nn
from ..dygraph.layers import Layer

__all__ = ["GPTConfig", "GPTModel", "GPTForGeneration", "gpt_small"]


class GPTConfig:
    def __init__(self, vocab_size=5000, hidden_size=256, num_layers=4,
                 num_heads=4, intermediate_size=None, max_position=512,
                 bos_id=0, eos_id=1, dropout=0.1):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size or hidden_size * 4
        self.max_position = max_position
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.dropout = dropout


class _Block(Layer):
    """Pre-norm decoder block (GPT-2 style)."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln1 = nn.LayerNorm(cfg.hidden_size)
        self.attn = nn.MultiHeadAttention(cfg.hidden_size, cfg.num_heads,
                                          dropout=cfg.dropout)
        self.ln2 = nn.LayerNorm(cfg.hidden_size)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x, mask, cache=None):
        h = self.ln1(x)
        if cache is None:
            x = x + self.attn(h, h, h, attn_mask=mask)
        else:
            # incremental decode: attn consumes + extends the per-layer
            # KV cache (MultiHeadAttention.Cache concat path)
            out, cache = self.attn(h, h, h, attn_mask=mask, cache=cache)
            x = x + out
        h = self.ln2(x)
        x = x + self.fc2(nn.functional.gelu(self.fc1(h)))
        return x if cache is None else (x, cache)


class GPTModel(Layer):
    def __init__(self, cfg: GPTConfig = None, **kw):
        super().__init__()
        self.config = cfg or GPTConfig(**kw)
        c = self.config
        self.wte = nn.Embedding(c.vocab_size, c.hidden_size)
        self.wpe = nn.Embedding(c.max_position, c.hidden_size)
        self.blocks = nn.LayerList([_Block(c) for _ in range(c.num_layers)])
        self.ln_f = nn.LayerNorm(c.hidden_size)
        self._mask_cache = {}

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    def _mask(self, seq):
        # cached per length on the device: decode loops call every step
        # and should not upload an [S, S] mask host->device each time
        key = (seq, self.device)
        m = self._mask_cache.get(key)
        if m is None:
            m = torch.full((seq, seq), -1e9, dtype=torch.float32,
                           device=self.device).triu(1)
            self._mask_cache[key] = m
        return m

    def forward(self, input_ids, cache=None, pos_offset=None,
                attn_mask=None):
        """Plain LM forward, or — when ``cache`` (list of per-block
        ``MultiHeadAttention.Cache``) is given — one incremental decode
        step that returns ``(logits, new_caches)``.

        ``pos_offset``: per-row absolute position of ``input_ids[:, 0]``
        ([batch] ints: numpy or a tensor), for rows of different lengths
        in one batch.  ``attn_mask`` overrides the causal mask (the
        serving engine passes an additive mask that hides each slot's KV
        padding columns)."""
        dev = self.device
        ids = torch.as_tensor(input_ids, device=dev)
        seq = ids.shape[1]
        pos = torch.arange(seq, dtype=torch.int64, device=dev)[None]
        if pos_offset is not None:
            off = torch.as_tensor(pos_offset, dtype=torch.int64, device=dev)
            pos = off.reshape(-1, 1) + pos
        else:
            pos = pos.expand(ids.shape[0], seq)
        x = self.wte(ids) + self.wpe(pos)
        mask = attn_mask if attn_mask is not None else self._mask(seq)
        if cache is None:
            for blk in self.blocks:
                x = blk(x, mask)
            x = self.ln_f(x)
            # tied LM head
            return torch.matmul(x, self.wte.weight.t())
        new_caches = []
        for blk, c in zip(self.blocks, cache):
            x, c = blk(x, mask, cache=c)
            new_caches.append(c)
        x = self.ln_f(x)
        logits = torch.matmul(x, self.wte.weight.t())
        return logits, new_caches

    def gen_cache(self, batch_size):
        """Fresh empty per-block KV caches for ``batch_size`` rows, on the
        model's device (the serving engine's slot-admission entry
        point)."""
        c = self.config
        shape = (batch_size, c.num_heads, 0, c.hidden_size // c.num_heads)
        return [nn.MultiHeadAttention.Cache(
            torch.zeros(shape, device=self.device),
            torch.zeros(shape, device=self.device)) for _ in self.blocks]


class GPTForGeneration(Layer):
    """generate() with greedy / sampling / beam_search strategies (the
    paddle 2.x generation contract), built on the beam_search op."""

    def __init__(self, gpt: GPTModel):
        super().__init__()
        self.gpt = gpt

    def forward(self, input_ids):
        return self.gpt(input_ids)

    def _last_logits(self, ids: np.ndarray) -> np.ndarray:
        """[batch, vocab] fp32 logits at the last position, on the host."""
        with torch.inference_mode():
            logits = self.gpt(torch.as_tensor(ids, device=self.gpt.device))
            return logits[:, -1].float().cpu().numpy()

    def generate(self, input_ids, max_length=20,
                 decode_strategy="greedy_search", num_beams=4, top_k=0,
                 temperature=1.0, seed=0, length_penalty=0.0):
        cfg = self.gpt.config
        if isinstance(input_ids, torch.Tensor):
            input_ids = input_ids.cpu().numpy()
        ids = np.asarray(input_ids.numpy() if hasattr(input_ids, "numpy")
                         else input_ids).astype(np.int64)
        if decode_strategy not in ("greedy_search", "sampling",
                                   "beam_search"):
            raise ValueError(
                f"unknown decode_strategy {decode_strategy!r}; expected "
                "'greedy_search', 'sampling', or 'beam_search'")
        if ids.shape[1] + max_length > cfg.max_position:
            raise ValueError(
                f"prefix ({ids.shape[1]}) + max_length ({max_length}) "
                f"exceeds max_position ({cfg.max_position}); longer "
                "sequences would silently clamp position embeddings")
        if decode_strategy == "beam_search":
            return self._beam(ids, max_length, num_beams, length_penalty)
        rng = np.random.RandomState(seed)
        batch = ids.shape[0]
        finished = np.zeros(batch, bool)
        for _ in range(max_length):
            logits = self._last_logits(ids)
            if decode_strategy == "sampling":
                logits = logits / max(temperature, 1e-6)
                if top_k:
                    kth = np.sort(logits, -1)[:, -top_k][:, None]
                    logits = np.where(logits < kth, -1e9, logits)
                p = np.exp(logits - logits.max(-1, keepdims=True))
                p /= p.sum(-1, keepdims=True)
                nxt = np.array([rng.choice(p.shape[1], p=row)
                                for row in p])
            else:  # greedy_search
                nxt = logits.argmax(-1)
            nxt = np.where(finished, cfg.eos_id, nxt)
            finished |= nxt == cfg.eos_id
            ids = np.concatenate([ids, nxt[:, None].astype(np.int64)], 1)
            if finished.all():
                break
        return ids

    def _beam(self, ids, max_length, W, length_penalty=0.0):
        from ._decode import beam_search_loop
        return beam_search_loop(self._last_logits, ids, W,
                                self.gpt.config.eos_id, max_length,
                                length_penalty)


def gpt_small(**kw):
    return GPTForGeneration(GPTModel(GPTConfig(
        hidden_size=256, num_layers=4, num_heads=4, **kw)))
