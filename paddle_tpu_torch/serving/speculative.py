"""Draft/target speculative decoding for the continuous-batching engine
(Leviathan et al. 2023; greedy-mode acceptance).

Counterpart of paddle_tpu/serving/speculative.py.  A small DRAFT model
proposes ``k`` tokens autoregressively; the TARGET verifies them all in
ONE batched step through the paged KV cache (the engine's
``_step_spec``, query width ``k + 1``).  Accepted prefixes commit; the
first rejection truncates the page-table tail (``PagedKVPool.truncate``)
and the target's own argmax replaces the rejected token, so greedy output
is TOKEN-EQUAL to the target decoding alone, whatever the draft says.

This module owns the draft side and the acceptance rule:

* ``SpeculativeDecoder`` wraps a draft model and keeps one dense KV
  cache per engine slot ON THE DEVICE (a ``[L, H, capacity, Dh]`` buffer
  per tensor, written in place one column per fed token; a rollback just
  moves the valid length back).  Proposals are greedy: each proposed
  token is the device argmax of the previous draft step and is fed back
  without a host read; the ``n`` proposals come to the host in one read.
* ``longest_accepted(proposed, target_greedy)``: drafts are accepted
  while they match the target's greedy chain.
* ``stamp_draft(target, num_layers=2)`` stamps a draft sibling from the
  TARGET's config (same vocab / hidden / heads, ``num_layers`` blocks) on
  the target's device and adopts its embeddings, first blocks and final
  LayerNorm.  With ``num_layers`` equal to the target's, the stamp is
  exact and every proposal is accepted; a shallower stamp exercises real
  rejection.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from ..core.compile_cache import next_pow2 as _next_pow2

__all__ = ["SpeculativeDecoder", "stamp_draft", "longest_accepted"]

_NEG_INF = -1e9


def longest_accepted(proposed: Sequence[int],
                     target_greedy: Sequence[int]) -> int:
    """Number of draft tokens accepted under greedy verification: the
    longest prefix of ``proposed`` matching the target's greedy chain
    (``target_greedy[t]`` = the target argmax after the fed prefix ending
    in token t).  Chain acceptance: a mismatch at j invalidates every
    later draft."""
    a = 0
    while a < len(proposed) and a < len(target_greedy) \
            and int(proposed[a]) == int(target_greedy[a]):
        a += 1
    return a


def stamp_draft(target, num_layers: int = 2, copy_weights: bool = True):
    """A draft sibling of the target on its device: same vocab, hidden,
    heads and positions, ``num_layers`` blocks, dropout 0.
    ``copy_weights`` adopts the target's embeddings, first ``num_layers``
    blocks and final LayerNorm (the structured names line up; deeper
    blocks are absent from the draft)."""
    from ..dygraph import guard
    from ..models.gpt import GPTConfig, GPTModel, GPTForGeneration
    from .int8_decode import _place_of
    gpt = getattr(target, "gpt", target)
    c = gpt.config
    draft_cfg = GPTConfig(
        vocab_size=c.vocab_size, hidden_size=c.hidden_size,
        num_layers=min(int(num_layers), int(c.num_layers)),
        num_heads=c.num_heads, intermediate_size=c.intermediate_size,
        max_position=c.max_position, bos_id=c.bos_id, eos_id=c.eos_id,
        dropout=0.0)
    with guard(_place_of(gpt.device)):
        draft = GPTForGeneration(GPTModel(draft_cfg))
    if copy_weights:
        draft.gpt.set_state_dict(gpt.state_dict())
    draft.eval()
    return draft


class _DraftState:
    """One slot's draft-side memory: dense KV buffers [L, H, cap, Dh] on
    the device, ``n`` valid columns, and the token stream those columns
    were computed for."""

    __slots__ = ("k", "v", "n", "fed")

    def __init__(self, k, v):
        self.k, self.v = k, v
        self.n = 0
        self.fed: List[int] = []


class SpeculativeDecoder:
    """Draft-model manager for one engine: per-slot dense draft KV on the
    device, greedy proposals, commit / rollback mirroring the target's
    page table.

        spec = SpeculativeDecoder(stamp_draft(target), k=4)
        eng = ContinuousBatchingEngine(target, kv_pool=plan,
                                       speculative=spec)

    Proposal forwards are batch-1 with the engine's pow2 KV bucketing."""

    def __init__(self, draft_model, k: int = 4,
                 kv_bucket_floor: int = 16):
        self._draft = getattr(draft_model, "gpt", draft_model)
        self.config = self._draft.config
        self.k = int(k)
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self._floor = int(kv_bucket_floor)
        self._state: Dict[int, _DraftState] = {}
        self._buckets = None   # the engine's kv-bucket set (shared)
        self._on_bucket = None
        self.draft_tokens = 0

    @property
    def device(self) -> torch.device:
        return self._draft.device

    def geometry_check(self, target_config):
        """The draft must speak the target's token space and position
        range (acceptance compares token ids; positions index wpe)."""
        for name in ("vocab_size", "max_position", "eos_id"):
            want, got = (int(getattr(target_config, name)),
                         int(getattr(self.config, name)))
            if want != got:
                raise ValueError(
                    f"draft/target mismatch: {name} target={want} "
                    f"draft={got}")

    def track_buckets(self, bucket_set, on_change=None):
        """Share the engine's bucket set, so draft shapes count in the
        same gauge."""
        self._buckets = bucket_set
        self._on_bucket = on_change

    def _bucket(self, tag, n):
        if self._buckets is not None:
            before = len(self._buckets)
            self._buckets.add(("draft_" + tag, n))
            if self._on_bucket is not None \
                    and len(self._buckets) != before:
                self._on_bucket()

    # -- slot lifecycle -----------------------------------------------------
    def open(self, slot: int, prompt_tokens):
        """Draft prefill at admission: one forward over the prompt
        (pow2-padded like the engine's target prefill) seeds this slot's
        dense draft KV."""
        cfg = self.config
        dev = self.device
        toks = [int(t) for t in prompt_tokens]
        p = len(toks)
        pp = min(_next_pow2(p, self._floor), int(cfg.max_position))
        self._bucket("prefill", pp)
        ids = torch.full((1, pp), int(cfg.eos_id), dtype=torch.int64,
                         device=dev)
        ids[0, :p] = torch.as_tensor(toks, dtype=torch.int64).to(dev)
        _, caches = self._draft.forward(
            ids, cache=self._draft.gen_cache(1),
            pos_offset=torch.zeros(1, dtype=torch.int64, device=dev),
            attn_mask=self._draft._mask(pp))
        cap = _next_pow2(int(cfg.max_position), self._floor)
        H, Dh = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        shape = (cfg.num_layers, H, cap, Dh)
        st = _DraftState(torch.zeros(shape, device=dev),
                         torch.zeros(shape, device=dev))
        st.k[:, :, :p] = torch.stack([c.k[0, :, :p] for c in caches])
        st.v[:, :, :p] = torch.stack([c.v[0, :, :p] for c in caches])
        st.n, st.fed = p, toks
        self._state[slot] = st

    def close(self, slot: int):
        self._state.pop(slot, None)

    def close_all(self):
        self._state.clear()

    @property
    def open_slots(self) -> int:
        return len(self._state)

    # -- proposal -----------------------------------------------------------
    def _feed_one(self, st: _DraftState, ids: torch.Tensor) -> torch.Tensor:
        """Advance the draft one token (``ids``: [1, 1] int64 on the
        device): extends the draft KV by one column and returns the
        next-token logits [V] on the device."""
        from ..nn import MultiHeadAttention
        dev = self.device
        n = st.n
        lpad = _next_pow2(max(1, n), self._floor)
        self._bucket("decode", lpad)
        cols = torch.arange(lpad + 1, device=dev)
        mask = torch.where((cols < n) | (cols == lpad), 0.0, _NEG_INF)
        caches = [MultiHeadAttention.Cache(st.k[li, None, :, :lpad],
                                           st.v[li, None, :, :lpad])
                  for li in range(self.config.num_layers)]
        logits, new_caches = self._draft.forward(
            ids, cache=caches,
            pos_offset=torch.full((1,), n, dtype=torch.int64, device=dev),
            attn_mask=mask[None, None, None])
        st.k[:, :, n] = torch.stack([c.k[0, :, lpad] for c in new_caches])
        st.v[:, :, n] = torch.stack([c.v[0, :, lpad] for c in new_caches])
        st.n = n + 1
        self.draft_tokens += 1
        return logits[0, 0]

    def propose(self, slot: int, committed: Sequence[int],
                pending: int, n: Optional[int] = None) -> List[int]:
        """Greedily propose up to ``n`` (default ``k``) tokens after
        ``committed + [pending]``.  Tokens the draft has not seen yet (the
        bonus token after a full accept) are fed first; the draft KV ends
        covering the whole stream plus all but the last proposal.  The
        proposals come to the host in one read."""
        st = self._state[slot]
        stream = [int(t) for t in committed] + [int(pending)]
        if st.fed != stream[:len(st.fed)]:
            raise AssertionError(
                "draft cache diverged from the committed stream — "
                "commit() missed a rollback")
        n = self.k if n is None else min(int(n), self.k)
        catch_up = stream[len(st.fed):]
        if not catch_up:
            raise AssertionError("propose() needs >= 1 unfed token")
        dev = self.device
        logits = None
        for tok in catch_up:
            logits = self._feed_one(st, torch.full(
                (1, 1), tok, dtype=torch.int64, device=dev))
        st.fed.extend(catch_up)
        props = []
        for j in range(n):
            nxt = torch.argmax(logits).reshape(1, 1)
            props.append(nxt)
            if j + 1 < n:   # the last proposal is never fed
                logits = self._feed_one(st, nxt)
        proposals = [int(t) for t in torch.cat(props).reshape(-1).cpu()]
        st.fed.extend(proposals[:-1])
        return proposals

    # -- commit / rollback --------------------------------------------------
    def commit(self, slot: int, committed: Sequence[int],
               pending: Optional[int]):
        """Mirror the target-side outcome: truncate the draft KV to the
        longest prefix of what it fed that the engine committed
        (``committed`` + the pending next token).  The columns past it are
        overwritten by later feeds."""
        st = self._state.get(slot)
        if st is None:
            return
        stream = [int(t) for t in committed]
        if pending is not None:
            stream.append(int(pending))
        keep = 0
        while keep < len(st.fed) and keep < len(stream) \
                and st.fed[keep] == stream[keep]:
            keep += 1
        if keep < len(st.fed):
            st.fed = st.fed[:keep]
            st.n = keep

    def stats(self) -> Dict:
        return {"k": self.k, "open_slots": len(self._state),
                "draft_tokens": self.draft_tokens,
                "draft_layers": int(self.config.num_layers)}
