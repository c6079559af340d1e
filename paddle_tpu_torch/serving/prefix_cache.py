"""Retained radix-tree prefix cache over the paged KV pool.

Copy of paddle_tpu/serving/prefix_cache.py (SGLang's RadixAttention idea
on the pool's page/refcount substrate); it holds no tensor and imports
no JAX, and the port keeps it as it is.  In short:

* **Retention** — at sequence retirement the full-page prefix of the
  committed tokens is inserted into a radix tree whose nodes PIN their
  pages in the pool (``pin_page``), so hot prompt heads stay resident
  across non-concurrent requests; pinned pages with no live sequence are
  the pool's RETAINED class (reclaimable headroom).
* **Compute sharing** — on a hit the engine maps the hit pages into the
  new sequence's page table (``adopt_prefix``) and runs prefill only over
  the uncovered suffix (``kv.radix_hit_tokens`` counts the tokens
  skipped).
* Edges are whole pages (``page_tokens`` token chunks), nodes split on
  page boundaries, LRU timestamps per node; retention is watermark-bounded
  (evict LRU leaves when free pages fall below ``low_watermark`` until
  ``high_watermark`` are free) and the pool's allocator calls ``reclaim``
  when retention has consumed the free list.  Watermarks come from the
  plan's ``retained_watermarks`` (``from_plan``) or default to pages/8,
  pages/4.

The tree keys on token bytes and stores page ids only: where the pool
keeps its slabs (host or device) does not enter here.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from . import metrics

__all__ = ["RadixPrefixCache"]


class _Node:
    """One radix edge + vertex: ``chunks[j]`` is the byte key of the
    j-th page on this edge (``page_tokens`` int64 tokens), ``pages[j]``
    the pinned pool page holding its KV.  Children are keyed by their
    first page's chunk bytes."""

    __slots__ = ("chunks", "pages", "children", "parent", "last_use")

    def __init__(self, chunks: List[bytes], pages: List[int],
                 parent: Optional["_Node"]):
        self.chunks = chunks
        self.pages = pages
        self.children: Dict[bytes, "_Node"] = {}
        self.parent = parent
        self.last_use = 0


class RadixPrefixCache:
    """Watermark-bounded retained prefix cache.

        cache = RadixPrefixCache(pool, low_watermark=4, high_watermark=8)
        n, pids = cache.match(prompt)          # longest retained prefix
        pool.adopt_prefix(table, pids, n)      # engine: map hit pages
        ...
        cache.insert(committed_tokens, table)  # engine: at retirement

    All mutation happens on the engine's single decode thread (like the
    pool); the pool's RLock covers the refcount plumbing.
    """

    def __init__(self, pool, low_watermark: int = 1,
                 high_watermark: int = 2,
                 max_retained_pages: Optional[int] = None):
        low, high = int(low_watermark), int(high_watermark)
        if not (0 < low < high <= pool.num_pages):
            raise ValueError(
                f"need 0 < low < high <= pages, got low={low} "
                f"high={high} pages={pool.num_pages}")
        self.pool = pool
        self.low_watermark = low
        self.high_watermark = high
        self.max_retained_pages = (int(max_retained_pages)
                                   if max_retained_pages else None)
        self._root = _Node([], [], None)
        self._clock = 0
        self.hits = 0
        self.hit_tokens = 0
        self.inserted_pages = 0
        self.evicted_pages = 0
        pool.set_reclaimer(self.reclaim)

    @classmethod
    def from_plan(cls, pool) -> "RadixPrefixCache":
        """Build with the watermarks ``static.page_budget`` put in the
        pool's recorded plan (falls back to pages/8 // pages/4 for a
        hand-built pool)."""
        wm = (pool.plan or {}).get("retained_watermarks") or {}
        low = int(wm.get("low", max(1, pool.num_pages // 8)))
        high = int(wm.get("high", max(low + 1, pool.num_pages // 4)))
        return cls(pool, low_watermark=low,
                   high_watermark=min(high, pool.num_pages))

    # -- chunking -----------------------------------------------------------
    def _chunks(self, tokens: np.ndarray, limit: Optional[int] = None
                ) -> List[bytes]:
        """Full-page byte keys of a token stream (partial tail page
        dropped — a partial page is never an exact-prefix unit)."""
        toks = np.ascontiguousarray(np.asarray(tokens, np.int64))
        T = self.pool.page_tokens
        q = int(toks.size) // T
        if limit is not None:
            q = min(q, max(0, int(limit)) // T)
        return [toks[i * T:(i + 1) * T].tobytes() for i in range(q)]

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # -- lookup -------------------------------------------------------------
    def match(self, tokens, max_tokens: Optional[int] = None
              ) -> Tuple[int, List[int]]:
        """Longest retained full-page prefix of ``tokens``: returns
        ``(n_tokens, page_ids)`` with ``n_tokens`` page-aligned (0 on a
        miss).  ``max_tokens`` caps the hit (the engine passes
        ``len(prompt) - 1`` so at least one suffix token always runs
        through the model for next-token logits).  Touches every node
        on the path (LRU protection)."""
        chunks = self._chunks(tokens, max_tokens)
        now = self._tick()
        node, i, pids = self._root, 0, []
        while i < len(chunks):
            child = node.children.get(chunks[i])
            if child is None:
                break
            child.last_use = now
            j = 0
            while (j < len(child.chunks) and i < len(chunks)
                   and child.chunks[j] == chunks[i]):
                pids.append(child.pages[j])
                i += 1
                j += 1
            if j < len(child.chunks):
                break           # diverged (or ran out) inside the edge
            node = child
        T = self.pool.page_tokens
        return len(pids) * T, pids

    # -- insert (retirement path) -------------------------------------------
    def insert(self, tokens, table) -> int:
        """Retain the full-page prefix of a retiring sequence's
        committed tokens: pages already in the tree are kept (the
        table's duplicates free normally at close), uncovered tail
        pages are pinned as new nodes.  Returns the number of NEWLY
        retained pages, then enforces the watermarks."""
        n = min(int(np.asarray(tokens).size), table.length)
        chunks = self._chunks(np.asarray(tokens)[:n])
        pids = [int(p) for p in table.pages[:len(chunks)]]
        now = self._tick()
        node, i = self._root, 0
        new_pages = 0
        while i < len(chunks):
            child = node.children.get(chunks[i])
            if child is None:
                if self.max_retained_pages is not None:
                    room = self.max_retained_pages - self.retained_pages
                    if room <= 0:
                        break
                    chunks, pids = chunks[:i + room], pids[:i + room]
                leaf = _Node(chunks[i:], pids[i:], node)
                leaf.last_use = now
                for pid in leaf.pages:
                    self.pool.pin_page(pid)
                node.children[chunks[i]] = leaf
                new_pages += len(leaf.pages)
                break
            child.last_use = now
            j = 0
            while (j < len(child.chunks) and i < len(chunks)
                   and child.chunks[j] == chunks[i]):
                i += 1
                j += 1
            if j == len(child.chunks):
                node = child            # edge fully matched, descend
                continue
            if i == len(chunks):
                break                   # new stream ends inside the edge
            # split-node: the edge diverges at page j — the common
            # prefix keeps the vertex, the old tail becomes a child
            tail = _Node(child.chunks[j:], child.pages[j:], child)
            tail.children = child.children
            for grandchild in tail.children.values():
                grandchild.parent = tail
            tail.last_use = child.last_use
            child.chunks = child.chunks[:j]
            child.pages = child.pages[:j]
            child.children = {tail.chunks[0]: tail}
            node = child                # loop re-enters: miss → new leaf
        if new_pages:
            self.inserted_pages += new_pages
        self.maintain()
        return new_pages

    # -- eviction -----------------------------------------------------------
    def _leaves(self) -> List[_Node]:
        out, stack = [], [self._root]
        while stack:
            nd = stack.pop()
            kids = list(nd.children.values())
            if not kids and nd is not self._root:
                out.append(nd)
            stack.extend(kids)
        return out

    def _evict_one(self) -> bool:
        """Drop the least-recently-used leaf: unpin its pages (they
        free unless a live sequence still shares them) and detach the
        node.  Returns False when the tree is empty."""
        leaves = self._leaves()
        if not leaves:
            return False
        leaf = min(leaves, key=lambda nd: nd.last_use)
        for pid in leaf.pages:
            self.pool.unpin_page(pid)
        del leaf.parent.children[leaf.chunks[0]]
        self.evicted_pages += len(leaf.pages)
        metrics.count("kv.evictions", len(leaf.pages))
        return True

    def maintain(self):
        """Watermark enforcement: when free pages fall below the low
        mark, evict LRU leaves until the high mark is free again (or
        nothing retained is left)."""
        if self.pool.pages_free >= self.low_watermark:
            return
        while self.pool.pages_free < self.high_watermark:
            if not self._evict_one():
                break

    def reclaim(self, n_free: int):
        """The pool allocator's hook (``set_reclaimer``): make at least
        ``n_free`` pages free by evicting LRU leaves — the promise that
        lets ``pages_available`` count retained pages."""
        while self.pool.pages_free < int(n_free):
            if not self._evict_one():
                break

    def clear(self):
        """Release every retained page (engine shutdown / tests)."""
        while self._evict_one():
            pass

    # -- observability ------------------------------------------------------
    @property
    def retained_pages(self) -> int:
        total, stack = 0, [self._root]
        while stack:
            nd = stack.pop()
            total += len(nd.pages)
            stack.extend(nd.children.values())
        return total

    @property
    def nodes(self) -> int:
        total, stack = 0, [self._root]
        while stack:
            nd = stack.pop()
            total += len(nd.children)
            stack.extend(nd.children.values())
        return total

    def stats(self) -> Dict:
        return {
            "nodes": self.nodes,
            "retained_pages": self.retained_pages,
            "retained_reclaimable": self.pool.pages_retained,
            "low_watermark": self.low_watermark,
            "high_watermark": self.high_watermark,
            "hits": self.hits,
            "hit_tokens": self.hit_tokens,
            "inserted_pages": self.inserted_pages,
            "evicted_pages": self.evicted_pages,
        }
