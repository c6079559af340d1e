"""The port's radix prefix cache (paddle_tpu_torch/serving/prefix_cache.py)
over its device-slab pool, against paddle_tpu's over the host pool: the
same retire / match / split / evict / reclaim sequence on both, then
equal match results, tree stats, pool refcounts, pins and free lists."""
import numpy as np
import torch

from paddle_tpu.serving import (PagedKVPool as JPool,
                                RadixPrefixCache as JRadix)
from paddle_tpu_torch.serving import PagedKVPool, RadixPrefixCache

GEOM = dict(num_layers=2, num_heads=2, head_dim=3, page_tokens=4)


class _Pair:
    """One pool + radix cache per package, driven in lockstep."""

    def __init__(self, pages, low, high):
        self.jp = JPool(num_pages=pages, **GEOM)
        self.tp = PagedKVPool(num_pages=pages, device="cpu", **GEOM)
        self.jr = JRadix(self.jp, low_watermark=low, high_watermark=high)
        self.tr = RadixPrefixCache(self.tp, low_watermark=low,
                                   high_watermark=high)
        self.rng = np.random.RandomState(0)

    def open(self, tokens):
        tokens = np.asarray(tokens, np.int64)
        shape = (2, 2, tokens.size, 3)
        k = self.rng.randn(*shape).astype(np.float32)
        v = self.rng.randn(*shape).astype(np.float32)
        return (self.jp.open_sequence(tokens, k, v),
                self.tp.open_sequence(tokens, torch.from_numpy(k),
                                      torch.from_numpy(v)))

    def retire(self, tokens):
        """Open, retain, close: the engine's _finish path in miniature."""
        jt, tt = self.open(tokens)
        new = (self.jr.insert(np.asarray(tokens, np.int64), jt),
               self.tr.insert(np.asarray(tokens, np.int64), tt))
        self.jp.close_sequence(jt)
        self.tp.close_sequence(tt)
        assert new[0] == new[1]
        self.same()
        return new[1]

    def match(self, tokens, **kw):
        got = self.tr.match(np.asarray(tokens, np.int64), **kw)
        assert got == self.jr.match(np.asarray(tokens, np.int64), **kw)
        return got

    def same(self):
        assert self.tr.stats() == self.jr.stats()
        np.testing.assert_array_equal(self.tp._refcount, self.jp._refcount)
        assert self.tp._free == self.jp._free
        assert self.tp._radix_pinned == self.jp._radix_pinned
        assert self.tp.pages_retained == self.jp.pages_retained


def test_radix_operations_match_jax():
    pr = _Pair(pages=12, low=2, high=4)
    a = list(range(2, 14))                    # 3 full pages
    assert pr.retire(a) == 3
    n, pids = pr.match(a)
    assert n == 12 and set(pids) == pr.tp._radix_pinned
    assert pr.match(a, max_tokens=11)[0] == 8   # capped below the prompt
    # divergence inside the edge splits the node
    b = a[:4] + [40, 41, 42, 43, 44]
    assert pr.retire(b) == 1
    assert pr.tr.stats()["nodes"] == 3
    assert pr.match(b + [1])[0] == 8
    assert pr.match([99] * 8) == (0, [])
    pr.same()
    # filling the pool below the low watermark evicts LRU leaves
    c = list(range(60, 72))
    pr.retire(c)
    pr.match(a)                                  # a is touched: newest
    d = list(range(80, 96))
    pr.retire(d)
    assert pr.tr.evicted_pages > 0
    pr.same()
    # an allocation that finds the free list empty reclaims retained pages
    n = pr.tp.pages_available
    jt = pr.jp.reserve(n)
    tt = pr.tp.reserve(n)
    for _ in range(n):
        jt.pages.append(pr.jp._alloc(jt))
        tt.pages.append(pr.tp._alloc(tt))
    assert pr.tp.pages_retained == 0
    pr.same()
    pr.jp.close_sequence(jt)
    pr.tp.close_sequence(tt)
    pr.tr.clear()
    pr.jr.clear()
    pr.same()
    pr.tp.assert_drained()
    assert pr.tp.pages_free == pr.tp.num_pages


def test_adopted_prefix_reads_the_retained_kv():
    """A retained prefix adopted into a new table gathers the very columns
    the retired sequence wrote (on the pool's device)."""
    pr = _Pair(pages=8, low=1, high=2)
    toks = list(range(2, 11))
    jt, tt = pr.open(toks)
    k_ref, v_ref = pr.tp.gather(tt)
    pr.tr.insert(np.asarray(toks, np.int64), tt)
    pr.tp.close_sequence(tt)
    n, pids = pr.tr.match(np.asarray(toks, np.int64), max_tokens=8)
    assert n == 8 and pr.tp.pages_retained == 2
    new = pr.tp.reserve(3)
    pr.tp.adopt_prefix(new, pids, n)
    k, v = pr.tp.gather(new)
    torch.testing.assert_close(k, k_ref[:, :, :8], rtol=0, atol=0)
    torch.testing.assert_close(v, v_ref[:, :, :8], rtol=0, atol=0)
    pr.tp.close_sequence(new)
    pr.tr.clear()
    pr.tp.assert_drained()
