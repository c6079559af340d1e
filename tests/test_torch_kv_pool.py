"""The port's paged KV pool (paddle_tpu_torch/serving/kv_pool.py), its
slabs torch tensors on the pool's device (the CPU here), against
paddle_tpu's host-numpy pool: the same sequence of operations — reserve,
open (with prefix sharing), append, copy-on-write, truncate, pin, adopt,
unpin (evict), close — on both, then equal refcounts, free lists,
prefix registrations, tables, stats and gathered KV (exactly equal: the
pools only copy values)."""
import numpy as np
import pytest
import torch

from paddle_tpu.serving import PagedKVPool as JPool
from paddle_tpu_torch.serving import (PagedKVPool, PagePoolExhaustedError,
                                      budget_drift)

GEOM = dict(num_layers=2, num_heads=2, head_dim=3, page_tokens=4)
STATS = ("pages_total", "pages_free", "pages_used", "pages_reserved",
         "pages_shared", "pages_retained", "page_tokens", "page_bytes",
         "prefix_hits", "cow_copies", "kv_dtype", "occupancy")


def _pools(pages=20):
    return (JPool(num_pages=pages, **GEOM),
            PagedKVPool(num_pages=pages, device="cpu", **GEOM))


def _kv(rng, n):
    shape = (GEOM["num_layers"], GEOM["num_heads"], n, GEOM["head_dim"])
    return rng.randn(*shape).astype(np.float32), \
        rng.randn(*shape).astype(np.float32)


def _same(jp, tp, tables):
    np.testing.assert_array_equal(tp._refcount, jp._refcount)
    assert tp._free == jp._free
    assert tp._prefix == jp._prefix and tp._page_key == jp._page_key
    assert tp._radix_pinned == jp._radix_pinned
    js, ts = jp.stats(), tp.stats()
    assert {k: ts[k] for k in STATS} == {k: js[k] for k in STATS}
    for jt, tt in tables:
        assert (tt.pages, tt.length, tt.reserved, tt.charged) == \
            (jt.pages, jt.length, jt.reserved, jt.charged)
        for got, want in zip(tp.gather(tt), jp.gather(jt)):
            assert got.device == tp.device
            np.testing.assert_array_equal(got.numpy(), want)


def test_pool_operations_match_jax():
    jp, tp = _pools()
    rng = np.random.RandomState(0)
    head = rng.randint(2, 50, (8,)).astype(np.int64)   # two full pages
    pa = np.concatenate([head, [7]])
    pb = np.concatenate([head, [9, 11]])

    def both(fn, *args):
        return fn(jp, *args), fn(tp, *args)

    def reserve_open(prompt, kv):
        n = jp.pages_for_request(prompt.size, 4)
        assert tp.pages_for_request(prompt.size, 4) == n
        tj, tt = both(lambda p: p.reserve(n))
        jp.open_sequence(prompt, *kv, table=tj)
        tp.open_sequence(prompt, *(torch.from_numpy(x) for x in kv),
                         table=tt)
        return tj, tt

    kv_a = _kv(rng, pa.size)
    a = reserve_open(pa, kv_a)
    # b shares the two head pages (the KV of a causal prefix is a function
    # of the prefix: hand it the same columns)
    kv_b = tuple(np.concatenate([x[:, :, :8], y], 2) for x, y in
                 zip(kv_a, _kv(rng, 2)))
    b = reserve_open(pb, kv_b)
    # c repeats a's prompt: all three pages shared, the partial one too
    c = reserve_open(pa, kv_a)
    _same(jp, tp, [a, b, c])
    assert tp.prefix_hits == 5 and tp.pages_shared == 3
    # decode columns: into c's shared partial page (copy-on-write), then
    # across a page boundary (a fresh page)
    for _ in range(4):
        col = _kv(rng, 1)
        jp.append_column(c[0], col[0][:, :, 0], col[1][:, :, 0])
        tp.append_column(c[1], torch.from_numpy(col[0][:, :, 0]),
                         torch.from_numpy(col[1][:, :, 0]))
    assert tp.cow_copies == 1
    _same(jp, tp, [a, b, c])
    # roll c back into its first page, then retain a's head pages and
    # retire a: they stay resident (pinned), the partial page frees
    jp.truncate(c[0], 3)
    tp.truncate(c[1], 3)
    for pid in a[0].pages[:2]:
        jp.pin_page(pid)
        tp.pin_page(pid)
    jp.close_sequence(a[0])
    tp.close_sequence(a[1])
    _same(jp, tp, [b, c])
    # a fresh sequence adopts the retained head (radix-hit path)
    n = jp.pages_for_request(9, 2)
    d = (jp.reserve(n), tp.reserve(n))
    hit = list(b[0].pages[:2])
    jp.adopt_prefix(d[0], hit, 8)
    tp.adopt_prefix(d[1], hit, 8)
    _same(jp, tp, [b, c, d])
    # evict the pins, retire everything: drained on both
    for pid in hit:
        jp.unpin_page(pid)
        tp.unpin_page(pid)
    for jt, tt in (b, c, d):
        jp.close_sequence(jt)
        tp.close_sequence(tt)
    _same(jp, tp, [])
    jp.assert_drained()
    tp.assert_drained()
    assert tp.pages_free == tp.num_pages


def test_reservation_and_leak_checks_match_jax():
    jp, tp = _pools(pages=4)
    rng = np.random.RandomState(1)
    for p in (jp, tp):
        t = p.reserve(3)
        assert p.pages_available == 1 and not p.can_reserve(2)
    with pytest.raises(PagePoolExhaustedError):
        tp.reserve(2)
    prompt = rng.randint(2, 50, (4,)).astype(np.int64)
    k, v = _kv(rng, 4)
    tt = tp.open_sequence(prompt, torch.from_numpy(k), torch.from_numpy(v),
                          reserved=1)
    with pytest.raises(PagePoolExhaustedError, match="reservation"):
        tp.append_column(tt, torch.zeros(2, 2, 3), torch.zeros(2, 2, 3))
    with pytest.raises(AssertionError, match="page leak"):
        tp.assert_drained()
    tp.close_sequence(tt)
    tp.release(t)
    tp.assert_drained()


def test_gather_batch_is_the_dense_batched_cache():
    """gather_batch builds [L, S, H, width, Dh] in one device gather from
    the page_index table: row i's first table.length columns equal
    gather(table i)."""
    _, tp = _pools(pages=16)
    rng = np.random.RandomState(2)
    tables = []
    for n in (5, 9, 1):
        k, v = _kv(rng, n)
        tables.append(tp.open_sequence(
            rng.randint(2, 50, (n,)).astype(np.int64), torch.from_numpy(k),
            torch.from_numpy(v)))
    idx = tp.page_index([tables[0], None, tables[1], tables[2]], 16)
    assert idx.shape == (4, 4) and not idx[1].any()
    k_b, v_b = tp.gather_batch(torch.from_numpy(idx), 16)
    assert k_b.shape == (2, 4, 2, 16, 3)
    for row, t in ((0, tables[0]), (2, tables[1]), (3, tables[2])):
        k, v = tp.gather(t)
        torch.testing.assert_close(k_b[:, row, :, :t.length], k, rtol=0,
                                   atol=0)
        torch.testing.assert_close(v_b[:, row, :, :t.length], v, rtol=0,
                                   atol=0)
    for t in tables:
        tp.close_sequence(t)
    tp.assert_drained()


def test_plan_geometry_drift_and_what_still_raises():
    plan = dict(num_layers=2, num_heads=2, head_dim=3, page_tokens=4,
                pages=6, max_slots=2, max_context=24)
    pool = PagedKVPool.from_plan(plan, device="cpu")
    assert pool.k.shape == (2, 6, 2, 4, 3) and pool.plan == plan
    assert pool.stats()["pool_bytes"] == 2 * 2 * 6 * 2 * 4 * 3 * 4
    assert budget_drift(pool) == []
    pool.num_pages = 7
    assert budget_drift(pool) == ["pages: pool has 7, plan records 6"]
    assert budget_drift(PagedKVPool(device="cpu", **GEOM))[0].startswith(
        "pool carries no recorded plan")
    # int8 pages are ported (tests/test_torch_int8_serving.py), and so
    # is a tp-sharded pool's plan (tests/test_torch_tp_decode.py): each
    # rank of the tp group holds its heads' share of a page
    pool8 = PagedKVPool(kv_dtype="int8", device="cpu", **GEOM)
    assert pool8.is_quantized and pool8.k.dtype == torch.int8
    pool2 = PagedKVPool.from_plan(dict(plan, tp_degree=2), device="cpu")
    assert pool2.tp_degree == 2 and pool.tp_degree == 1
    assert pool2.page_bytes_per_chip * 2 == pool2.page_bytes
