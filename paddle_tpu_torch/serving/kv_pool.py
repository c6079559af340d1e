"""Block-paged KV-cache pool with copy-on-write prefix sharing, its slabs
on the device.

Counterpart of paddle_tpu/serving/kv_pool.py (vLLM's PagedAttention block
manager; SGLang's prefix cache), with the same bookkeeping: KV lives in
FIXED-SIZE PAGES of ``page_tokens`` token columns, allocated ONCE as one
``[L, P, H, T, Dh]`` slab per tensor (one page id indexes every layer's
slice), each sequence owns a PAGE TABLE mapping logical token positions
to page ids, prompt pages are shared by the hash of the exact token
prefix they complete (refcounted, copy-on-write on the first decode write
into a shared page), admission is by worst-case PAGE RESERVATION, and the
radix prefix cache may PIN pages past their last sharer (RETAINED pages,
reclaimable on demand).  See the JAX module's docstring for the full
contract; every rule of it holds here.

What differs is where the bytes live.  The JAX pool keeps its slabs in
host numpy arrays, and its engine builds the dense batched cache on the
host and uploads it every decode step.  Here the slabs are torch tensors
on the pool's device (CUDAPlace(0) unless the caller names one), and
``open_sequence``, ``append_column``, the copy-on-write copy, ``gather``
and ``gather_batch`` take and return device tensors and index on the
device (``gather_batch`` reads a page-index table the caller uploads).
The reservation, refcount, prefix-key and pin bookkeeping stays on the
host, in Python, as in the JAX package: it is a few integers per page
and never touches the slabs.

int8 pages (``kv_dtype="int8"``): the slabs hold int8 with a
per-(layer, page, head) fp32 dequant scale sidecar on the device
(``x ~ q * scale``, ``scale = absmax / 127``), quantized on write
(``rint(x / scale)``, the JAX package's order) and dequantized inside
``gather`` and ``gather_batch``, so page tables, copy-on-write (which
copies the scale rows with the page), radix adoption and ``truncate``
ride unchanged on page ids.  A decode column hotter than its page's
scale grows the scale and requantizes the resident columns under it
(requantize-on-grow), written branch-free on the device: ``new =
max(old, col_absmax / 127)``, residents times ``old / new`` (exactly 1
where the scale did not grow), so no column costs a host read.  Any
element a defensive clamp saturates is counted on the device;
``quant_scale_clips`` reads the count (one host read, in ``stats()``).

``budget_drift`` re-derives the recorded plan through
``static.planner.page_budget`` under its recorded inputs and reports every
way the live geometry disagrees.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import metrics
from ..core.dtype import convert_dtype, torch_dtype

__all__ = ["PagedKVPool", "PageTable", "PagePoolExhaustedError",
           "budget_drift"]


class PagePoolExhaustedError(RuntimeError):
    """A page allocation found the free list empty.  Reservation
    accounting makes this unreachable from the engine — raising it
    loudly means the accounting itself is broken, not the load."""


class PageTable:
    """One sequence's mapping from logical token positions to pages.

    ``pages[j]`` holds positions ``[j*T, (j+1)*T)``; ``length`` tokens
    are valid.  ``reserved`` is the worst-case page count admission
    granted; ``charged`` counts the allocations (fresh + COW) already
    consumed from it."""

    __slots__ = ("pages", "length", "reserved", "charged")

    def __init__(self, reserved: int):
        self.pages: List[int] = []
        self.length = 0
        self.reserved = int(reserved)
        self.charged = 0


class PagedKVPool:
    """Fixed-size paged KV storage shared by every active sequence.

        pool = PagedKVPool(num_layers=4, num_heads=4, head_dim=64,
                           page_tokens=16, num_pages=256, device="cuda")
        table = pool.open_sequence(prompt, k_lhpd, v_lhpd, reserved=R)
        k, v = pool.gather(table)          # [L, H, len, Dh] on the device
        pool.append_column(table, k_col, v_col)
        pool.close_sequence(table)         # refcounts drop, pages free

    All mutation happens on the engine's single decode thread; the
    internal lock only protects the stats surface other threads read.
    """

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 page_tokens: int = 16, num_pages: int = 64,
                 dtype="float32", plan: Optional[Dict] = None,
                 kv_dtype=None, device=None):
        if page_tokens < 1 or num_pages < 1:
            raise ValueError(
                f"need positive page_tokens/num_pages, got "
                f"{page_tokens}/{num_pages}")
        name = convert_dtype(kv_dtype if kv_dtype is not None else dtype)
        if name not in ("float32", "float16", "bfloat16", "int8"):
            raise ValueError(
                f"kv pages must be a float dtype or int8, got {name}")
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.page_tokens = int(page_tokens)
        self.num_pages = int(num_pages)
        self.kv_dtype = name
        self.dtype = torch_dtype(name)
        self.is_quantized = name == "int8"
        if device is None:
            from ..core.place import resolve_place
            device = resolve_place(None).torch_device()
        self.device = torch.device(device)
        # ONE slab per tensor, allocated up front on the device: page id p
        # is self.k[:, p] across every layer (no per-sequence allocation
        # ever happens again)
        shape = (self.num_layers, self.num_pages, self.num_heads,
                 self.page_tokens, self.head_dim)
        self.k = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=self.dtype, device=self.device)
        if self.is_quantized:
            # per-(layer, page, head) fp32 dequant scale: x ~ q * scale
            sshape = (self.num_layers, self.num_pages, self.num_heads)
            self.k_scale = torch.zeros(sshape, dtype=torch.float32,
                                       device=self.device)
            self.v_scale = torch.zeros_like(self.k_scale)
        # elements a defensive clamp saturated, counted on the device
        self._clips = torch.zeros((), dtype=torch.int64, device=self.device)
        # the int8 grid's 127 as a device tensor: a Python-scalar divisor
        # makes a CUDA division multiply by the reciprocal instead
        self._q127 = torch.full((), 127.0, device=self.device)
        self._refcount = np.zeros(self.num_pages, np.int32)
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self._reserved_unallocated = 0
        # maintained on refcount 1<->2 transitions: _publish runs once
        # per appended token, so pages_shared must not scan the pool
        self._shared_pages = 0
        # prefix sharing: exact-token-prefix key -> page id, and back
        self._prefix: Dict[bytes, int] = {}
        self._page_key: Dict[int, bytes] = {}
        # retention: page ids the radix prefix cache holds one ref on; a
        # pinned page with refcount 1 is RETAINED (cache-only) and
        # reclaimable through _reclaim_cb.  RLock: the reclaimer runs
        # inside _alloc and calls back into unpin_page.
        self._radix_pinned: set = set()
        self._reclaim_cb = None
        self._mu = threading.RLock()
        self.cow_copies = 0
        self.prefix_hits = 0
        self.plan = dict(plan) if plan else None
        self._publish()

    @classmethod
    def from_plan(cls, plan: Dict, dtype="float32",
                  device=None) -> "PagedKVPool":
        """Build a pool from a plan dict (num_layers, num_heads, head_dim,
        page_tokens, pages; optional kv_dtype, max_slots, max_context,
        retained_watermarks) and record the plan."""
        return cls(num_layers=int(plan["num_layers"]),
                   num_heads=int(plan["num_heads"]),
                   head_dim=int(plan["head_dim"]),
                   page_tokens=int(plan["page_tokens"]),
                   num_pages=int(plan["pages"]),
                   dtype=plan.get("kv_dtype", dtype), plan=plan,
                   device=device)

    # -- geometry -----------------------------------------------------------
    @property
    def page_bytes(self) -> int:
        """Bytes one page occupies across both tensors and all layers; for
        int8 pages the int8 data plus the fp32 scale sidecar rows of K and
        V."""
        data = 2 * self.num_layers * self.num_heads * self.page_tokens \
            * self.head_dim * self.k.element_size()
        if self.is_quantized:
            data += 2 * self.num_layers * self.num_heads * 4
        return data

    @property
    def tp_degree(self) -> int:
        """The tensor-parallel degree the recorded plan sized this pool
        for (1 = one device).  The pool always holds the full head dim on
        the leader's device (page ids, refcounts and tables are global
        token geometry), but under tp-sharded decode each rank's part of
        a page's K/V is ``[L, H/tp, T, Dh]``, so the per-device charge
        divides."""
        return int((self.plan or {}).get("tp_degree", 1))

    @property
    def page_bytes_per_chip(self) -> int:
        """Bytes of one page a rank of the tp group holds:
        `page_bytes` over the tp degree (the number the plan carved pages
        against)."""
        return self.page_bytes // max(1, self.tp_degree)

    @property
    def pool_bytes(self) -> int:
        """Bytes of both slabs (and scale sidecars) on the device."""
        return self.page_bytes * self.num_pages

    @property
    def quant_scale_clips(self) -> int:
        """Elements a defensive clamp saturated (0 by construction under
        requantize-on-grow); reading it is one host read."""
        return int(self._clips)

    def pages_needed(self, n_tokens: int) -> int:
        """Worst-case pages a sequence of ``n_tokens`` total (prompt +
        generated) occupies — the admission reservation unit."""
        return -(-max(0, int(n_tokens)) // self.page_tokens)

    def pages_for_request(self, prompt_tokens: int,
                          new_tokens: int) -> int:
        """Admission reservation for one request: the worst-case page
        count plus one COW allowance when the prompt's final page is
        partial (a later identical prompt may share it, and then this
        sequence's first decode write needs a copy)."""
        p = max(0, int(prompt_tokens))
        extra = 1 if p % self.page_tokens else 0
        return self.pages_needed(p + max(0, int(new_tokens))) + extra

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_reserved(self) -> int:
        return self._reserved_unallocated

    @property
    def pages_shared(self) -> int:
        return self._shared_pages

    @property
    def pages_retained(self) -> int:
        """Pages held ONLY by the radix prefix cache (pinned, no live
        sequence)."""
        with self._mu:
            return sum(1 for pid in self._radix_pinned
                       if self._refcount[pid] == 1)

    @property
    def pages_available(self) -> int:
        """Pages a NEW reservation may claim right now (retained pages
        count: the reclaimer evicts them on demand)."""
        return len(self._free) + self.pages_retained \
            - self._reserved_unallocated

    def set_reclaimer(self, fn):
        """Register the radix cache's eviction hook: ``fn(n)`` must try
        to bring ``pages_free`` up to ``n`` by unpinning retained
        pages."""
        self._reclaim_cb = fn

    # -- admission reservation ---------------------------------------------
    def can_reserve(self, n_pages: int) -> bool:
        return int(n_pages) <= self.pages_available

    def reserve(self, n_pages: int) -> PageTable:
        """Claim worst-case headroom for one sequence; the returned
        table is the charge account every later allocation debits."""
        n = int(n_pages)
        if n > self.pages_available:
            raise PagePoolExhaustedError(
                f"cannot reserve {n} pages "
                f"({self.pages_available} available of {self.num_pages})")
        self._reserved_unallocated += n
        self._publish()
        return PageTable(n)

    def release(self, table: PageTable):
        """Return a table's unconsumed reservation."""
        left = table.reserved - table.charged
        if left > 0:
            self._reserved_unallocated -= left
        table.reserved = table.charged
        self._publish()

    # -- page plumbing ------------------------------------------------------
    def _alloc(self, table: PageTable) -> int:
        if table.charged >= table.reserved:
            raise PagePoolExhaustedError(
                f"sequence exceeded its reservation "
                f"({table.reserved} pages)")
        if not self._free and self._reclaim_cb is not None:
            self._reclaim_cb(1)
        if not self._free:
            raise PagePoolExhaustedError(
                "free list empty under outstanding reservations — "
                "reservation accounting bug")
        pid = self._free.pop()
        self._refcount[pid] = 1
        table.charged += 1
        self._reserved_unallocated -= 1
        return pid

    def _incref(self, pid: int):
        self._refcount[pid] += 1
        if self._refcount[pid] == 2:
            self._shared_pages += 1

    def _decref(self, pid: int):
        self._refcount[pid] -= 1
        if self._refcount[pid] == 1:
            self._shared_pages -= 1
        if self._refcount[pid] == 0:
            key = self._page_key.pop(pid, None)
            if key is not None and self._prefix.get(key) == pid:
                del self._prefix[key]
            self._free.append(pid)

    # -- retention (radix prefix cache hooks) -------------------------------
    def pin_page(self, pid: int):
        """Hold one reference on a page past last-sharer retirement.
        Idempotent per page."""
        with self._mu:
            if self._refcount[pid] < 1:
                raise ValueError(f"cannot pin free page {pid}")
            if pid in self._radix_pinned:
                return
            self._radix_pinned.add(pid)
            self._incref(pid)
        self._publish()

    def unpin_page(self, pid: int):
        """Drop a pin: the page frees now if no live sequence still
        references it."""
        with self._mu:
            if pid not in self._radix_pinned:
                return
            self._radix_pinned.discard(pid)
            self._decref(pid)
        self._publish()

    def adopt_prefix(self, table: PageTable, pids: Sequence[int],
                     n_tokens: int):
        """Map already-resident prefix pages into a fresh sequence's page
        table (refcount bumps, no writes, no charge)."""
        n = int(n_tokens)
        if n % self.page_tokens or len(pids) != n // self.page_tokens:
            raise ValueError(
                f"adopt_prefix needs page-aligned tokens: {n} tokens "
                f"vs {len(pids)} pages of {self.page_tokens}")
        if table.pages or table.length:
            raise ValueError("adopt_prefix needs a fresh page table")
        with self._mu:
            for pid in pids:
                if self._refcount[pid] < 1:
                    raise ValueError(
                        f"page {pid} is free — stale radix hit")
            for pid in pids:
                self._incref(pid)
                table.pages.append(int(pid))
            table.length = n
        self._publish()

    def truncate(self, table: PageTable, new_length: int):
        """Roll a sequence back to ``new_length`` committed tokens: pages
        wholly past the boundary are dropped, and pages this table owned
        exclusively are refunded to its reservation."""
        n = int(new_length)
        if n < 0 or n > table.length:
            raise ValueError(
                f"truncate to {n} outside [0, {table.length}]")
        keep = -(-n // self.page_tokens)
        with self._mu:
            dropped = table.pages[keep:]
            del table.pages[keep:]
            for pid in dropped:
                if self._refcount[pid] == 1 \
                        and pid not in self._radix_pinned:
                    table.charged -= 1
                    self._reserved_unallocated += 1
                self._decref(pid)
            table.length = n
        self._publish()

    # -- sequence lifecycle -------------------------------------------------
    def _as_kv(self, x) -> torch.Tensor:
        dtype = torch.float32 if self.is_quantized else self.dtype
        return torch.as_tensor(x).to(device=self.device, dtype=dtype)

    # -- int8 page quantization ---------------------------------------------
    def _quantize(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """int8 of fp32 ``x`` [L, H, n, Dh] under the per-(L, H) scale
        ``s``: rint(x / s), 0 where s is 0.  The scale always covers the
        absmax, so the clamp is defensive; what it saturates is counted on
        the device."""
        s4 = s[:, :, None, None]
        q = torch.round(torch.where(s4 > 0, x / s4, torch.zeros_like(x)))
        self._clips += (q.abs() > 127).sum()
        return torch.clamp(q, -127, 127).to(torch.int8)

    def _store_page_chunk(self, pid: int, ncols: int, k_chunk, v_chunk):
        """Install columns [0, ncols) of a FRESHLY allocated page (the
        prefill write); int8 pages take the chunk's per-(layer, head)
        absmax as the page scale."""
        if not self.is_quantized:
            self.k[:, pid, :, :ncols] = k_chunk
            self.v[:, pid, :, :ncols] = v_chunk
            return
        for slab, scale, x in ((self.k, self.k_scale, k_chunk),
                               (self.v, self.v_scale, v_chunk)):
            s = x.abs().amax(dim=(2, 3)) / self._q127
            scale[:, pid] = s
            slab[:, pid, :, :ncols] = self._quantize(x, s)

    def _store_column(self, pid: int, off: int, k_col, v_col):
        """Write one decode column at ``off`` of an EXCLUSIVE page.  int8
        pages requantize-on-grow, branch-free: new = max(old, col absmax /
        127), the resident columns rint(q * old / new) (the identity where
        the scale did not grow; the ratio is <= 1, so the rewrite never
        clips), then the column under the new scale."""
        if not self.is_quantized:
            self.k[:, pid, :, off] = k_col
            self.v[:, pid, :, off] = v_col
            return
        for slab, scale, col in ((self.k, self.k_scale, k_col),
                                 (self.v, self.v_scale, v_col)):
            need = col.abs().amax(dim=2) / self._q127     # [L, H]
            cur = scale[:, pid]
            new = torch.maximum(cur, need)
            if off:
                ratio = torch.where(new > 0, cur / new,
                                    torch.ones_like(cur))
                resident = slab[:, pid, :, :off].float()
                slab[:, pid, :, :off] = torch.round(
                    resident * ratio[:, :, None, None]).to(torch.int8)
            scale[:, pid] = new
            slab[:, pid, :, off:off + 1] = self._quantize(col[:, :, None],
                                                          new)

    def _dequantize(self, q: torch.Tensor, scale: torch.Tensor):
        """fp32 of int8 pages ``q`` [..., H, T, Dh] under ``scale``
        [..., H] (the same leading page index)."""
        return q.float() * scale[..., None, None]

    def open_sequence(self, prompt: np.ndarray, k_prompt, v_prompt,
                      table: Optional[PageTable] = None,
                      reserved: Optional[int] = None,
                      start: int = 0) -> PageTable:
        """Install a prefilled prompt: ``k_prompt``/``v_prompt`` are the
        per-layer stacked KV ``[L, H, p - start, Dh]`` (tensors, moved to
        the pool's device if they are not there) and ``prompt`` the FULL
        int64 token ids (the sharing key material).  Pages completing a
        prefix another live sequence already stored are SHARED (refcount
        bump, no write); the rest are written and registered.  ``start``
        is the reused-prefill entry: the table already holds ``start``
        page-aligned tokens of adopted radix pages."""
        prompt = np.ascontiguousarray(np.asarray(prompt, np.int64))
        p = int(prompt.size)
        T = self.page_tokens
        start = int(start)
        if start % T:
            raise ValueError(
                f"start={start} must be page-aligned ({T} tokens/page)")
        if table is None:
            if start:
                raise ValueError("suffix install needs the adopted table")
            table = self.reserve(self.pages_needed(p) if reserved is None
                                 else reserved)
        if start and (table.length != start
                      or len(table.pages) != start // T):
            raise ValueError(
                f"table holds {table.length} tokens / "
                f"{len(table.pages)} pages, expected {start} adopted")
        k_prompt, v_prompt = self._as_kv(k_prompt), self._as_kv(v_prompt)
        with self._mu:
            for a in range(start, p, T):
                b = min(a + T, p)
                # key = the exact token prefix this page completes; KV col
                # t is a pure function of tokens <= t, so equal prefixes
                # mean equal page content
                key = prompt[:b].tobytes()
                pid = self._prefix.get(key)
                if pid is not None and self._refcount[pid] > 0:
                    self._incref(pid)
                    self.prefix_hits += 1
                    metrics.count("kv.prefix_hits")
                else:
                    pid = self._alloc(table)
                    self._store_page_chunk(
                        pid, b - a, k_prompt[:, :, a - start:b - start],
                        v_prompt[:, :, a - start:b - start])
                    self._prefix[key] = pid
                    self._page_key[pid] = key
                table.pages.append(pid)
            table.length = p
        self._publish()
        return table

    def append_column(self, table: PageTable, k_col, v_col):
        """Write one decode step's KV column ``[L, H, Dh]`` at position
        ``table.length``.  Crossing a page boundary allocates a fresh
        exclusive page; writing into a shared page copies it first
        (copy-on-write, a device copy) so sharers never see this
        sequence's tokens."""
        pos = table.length
        T = self.page_tokens
        j, off = pos // T, pos % T
        with self._mu:
            if off == 0:
                if j != len(table.pages):
                    raise ValueError(
                        f"page table corrupt: position {pos} expects "
                        f"page index {j}, table holds {len(table.pages)}")
                table.pages.append(self._alloc(table))
            pid = table.pages[j]
            if self._refcount[pid] > 1:
                new = self._alloc(table)
                self.k[:, new] = self.k[:, pid]
                self.v[:, new] = self.v[:, pid]
                if self.is_quantized:
                    self.k_scale[:, new] = self.k_scale[:, pid]
                    self.v_scale[:, new] = self.v_scale[:, pid]
                self._decref(pid)
                table.pages[j] = new
                pid = new
                self.cow_copies += 1
                metrics.count("kv.cow_copies")
            self._store_column(pid, off, self._as_kv(k_col),
                               self._as_kv(v_col))
            table.length = pos + 1
        self._publish()

    def gather(self, table: PageTable):
        """Dense per-layer KV of one sequence: ``(k, v)`` each
        ``[L, H, length, Dh]`` on the device (the gather-by-page-table
        read)."""
        L, H, T, D = (self.num_layers, self.num_heads, self.page_tokens,
                      self.head_dim)
        if not table.pages:
            empty = torch.zeros(
                (L, H, 0, D), device=self.device,
                dtype=torch.float32 if self.is_quantized else self.dtype)
            return empty, empty.clone()
        idx = torch.as_tensor(table.pages, dtype=torch.int64,
                              device=self.device)
        n = idx.numel()
        k, v = self._pages(idx)
        k = k.permute(0, 2, 1, 3, 4).reshape(L, H, n * T, D)
        v = v.permute(0, 2, 1, 3, 4).reshape(L, H, n * T, D)
        return k[:, :, :table.length], v[:, :, :table.length]

    def _pages(self, idx: torch.Tensor):
        """The K and V pages ``idx`` indexes (any shape of page ids after
        the layer axis), dequantized to fp32 for int8 pages."""
        if not self.is_quantized:
            return self.k[:, idx], self.v[:, idx]
        return (self._dequantize(self.k[:, idx], self.k_scale[:, idx]),
                self._dequantize(self.v[:, idx], self.v_scale[:, idx]))

    def page_index(self, tables: Sequence[Optional[PageTable]],
                   width: int) -> np.ndarray:
        """The host ``[len(tables), ceil(width / page_tokens)]`` int64 page
        ids that ``gather_batch`` reads: row i lists ``tables[i]``'s first
        pages, then 0 (as does a row whose table is None)."""
        n = -(-int(width) // self.page_tokens)
        idx = np.zeros((len(tables), n), np.int64)
        for i, t in enumerate(tables):
            if t is not None and t.pages:
                pages = t.pages[:n]
                idx[i, :len(pages)] = pages
        return idx

    def gather_batch(self, idx: torch.Tensor, width: int):
        """The dense batched cache of a decode step in one device gather:
        ``(k, v)`` each ``[L, S, H, width, Dh]`` from ``idx``, the
        ``[S, n]`` ``page_index`` table on the pool's device (the caller
        uploads it, so it can count the bytes).  Row i holds its table's
        first ``table.length`` columns; the columns past a row's length
        (and the rows whose table is None) hold other pages' finite
        values: the caller's additive mask hides them (-1e9 scores, whose
        softmax weight is exactly 0)."""
        L, H, T, D = (self.num_layers, self.num_heads, self.page_tokens,
                      self.head_dim)
        S, n = idx.shape
        if n * T < width:
            raise ValueError(f"{n} pages of {T} tokens < width {width}")

        def dense(pages):
            return pages.permute(0, 1, 3, 2, 4, 5) \
                .reshape(L, S, H, n * T, D)[:, :, :, :width]

        k, v = self._pages(idx)
        return dense(k), dense(v)

    def close_sequence(self, table: PageTable):
        """Retire a sequence THE MOMENT it finishes: drop every page
        refcount and return the unconsumed reservation."""
        with self._mu:
            for pid in table.pages:
                self._decref(pid)
            table.pages = []
            table.length = 0
        self.release(table)
        self._publish()

    # -- observability ------------------------------------------------------
    def stats(self) -> Dict:
        """The /stats payload: geometry, occupancy, sharing; for int8 pages
        the clip count (one host read)."""
        metrics.gauge("kv.quant_scale_clips", self.quant_scale_clips)
        with self._mu:
            free = len(self._free)
            return {
                "pages_total": self.num_pages,
                "pages_free": free,
                "pages_used": self.num_pages - free,
                "pages_reserved": self._reserved_unallocated,
                "pages_shared": self.pages_shared,
                "pages_retained": self.pages_retained,
                "page_tokens": self.page_tokens,
                "page_bytes": self.page_bytes,
                "tp_degree": self.tp_degree,
                "page_bytes_per_chip": self.page_bytes_per_chip,
                "prefix_hits": self.prefix_hits,
                "cow_copies": self.cow_copies,
                "kv_dtype": self.kv_dtype,
                "quant_scale_clips": self.quant_scale_clips,
                "occupancy": round(1.0 - free / self.num_pages, 4),
                "device": str(self.device),
                "pool_bytes": self.pool_bytes,
            }

    def _publish(self):
        """Keep the autoscaler-facing gauges current."""
        metrics.gauge("kv.pages_total", self.num_pages)
        metrics.gauge("kv.pages_free", len(self._free))
        metrics.gauge("kv.pages_shared", self.pages_shared)
        metrics.gauge("kv.pages_reserved", self._reserved_unallocated)
        metrics.gauge("kv.retained_pages", self.pages_retained)
        # 1 = int8 pages (Prometheus has no string series); the clip count
        # is a device value, published by stats() where it is read
        metrics.gauge("kv.kv_dtype_int8", int(self.is_quantized))

    def assert_drained(self):
        """Post-drain leak check: every page free OR retained-by-radix,
        nothing reserved, and no prefix registered for a page that is
        neither free, live, nor radix-pinned."""
        with self._mu:
            leaked = [pid for pid in range(self.num_pages)
                      if self._refcount[pid] > 0
                      and not (pid in self._radix_pinned
                               and self._refcount[pid] == 1)]
            stale = [k for k, pid in self._prefix.items()
                     if pid not in self._radix_pinned]
            if leaked or self._reserved_unallocated or stale:
                raise AssertionError(
                    f"page leak: {len(leaked)} pages held by retired "
                    f"sequences (neither free, live, nor radix-pinned), "
                    f"{self._reserved_unallocated} reserved, "
                    f"{len(stale)} prefixes registered for unpinned "
                    f"pages")


def _recorded_geometry_drift(pool: PagedKVPool, plan: Dict) -> List[str]:
    drift = []
    want_dtype = convert_dtype(str(plan.get("kv_dtype", "float32")))
    if pool.kv_dtype != want_dtype:
        drift.append(f"kv_dtype: pool stores {pool.kv_dtype}, plan records "
                     f"{want_dtype}")
    for key, have in (("pages", pool.num_pages),
                      ("page_tokens", pool.page_tokens),
                      ("num_layers", pool.num_layers),
                      ("num_heads", pool.num_heads),
                      ("head_dim", pool.head_dim)):
        if int(plan[key]) != int(have):
            drift.append(f"{key}: pool has {have}, plan records {plan[key]}")
    return drift


def budget_drift(pool: PagedKVPool, model=None) -> List[str]:
    """Re-derive the pool's recorded ``static.page_budget`` plan and
    report every way the live geometry disagrees — the serving analog
    of the verifier's V504 plan-drift check (a hand-resized pool stops
    matching what the HBM walker sized, and this makes it visible
    instead of silently mis-budgeted).  A hand-written plan (one that
    records no ``hbm_bytes``) is held to its own recorded geometry."""
    if pool.plan is None:
        return ["pool carries no recorded plan (hand-built, not "
                "page_budget-sized)"]
    plan = pool.plan
    if "hbm_bytes" not in plan:
        # a hand-written plan records no page_budget inputs to re-derive
        # from: the live geometry is held to the recorded one instead
        return _recorded_geometry_drift(pool, plan)
    from ..static.planner import page_budget
    fresh = page_budget(
        model, config=plan.get("config"),
        page_tokens=int(plan["page_tokens"]),
        # the PRE-clamp requested context: re-deriving from the clamped
        # value would shift the workspace split and cry wolf
        max_context=int(plan.get("max_context_requested",
                                 plan["max_context"])),
        hbm_bytes=int(plan["hbm_bytes"]),
        # weight_bytes_fp32 is the RAW parameter-byte input; feeding the
        # int8-adjusted resident bytes back would re-quantize them
        weight_bytes=(int(plan.get("weight_bytes_fp32",
                                   plan["weight_bytes"]))
                      if model is None else None),
        max_slots_cap=int(plan.get("max_slots_cap", 0)) or None,
        headroom=float(plan.get("headroom", 0.08)),
        draft_layers=int(plan.get("draft_layers", 0)),
        tp_degree=int(plan.get("tp_degree", 1)),
        kv_dtype=str(plan.get("kv_dtype", "float32")),
        weight_dtype=str(plan.get("weight_dtype", "float32")))
    drift = []
    want_dtype = convert_dtype(str(plan.get("kv_dtype", "float32")))
    if pool.kv_dtype != want_dtype:
        drift.append(
            f"kv_dtype: pool stores {pool.kv_dtype}, plan records "
            f"{want_dtype} — the carve assumed "
            f"{np.dtype(want_dtype).itemsize}-byte pages")
    for key, live in (("pages", pool.num_pages),
                      ("page_tokens", pool.page_tokens),
                      ("num_layers", pool.num_layers),
                      ("num_heads", pool.num_heads),
                      ("head_dim", pool.head_dim)):
        if int(fresh[key]) != int(live):
            drift.append(
                f"{key}: pool has {live}, page_budget derives "
                f"{fresh[key]} under the recorded inputs")
    # retention watermarks ride the plan (prefix_cache reads them);
    # hand-edited watermarks are drift exactly like hand-set pages
    if plan.get("retained_watermarks") is not None:
        for key in ("low", "high"):
            want = int(fresh["retained_watermarks"][key])
            have = int(plan["retained_watermarks"].get(key, -1))
            if want != have:
                drift.append(
                    f"retained_watermarks.{key}: plan records {have}, "
                    f"page_budget derives {want}")
    return drift
