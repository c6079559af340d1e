"""Continuous-batching generation engine (Orca-style iteration-level
scheduling) for autoregressive decode.

Counterpart of paddle_tpu/serving/generation.py, with its contract: a
decode batch of up to ``max_slots`` rows steps continuously; sequences
are admitted BETWEEN steps and retire the moment they emit EOS or reach
their length budget.  KV storage is fixed-slot (each slot owns a dense
per-layer K/V buffer, worst case) or paged (``kv_pool=``: the block-paged
``PagedKVPool`` with copy-on-write prefix sharing and admission by page
reservation), optionally with the retained radix prefix cache
(``prefix_cache=``: a hit adopts the retained pages and runs prefill only
over the uncovered suffix).  Backpressure is the DynamicBatcher's:
``QueueFullError`` with a load-scaled, jittered Retry-After; requests
that can never fit the pool are rejected at submit; queued requests
expire at their deadline; a cancelled future frees its slot.  KV lengths
and prompts pad to pow2 buckets, so the caching allocator sees a few
block sizes (the JAX package's bounded compiled shapes).  Decoding is
``greedy_search`` (token-for-token equal to per-sequence ``generate``)
or ``sampling`` (temperature / top-k, per-request seeded numpy
``RandomState``, so draws follow the JAX package's).

Where the bytes live.  The JAX engine builds the dense batched cache
``[L, S, H, lpad, Dh]`` on the host from host slabs and uploads it every
step.  Here everything the model reads stays on its device: the pool's
slabs (``gather_batch`` builds the batched cache with one device gather),
the fixed slots' buffers, the additive mask (built on the device from
the rows' lengths), the new K/V columns (written back into pages or slot
buffers on the device).  What goes up is int64 indices: a decode step
uploads its token ids, lengths, active and sampling rows and (paged) the
page-index table of the batched cache in one copy; a prefill uploads
its prompt ids, offset, mask and the page ids of a radix hit.  Only what
the sampler needs comes down: the argmax of every row, and the full
logits row of a ``sampling`` request.  Every copy goes through
``_upload`` / ``_download``, which count the bytes in ``bytes_h2d`` /
``bytes_d2h`` (and the ``gen.h2d_bytes`` / ``gen.d2h_bytes`` counters).
The decode thread sets the model's CUDA device and runs under
``torch.inference_mode()``; HTTP handler threads only hand numpy prompts
to ``submit``.

``speculative=`` (``"auto"``: a 2-layer ``stamp_draft`` with k = 4, or a
ready ``SpeculativeDecoder``; paged mode only) decodes through
``_step_spec``: the draft proposes, the target verifies the pending token
and the proposals in ONE W-wide forward (bucket ``("spec", lpad, W)``),
all W new columns go through ``append_column`` and the pool is truncated
to the committed length; emission replays the plain greedy loop, so the
tokens equal ``_step``'s.  Only the argmax of every (row, position) and
the logits of ``sampling`` rows come down.  ``weight_dtype="int8"``
(given, or recorded in the pool's plan) serves an ``Int8Linear`` sibling
of the model (``serving/int8_decode.py``); ``kv_dtype="int8"`` is the
pool's.

``tp_degree > 1`` (given, or recorded in the pool's plan) serves the
forward through ``serving/tp_decode.py``'s ``TPShardedDecoder``: this
engine lives on the leader (rank 0), the other ranks of the process group
follow; everything else (pool, radix cache, draft, sampling) stays on the
leader.  A decoder the engine made is stopped (its followers released)
by the engine's ``stop()``.

``kv_pool="auto"`` sizes the pool with ``static.planner.page_budget``
from the card's memory budget (``static.hbm_budget_bytes``).
"""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import metrics
from ..core.compile_cache import next_pow2 as _next_pow2
from .batcher import (BatcherStoppedError, DeadlineExceededError,
                      QueueFullError, _jittered)
from .kv_pool import PagedKVPool, PageTable
from .speculative import longest_accepted

__all__ = ["ContinuousBatchingEngine", "GenerationRequest"]

_NEG_INF = -1e9


class GenerationRequest:
    """One admitted generation request; resolves its Future with the full
    token sequence (prompt + generated, truncated at EOS) as int64[n]."""

    __slots__ = ("prompt", "max_new", "strategy", "top_k", "temperature",
                 "rng", "future", "deadline", "t_enqueue", "t_first")

    def __init__(self, prompt, max_new, strategy, top_k, temperature,
                 seed, timeout_s):
        self.prompt = np.asarray(prompt, np.int64).reshape(-1)
        self.max_new = int(max_new)
        self.strategy = strategy
        self.top_k = int(top_k)
        self.temperature = float(temperature)
        self.rng = np.random.RandomState(seed)
        self.future: Future = Future()
        self.t_enqueue = time.monotonic()
        self.deadline = self.t_enqueue + timeout_s
        self.t_first = None  # when its first token was sampled


class _Slot:
    __slots__ = ("req", "kv", "fixed_len", "table", "tokens", "next_id",
                 "n_new")

    def __init__(self, req, kv, tokens, next_id, table=None, fixed_len=0):
        self.req = req
        self.kv = kv          # fixed mode: (k, v) [L, H, capacity, Dh]
        self.fixed_len = fixed_len  # fixed mode: valid columns of kv
        self.table = table    # paged mode: PageTable into the pool
        self.tokens = tokens  # prompt + generated so far (python list)
        self.next_id = next_id  # sampled, not yet fed through the model
        self.n_new = 1

    @property
    def kv_len(self) -> int:
        if self.table is not None:
            return self.table.length
        return self.fixed_len


class ContinuousBatchingEngine:
    """Serve ``generate()`` traffic from one continuously-stepping batch.

        eng = ContinuousBatchingEngine(model, max_slots=4).start()
        fut = eng.submit([2, 17, 5], max_length=20)
        tokens = fut.result()          # np.int64 [prompt+generated]
        eng.stop()

    ``model`` is a ``GPTForGeneration`` (or bare ``GPTModel``).
    ``kv_pool``: ``None`` keeps the dense fixed-slot cache; ``"auto"``
    sizes one with ``static.page_budget``; a plan dict
    or a ready ``PagedKVPool`` (on the model's device) is consumed as-is;
    the plan's ``max_slots`` applies unless given.  ``prefix_cache``:
    ``"auto"`` builds a ``RadixPrefixCache`` with the plan's
    watermarks; a ready cache bound to this pool is consumed as-is.

    ``step_log`` and ``request_log`` (bounded deques) keep, per decode
    step, its wall ms (ending in the host read of the sampled tokens),
    rows, KV bucket and bytes moved each way, and per finished request
    its time to first token and latency.
    """

    def __init__(self, model, max_slots: Optional[int] = None,
                 max_queue: int = 64, default_timeout_s: float = 120.0,
                 kv_bucket_floor: int = 16, kv_pool=None,
                 prefix_cache=None, speculative=None,
                 tp_degree: Optional[int] = None,
                 weight_dtype: Optional[str] = None):
        plan_of = (kv_pool.plan or {}) if isinstance(kv_pool, PagedKVPool) \
            else kv_pool if isinstance(kv_pool, dict) else {}
        if tp_degree is None:
            tp_degree = int(plan_of.get("tp_degree", 1))
        self.tp_degree = max(1, int(tp_degree))
        if weight_dtype is None:
            weight_dtype = plan_of.get("weight_dtype", "float32")
        self.weight_dtype = str(weight_dtype)
        if self.weight_dtype not in ("float32", "int8"):
            raise ValueError(
                f"weight_dtype must be float32 or int8, got "
                f"{weight_dtype!r}")
        from .tp_decode import TPShardedDecoder
        # the float model page_budget prices (before any int8 / tp wrap)
        float_model = getattr(model, "gpt", model)
        # a decoder this engine made is this engine's to stop
        self._owns_decoder = False
        if self.tp_degree > 1:
            # tp-sharded decode: the model's forward runs through the
            # leader / follower backend (int8 weights by its static stamp)
            if not isinstance(model, TPShardedDecoder):
                model = TPShardedDecoder(model, self.tp_degree,
                                         weight_dtype=self.weight_dtype)
                self._owns_decoder = True
        elif self.weight_dtype == "int8" and \
                not isinstance(model, TPShardedDecoder):
            # a quantized sibling; the float model stays as it is
            from .int8_decode import quantize_decode_model
            model = quantize_decode_model(model)
        self._model = getattr(model, "gpt", model)
        self.config = self._model.config
        self.device = self._model.device
        self._pool: Optional[PagedKVPool] = None
        if kv_pool is not None:
            if kv_pool == "auto":
                from ..static.planner import page_budget
                self._pool = PagedKVPool.from_plan(
                    page_budget(float_model, tp_degree=self.tp_degree,
                                weight_dtype=self.weight_dtype),
                    device=self.device)
            elif isinstance(kv_pool, PagedKVPool):
                self._pool = kv_pool
            elif isinstance(kv_pool, dict):
                self._pool = PagedKVPool.from_plan(kv_pool,
                                                   device=self.device)
            else:
                raise ValueError(
                    f"kv_pool must be None, 'auto', a plan dict or a "
                    f"PagedKVPool, got {type(kv_pool).__name__}")
            if self._pool.device != self.device:
                raise ValueError(
                    f"kv_pool lives on {self._pool.device} but the model "
                    f"on {self.device}")
            for name, want, got in (
                    ("num_layers", self.config.num_layers,
                     self._pool.num_layers),
                    ("num_heads", self.config.num_heads,
                     self._pool.num_heads),
                    ("head_dim",
                     self.config.hidden_size // self.config.num_heads,
                     self._pool.head_dim)):
                if int(want) != int(got):
                    raise ValueError(
                        f"kv_pool geometry mismatch: model {name}={want} "
                        f"but pool was built for {got}")
            if self._pool.tp_degree != self.tp_degree:
                raise ValueError(
                    f"tp_degree mismatch: engine runs tp={self.tp_degree} "
                    f"but the pool plan was sized for "
                    f"tp={self._pool.tp_degree} — per-device page budgets "
                    "would not match the sharded caches")
            plan_wd = str((self._pool.plan or {}).get(
                "weight_dtype", self.weight_dtype))
            if plan_wd != self.weight_dtype:
                raise ValueError(
                    f"weight_dtype mismatch: engine serves "
                    f"{self.weight_dtype} weights but the pool plan "
                    f"budgeted for {plan_wd}")
        plan = self._pool.plan if self._pool is not None else None
        if max_slots is None:
            max_slots = int(plan["max_slots"]) if plan else 4
        self.max_slots = int(max_slots)
        # paged max-context: what the plan granted (never beyond the
        # model's positions); fixed mode keeps max_position
        self.max_context = int(self.config.max_position)
        if self._pool is not None:
            pool_ctx = self._pool.num_pages * self._pool.page_tokens
            self.max_context = min(
                self.max_context,
                int(plan["max_context"]) if plan else pool_ctx)
        self.max_queue = int(max_queue)
        self.default_timeout_s = float(default_timeout_s)
        self._kv_floor = int(kv_bucket_floor)
        self._queue: List[GenerationRequest] = []
        self._slots: List[Optional[_Slot]] = [None] * self.max_slots
        self._kv_buckets = set()   # distinct padded KV lengths seen
        self._radix = None
        if prefix_cache is not None:
            if self._pool is None:
                raise ValueError(
                    "prefix_cache requires paged KV (kv_pool=)")
            if prefix_cache == "auto":
                from .prefix_cache import RadixPrefixCache
                self._radix = RadixPrefixCache.from_plan(self._pool)
            else:
                if prefix_cache.pool is not self._pool:
                    raise ValueError(
                        "prefix_cache is bound to a different pool")
                self._radix = prefix_cache
        self._spec = None
        if speculative is not None:
            if self._pool is None:
                raise ValueError(
                    "speculative decoding requires paged KV (kv_pool=): "
                    "rollback is page-table truncation")
            if speculative == "auto":
                from .speculative import SpeculativeDecoder, stamp_draft
                self._spec = SpeculativeDecoder(
                    stamp_draft(self._model, num_layers=2),
                    kv_bucket_floor=self._kv_floor)
            else:
                self._spec = speculative
            self._spec.geometry_check(self.config)
            self._spec.track_buckets(
                self._kv_buckets,
                on_change=lambda: metrics.gauge(
                    "gen.kv_buckets", len(self._kv_buckets)))
        self.bytes_h2d = 0
        self.bytes_d2h = 0
        self.step_log = collections.deque(maxlen=4096)
        self.request_log = collections.deque(maxlen=4096)
        self._mu = threading.Lock()
        self._work = threading.Condition(self._mu)
        self._idle = threading.Condition(self._mu)
        self._running = False
        self._draining = False
        self._thread: Optional[threading.Thread] = None

    @property
    def kv_pool(self) -> Optional[PagedKVPool]:
        return self._pool

    @property
    def paged(self) -> bool:
        return self._pool is not None

    @property
    def prefix_cache(self):
        return self._radix

    @property
    def speculative(self):
        return self._spec

    @property
    def kv_buckets(self) -> int:
        """Distinct padded KV lengths the model has been run at."""
        with self._mu:
            return len(self._kv_buckets)

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        with self._mu:
            if self._running:
                return self
            self._running, self._draining = True, False
        self._thread = threading.Thread(target=self._decode_loop,
                                        name="paddle-tpu-torch-genloop",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 60.0):
        with self._mu:
            if not self._running:
                if self._owns_decoder:
                    self._model.stop()
                return
            self._draining = True
            self._work.notify_all()
            if drain:
                deadline = time.monotonic() + timeout
                while self._queue or any(self._slots):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._idle.wait(left)
            for req in self._queue:
                req.future.set_exception(BatcherStoppedError(
                    "generation engine stopped before request started"))
            self._queue.clear()
            self._running = False
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        # the decode thread is dead now: fail whatever it left in-flight
        # and give its pages back
        for i, slot in enumerate(self._slots):
            if slot is not None:
                if not slot.req.future.done():
                    slot.req.future.set_exception(BatcherStoppedError(
                        "generation engine stopped mid-decode"))
                if slot.table is not None:
                    self._pool.close_sequence(slot.table)
                self._slots[i] = None
        if self._spec is not None:
            self._spec.close_all()
        if self._owns_decoder:
            self._model.stop()

    # -- admission ----------------------------------------------------------
    def _retry_hint(self, depth: int) -> float:
        """Load-scaled jittered Retry-After, inflated by page-pool
        admission pressure."""
        base = max(0.05, 0.1 * depth / max(1, self.max_slots))
        if self._pool is not None:
            occupancy = 1.0 - (self._pool.pages_available
                               / max(1, self._pool.num_pages))
            base *= 1.0 + occupancy
        return _jittered(base)

    def submit(self, input_ids, max_length: int = 20,
               decode_strategy: str = "greedy_search", top_k: int = 0,
               temperature: float = 1.0, seed: int = 0,
               timeout_s: Optional[float] = None) -> Future:
        if decode_strategy not in ("greedy_search", "sampling"):
            raise ValueError(
                f"continuous batching supports 'greedy_search' and "
                f"'sampling', got decode_strategy={decode_strategy!r} "
                "(beam search is whole-sequence and cannot join a "
                "running batch)")
        prompt = np.asarray(input_ids, np.int64).reshape(-1)
        if prompt.size == 0:
            raise ValueError("input_ids must hold at least one token")
        if prompt.size + max_length > self.max_context:
            limit = ("max_position" if self.max_context ==
                     self.config.max_position else "the pool's max_context")
            raise ValueError(
                f"prefix ({prompt.size}) + max_length ({max_length}) "
                f"exceeds {limit} ({self.max_context})")
        if self._pool is not None:
            worst = self._pool.pages_for_request(prompt.size, max_length)
            if worst > self._pool.num_pages:
                metrics.count("gen.rejected")
                metrics.count("gen.rejected_pages")
                raise ValueError(
                    f"request can never fit: needs {worst} KV pages, the "
                    f"pool holds {self._pool.num_pages} "
                    f"({self._pool.page_tokens} tokens/page)")
        req = GenerationRequest(
            prompt, max_length, decode_strategy, top_k, temperature, seed,
            self.default_timeout_s if timeout_s is None else timeout_s)
        with self._mu:
            if not self._running or self._draining:
                metrics.count("gen.rejected")
                raise BatcherStoppedError(
                    "generation engine is not accepting work")
            if len(self._queue) >= self.max_queue:
                metrics.count("gen.rejected")
                metrics.count("gen.rejected_queue_full")
                raise QueueFullError(len(self._queue),
                                     self._retry_hint(len(self._queue)))
            self._queue.append(req)
            metrics.count("gen.admitted")
            metrics.gauge("gen.queue.depth", len(self._queue))
            self._work.notify()
        return req.future

    # -- decode loop --------------------------------------------------------
    def _decode_loop(self):
        # this thread owns the model's device work
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            self._loop()

    def _loop(self):
        while True:
            with self._mu:
                while self._running and not self._queue \
                        and not any(self._slots):
                    self._idle.notify_all()
                    if self._draining:
                        return
                    self._work.wait(timeout=0.05)
                if not self._running:
                    return
                pending = self._admit_locked()
            for req, table in pending:
                try:
                    self._prefill(req, table)
                except Exception as e:  # noqa: BLE001 — this request only
                    metrics.count("gen.failed")
                    if table is not None:
                        self._pool.close_sequence(table)
                    req.future.set_exception(e)
            try:
                if any(self._slots):
                    if self._spec is not None:
                        self._step_spec()
                    else:
                        self._step()
            except Exception as e:  # noqa: BLE001 — fail loud, stay alive
                self._fail_all(e)

    def _admit_locked(self) -> List[Tuple[GenerationRequest,
                                          Optional[PageTable]]]:
        """Pick queued requests for the free slots (FIFO, expired
        dropped); paged mode additionally requires a worst-case page
        reservation and stops at the first request the pool cannot cover
        (strict FIFO).  Called with the lock held."""
        now = time.monotonic()
        keep = []
        for req in self._queue:
            if req.future.cancelled():
                pass  # caller gave up (e.g. /generate handler timeout)
            elif req.deadline <= now:
                metrics.count("gen.timeout")
                req.future.set_exception(DeadlineExceededError(
                    f"request expired after {now - req.t_enqueue:.2f}s "
                    "in queue"))
            elif self._pool is not None and self._pool.pages_for_request(
                    req.prompt.size, req.max_new) > self._pool.num_pages:
                metrics.count("gen.rejected_pages")
                req.future.set_exception(ValueError(
                    "request can never fit in the KV page pool"))
            else:
                keep.append(req)
        self._queue = keep
        free = sum(s is None for s in self._slots)
        pending: List[Tuple[GenerationRequest, Optional[PageTable]]] = []
        blocked = False
        while self._queue and len(pending) < free:
            req = self._queue[0]
            table = None
            if self._pool is not None:
                worst = self._pool.pages_for_request(
                    req.prompt.size, req.max_new)
                if not self._pool.can_reserve(worst):
                    blocked = True
                    metrics.count("kv.admit_blocked")
                    break
                table = self._pool.reserve(worst)
            pending.append((self._queue.pop(0), table))
        metrics.gauge("kv.admission_blocked", int(blocked))
        metrics.gauge("gen.queue.depth", len(self._queue))
        return pending

    def _fail_all(self, err):
        with self._mu:
            for i, slot in enumerate(self._slots):
                if slot is not None:
                    if not slot.req.future.done():
                        slot.req.future.set_exception(err)
                    if slot.table is not None:
                        self._pool.close_sequence(slot.table)
                    self._slots[i] = None
            if self._spec is not None:
                self._spec.close_all()
            metrics.gauge("gen.active_slots", 0)
            self._idle.notify_all()

    # -- host <-> device ----------------------------------------------------
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        self.bytes_h2d += arr.nbytes
        metrics.count("gen.h2d_bytes", arr.nbytes)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _download(self, t: torch.Tensor) -> np.ndarray:
        out = t.cpu().numpy()
        self.bytes_d2h += out.nbytes
        metrics.count("gen.d2h_bytes", out.nbytes)
        return out

    def _next_tokens(self, reqs, logits: torch.Tensor,
                     sampling_rows: Optional[torch.Tensor] = None
                     ) -> List[int]:
        """Sample one token per row of ``logits`` [n, V] (a device
        tensor) for ``reqs``: the argmax of every row comes to the host
        in one read, and the full row only of a ``sampling`` request.
        ``sampling_rows`` is the device index of those rows when the
        caller uploaded it already."""
        greedy = self._download(torch.argmax(logits, dim=-1))
        rows = [i for i, r in enumerate(reqs) if r.strategy == "sampling"]
        out = [int(g) for g in greedy]
        if rows:
            idx = sampling_rows if sampling_rows is not None else \
                self._upload(np.asarray(rows, np.int64))
            sampled = self._download(logits.index_select(0, idx).float())
            for row, i in zip(sampled, rows):
                out[i] = self._sample(reqs[i], row)
        return out

    # -- model plumbing -----------------------------------------------------
    def _bucket(self, key):
        with self._mu:
            self._kv_buckets.add(key)
            metrics.gauge("gen.kv_buckets", len(self._kv_buckets))

    def _prefill(self, req: GenerationRequest,
                 table: Optional[PageTable] = None):
        """Run the prompt through the model once: fills this sequence's
        KV (a fixed slot's buffer, or pool pages through the
        prefix-sharing write path) and samples its first token, then
        installs it in a free slot (or retires it at once on EOS /
        budget).  A radix hit (capped at ``p - 1`` tokens) adopts the hit
        pages and runs prefill only over the uncovered suffix."""
        from ..nn import MultiHeadAttention
        if req.future.cancelled():
            if table is not None:
                self._pool.close_sequence(table)
            return
        cfg = self.config
        L, H = cfg.num_layers, cfg.num_heads
        Dh = cfg.hidden_size // H
        p = req.prompt.size
        m, hit_pids = 0, []
        if self._radix is not None and table is not None:
            m, hit_pids = self._radix.match(req.prompt, max_tokens=p - 1)
        if m:
            self._pool.adopt_prefix(table, hit_pids, m)
            self._radix.hits += 1
            self._radix.hit_tokens += m
            metrics.count("kv.radix_hits")
            metrics.count("kv.radix_hit_tokens", m)
            sp = p - m
            # cached columns and suffix rows both pad to pow2 buckets;
            # suffix pad capped so pad positions stay inside wpe
            mpad = _next_pow2(m, self._kv_floor)
            spp = min(_next_pow2(sp, self._kv_floor),
                      int(cfg.max_position) - m)
            self._bucket(("reuse_prefill", mpad, spp))
            k_hit, v_hit = self._pool.gather_batch(   # [L, 1, H, m, Dh]
                self._upload(self._pool.page_index([table], m)), m)
            k_c = torch.zeros((L, 1, H, mpad, Dh), dtype=k_hit.dtype,
                              device=self.device)
            v_c = torch.zeros_like(k_c)
            k_c[:, :, :, :m] = k_hit
            v_c[:, :, :, :m] = v_hit
            caches = [MultiHeadAttention.Cache(k_c[li], v_c[li])
                      for li in range(L)]
            ids = np.full((1, spp), cfg.eos_id, np.int64)
            ids[0, :sp] = req.prompt[m:]
            # suffix row u sees every adopted column plus suffix columns
            # <= u (causal); pad cache columns stay -inf
            mask = np.full((1, 1, spp, mpad + spp), _NEG_INF, np.float32)
            mask[0, 0, :, :m] = 0.0
            for u in range(spp):
                mask[0, 0, u, mpad:mpad + u + 1] = 0.0
            logits, caches = self._model.forward(
                self._upload(ids), cache=caches,
                pos_offset=self._upload(np.asarray([m], np.int64)),
                attn_mask=self._upload(mask))
            last = logits[0, sp - 1:sp]
            metrics.count("gen.prefill_tokens", sp)
        else:
            # pad the prompt to a pow2 length bucket; causality makes the
            # pad tokens invisible to rows < p, and their K/V columns are
            # sliced away below
            pp = min(_next_pow2(p, self._kv_floor), int(cfg.max_position))
            self._bucket(("prefill", pp))
            ids = np.full((1, pp), cfg.eos_id, np.int64)
            ids[0, :p] = req.prompt
            logits, caches = self._model.forward(
                self._upload(ids), cache=self._model.gen_cache(1),
                pos_offset=self._upload(np.zeros(1, np.int64)),
                attn_mask=self._model._mask(pp))
            last = logits[0, p - 1:p]
            metrics.count("gen.prefill_tokens", p)
        (nxt,) = self._next_tokens([req], last)
        req.t_first = time.monotonic()
        metrics.observe("gen.ttft_ms", (req.t_first - req.t_enqueue) * 1e3)
        if nxt == cfg.eos_id or req.max_new <= 1:
            # never occupied a slot; adopted pages (if any) just drop
            # their refcount at close
            if table is not None:
                self._pool.close_sequence(table)
            slot = _Slot(req, None, list(req.prompt), nxt)
            slot.tokens.append(nxt)
            self._finish(slot)
            return
        off = mpad if m else 0
        k_stack = torch.stack([c.k[0, :, off:off + p - m] for c in caches])
        v_stack = torch.stack([c.v[0, :, off:off + p - m] for c in caches])
        if table is not None:
            # KV column t is a pure function of tokens <= t, so the pool
            # may satisfy whole prompt-head pages from another sequence's
            # identical prefill (COW prefix sharing); on a radix hit only
            # the suffix columns install (start=m)
            self._pool.open_sequence(req.prompt, k_stack, v_stack,
                                     table=table, start=m)
            slot = _Slot(req, None, list(req.prompt), nxt, table=table)
        else:
            # the fixed slot's buffer holds its worst case
            cap = p + req.max_new
            k_buf = torch.zeros((L, H, cap, Dh), dtype=k_stack.dtype,
                                device=self.device)
            v_buf = torch.zeros_like(k_buf)
            k_buf[:, :, :p] = k_stack
            v_buf[:, :, :p] = v_stack
            slot = _Slot(req, (k_buf, v_buf), list(req.prompt), nxt,
                         fixed_len=p)
        with self._mu:
            idx = self._slots.index(None)
            self._slots[idx] = slot
            metrics.gauge("gen.active_slots",
                          sum(s is not None for s in self._slots))
        if self._spec is not None:
            # seed the draft's dense KV for this slot (the decode thread
            # owns both models, so this cannot race a step)
            self._spec.open(idx, slot.tokens)

    def _step(self):
        """One decode step over every active slot (ONE device batch).
        Paged and fixed slots feed the same batched dense cache."""
        from ..nn import MultiHeadAttention
        t0 = time.perf_counter()
        h2d0, d2h0 = self.bytes_h2d, self.bytes_d2h
        with self._mu:
            # a cancelled future means the caller stopped waiting — free
            # the slot (and its pages)
            for i, s in enumerate(self._slots):
                if s is not None and s.req.future.cancelled():
                    metrics.count("gen.cancelled")
                    if s.table is not None:
                        self._pool.close_sequence(s.table)
                    self._slots[i] = None
            active = [(i, s) for i, s in enumerate(self._slots)
                      if s is not None]
        if not active:
            return
        S = self.max_slots
        cfg = self.config
        L, H = cfg.num_layers, cfg.num_heads
        Dh = cfg.hidden_size // H
        lpad = _next_pow2(max(s.kv_len for _, s in active), self._kv_floor)
        self._bucket(("decode", lpad))

        # one copy up: ids, lengths, the active rows, the sampling rows
        # among them and (paged) the page-index table of the batched
        # cache.  The additive mask over [cache columns 0..lpad-1,
        # new-token column] is built on the device: valid history + self
        # are 0, pad columns and idle rows -inf
        ids_lens = np.zeros((2, S), np.int64)
        ids_lens[0] = cfg.eos_id
        slot_tables = [None] * S
        for i, s in active:
            ids_lens[0, i] = s.next_id
            ids_lens[1, i] = s.kv_len
            slot_tables[i] = s.table
        rows = np.asarray([i for i, _ in active], np.int64)
        sampling = np.asarray([j for j, (_, s) in enumerate(active)
                               if s.req.strategy == "sampling"], np.int64)
        pages = self._pool.page_index(slot_tables, lpad) \
            if self._pool is not None else np.zeros((S, 0), np.int64)
        up = self._upload(np.concatenate(
            [ids_lens.ravel(), rows, sampling, pages.ravel()]))
        ids, lens = up[:S, None], up[S:2 * S]
        up = up[2 * S:]
        rows_d, up = up[:rows.size], up[rows.size:]
        sampling_d, pages_d = up[:sampling.size], up[sampling.size:]
        cols = torch.arange(lpad + 1, device=self.device)
        visible = (cols[None] < lens[:, None]) | (cols[None] == lpad)
        mask = torch.where(visible, 0.0, _NEG_INF)[:, None, None, :]
        if self._pool is not None:
            k_b, v_b = self._pool.gather_batch(pages_d.view(S, -1), lpad)
        else:
            k_b = torch.zeros((L, S, H, lpad, Dh), device=self.device)
            v_b = torch.zeros_like(k_b)
            for i, s in active:
                ln = s.kv_len
                k_b[:, i, :, :ln] = s.kv[0][:, :, :ln]
                v_b[:, i, :, :ln] = s.kv[1][:, :, :ln]
        caches = [MultiHeadAttention.Cache(k_b[li], v_b[li])
                  for li in range(L)]
        logits, new_caches = self._model.forward(
            ids, cache=caches, pos_offset=lens, attn_mask=mask)
        # the new K/V column of every slot sits at index lpad
        k_new = torch.stack([c.k[:, :, lpad] for c in new_caches])
        v_new = torch.stack([c.v[:, :, lpad] for c in new_caches])
        nxt_tokens = self._next_tokens(
            [s.req for _, s in active], logits[:, 0].index_select(0, rows_d),
            sampling_d)
        metrics.count("gen.steps")
        metrics.count("gen.tokens", len(active))
        metrics.observe("gen.step_occupancy", len(active))

        retired = []
        for (i, s), nxt in zip(active, nxt_tokens):
            if s.table is not None:
                # write-through the page table: a fresh page at the
                # boundary, a COW copy when the target page is shared
                self._pool.append_column(s.table, k_new[:, i], v_new[:, i])
            else:
                s.kv[0][:, :, s.fixed_len] = k_new[:, i]
                s.kv[1][:, :, s.fixed_len] = v_new[:, i]
                s.fixed_len += 1
            s.tokens.append(s.next_id)
            s.next_id = nxt
            s.n_new += 1
            if nxt == cfg.eos_id or s.n_new >= s.req.max_new:
                s.tokens.append(nxt)
                retired.append(i)
        with self._mu:
            for i in retired:
                slot, self._slots[i] = self._slots[i], None
                self._finish(slot)
            metrics.gauge("gen.active_slots",
                          sum(s is not None for s in self._slots))
        ms = (time.perf_counter() - t0) * 1e3
        metrics.observe("gen.step_ms", ms)
        self.step_log.append({"ms": ms, "rows": len(active), "lpad": lpad,
                              "sampling_rows": int(sampling.size),
                              "h2d_bytes": self.bytes_h2d - h2d0,
                              "d2h_bytes": self.bytes_d2h - d2h0})

    def _step_spec(self):
        """One SPECULATIVE decode step over every active slot: the draft
        proposes up to k tokens per greedy row, the target verifies the
        pending token and the proposals in ONE batched forward (query
        width W), every fed column is written through the page table and
        the rejected tail rolled back with ``pool.truncate``.  Emission
        replays the plain greedy loop over the verified chain, so the
        tokens equal ``_step``'s whatever the draft proposed.  Sampling
        rows ride along at width 1.  Down come the argmax of every
        (row, position) and the position-0 logits of sampling rows."""
        from ..nn import MultiHeadAttention
        t0 = time.perf_counter()
        h2d0, d2h0 = self.bytes_h2d, self.bytes_d2h
        with self._mu:
            for i, s in enumerate(self._slots):
                if s is not None and s.req.future.cancelled():
                    metrics.count("gen.cancelled")
                    self._pool.close_sequence(s.table)
                    self._spec.close(i)
                    self._slots[i] = None
            active = [(i, s) for i, s in enumerate(self._slots)
                      if s is not None]
        if not active:
            return
        S = self.max_slots
        cfg = self.config
        L = cfg.num_layers
        max_ln = max(s.kv_len for _, s in active)
        # query width: the pending token and up to k proposals, shrunk
        # only where a row's positions ln .. ln + W - 1 would leave wpe
        W = max(1, min(1 + self._spec.k, int(cfg.max_position) - max_ln))
        fed = {}
        for i, s in active:
            w = max(1, min(W, s.req.max_new - s.n_new,
                           self.max_context - s.kv_len))
            row = [s.next_id]
            if w > 1 and s.req.strategy == "greedy_search":
                row += self._spec.propose(i, s.tokens, s.next_id,
                                          n=w - 1)
            fed[i] = row
        lpad = _next_pow2(max_ln, self._kv_floor)
        self._bucket(("spec", lpad, W))

        # one copy up: the fed ids [S, W], lengths, the active rows, the
        # sampling rows among them and the page-index table
        ids_lens = np.zeros((S, W + 1), np.int64)
        ids_lens[:, :W] = cfg.eos_id
        slot_tables = [None] * S
        for i, s in active:
            ids_lens[i, :len(fed[i])] = fed[i]
            ids_lens[i, W] = s.kv_len
            slot_tables[i] = s.table
        rows = np.asarray([i for i, _ in active], np.int64)
        sampling = np.asarray([j for j, (_, s) in enumerate(active)
                               if s.req.strategy == "sampling"], np.int64)
        pages = self._pool.page_index(slot_tables, lpad)
        up = self._upload(np.concatenate(
            [ids_lens.ravel(), rows, sampling, pages.ravel()]))
        ids_lens_d = up[:S * (W + 1)].view(S, W + 1)
        ids, lens = ids_lens_d[:, :W], ids_lens_d[:, W]
        up = up[S * (W + 1):]
        rows_d, up = up[:rows.size], up[rows.size:]
        sampling_d, pages_d = up[:sampling.size], up[sampling.size:]
        # additive mask [S, 1, W, lpad + W]: a query sees its row's valid
        # history and the new columns up to its own (causal), pads -inf
        cols = torch.arange(lpad + W, device=self.device)
        qpos = torch.arange(W, device=self.device)
        hist = cols[None, None, :] < lens[:, None, None]
        new = (cols[None, :] >= lpad) & (cols[None, :] - lpad
                                         <= qpos[:, None])
        mask = torch.where(hist | new[None], 0.0, _NEG_INF)[:, None]
        k_b, v_b = self._pool.gather_batch(pages_d.view(S, -1), lpad)
        caches = [MultiHeadAttention.Cache(k_b[li], v_b[li])
                  for li in range(L)]
        logits, new_caches = self._model.forward(
            ids, cache=caches, pos_offset=lens, attn_mask=mask)
        k_new = torch.stack([c.k[:, :, lpad:] for c in new_caches])
        v_new = torch.stack([c.v[:, :, lpad:] for c in new_caches])
        act = logits.index_select(0, rows_d)            # [n, W, V]
        greedy = self._download(torch.argmax(act, dim=-1))
        sampled = {}
        if sampling.size:
            got = self._download(act[:, 0].index_select(0, sampling_d)
                                 .float())
            sampled = dict(zip(sampling.tolist(), got))
        metrics.count("gen.steps")
        metrics.count("spec.steps")
        metrics.observe("gen.step_occupancy", len(active))

        retired, n_committed = [], 0
        for j, (i, s) in enumerate(active):
            row = fed[i]
            w = len(row)
            base = s.kv_len
            # the verify produced a KV column for every fed token: write
            # them all, then roll the rejected tail back
            for t in range(w):
                self._pool.append_column(s.table, k_new[:, i, :, t],
                                         v_new[:, i, :, t])
            # the pending token and the accepted proposals, each followed
            # by the target's own next token, stop at EOS or max_new
            accepted = longest_accepted(row[1:], greedy[j, :w - 1])
            committed, done = 0, False
            for t in range(accepted + 1):
                s.tokens.append(row[t])
                nxt = self._sample(s.req, sampled[j]) if j in sampled \
                    else int(greedy[j, t])
                s.next_id = nxt
                s.n_new += 1
                committed = t + 1
                if nxt == cfg.eos_id or s.n_new >= s.req.max_new:
                    s.tokens.append(nxt)
                    done = True
                    break
            if committed < w:
                self._pool.truncate(s.table, base + committed)
                metrics.count("spec.rollback_cols", w - committed)
            metrics.observe("spec.accepted_per_step", committed)
            metrics.count("spec.proposed", w - 1)
            metrics.count("spec.accepted", committed - 1)
            metrics.count("gen.tokens", committed)
            n_committed += committed
            if done:
                self._spec.close(i)
                retired.append(i)
            else:
                # the draft's rollback to the committed stream
                self._spec.commit(i, s.tokens, s.next_id)
        with self._mu:
            for i in retired:
                slot, self._slots[i] = self._slots[i], None
                self._finish(slot)
            metrics.gauge("gen.active_slots",
                          sum(s is not None for s in self._slots))
        ms = (time.perf_counter() - t0) * 1e3
        metrics.observe("gen.step_ms", ms)
        self.step_log.append({"ms": ms, "rows": len(active), "lpad": lpad,
                              "width": W, "committed": n_committed,
                              "sampling_rows": int(sampling.size),
                              "h2d_bytes": self.bytes_h2d - h2d0,
                              "d2h_bytes": self.bytes_d2h - d2h0})

    @staticmethod
    def _sample(req: GenerationRequest, logits: np.ndarray) -> int:
        """One draw of a ``sampling`` request from its host logits row
        (greedy rows take the device argmax in ``_next_tokens``)."""
        logits = logits / max(req.temperature, 1e-6)
        if req.top_k:
            kth = np.sort(logits)[-req.top_k]
            logits = np.where(logits < kth, _NEG_INF, logits)
        p = np.exp(logits - logits.max())
        p /= p.sum()
        return int(req.rng.choice(p.shape[0], p=p))

    def _finish(self, slot: _Slot):
        """Resolve a finished sequence and retire its pages the moment it
        completes.  With a radix cache attached, the committed full-page
        prefix is retained FIRST, then the table closes."""
        if slot.table is not None:
            if self._radix is not None and slot.table.pages:
                self._radix.insert(np.asarray(slot.tokens, np.int64),
                                   slot.table)
            self._pool.close_sequence(slot.table)
            slot.table = None
        slot.kv = None
        now = time.monotonic()
        req = slot.req
        metrics.count("gen.completed")
        metrics.observe("gen.seq_len", len(slot.tokens))
        metrics.latency_ms(now - req.t_enqueue)
        self.request_log.append({
            "ttft_s": (req.t_first or now) - req.t_enqueue,
            "latency_s": now - req.t_enqueue,
            "new_tokens": len(slot.tokens) - req.prompt.size})
        if not req.future.done():
            req.future.set_result(np.asarray(slot.tokens, np.int64))

    @property
    def active_slots(self) -> int:
        with self._mu:
            return sum(s is not None for s in self._slots)

    @property
    def queue_depth(self) -> int:
        with self._mu:
            return len(self._queue)
