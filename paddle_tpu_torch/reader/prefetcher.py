"""Async double-buffered feed prefetch — overlap the host-to-device copy
of batch N+1 with the device compute of batch N.

Counterpart of paddle_tpu/reader/prefetcher.py: `Prefetcher` moves the
placement of each feed onto a worker thread behind a bounded queue
(depth 2 = double buffering).  Contracts, as in the JAX package:

  * order-preserving — one worker thread, FIFO queue;
  * exception-propagating — a worker error re-raises at the consumer's
    `next()` call *after* all batches that preceded it;
  * bounded — at most `depth` placed batches exist ahead of the consumer;
  * closeable — `close()` (or exhausting the iterator, or `with` exit)
    stops the worker without deadlocking on a full queue;
  * `position` counts the batches handed to the consumer (the resume
    cursor a checkpoint records).
"""
from __future__ import annotations

import queue as _queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

__all__ = ["Prefetcher", "place_feed"]

_END = object()


def place_feed(feed: Any, device=None):
    """One batch as tensors on `device` (dict values / list items / bare
    arrays; tensors already there pass through).  The copy is blocking:
    the consumer may read the tensor on another stream."""
    def _one(v):
        if not isinstance(v, torch.Tensor):
            a = np.asarray(v)
            v = torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))
        return v if device is None else v.to(device)

    if isinstance(feed, dict):
        return {k: _one(v) for k, v in feed.items()}
    if isinstance(feed, (list, tuple)):
        return type(feed)(_one(v) for v in feed)
    return _one(feed)


class Prefetcher:
    """Iterate `source`, applying `place_fn` on a background thread,
    `depth` batches ahead of the consumer."""

    def __init__(self, source: Iterable, depth: int = 2,
                 place_fn: Optional[Callable[[Any], Any]] = None,
                 device=None, place: bool = True):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        if place_fn is None and place:
            place_fn = lambda b: place_feed(b, device=device)  # noqa: E731
        self._place_fn = place_fn or (lambda b: b)
        self._source = iter(source)
        self.position = 0
        self._q: "_queue.Queue" = _queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._closed = threading.Event()
        self._done = False
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="paddle-tpu-torch-prefetch")
        self._thread.start()

    def _worker(self):
        try:
            for item in self._source:
                if self._closed.is_set():
                    return
                if not self._put(self._place_fn(item)):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised at consumer
            self._err = e
        finally:
            self._put(_END)

    def _put(self, item) -> bool:
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is _END:
            self._done = True
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        self.position += 1
        return item

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        """Stop the worker and release staged batches.  Idempotent."""
        self._closed.set()

        def drain():
            while True:
                try:
                    self._q.get_nowait()
                except _queue.Empty:
                    break

        drain()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
        drain()
