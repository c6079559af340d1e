"""paddle_tpu_torch.serving — the request-coalescing tier between the
HTTP surface (inference/server.py) and the model.

* ``DynamicBatcher`` (batcher.py) — coalesces concurrent ``/predict``
  requests into one device batch per tick.
* ``ContinuousBatchingEngine`` (generation.py) — continuous-batching
  decode for ``/generate``: fixed-slot dense KV, or the paged pool.
* ``PagedKVPool`` (kv_pool.py) — fixed-size KV pages on the device, page
  tables with refcounted copy-on-write prefix sharing, admission by
  page reservation, ``budget_drift``.
* ``RadixPrefixCache`` (prefix_cache.py) — retained radix tree over
  committed prefixes (reused prefill on a hit).
* metrics (metrics.py) — the ``serving.*`` counters, gauges and
  histograms, dumped by ``/stats`` and ``/metrics``.

Speculative decoding, tp-sharded decode and int8 decode wait for
ROADMAP.md Queue 1, Serving remainders.
"""
from .batcher import (  # noqa: F401
    DynamicBatcher, BatcherError, QueueFullError, DeadlineExceededError,
    BatcherStoppedError,
)
from .generation import (  # noqa: F401
    ContinuousBatchingEngine, GenerationRequest,
)
from .kv_pool import (  # noqa: F401
    PagedKVPool, PageTable, PagePoolExhaustedError, budget_drift,
)
from .prefix_cache import RadixPrefixCache  # noqa: F401
from .metrics import serving_stats, reset_serving_stats  # noqa: F401

__all__ = ["DynamicBatcher", "BatcherError", "QueueFullError",
           "DeadlineExceededError", "BatcherStoppedError",
           "ContinuousBatchingEngine", "GenerationRequest",
           "PagedKVPool", "PageTable", "PagePoolExhaustedError",
           "budget_drift", "RadixPrefixCache", "serving_stats",
           "reset_serving_stats"]
