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
* ``SpeculativeDecoder`` (speculative.py) — draft/target speculative
  decoding: ``stamp_draft`` builds the small sibling, the engine verifies
  k proposals per batched step and rolls rejections back by page-table
  truncation.
* int8 decode (int8_decode.py + ``PagedKVPool(kv_dtype="int8")``) —
  weight-only quantized decode matmuls (``Int8Linear`` /
  ``quantize_decode_model`` for tp = 1, ``slim.freeze_weights_int8``
  stamped inside ``TPShardedDecoder`` for tp > 1) over int8 KV pages
  with fp32 scale sidecars.
* ``TPShardedDecoder`` (tp_decode.py) — tp-sharded decode: the engine on
  rank 0 leads, the other ranks of the process group follow.
* metrics (metrics.py) — the ``serving.*`` counters, gauges and
  histograms, dumped by ``/stats`` and ``/metrics``.
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
from .tp_decode import TPShardedDecoder, build_decode_program  # noqa: F401
from .int8_decode import Int8Linear, quantize_decode_model  # noqa: F401
from .speculative import (  # noqa: F401
    SpeculativeDecoder, stamp_draft, longest_accepted,
)
from .metrics import serving_stats, reset_serving_stats  # noqa: F401

__all__ = ["DynamicBatcher", "BatcherError", "QueueFullError",
           "DeadlineExceededError", "BatcherStoppedError",
           "ContinuousBatchingEngine", "GenerationRequest",
           "PagedKVPool", "PageTable", "PagePoolExhaustedError",
           "budget_drift", "RadixPrefixCache", "TPShardedDecoder",
           "build_decode_program", "Int8Linear",
           "quantize_decode_model", "SpeculativeDecoder", "stamp_draft",
           "longest_accepted", "serving_stats", "reset_serving_stats"]
