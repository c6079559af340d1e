"""Copy of paddle_tpu/serving/metrics.py (no JAX dependency).

Serving-tier metrics — every number the batcher/engine/server emits.

One namespace (``serving.*``) over core/monitor so operators get the
whole serving story from a single ``/stats`` scrape:

  counters    serving.requests.admitted / rejected / timeout / completed /
              failed, serving.batch.runs, serving.batch.coalesced,
              serving.gen.admitted / rejected / rejected_queue_full /
              rejected_pages / timeout / cancelled / failed / completed /
              steps / tokens / prefill_tokens / h2d_bytes / d2h_bytes,
              serving.kv.prefix_hits / cow_copies / radix_hits /
              radix_hit_tokens / evictions / admit_blocked
  gauges      serving.queue.depth, serving.batch.last_size,
              serving.gen.active_slots / queue.depth / kv_buckets,
              serving.kv.pages_total / pages_free / pages_shared /
              pages_reserved / retained_pages / admission_blocked,
              serving.server.inflight
  histograms  serving.latency_ms (end-to-end request latency),
              serving.batch.occupancy (rows per device run),
              serving.gen.seq_len (retired sequence lengths),
              serving.gen.step_occupancy (rows per decode step),
              serving.gen.step_ms, serving.gen.ttft_ms

The histogram percentiles come from core/monitor's bounded reservoir, so
a week of traffic costs the same memory as a minute.
"""
from __future__ import annotations

from ..core.monitor import (gauge_get, gauge_set, hist_observe,
                            hist_snapshot, monitor_snapshot, stat_add,
                            stat_get, stat_reset)

__all__ = ["NAMESPACE", "count", "counter", "gauge", "gauge_value",
           "observe", "latency_ms", "percentiles", "serving_stats",
           "reset_serving_stats"]

NAMESPACE = "serving."


def _qual(name: str) -> str:
    return name if name.startswith(NAMESPACE) else NAMESPACE + name


def count(name: str, value: int = 1):
    """Bump a serving counter (name auto-prefixed with ``serving.``)."""
    stat_add(_qual(name), value)


def counter(name: str) -> int:
    return stat_get(_qual(name))


def gauge(name: str, value: float):
    gauge_set(_qual(name), value)


def gauge_value(name: str, default: float = 0) -> float:
    return gauge_get(_qual(name), default)


def observe(name: str, value: float):
    hist_observe(_qual(name), value)


def latency_ms(seconds: float):
    """Record one end-to-end request latency (seconds in, ms stored)."""
    hist_observe(_qual("latency_ms"), seconds * 1000.0)


def percentiles(name: str = "latency_ms"):
    """{count,min,max,mean,p50,p95,p99} for a serving histogram."""
    return hist_snapshot(_qual(name))


def serving_stats():
    """Full ``serving.*`` snapshot — counters, gauges and histogram
    percentile dicts (the /stats route payload)."""
    return monitor_snapshot(NAMESPACE)


def reset_serving_stats():
    """Drop every ``serving.*`` metric (test isolation)."""
    for key in list(serving_stats()):
        stat_reset(key)
