"""Shape buckets.  Copy of `next_pow2` from paddle_tpu/core/compile_cache.py
(the rest of that module is the XLA executable cache, which the eager
port has no use for).  The serving engine pads KV lengths and prompts to
these buckets: in the JAX package they bound the compiled shapes, here
they let the CUDA caching allocator reuse the same few block sizes."""
from __future__ import annotations

__all__ = ["next_pow2"]


def next_pow2(n: int, floor: int = 16) -> int:
    """Smallest power-of-two bucket >= ``n`` (>= ``floor``)."""
    b = int(floor)
    n = int(n)
    while b < n:
        b <<= 1
    return b
