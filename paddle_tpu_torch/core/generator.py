"""Global RNG seeding.

Counterpart of paddle_tpu/core/generator.py.  There one global seed feeds
JAX threefry keys; here it keys the port's Philox generator
(ops/random.py, ops/dropout.py).  Every eager random draw (a dygraph
parameter's initializer) runs its op with an `OpContext` whose seed is
the global seed plus a monotone draw counter (`next_eager_uid`), and the
op draws from (that seed, its uid) on the tensor's device: the Philox
kernel on the card, its plain version on the CPU.  So a seed fixes every
draw, in order, and nothing on the path reads or moves torch's global
RNG.  The draws are not the JAX package's: parity tests copy weights
(`Layer.set_state_dict`) instead of comparing draws.

`process_salt()` is per-process OS entropy that only the samplers'
unseeded shuffles mix in (io/sampler.py), as in the JAX package: a seed
zeroes it, and it rides the RNG state, so a seeded or resumed run
shuffles in the same order as the JAX package's for that seed.
"""
from __future__ import annotations

import os
import threading

__all__ = ["seed", "global_seed", "next_eager_uid", "process_salt",
           "get_rng_state", "set_rng_state"]


class _State:
    """Process-global generator state (one default generator per device
    type, as the reference's generator.h; not one per thread)."""
    seed = 0
    counter = 0
    salt = int.from_bytes(os.urandom(4), "little")


_state = _State()
_mu = threading.Lock()


def seed(s: int) -> int:
    """paddle.seed: seed every generator and restart the draw counter;
    the default programs' random_seed follows."""
    with _mu:
        _state.seed = int(s)
        _state.counter = 0
        _state.salt = 0
    from .program import default_main_program, default_startup_program
    default_main_program().random_seed = int(s)
    default_startup_program().random_seed = int(s)
    return _state.seed


def global_seed() -> int:
    return _state.seed


def process_salt() -> int:
    """OS-entropy part of unseeded sampler draws (0 once seeded)."""
    return _state.salt


def next_eager_uid() -> int:
    """Monotone uid of eager draws: each one seeds its generator from
    global_seed() + uid, so two layers built in a row draw differently."""
    with _mu:
        _state.counter += 1
        return _state.counter


def get_rng_state() -> dict:
    """Snapshot (seed, draw counter, salt); restore with
    `set_rng_state`."""
    with _mu:
        return {"seed": _state.seed, "counter": _state.counter,
                "salt": _state.salt}


def set_rng_state(state: dict) -> None:
    """Restore a `get_rng_state` snapshot: the next draws repeat the ones
    that followed it (the default programs' random_seed is untouched)."""
    with _mu:
        _state.seed = int(state.get("seed", _state.seed))
        _state.counter = int(state.get("counter", _state.counter))
        _state.salt = int(state.get("salt", _state.salt))
