"""Per-rank heartbeat files — liveness that means PROGRESS, not just a
process table entry.  Counterpart of paddle_tpu/observability/heartbeat.py
(a copy: it is pure Python; the records are the JAX package's JSON).

The elastic supervisor detects a DEAD rank by exit code, but a
rank wedged inside a dead collective never exits: its process is alive,
its peers are blocked, and the job hangs forever looking healthy.  The
fix is the oldest one in distributed systems — each rank writes a
heartbeat (step + wall-clock) every training step, and the supervisor
treats a heartbeat older than the stall deadline exactly like a dead
rank: SIGTERM → grace → SIGKILL teardown, then elastic re-form
(`launch_utils.watch_local_trainers` / `launch.py --elastic`).

Files are ``<dir>/heartbeat.rank<r>.json``, written atomically
(temp + rename) so a reader never sees a torn beat.  Arming: set
``PADDLE_TPU_HEARTBEAT_DIR`` (the launcher does this for its workers
when supervision is on) or construct a `HeartbeatWriter` directly.
When unarmed, the executor's per-step call is one cached None check.

The stall deadline is the operator's knob: it must cover the LONGEST
legitimate gap between steps — the first step's kernel builds and
graph capture included — so the
launcher defaults to a generous 300 s and only arms the check once a
rank's FIRST beat exists (a rank still compiling has no file and is
not stalled).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = ["HEARTBEAT_ENV", "HeartbeatWriter", "maybe_beat",
           "read_heartbeats", "stalled_ranks", "DEFAULT_STALL_TIMEOUT_S"]

HEARTBEAT_ENV = "PADDLE_TPU_HEARTBEAT_DIR"

# must out-wait a first-step XLA compile of the big configs
DEFAULT_STALL_TIMEOUT_S = 300.0


from .journal import trainer_rank as _rank  # one rank resolver tier-wide


def heartbeat_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"heartbeat.rank{int(rank)}.json")


class HeartbeatWriter:
    """Atomic per-rank heartbeat writer (one per process)."""

    def __init__(self, directory: str, rank: Optional[int] = None):
        self.dir = directory
        self.rank = _rank() if rank is None else int(rank)
        self.path = heartbeat_path(directory, self.rank)
        self._tmp = self.path + f".tmp.{os.getpid()}"
        self._mu = threading.Lock()
        self.beats = 0
        os.makedirs(directory, exist_ok=True)

    def beat(self, step: int, **fields) -> None:
        """Write one heartbeat: rank, step, wall-clock.  Atomic rename —
        a supervisor reading concurrently sees the previous complete
        beat, never a torn one.  Failures are swallowed: a full disk
        must degrade to 'no liveness signal', not kill training."""
        with self._mu:
            self.beats += 1
            rec = {"rank": self.rank, "step": int(step), "t": time.time(),
                   "pid": os.getpid(), "beats": self.beats}
            rec.update(fields)
            try:
                with open(self._tmp, "w") as f:
                    json.dump(rec, f)
                os.replace(self._tmp, self.path)
            except OSError:
                pass


# -- trainer-side convenience -------------------------------------------------
_writer: Optional[HeartbeatWriter] = None
_armed: Optional[bool] = None


def maybe_beat(step: int, **fields) -> None:
    """Heartbeat iff ``PADDLE_TPU_HEARTBEAT_DIR`` is set; the armed/
    unarmed verdict is cached so the unarmed per-step cost is one
    global read (this sits inside Executor.run)."""
    global _writer, _armed
    if _armed is None:
        directory = os.environ.get(HEARTBEAT_ENV)
        _armed = bool(directory)
        if _armed:
            _writer = HeartbeatWriter(directory)
    if _writer is not None:
        _writer.beat(step, **fields)


def _reset_for_tests() -> None:
    global _writer, _armed
    _writer = None
    _armed = None


# -- supervisor side ----------------------------------------------------------
def read_heartbeats(directory: str) -> Dict[int, dict]:
    """rank -> last complete beat for every heartbeat file present."""
    out: Dict[int, dict] = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        if not (name.startswith("heartbeat.rank")
                and name.endswith(".json")):
            continue
        try:
            rank = int(name[len("heartbeat.rank"):-len(".json")])
            with open(os.path.join(directory, name)) as f:
                out[rank] = json.load(f)
        except (ValueError, OSError):
            continue  # racing a writer's rename; next tick sees it
    return out


def stalled_ranks(directory: str, stall_timeout_s: float,
                  ranks: Optional[List[int]] = None,
                  now: Optional[float] = None) -> List[int]:
    """Ranks whose last heartbeat is older than `stall_timeout_s`.
    `ranks` restricts the verdict to the supervisor's LIVE children —
    a stale file from a rank that already exited (or a previous
    incarnation at a smaller world) is not a stall.  Ranks with no file
    yet are never stalled (still compiling their first step)."""
    now = time.time() if now is None else now
    beats = read_heartbeats(directory)
    out = []
    for rank, rec in sorted(beats.items()):
        if ranks is not None and rank not in ranks:
            continue
        if now - float(rec.get("t", now)) > stall_timeout_s:
            out.append(rank)
    return out
