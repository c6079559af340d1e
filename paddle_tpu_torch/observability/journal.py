"""Structured run journal — append-only per-rank JSONL of everything
that happened to a training run.  Counterpart of
paddle_tpu/observability/journal.py (a copy: it is pure Python; the
lines are the JAX package's JSON, key for key).

The elastic tier made kill/resume/shrink/regrow a *supported* lifecycle,
which means a production incident is now a SEQUENCE of process
incarnations; stdout logs die with each one.  The journal is the
durable, machine-parseable record: every rank appends one JSON object
per event to ``<dir>/journal.rank<r>.jsonl`` (append-only across
restarts — successive incarnations of the same rank share the file, so
the whole 8→4→8 story reads out of one stream), and
`reconstruct_timeline` turns the raw events back into the restart
story a post-mortem needs (incarnations, steps run, restore points,
reanchors, checkpoint commits, injected chaos).

Event schema (every event):

  ``v``       journal format version (1)
  ``run_id``  one per process incarnation (env ``PADDLE_TPU_RUN_ID`` or
              minted from pid+time at first use)
  ``rank``    trainer rank (``PADDLE_TRAINER_ID``, 0 off-fleet)
  ``seq``     per-process monotonic sequence number (gap-free; a reader
              detects torn tails by the seq chain, not file size)
  ``t``       wall-clock unix seconds (float)
  ``kind``    event type + kind-specific fields, e.g.:

    run_start         argv, world, platform
    step              step (executor step), wall_ms, [tokens_per_sec,
                      mfu, global_step]
    compile           fingerprint, kind (run | run_steps | compiled)
    checkpoint_save   step (staged)
    checkpoint_commit step, path
    restore           step, [global_step, world]
    reanchor          world, global_step (elastic topology shift)
    reform            epoch, world, members, restore_step (fleet
                      control plane committed a (re-)formation —
                      distributed/fleet_control.py)
    chaos             directive, step (injected fault fired)
    collective_retry  step, attempt (caller retrying an injected /
                      transient collective failure)
    stall             ranks (supervisor-side heartbeat verdict)

Arming: set ``PADDLE_TPU_JOURNAL_DIR`` (the launcher forwards it to
workers) or call `set_journal_dir` in-process.  When unarmed every
`emit` is one attribute read — the hot path never pays for a feature
that is off.  Writes are line-buffered appends under a lock: JSONL with
one ``os.write``-sized line per event is torn-write-safe enough for a
post-hoc reader that skips truncated tails (`read_journal`).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Iterable, List, Optional

__all__ = ["JOURNAL_ENV", "RUN_ID_ENV", "RunJournal", "get_journal",
           "set_journal_dir", "emit", "journal_enabled", "read_journal",
           "read_rank_journals", "reconstruct_timeline"]

JOURNAL_ENV = "PADDLE_TPU_JOURNAL_DIR"
RUN_ID_ENV = "PADDLE_TPU_RUN_ID"

_FORMAT_VERSION = 1


def trainer_rank() -> int:
    """This process's trainer rank (``PADDLE_TRAINER_ID``, 0 off-fleet).
    THE rank resolver for the whole observability tier — heartbeat
    filenames and the chaos rank filter import it, so the journal's
    ``rank`` field can never diverge from them."""
    try:
        return int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    except ValueError:
        return 0


_rank = trainer_rank


def _mint_run_id() -> str:
    return f"{os.getpid():x}-{int(time.time() * 1000) & 0xFFFFFFFF:08x}"


class RunJournal:
    """One process's append handle onto its rank's journal file."""

    def __init__(self, directory: str, run_id: Optional[str] = None,
                 rank: Optional[int] = None):
        self.dir = directory
        self.rank = _rank() if rank is None else int(rank)
        self.run_id = run_id or os.environ.get(RUN_ID_ENV) \
            or _mint_run_id()
        self.path = os.path.join(directory,
                                 f"journal.rank{self.rank}.jsonl")
        os.makedirs(directory, exist_ok=True)
        self._mu = threading.Lock()
        self._seq = 0
        # a SIGKILL may have torn the previous incarnation's final line
        # mid-write; appending straight onto the fragment would weld two
        # incarnations into one corrupt line.  Seal the tear with a
        # newline so the fragment stays its own (skippable) line.
        needs_newline = False
        try:
            with open(self.path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                needs_newline = f.read(1) != b"\n"
        except OSError:
            pass  # missing or empty file
        self._f = open(self.path, "a", buffering=1)
        if needs_newline:
            self._f.write("\n")

    def event(self, kind: str, **fields) -> None:
        """Append one event (thread-safe; flushed per line so a SIGKILL
        loses at most the in-flight event)."""
        with self._mu:
            rec = {"v": _FORMAT_VERSION, "run_id": self.run_id,
                   "rank": self.rank, "seq": self._seq,
                   "t": time.time(), "kind": kind}
            self._seq += 1
            rec.update(fields)
            try:
                self._f.write(json.dumps(rec, sort_keys=True) + "\n")
            except (OSError, ValueError):  # closed fd / full disk:
                pass                       # telemetry must never kill a run

    def close(self) -> None:
        with self._mu:
            try:
                self._f.close()
            except OSError:
                pass


# -- process singleton --------------------------------------------------------
_journal: Optional[RunJournal] = None
_journal_dir: Optional[str] = None
_disarmed = False  # set_journal_dir(None) overrides even the env
_mu = threading.Lock()


def journal_enabled() -> bool:
    if _disarmed:
        return False
    return bool(_journal_dir or os.environ.get(JOURNAL_ENV))


def set_journal_dir(directory: Optional[str]) -> None:
    """Programmatic arm/disarm (tests; trainers usually use the env).
    Passing None closes the active journal AND disarms the env
    fallback — emit() stays off even under ``PADDLE_TPU_JOURNAL_DIR``
    until a directory is set again."""
    global _journal, _journal_dir, _disarmed
    with _mu:
        if _journal is not None:
            _journal.close()
        _journal = None
        _journal_dir = directory
        _disarmed = directory is None


def get_journal() -> Optional[RunJournal]:
    """The process journal, or None when unarmed.  Created lazily on
    first use; the first event of every incarnation is ``run_start``."""
    global _journal
    if _journal is not None:
        return _journal
    if _disarmed:
        return None
    directory = _journal_dir or os.environ.get(JOURNAL_ENV)
    if not directory:
        return None
    with _mu:
        if _journal is None:
            j = RunJournal(directory)
            j.event("run_start", pid=os.getpid(),
                    world=os.environ.get("PADDLE_TRAINERS_NUM"),
                    restart=os.environ.get("PADDLE_TPU_ELASTIC_RESTART"))
            _journal = j
    return _journal


def emit(kind: str, **fields) -> None:
    """Append one event to the process journal; no-op (one env/global
    read) when journaling is off."""
    if _journal is None and not journal_enabled():
        return
    j = get_journal()
    if j is not None:
        j.event(kind, **fields)


# -- readers ------------------------------------------------------------------
def read_journal(path: str, strict: bool = False) -> List[dict]:
    """Parse one JSONL journal file.  Lines a SIGKILL tore mid-write are
    skipped — at the tail of the file (the process died there) or
    mid-file (a later incarnation sealed the tear with a newline and
    appended after it); per-incarnation ``seq`` chains stay the
    integrity check.  ``strict=True`` raises on ANY unparseable line
    instead (forensic mode)."""
    events: List[dict] = []
    with open(path) as f:
        lines = f.read().splitlines()
    for line in lines:
        if not line.strip():
            continue
        try:
            events.append(json.loads(line))
        except ValueError:
            if strict:
                raise
    return events


def read_rank_journals(directory: str) -> Dict[int, List[dict]]:
    """rank -> parsed events for every ``journal.rank*.jsonl`` under
    `directory`."""
    out: Dict[int, List[dict]] = {}
    for name in sorted(os.listdir(directory)):
        if not (name.startswith("journal.rank")
                and name.endswith(".jsonl")):
            continue
        rank = int(name[len("journal.rank"):-len(".jsonl")])
        out[rank] = read_journal(os.path.join(directory, name))
    return out


def reconstruct_timeline(events: Iterable[dict]) -> dict:
    """Fold a rank's event stream into the restart story: one entry per
    process incarnation (run_id), ordered by first-seen time, each with
    the steps it ran, where it resumed, topology reanchors, checkpoint
    commits and injected chaos.  This is the post-hoc proof that a
    kill/resume run did what the elastic contract promises — derived
    from the journals alone, no live process needed.

    Also the fleet control plane's LIVE substrate: per-incarnation
    ``saves`` (checkpoint_save — staged shards) vs ``commits``
    (published steps) is what `fleet_control.newest_mutual_checkpoint_
    step` intersects across survivors to agree on the restore point,
    and ``reforms`` records the committed fleet (re-)formations."""
    runs: List[dict] = []
    by_id: Dict[str, dict] = {}
    for e in sorted(events, key=lambda e: (e.get("t", 0),
                                           e.get("seq", 0))):
        rid = e.get("run_id", "?")
        run = by_id.get(rid)
        if run is None:
            run = by_id[rid] = {
                "run_id": rid, "start_t": e.get("t"),
                "steps": [], "global_steps": [], "restored_step": None,
                "restored_global": None, "reanchors": [], "saves": [],
                "commits": [], "reforms": [],
                "chaos": [], "collective_retries": 0, "n_events": 0,
            }
            runs.append(run)
        run["n_events"] += 1
        kind = e.get("kind")
        if kind == "step":
            run["steps"].append(e.get("step"))
            if e.get("global_step") is not None:
                run["global_steps"].append(e["global_step"])
        elif kind == "restore":
            run["restored_step"] = e.get("step")
            run["restored_global"] = e.get("global_step")
        elif kind == "reanchor":
            run["reanchors"].append({"world": e.get("world"),
                                     "global_step": e.get("global_step")})
        elif kind == "checkpoint_save":
            run["saves"].append(e.get("step"))
        elif kind == "checkpoint_commit":
            run["commits"].append(e.get("step"))
        elif kind == "reform":
            run["reforms"].append({"epoch": e.get("epoch"),
                                   "world": e.get("world"),
                                   "members": e.get("members"),
                                   "restore_step": e.get("restore_step")})
        elif kind == "chaos":
            run["chaos"].append({"directive": e.get("directive"),
                                 "step": e.get("step")})
        elif kind == "collective_retry":
            run["collective_retries"] += 1
    return {"incarnations": runs, "n_incarnations": len(runs)}
