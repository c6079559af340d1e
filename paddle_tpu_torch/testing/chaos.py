"""Fault-injection harness — make host loss and torn writes reproducible.

Counterpart of paddle_tpu/testing/chaos.py (a copy: it is pure Python),
with the same env grammar, so one worker script reads either launcher's
environment.  The elastic tier's whole claim is "training survives rank
death, mesh shrink and torn checkpoints"; none of that is testable
unless the faults themselves are deterministic.  This module injects
them from an env knob, so the SAME kill/shrink/regrow scenario replays
across spawned CPU ranks in every test run and on the card.

``PADDLE_TPU_CHAOS`` grammar — semicolon-separated directives:

  ``kill@<step>[:rank=<r>][:signal=kill|term]``
      Kill THIS process (default SIGKILL — a preempted host gets no
      goodbye; ``signal=term`` simulates a graceful preemption notice)
      right after the executor finishes micro-step ``<step>``, but only
      on trainer rank ``<r>`` (default 0, from ``PADDLE_TRAINER_ID``).

  ``lose_host@<step>[:host=<h>]``
      Simulate losing a WHOLE host of the fleet (docs/elastic.md
      multi-host): right after the executor finishes micro-step
      ``<step>``, but only when this process's fleet host id
      (``PADDLE_TPU_FLEET_HOST_ID``) is ``<h>`` (default 0), SIGKILL
      the host's fleet launcher (``PADDLE_TPU_FLEET_LAUNCHER_PID``)
      and then this trainer — no goodbye from either, exactly what a
      preempted host looks like.  Surviving hosts' controllers see the
      membership record go stale and drive the cross-host re-form.

  ``slow_save=<seconds>``
      Sleep inside the checkpoint writer between the shard bytes and the
      manifest — the slow-disk half of a torn-write race.

  ``torn_save@<step>``
      SIGKILL the process mid-checkpoint-write at save step ``<step>``
      (shard bytes staged, manifest/commit never happens).  Exercises
      the crash-consistency contract: the orphaned stage is swept on the
      next startup and load() falls back to the last CRC-valid commit.

  ``collective_fail@<step>[:times=<n>][:rank=<r>]``
      Raise ``ChaosCollectiveError`` from the next ``<n>`` (default 1)
      compiled-program dispatches at executor step ``<step>`` — the
      transient collective failure a flaky link produces; callers
      retry or surface it to the supervisor.  ``rank=<r>`` restricts the
      fault to one trainer rank (default: every rank); ``times`` large
      enough to outlast any retry budget turns the fault PERMANENT — the
      wedged-rank scenario the heartbeat stall deadline exists for
      (docs/observability.md).

Every fired directive is also recorded in the run journal
(``paddle_tpu_torch.observability.journal``) when journaling is armed, so a
chaos run's post-mortem shows which faults actually fired where.

Hooks are wired into ``Executor.run`` (step_hook), ``CheckpointManager.
_persist`` (save_hook) and ``CompiledProgram._run`` (collective_hook);
each is a no-op costing one attribute read when chaos is off.
"""
from __future__ import annotations

import os
import signal
import time
from typing import List, Optional

__all__ = ["ChaosCollectiveError", "enabled", "reload", "step_hook",
           "save_hook", "collective_hook", "CHAOS_ENV"]

CHAOS_ENV = "PADDLE_TPU_CHAOS"


class ChaosCollectiveError(RuntimeError):
    """Injected transient collective failure (retryable)."""


class _Directive:
    __slots__ = ("kind", "step", "rank", "sig", "seconds", "times")

    def __init__(self, kind, step=None, rank=0, sig=signal.SIGKILL,
                 seconds=0.0, times=1):
        self.kind = kind
        self.step = step
        self.rank = rank
        self.sig = sig
        self.seconds = seconds
        self.times = times


_spec: Optional[List[_Directive]] = None
_spec_raw: Optional[str] = None


def _rank() -> int:
    # the observability tier's shared resolver, so the chaos rank filter,
    # heartbeat filenames and journal rank field can never disagree
    from ..observability.journal import trainer_rank
    return trainer_rank()


def _parse(raw: str) -> List[_Directive]:
    out = []
    for part in raw.split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        head = fields[0]
        opts = {}
        for f in fields[1:]:
            k, _, v = f.partition("=")
            opts[k.strip()] = v.strip()
        if "@" in head:
            name, _, at = head.partition("@")
            name = name.strip()
            step = int(at)
        else:
            name, _, val = head.partition("=")
            name = name.strip()
            step = None
            if val:
                opts["value"] = val.strip()
        if name == "kill":
            sig = signal.SIGTERM if \
                opts.get("signal", "kill").lower() == "term" \
                else signal.SIGKILL
            out.append(_Directive("kill", step=step,
                                  rank=int(opts.get("rank", 0)), sig=sig))
        elif name == "lose_host":
            out.append(_Directive("lose_host", step=step,
                                  rank=int(opts.get("host", 0))))
        elif name == "slow_save":
            out.append(_Directive("slow_save",
                                  seconds=float(opts.get("value", 0.1))))
        elif name == "torn_save":
            out.append(_Directive("torn_save", step=step,
                                  rank=int(opts.get("rank", 0))))
        elif name == "collective_fail":
            out.append(_Directive("collective_fail", step=step,
                                  times=int(opts.get("times", 1)),
                                  rank=(int(opts["rank"])
                                        if "rank" in opts else None)))
        else:
            raise ValueError(
                f"unknown {CHAOS_ENV} directive {part!r} (see "
                "paddle_tpu_torch/testing/chaos.py for the grammar)")
    return out


def reload() -> None:
    """Re-parse ``PADDLE_TPU_CHAOS`` (tests monkeypatching the env call
    this; normal processes parse once at first use)."""
    global _spec, _spec_raw
    _spec_raw = os.environ.get(CHAOS_ENV, "")
    _spec = _parse(_spec_raw) if _spec_raw else []


def _directives() -> List[_Directive]:
    if _spec is None or _spec_raw != os.environ.get(CHAOS_ENV, ""):
        reload()
    return _spec


def enabled() -> bool:
    return bool(os.environ.get(CHAOS_ENV)) and bool(_directives())


def _die(sig) -> None:  # pragma: no cover - ends the process
    # flush whatever the harness buffered; SIGKILL gives no second chance
    try:
        import sys
        sys.stdout.flush()
        sys.stderr.flush()
    except Exception:
        pass
    os.kill(os.getpid(), sig)
    if sig != signal.SIGKILL:
        # a SIGTERM handler (preemption save) may return; don't continue
        # training afterwards — the "host" is gone
        os._exit(143)


def _journal_fire(directive: str, step) -> None:
    """Record a fired directive in the run journal (no-op when
    journaling is unarmed; flushed per line, so even a SIGKILL directive
    leaves its own record behind)."""
    try:
        from ..observability.journal import emit
        emit("chaos", directive=directive, step=step)
    except Exception:
        pass


def _fleet_host() -> int:
    try:
        return int(os.environ.get("PADDLE_TPU_FLEET_HOST_ID", "0"))
    except ValueError:
        return 0


def step_hook(step: int) -> None:
    """Called by the executor after finishing micro-step `step`."""
    if not enabled():
        return
    for d in _directives():
        if d.kind == "kill" and d.step == step and d.rank == _rank():
            d.step = None  # never double-fire in one process
            _journal_fire("kill", step)
            _die(d.sig)
        elif d.kind == "lose_host" and d.step == step and \
                d.rank == _fleet_host():
            d.step = None
            _journal_fire("lose_host", step)
            # the launcher first (it must not observe our death and
            # relaunch locally — the HOST is gone), then ourselves;
            # SIGKILL both: a preempted host sends no goodbyes
            pid = os.environ.get("PADDLE_TPU_FLEET_LAUNCHER_PID")
            if pid:
                try:
                    os.kill(int(pid), signal.SIGKILL)
                except (ValueError, ProcessLookupError, PermissionError):
                    pass
            _die(signal.SIGKILL)


def save_hook(stage_dir: str, step: int) -> None:
    """Called by the checkpoint writer with the shard bytes staged but
    the manifest/commit not yet written."""
    if not enabled():
        return
    for d in _directives():
        if d.kind == "slow_save" and d.seconds > 0:
            _journal_fire("slow_save", step)
            time.sleep(d.seconds)
        elif d.kind == "torn_save" and d.step == step and \
                d.rank == _rank():
            d.step = None
            _journal_fire("torn_save", step)
            _die(signal.SIGKILL)


def collective_hook(step: int) -> None:
    """Called before each compiled-program dispatch; raises the injected
    transient failure while its budget lasts."""
    if not enabled():
        return
    for d in _directives():
        if d.kind == "collective_fail" and d.step == step and \
                d.times > 0 and d.rank in (None, _rank()):
            d.times -= 1
            _journal_fire("collective_fail", step)
            raise ChaosCollectiveError(
                f"injected transient collective failure at step {step} "
                f"({d.times} more)")
