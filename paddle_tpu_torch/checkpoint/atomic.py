"""Atomic filesystem commit primitives for the checkpoint tier (a copy of
paddle_tpu/checkpoint/atomic.py: it is pure Python).

Crash-safety contract: a reader never observes a partially-written
artifact under its final name.  Files are written to a same-directory
temp name, fsync'd, then `os.replace`d into place (POSIX rename
atomicity); directories are staged under a dot-prefixed temp name and
renamed as a unit, with the parent directory fsync'd so the rename
itself survives a power cut.  Check-N-Run (NSDI '22) calls this the
decoupling point between *snapshot* (cheap, in-memory) and *persist*
(slow, crash-exposed); everything here is the persist half.
"""
from __future__ import annotations

import contextlib
import os
import uuid
import zlib

__all__ = ["atomic_write", "fsync_path", "fsync_dir", "commit_dir",
           "new_temp_path", "crc32_file", "stage_idle_seconds",
           "sweep_dead_stages", "STAGE_SWEEP_GRACE_S"]

# how long an abandoned-looking stage dir must sit unmodified before a
# sweep may delete it: the pid-liveness test in stage names is HOST-local,
# so on a shared mount another host's live writer looks dead — but it
# never goes this long without writing
STAGE_SWEEP_GRACE_S = 3600.0


def stage_idle_seconds(stage: str) -> float:
    """Seconds since anything under `stage` was last modified."""
    import time
    newest = 0.0
    for root, _dirs, files in os.walk(stage):
        for entry in [root] + files:
            p = entry if entry == root else os.path.join(root, entry)
            try:
                newest = max(newest, os.path.getmtime(p))
            except OSError:
                pass
    return time.time() - newest


def sweep_dead_stages(parent: str, prefix: str = ".tmp.") -> None:
    """Remove staging dirs under `parent` abandoned by a crashed writer.

    Stage names embed the writer's pid (new_temp_path); a stage whose
    owner is still alive belongs to a concurrent in-progress save and is
    kept.  The pid test is HOST-local — on a shared mount another host's
    live writer looks dead here — so a dead-looking stage is only swept
    once it has also been idle past STAGE_SWEEP_GRACE_S, longer than any
    in-progress save ever goes without writing."""
    import shutil
    if not os.path.isdir(parent):
        return
    for name in os.listdir(parent):
        if not name.startswith(prefix):
            continue
        path = os.path.join(parent, name)
        if not os.path.isdir(path):
            continue
        try:
            pid = int(name.rsplit(".", 2)[-2])
            os.kill(pid, 0)  # raises if no such process
            continue  # owner alive: in-progress stage, keep
        except (ValueError, IndexError, ProcessLookupError):
            pass  # unparseable or owner dead (on THIS host)
        except PermissionError:
            continue  # pid exists under another uid: keep
        if stage_idle_seconds(path) < STAGE_SWEEP_GRACE_S:
            continue  # possibly another host's live writer
        shutil.rmtree(path, ignore_errors=True)


def fsync_path(path: str) -> None:
    """fsync one file by path (no-op if the OS refuses, e.g. some network
    mounts return EINVAL — the rename still orders after the writes)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    """Persist directory entries (created/renamed names) themselves."""
    fsync_path(path)


def new_temp_path(final_path: str, prefix: str = ".tmp.") -> str:
    """A unique same-directory temp name for `final_path` (same dir =>
    os.replace is a rename, never a copy)."""
    d, base = os.path.split(final_path)
    return os.path.join(d, f"{prefix}{base}.{os.getpid()}.{uuid.uuid4().hex[:8]}")


@contextlib.contextmanager
def atomic_write(path: str, mode: str = "wb", fsync: bool = True):
    """Write-temp-then-rename for a single file::

        with atomic_write(prefix + ".pdparams") as f:
            pickle.dump(state, f)

    On success the temp file is fsync'd and renamed over `path`; on any
    exception the temp is removed and `path` is untouched — a crash
    mid-write can never corrupt an existing artifact."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = new_temp_path(path)
    f = open(tmp, mode)
    try:
        yield f
        f.flush()
        if fsync:
            try:
                os.fsync(f.fileno())
            except OSError:
                pass
        f.close()
        os.replace(tmp, path)
        if fsync and d:
            fsync_dir(d)
    except BaseException:
        with contextlib.suppress(OSError):
            f.close()
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise


def commit_dir(tmp_dir: str, final_dir: str, fsync: bool = True) -> None:
    """Atomically publish a fully-written staging directory.

    fsyncs every file in `tmp_dir` (unless already done by the writer),
    renames it to `final_dir` (replacing a stale same-name dir), and
    fsyncs the parent so the commit is durable.  After this returns,
    `final_dir` either exists complete or the rename never happened."""
    if fsync:
        for root, _dirs, files in os.walk(tmp_dir):
            for name in files:
                fsync_path(os.path.join(root, name))
        fsync_dir(tmp_dir)
    if os.path.isdir(final_dir):
        # a re-save of the same step: move the old dir aside first so the
        # rename below is a plain atomic publish, then drop the old one
        import shutil
        stale = new_temp_path(final_dir, prefix=".stale.")
        os.rename(final_dir, stale)
        os.rename(tmp_dir, final_dir)
        shutil.rmtree(stale, ignore_errors=True)
    else:
        os.rename(tmp_dir, final_dir)
    parent = os.path.dirname(final_dir)
    if fsync and parent:
        fsync_dir(parent)


def crc32_file(path: str, chunk: int = 1 << 20) -> int:
    """Streaming CRC-32 of a file (integrity line in checkpoint meta)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return crc
            crc = zlib.crc32(b, crc)
