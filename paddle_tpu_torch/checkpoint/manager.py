"""CheckpointManager — async, atomic, preemption-safe training checkpoints.

Counterpart of paddle_tpu/checkpoint/manager.py, on the same disk format
(a step either package wrote loads in the other).  Pretraining on
preemptible cards must snapshot and resume without ever blocking the
train loop on disk or trusting a half-written directory.  Design in the
spirit of Orbax async checkpointing and Check-N-Run (NSDI '22):

* **snapshot / persist decoupling** — ``save()`` copies state into host
  memory the manager owns (a blocking device-to-host copy of each CUDA
  tensor, a clone of each CPU one: a `run_steps` capture updates its
  static buffers in place, and the scope's CPU tensors are rebound or
  overwritten by the next step, so a view would tear) and returns; a single background writer thread does the slow part.  A
  bounded in-flight budget (``max_in_flight``) applies *backpressure*:
  when the writer falls behind, ``save()`` blocks instead of queueing
  unbounded host snapshots.
* **atomic commit with integrity** — shards + a JSON manifest (step,
  per-tensor shape/dtype/CRC-32, framework version) are staged in a
  temp dir, fsync'd, then renamed to ``step_<N>/`` (atomic.py).  A
  checkpoint directory under its final name is either complete or was
  never published.
* **verified load with fallback** — ``load()`` checks manifest shape/
  dtype/CRC per tensor and refuses truncated or bit-flipped shards,
  falling back to the previous valid step (``checkpoint.load_fallbacks``
  counter + a RuntimeWarning naming the corrupt dir).
* **retention** — keep-last-N ∪ keep-every-M-steps GC after each commit
  (generalizing incubate's ``clean_redundant_checkpoints``).
* **preemption** — ``install_preemption_handler()`` hooks SIGTERM/SIGINT:
  on signal the manager drains in-flight saves and writes one final
  synchronous checkpoint from the registered state provider before the
  process dies.

Monitor surface (core/monitor.py): ``checkpoint.save_seconds`` histogram,
``checkpoint.bytes_written`` / ``checkpoint.saves`` /
``checkpoint.save_failures`` / ``checkpoint.load_fallbacks`` counters,
``checkpoint.last_saved_step`` / ``checkpoint.in_flight`` gauges.

Multi-host layout (through the fleet FS abstraction): every host stages
``shard_<rank>.bin`` plus ``manifest_<rank>.json`` into a shared pending
dir; with ``world_size > 1`` nothing publishes inside ``save()`` — the
protocol is save-on-every-rank → ``wait()`` → cross-host barrier →
rank 0 ``commit(step)`` (atomic rename + GC), so a checkpoint can never
be published while another rank's shard is mid-write.  Each rank loads
strictly its own shard/manifest back, so per-host sharded params never
cross hosts.
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import signal
import threading
import time
import warnings
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..core.serialization import decode_tensor, encode_tensor
from ..core.monitor import gauge_set, hist_observe, stat_add
from .atomic import (STAGE_SWEEP_GRACE_S, commit_dir, fsync_path,
                     new_temp_path, stage_idle_seconds, sweep_dead_stages)

__all__ = ["CheckpointManager", "Checkpoint", "CheckpointError",
           "FORMAT_VERSION"]

FORMAT_VERSION = "paddle_tpu.checkpoint/1"

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointError(RuntimeError):
    pass


class Checkpoint(NamedTuple):
    """One verified restore: host (CPU) tensors + the non-tensor sidecar."""
    step: int
    state: Dict[str, torch.Tensor]
    extra: dict


class _Job(NamedTuple):
    step: int
    state: Dict[str, torch.Tensor]
    extra: dict
    done: threading.Event


# threads computing the per-tensor CRCs beside the shard write (zlib
# releases the GIL on large buffers)
_CRC_THREADS = max(1, min(4, os.cpu_count() or 1))


def _snapshot(state: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """Host snapshot of a state dict — always BY VALUE, into memory this
    manager owns.  Each CUDA tensor is copied device-to-host without
    blocking (into pinned memory), then every device's current stream is
    synchronised once, before any byte is handed on: a `non_blocking`
    copy without the sync would give the writer a buffer the copy has not
    filled yet, a torn snapshot whose CRC validates the garbage.  CPU
    tensors and arrays are cloned (`_device_get`)."""
    host, devices = {}, set()
    for name, v in state.items():
        if v is None:
            continue
        if isinstance(v, torch.Tensor) and v.is_cuda:
            host[name] = v.detach().to("cpu", non_blocking=True)
            devices.add(v.device)
        else:
            host[name] = _device_get(v)
    for d in devices:
        torch.cuda.current_stream(d).synchronize()
    return host


def _device_get(value) -> torch.Tensor:
    """Host snapshot of one tensor, BY VALUE: a CUDA tensor copied with a
    blocking device-to-host copy; a CPU tensor or a numpy array cloned,
    since the next step may overwrite it in place (a captured step's
    static buffers are the scope's tensors)."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.is_cuda:
            return t.to("cpu", copy=True)
        return t.clone(memory_format=torch.contiguous_format)
    a = np.array(value)  # an owning copy
    if a.dtype.name == "bfloat16":  # an ml_dtypes array
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))


class CheckpointManager:
    """Numbered atomic checkpoints under ``root/step_<N>/``.

    Args:
        root: checkpoint directory (created on first save).
        keep_last_n: retention — always keep the newest N steps.
        keep_every_m_steps: additionally keep every step that is a
            multiple of M (0 disables; the long-horizon archive knob).
        max_in_flight: async save budget; ``save()`` blocks when this
            many snapshots are still being persisted (backpressure, not
            an unbounded queue).
        fs: fleet FS abstraction for discovery/GC (LocalFS default).
        rank / world_size: multi-host shard layout; only rank 0 writes
            the commit manifest and runs GC.
    """

    def __init__(self, root: str, keep_last_n: int = 5,
                 keep_every_m_steps: int = 0, max_in_flight: int = 1,
                 fs=None, rank: int = 0, world_size: int = 1):
        if keep_last_n < 1:
            raise ValueError("keep_last_n must be >= 1")
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        from ..distributed.fleet.utils.fs import LocalFS
        if fs is not None and not isinstance(fs, LocalFS):
            # shard writes/reads go through os/open on `root`; a remote FS
            # client would silently split state between local disk and the
            # remote listing — refuse loudly.  Remote stores are served by
            # a mounted path (GCS-fuse etc.) or incubate's CheckpointSaver.
            raise ValueError(
                "CheckpointManager requires a locally-mounted filesystem "
                f"(LocalFS), got {type(fs).__name__}; mount the store or "
                "use incubate.checkpoint.CheckpointSaver for remote FS "
                "clients")
        self.root = str(root)
        self.keep_last_n = int(keep_last_n)
        self.keep_every_m_steps = int(keep_every_m_steps)
        self.rank = int(rank)
        self.world_size = int(world_size)
        self._fs = fs or LocalFS()
        self._slots = threading.BoundedSemaphore(int(max_in_flight))
        self._jobs: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self._in_flight = 0
        # RLock: the preemption handler runs on a thread whose
        # interrupted frame may hold this lock (save()'s accounting)
        self._mu = threading.RLock()
        self._last_error: Optional[BaseException] = None
        self._state_provider: Optional[Callable[[], tuple]] = None
        self._prev_handlers: dict = {}
        self._closed = False
        if self.rank == 0:
            self._recover_pending()
            _cleanup_stale(self.root)
        self._writer = threading.Thread(target=self._writer_loop,
                                        daemon=True,
                                        name="paddle-tpu-torch-ckpt-writer")
        self._writer.start()

    # -- naming -------------------------------------------------------------
    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{int(step)}")

    def _shard_name(self, rank: Optional[int] = None) -> str:
        r = self.rank if rank is None else rank
        return f"shard_{r:05d}.bin"

    def _manifest_name(self, rank: Optional[int] = None) -> str:
        r = self.rank if rank is None else rank
        return "manifest.json" if r == 0 else f"manifest_{r:05d}.json"

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Dict[str, object], extra: dict = None,
             sync: bool = False) -> int:
        """Snapshot `state` ({name: array}) at `step` and persist it.

        Returns immediately after the host snapshot unless `sync=True`
        or the in-flight budget is exhausted (then it blocks until a
        writer slot frees — backpressure instead of unbounded memory).
        Non-tensor training state (LR scheduler, RNG, dataset position)
        rides `extra`, which must be JSON-serializable."""
        if self._closed:
            raise CheckpointError("CheckpointManager is closed")
        if not sync:
            # a sync save must NOT abort on a stale background failure:
            # it is the preemption path's last chance to persist state.
            # The stale error still surfaces at the next wait()/close().
            self._raise_pending_error()
        host = _snapshot(state)
        if not host:
            # a zero-tensor checkpoint commits clean (valid manifest, no
            # CRC to fail) and restores nothing — almost always a caller
            # bug (snapshot taken from the wrong scope)
            warnings.warn(
                f"checkpoint save(step={step}) got an EMPTY state dict; "
                "committing a checkpoint that restores no tensors",
                RuntimeWarning, stacklevel=2)
        job = _Job(int(step), host, dict(extra or {}), threading.Event())
        if sync:
            t0 = time.monotonic()
            self._persist(job)
            self._note_saved(job.step, time.monotonic() - t0)
            return job.step
        t0 = time.monotonic()
        self._slots.acquire()  # backpressure point
        waited = time.monotonic() - t0
        if waited > 1e-4:
            hist_observe("checkpoint.backpressure_seconds", waited)
        with self._mu:
            self._in_flight += 1
            gauge_set("checkpoint.in_flight", self._in_flight)
        self._jobs.put(job)
        return job.step

    def _writer_loop(self):
        while True:
            job = self._jobs.get()
            if job is None:
                return
            t0 = time.monotonic()
            try:
                self._persist(job)
                self._note_saved(job.step, time.monotonic() - t0)
            except BaseException as e:  # noqa: BLE001 - surfaced at caller
                self._last_error = e
                stat_add("checkpoint.save_failures")
            finally:
                job.done.set()
                with self._mu:
                    self._in_flight -= 1
                    gauge_set("checkpoint.in_flight", self._in_flight)
                self._slots.release()
                self._jobs.task_done()

    def _persist(self, job: _Job) -> None:
        """The slow half: stage shards + manifest, fsync, atomic rename,
        then retention GC.  Runs on the writer thread (async) or the
        caller (sync / final preemption save)."""
        os.makedirs(self.root, exist_ok=True)
        final = self.step_dir(job.step)
        if self.world_size > 1:
            # shared staging dir so every rank lands in the same commit
            stage = os.path.join(self.root, f".pending.step_{job.step}")
            os.makedirs(stage, exist_ok=True)
        else:
            stage = new_temp_path(final)
            os.makedirs(stage)
        tensors = {}
        nbytes = 0
        shard_path = os.path.join(stage, self._shard_name())
        with open(shard_path, "wb") as f, \
                ThreadPoolExecutor(_CRC_THREADS) as pool:
            crcs = {}
            for name in sorted(job.state):
                view, tag = encode_tensor(job.state[name])
                # a flat byte view of the payload: no second copy of the
                # state (view.tobytes() would make one) for the CRC and
                # the write; the CRCs run on the pool beside the writes
                buf = view.reshape(-1).view(np.uint8)
                crcs[name] = pool.submit(zlib.crc32, buf)
                tensors[name] = {
                    "shape": list(view.shape),
                    "dtype": tag,
                    "vdtype": view.dtype.str,
                    "shard": self._shard_name(),
                    "offset": nbytes,
                    "nbytes": len(buf),
                }
                f.write(buf)
                nbytes += len(buf)
            for name, crc in crcs.items():
                tensors[name]["crc32"] = crc.result()
            f.flush()
            os.fsync(f.fileno())
        # fault injection (testing/chaos.py): the window
        # between shard bytes and manifest/commit is exactly where a
        # preempted host tears a checkpoint — chaos makes that timing
        # reproducible (slow_save / torn_save)
        from ..testing import chaos as _chaos
        _chaos.save_hook(stage, job.step)
        manifest = {
            "format": FORMAT_VERSION,
            "framework_version": _framework_version(),
            "step": job.step,
            "rank": self.rank,
            "world_size": self.world_size,
            "tensors": tensors,
            "extra": job.extra,
        }
        man_path = os.path.join(stage, self._manifest_name())
        with open(man_path, "w") as f:
            json.dump(manifest, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        stat_add("checkpoint.bytes_written", nbytes)
        from ..observability.journal import emit as _jemit
        _jemit("checkpoint_save", step=int(job.step), bytes=int(nbytes))
        if self.world_size == 1:
            # manifest.json is the commit marker; the rename publishes it
            commit_dir(stage, final, fsync=False)  # files fsync'd above
            fsync_path(self.root)
            self._gc()
            _jemit("checkpoint_commit", step=int(job.step), path=final)
        # world_size > 1: every rank only STAGES here.  Publishing is a
        # separate step — the caller barriers across hosts, then rank 0
        # calls commit(step).  Committing inside save() would let rank 0
        # publish (and GC) a checkpoint whose other-rank shards are still
        # being written.
        if self.world_size > 1 and self.rank == 0:
            # no-barrier mode never commits during the run: without
            # pruning, a long run accumulates one full model copy per
            # save under .pending.*
            self._prune_stale_pending()

    def commit(self, step: int) -> None:
        """Publish a multi-host staged checkpoint (rank 0 only; no-op on
        other ranks).  Call AFTER save(step) has returned on every rank
        AND a cross-host barrier::

            mgr.save(step, state)      # all ranks
            mgr.wait()                 # all ranks: shard staged + fsync'd
            barrier()                  # e.g. collective.barrier()
            mgr.commit(step)           # rank 0: atomic publish + GC

        Single-host managers (world_size == 1) commit inside save() and
        never need this."""
        if self.rank != 0 or self.world_size == 1:
            return
        stage = os.path.join(self.root, f".pending.step_{int(step)}")
        if not os.path.isdir(stage):
            raise CheckpointError(
                f"no staged checkpoint for step {step} at {stage} — "
                "call save() on every rank first")
        commit_dir(stage, self.step_dir(step))
        fsync_path(self.root)
        self._gc()
        from ..observability.journal import emit as _jemit
        _jemit("checkpoint_commit", step=int(step),
               path=self.step_dir(step))

    def _note_saved(self, step: int, seconds: float) -> None:
        stat_add("checkpoint.saves")
        hist_observe("checkpoint.save_seconds", seconds)
        gauge_set("checkpoint.last_saved_step", step)

    def wait(self) -> None:
        """Drain every queued/in-flight save; re-raises the first writer
        error, if any."""
        self._jobs.join()
        self._raise_pending_error()

    def _raise_pending_error(self):
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise CheckpointError(
                f"background checkpoint save failed: {err!r}") from err

    # -- discovery ----------------------------------------------------------
    def all_steps(self) -> List[int]:
        """Committed step numbers (dirs with a rank-0 manifest), ascending.
        No shard verification — see latest_step()/load() for validity."""
        if not self._fs.is_exist(self.root):
            return []
        dirs, _files = self._fs.ls_dir(self.root)
        steps = []
        for d in dirs:
            m = _STEP_RE.match(d)
            if m and os.path.exists(os.path.join(
                    self.root, d, "manifest.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        """Newest step that passes the cheap validity screen (manifest
        parses; every declared shard byte range exists on disk).  A
        truncated shard — the half-written artifact a preemption leaves
        when atomicity is violated out-of-band — is skipped here; CRC
        verification happens at load()."""
        for step in reversed(self.all_steps()):
            if self._screen(step) is not None:
                return step
        return None

    def _screen(self, step: int) -> Optional[dict]:
        """Parse + size-check one step's manifest; None if invalid.

        Strictly THIS rank's manifest: falling back to rank 0's would
        silently restore rank-0's parameter shard as this host's state —
        a missing rank manifest makes the step invalid here instead.
        (One screen implementation for load() and load_merged():
        delegates to `_rank_manifest`.)"""
        return self._rank_manifest(step, self.rank)

    # -- load ---------------------------------------------------------------
    def load(self, step: Optional[int] = None,
             on_mismatch: str = "convert") -> Optional[Checkpoint]:
        """Restore the newest valid checkpoint (or exactly `step`).

        Every tensor is CRC-verified against the manifest; a corrupt or
        truncated checkpoint is never returned — with `step=None` the
        manager warns and falls back to the previous valid step, with an
        explicit `step` it raises CheckpointError.

        ``on_mismatch`` governs a WORLD-SIZE mismatch at the storage
        layer (the checkpoint was written by a different rank count —
        the cross-host elastic re-form path, docs/elastic.md):

          * ``"convert"`` (default) routes the step through
            `load_merged`: every writer rank's shard manifest is read
            and reassembled into one rank-complete state;
          * ``"error"`` raises `CheckpointError` naming both worlds;
          * ``"warn"`` restores the old behaviour — read only THIS
            rank's shard and warn that vanished ranks' state is lost.
        """
        if on_mismatch not in ("convert", "error", "warn"):
            raise ValueError(
                f"on_mismatch must be 'convert', 'error' or 'warn', "
                f"got {on_mismatch!r}")
        if step is not None:
            manifest = self._screen(step)
            if manifest is None:
                if on_mismatch == "convert" and \
                        self._foreign_world(step) is not None:
                    # a GROWN world: this rank has no shard of its own
                    # in the old layout, but the merged state serves it
                    return self.load_merged(step=step)
                raise CheckpointError(
                    f"checkpoint {self.step_dir(step)} is missing, "
                    "incomplete, or truncated")
            return self._read(step, manifest, on_mismatch=on_mismatch)
        for cand in reversed(self.all_steps()):
            manifest = self._screen(cand)
            if manifest is None:
                if on_mismatch == "convert" and \
                        self._foreign_world(cand) is not None:
                    try:
                        return self.load_merged(step=cand)
                    except CheckpointError as e:
                        self._fallback_warn(cand, str(e))
                        continue
                self._fallback_warn(cand, "incomplete or truncated")
                continue
            try:
                return self._read(cand, manifest, on_mismatch=on_mismatch)
            except CheckpointError as e:
                self._fallback_warn(cand, str(e))
        return None

    def _foreign_world(self, step: int) -> Optional[int]:
        """The step's writer world size when it DIFFERS from this
        manager's (screened via the rank-0 manifest), else None."""
        man0 = self._rank_manifest(step, 0)
        if man0 is None:
            return None
        saved = int(man0.get("world_size", 1))
        return saved if saved != self.world_size else None

    def _fallback_warn(self, step: int, why: str) -> None:
        stat_add("checkpoint.load_fallbacks")
        warnings.warn(
            f"checkpoint {self.step_dir(step)} refused ({why}); "
            "falling back to the previous valid step", RuntimeWarning,
            stacklevel=3)

    def _read(self, step: int, manifest: dict,
              on_mismatch: str = "convert") -> Checkpoint:
        saved_world = int(manifest.get("world_size", 1))
        if saved_world != self.world_size:
            # topology shift at the storage layer: this manager's rank
            # layout differs from the writer's
            if on_mismatch == "convert":
                return self.load_merged(step=step)
            if on_mismatch == "error":
                raise CheckpointError(
                    f"checkpoint step {step} was written by a world of "
                    f"{saved_world} ranks but is being loaded by a "
                    f"world of {self.world_size} ranks "
                    f"(on_mismatch='error'; pass on_mismatch='convert' "
                    f"for the rank-merged restore, docs/elastic.md)")
            warnings.warn(
                f"checkpoint step {step} was written by a world of "
                f"{saved_world} ranks but is being loaded by a world of "
                f"{self.world_size}; rank-private shards of vanished "
                "ranks are NOT merged under on_mismatch='warn' — pass "
                "on_mismatch='convert' (or call load_merged) for the "
                "rank-merged restore (docs/elastic.md)",
                RuntimeWarning, stacklevel=3)
        state = self._read_state(step, manifest)
        return Checkpoint(step=int(manifest["step"]), state=state,
                          extra=dict(manifest.get("extra", {})))

    def _read_state(self, step: int, manifest: dict) \
            -> Dict[str, torch.Tensor]:
        """CRC-verified tensor read of one rank's manifest+shard."""
        state: Dict[str, torch.Tensor] = {}
        by_shard: Dict[str, List[tuple]] = {}
        for name, meta in manifest["tensors"].items():
            by_shard.setdefault(meta["shard"], []).append((name, meta))
        with ThreadPoolExecutor(_CRC_THREADS) as pool:
            for shard, entries in by_shard.items():
                path = os.path.join(self.step_dir(step), shard)
                bufs = []
                with open(path, "rb") as f:
                    for name, meta in sorted(entries,
                                             key=lambda e: e[1]["offset"]):
                        # a bytearray the restored tensor owns (writable,
                        # so no copy is needed to hand it to torch)
                        buf = bytearray(meta["nbytes"])
                        f.seek(meta["offset"])
                        if f.readinto(buf) != meta["nbytes"]:
                            raise CheckpointError(
                                f"shard {shard} truncated at {name!r}")
                        bufs.append((name, meta, buf,
                                     pool.submit(zlib.crc32, buf)))
                for name, meta, buf, crc in bufs:
                    if crc.result() != meta["crc32"]:
                        raise CheckpointError(
                            f"CRC mismatch for {name!r} in {shard}")
                    view = np.frombuffer(buf, dtype=np.dtype(meta["vdtype"]))
                    state[name] = decode_tensor(
                        view.reshape(meta["shape"]), meta["dtype"])
        return state

    # -- rank-merged load (cross-host world change, docs/elastic.md) --------
    def _rank_manifest(self, step: int, rank: int) -> Optional[dict]:
        """Parse + size-screen an EXPLICIT rank's manifest of `step`
        (same validity screen as `_screen`, which covers only this
        manager's own rank)."""
        path = os.path.join(self.step_dir(step), self._manifest_name(rank))
        try:
            with open(path) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return None
        if manifest.get("format") != FORMAT_VERSION:
            return None
        sizes: Dict[str, int] = {}
        for meta in manifest.get("tensors", {}).values():
            shard = os.path.join(self.step_dir(step), meta["shard"])
            if shard not in sizes:
                try:
                    sizes[shard] = os.path.getsize(shard)
                except OSError:
                    return None
            if meta["offset"] + meta["nbytes"] > sizes[shard]:
                return None
        return manifest

    def load_merged(self, step: Optional[int] = None,
                    world: Optional[int] = None) -> Optional[Checkpoint]:
        """Rank-merged restore: read EVERY writer rank's shard manifest
        of `step` (the writer world comes from the rank-0 manifest) and
        reassemble one rank-complete global state — the load path for a
        host-count change, where this manager's rank layout no longer
        matches the checkpoint's (fleet re-form, docs/elastic.md).

        Merge rules, per tensor name:

          * present in ONE rank — rank-private state, carried through;
          * present in SEVERAL ranks, bitwise identical — replicated
            state (the elastic fold guarantees per-host state is
            rank-complete and identical), one copy carried;
          * present in several ranks and DIFFERING — the hosts diverged;
            refused with `CheckpointError` (silently picking one would
            launder corruption into a resume).

        ``world``: the dp degree of the world that will CONSUME the
        merged state.  When the checkpoint records a ZeRO
        ``zero_shard_plan`` whose dp_degree differs, the bucketed
        layout is routed through ``sharding.unshard_state`` to the
        plain per-param layout (bucket padding is world-dependent, so
        the old bucket arrays cannot be re-fed directly) and the plan
        is dropped from the sidecar; `Executor.restore_from_checkpoint`
        then re-shards for the target program's own plan
        (``reshard_state``) — the unshard→reshard conversion pair that
        already carries single-host shard-count changes.

        With ``step=None`` walks committed steps newest-first and falls
        back past unmergeable ones, like `load`."""
        if step is None:
            for cand in reversed(self.all_steps()):
                try:
                    return self.load_merged(step=cand, world=world)
                except CheckpointError as e:
                    self._fallback_warn(cand, str(e))
            return None
        man0 = self._rank_manifest(step, 0)
        if man0 is None:
            raise CheckpointError(
                f"checkpoint {self.step_dir(step)} has no valid rank-0 "
                "manifest — nothing to merge")
        saved_world = int(man0.get("world_size", 1))
        state: Dict[str, torch.Tensor] = {}
        owner: Dict[str, int] = {}
        conflicts: List[str] = []
        for rank in range(saved_world):
            man = man0 if rank == 0 else self._rank_manifest(step, rank)
            if man is None:
                raise CheckpointError(
                    f"rank-merged load of step {step}: rank {rank} of "
                    f"the writing world ({saved_world}) has a missing "
                    "or truncated manifest/shard")
            for name, arr in self._read_state(step, man).items():
                prev = state.get(name)
                if prev is None:
                    state[name] = arr
                    owner[name] = rank
                elif prev.shape != arr.shape or prev.dtype != arr.dtype \
                        or not torch.equal(prev, arr):
                    conflicts.append(
                        f"{name!r} (rank {owner[name]} vs rank {rank})")
        if conflicts:
            raise CheckpointError(
                f"rank-merged load of step {step}: {len(conflicts)} "
                f"tensor(s) differ between writer ranks — the hosts "
                f"diverged and no merge is sound: "
                f"{conflicts[:6]}{'...' if len(conflicts) > 6 else ''}")
        extra = dict(man0.get("extra", {}))
        extra["merged_from_world"] = saved_world
        plan = extra.get("zero_shard_plan")
        if plan and world and int(world) != int(plan.get("dp_degree", 1)):
            # bucket padding is a function of the dp degree, so the old
            # world's bucket arrays cannot feed the new world's program;
            # unshard to the plain per-param layout here and let the
            # executor's topology-shift conversion re-shard for the
            # target program's own recorded plan
            from ..distributed.sharding import unshard_state
            state = unshard_state(state, plan)
            extra.pop("zero_shard_plan", None)
            extra.pop("dp_degree", None)
            warnings.warn(
                f"rank-merged load: ZeRO layout recorded for dp="
                f"{plan.get('dp_degree')} unsharded to the plain layout "
                f"for the new world of {world} (restore re-shards "
                "against the target program's plan)", RuntimeWarning,
                stacklevel=2)
        stat_add("checkpoint.merged_loads")
        from ..observability.journal import emit as _jemit
        _jemit("restore_merged", step=int(man0["step"]),
               merged_from_world=saved_world, world=self.world_size)
        return Checkpoint(step=int(man0["step"]), state=state,
                          extra=extra)

    # -- multi-host pending recovery ----------------------------------------
    def _prune_stale_pending(self) -> None:
        """Bound .pending.* growth in no-barrier multi-host mode (rank 0).

        Keeps every stage at or newer than the newest RECOVERABLE point —
        the newest committed step or fully-staged pending (what the next
        startup's _recover_pending would publish) — and sweeps older
        stages only once idle past the cross-host grace window, so a
        slow rank's in-progress stage is never deleted under it."""
        pending = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        for name in names:
            m = re.match(r"^\.pending\.step_(\d+)$", name)
            if m:
                pending.append((int(m.group(1)),
                                os.path.join(self.root, name)))
        if not pending:
            return
        committed = self.all_steps()
        newest_safe = max([s for s, p in pending
                           if self._pending_complete(p)] +
                          committed, default=None)
        if newest_safe is None:
            return
        for step, path in pending:
            if step >= newest_safe:
                continue
            if stage_idle_seconds(path) < STAGE_SWEEP_GRACE_S:
                continue  # possibly a slow rank still writing
            shutil.rmtree(path, ignore_errors=True)
            stat_add("checkpoint.pending_pruned")

    def _recover_pending(self) -> None:
        """Commit (or drop) `.pending.step_<N>` stages left by a previous
        process.  A multi-host preemption save can only STAGE inside the
        dying signal handler — the cross-host barrier + rank-0 commit()
        can never run there — so on the next startup rank 0 publishes any
        stage whose every rank finished writing (all manifests present,
        shard byte ranges intact) and deletes the rest.  This is what
        makes the SIGTERM final save real on world_size > 1."""
        if not os.path.isdir(self.root):
            return
        for name in os.listdir(self.root):
            m = re.match(r"^\.pending\.step_(\d+)$", name)
            if m is None:
                continue
            stage = os.path.join(self.root, name)
            step = int(m.group(1))
            if self._pending_complete(stage):
                commit_dir(stage, self.step_dir(step))
                fsync_path(self.root)
                stat_add("checkpoint.pending_recovered")
            else:
                shutil.rmtree(stage, ignore_errors=True)

    @staticmethod
    def _pending_complete(stage: str) -> bool:
        """Every rank the rank-0 manifest declares has a parseable
        manifest whose shard byte ranges exist in the stage dir."""
        def _manifest(rank: int) -> Optional[dict]:
            name = "manifest.json" if rank == 0 \
                else f"manifest_{rank:05d}.json"
            try:
                with open(os.path.join(stage, name)) as f:
                    man = json.load(f)
            except (OSError, ValueError):
                return None
            return man if man.get("format") == FORMAT_VERSION else None

        root_man = _manifest(0)
        if root_man is None:
            return False
        for rank in range(int(root_man.get("world_size", 1))):
            man = _manifest(rank) if rank else root_man
            if man is None:
                return False
            for meta in man.get("tensors", {}).values():
                path = os.path.join(stage, meta["shard"])
                try:
                    size = os.path.getsize(path)
                except OSError:
                    return False
                if meta["offset"] + meta["nbytes"] > size:
                    return False
        return True

    # -- retention ----------------------------------------------------------
    def _gc(self) -> None:
        """keep-last-N ∪ keep-every-M retention over committed steps."""
        steps = self.all_steps()
        keep = set(steps[-self.keep_last_n:])
        if self.keep_every_m_steps > 0:
            keep.update(s for s in steps
                        if s % self.keep_every_m_steps == 0)
        for s in steps:
            if s not in keep:
                self._fs.delete(self.step_dir(s))
                stat_add("checkpoint.gc_deleted")

    # -- preemption ---------------------------------------------------------
    def set_state_provider(self, fn: Callable[[], tuple]) -> None:
        """Register a zero-arg callable returning (step, state, extra) —
        the live training state the final preemption save snapshots."""
        self._state_provider = fn

    def preemption_save(self, drain_timeout: float = 60.0) -> Optional[int]:
        """Drain in-flight saves (bounded), then write one final
        SYNCHRONOUS checkpoint from the state provider.  Returns the
        saved step (None when no provider is registered).  Called from
        the signal handler; safe to call directly (orderly shutdown).

        Signal-context discipline: the drain POLLS the queue's
        unfinished count instead of Queue.join() — the handler runs on
        the thread whose interrupted frame may hold the queue's internal
        lock, and join() there would self-deadlock.  The drain is also
        time-bounded: if the writer can't finish in `drain_timeout`
        seconds, the final sync save (which bypasses the queue entirely)
        still goes out — a newer checkpoint beats a drained queue."""
        deadline = time.monotonic() + drain_timeout
        while self._jobs.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.05)
        if self._state_provider is None:
            return None
        provided = self._state_provider()
        if provided is None:
            # provider registered but nothing to save yet (e.g. hapi fit
            # preempted before its first epoch completed)
            return None
        step, state, extra = provided
        stat_add("checkpoint.preemption_saves")
        return self.save(step, state, extra=extra, sync=True)

    def install_preemption_handler(self,
                                   signals=(signal.SIGTERM, signal.SIGINT)):
        """SIGTERM/SIGINT → drain + final synchronous checkpoint, then the
        previous disposition runs (so Ctrl-C still interrupts and the
        platform's kill still kills — just after the state is safe).
        Idempotent: a second install never records the handler as its own
        predecessor (which would recurse on signal)."""
        for sig in signals:
            prev = signal.signal(sig, self._handle_preemption)
            # == not `is`: bound methods are re-created on each access
            if prev != self._handle_preemption:
                self._prev_handlers[sig] = prev

    def uninstall_preemption_handler(self):
        for sig, prev in self._prev_handlers.items():
            signal.signal(sig, prev)
        self._prev_handlers.clear()

    def _handle_preemption(self, signum, frame):
        try:
            self.preemption_save()
        finally:
            prev = self._prev_handlers.get(signum)
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_IGN:
                pass  # previously ignored stays ignored (post-save)
            elif signum == signal.SIGINT:
                raise KeyboardInterrupt
            else:
                raise SystemExit(128 + signum)

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Drain pending saves and stop the writer thread.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._jobs.join()
        self._jobs.put(None)
        self._writer.join(timeout=30.0)
        self.uninstall_preemption_handler()
        self._raise_pending_error()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _framework_version() -> str:
    try:
        import paddle_tpu_torch
        return getattr(paddle_tpu_torch, "__version__", "0")
    except ImportError:  # pragma: no cover
        return "0"


def _cleanup_stale(root: str) -> None:
    """Remove abandoned staging dirs from a previous crashed process.

    `.stale.<base>.<pid>.<hex>` dirs are special: commit_dir moves a
    same-name checkpoint aside under that name while re-publishing, so a
    crash between its two renames leaves the stale copy as the ONLY
    complete version of that step — recover it back to `<base>` instead
    of deleting it (unless the re-publish completed and `<base>`
    exists)."""
    if not os.path.isdir(root):
        return
    for name in os.listdir(root):
        path = os.path.join(root, name)
        if name.startswith(".stale."):
            base = name[len(".stale."):].rsplit(".", 2)[0]
            final = os.path.join(root, base)
            if not os.path.exists(final):
                try:
                    os.rename(path, final)
                    continue
                except OSError:
                    pass
            shutil.rmtree(path, ignore_errors=True)
    # .pending.* is owned by _recover_pending (commit-or-drop); .tmp.*
    # stages are swept only when their owner is dead AND they have gone
    # idle (a live concurrent manager on this root — e.g. an eval job
    # starting while training's writer is mid-_persist — keeps its stage)
    sweep_dead_stages(root, ".tmp.")
