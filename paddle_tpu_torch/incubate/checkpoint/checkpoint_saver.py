"""Numbered checkpoint management (fluid-parity surface, real engine).

Counterpart of paddle_tpu/incubate/checkpoint/checkpoint_saver.py (a
copy: it is pure Python) — CheckpointSaver over an FS abstraction (HDFS in
production, local in tests): save_checkpoint writes checkpoint.<n>,
load_checkpoint restores the newest, older ones are pruned.

Re-based on the checkpoint tier's atomic commit protocol: objects are
serialized into a dot-prefixed staging dir, every written file is
fsync'd and inventoried (size + CRC-32) in ``_meta.json``, and the dir
is atomically renamed to its numbered name.  ``get_last_checkpoint_no``
counts only committed checkpoints (meta present); ``load_checkpoint``
verifies the inventory first and falls back to the previous number when
the newest is truncated or bit-flipped — same keep/prune env contract
as before, no silently-corrupt restores.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Optional

from ...checkpoint.atomic import (commit_dir, crc32_file, fsync_path,
                                  new_temp_path, sweep_dead_stages)
from ...core.monitor import stat_add
from ...distributed.fleet.utils.fs import FS, LocalFS

__all__ = ["SerializableBase", "CheckpointSaver"]

_META = "_meta.json"


class SerializableBase:
    def serialize(self, path):
        raise NotImplementedError

    def deserialize(self, path):
        raise NotImplementedError


class CheckpointSaver:
    def __init__(self, fs: Optional[FS] = None):
        self._fs = fs or LocalFS()
        self._is_local = isinstance(self._fs, LocalFS)
        # absolute path of the checkpoint dir the last successful
        # load_checkpoint() deserialized from (the local cache copy for
        # remote FSes) — callers doing lazy/deferred restores read from
        # here instead of re-deriving cache paths
        self.last_restore_dir: Optional[str] = None

    def _ckpt_dirs(self, root, committed_only=True):
        if not self._fs.is_exist(root):
            return []
        dirs, _ = self._fs.ls_dir(root)
        nums = []
        for d in dirs:
            if d.startswith("__paddle_checkpoint__"):
                try:
                    no = int(d.rsplit(".", 1)[-1])
                except ValueError:
                    continue
                if committed_only and not self._fs.is_exist(
                        os.path.join(root, d, _META)):
                    continue  # uncommitted/legacy partial dir
                nums.append(no)
        return sorted(nums)

    def get_last_checkpoint_no(self, root) -> int:
        nums = self._ckpt_dirs(root)
        return nums[-1] if nums else -1

    def _inventory(self, d, fsync=False):
        """{relpath: {size, crc32}} over every file under `d` (meta
        excluded) — the integrity line load_checkpoint verifies.  The CRC
        read is inherent (objects serialize their own files, so the bytes
        only exist on disk); with `fsync` the same walk also persists each
        file so commit_dir need not walk a second time."""
        inv = {}
        for dirpath, _dirs, files in os.walk(d):
            for name in files:
                p = os.path.join(dirpath, name)
                rel = os.path.relpath(p, d)
                if rel == _META:
                    continue
                inv[rel] = {"size": os.path.getsize(p),
                            "crc32": crc32_file(p)}
                if fsync:
                    fsync_path(p)
        return inv

    def _materialize(self, d, local_cache_path):
        """A LOCAL directory holding checkpoint `d`'s contents: `d` itself
        on LocalFS; a download into the local cache for remote FSes
        (objects serialize/deserialize against local paths, as in the
        reference's HDFS flow)."""
        if self._is_local:
            return d
        import shutil
        local = os.path.join(local_cache_path, os.path.basename(d))
        shutil.rmtree(local, ignore_errors=True)
        os.makedirs(local_cache_path, exist_ok=True)
        self._fs.download(d, local_cache_path)
        return local

    def _verify(self, d, local_cache_path=".cache"):
        """Integrity screen; returns the VERIFIED LOCAL dir, or None."""
        try:
            local = self._materialize(d, local_cache_path)
        except Exception:  # noqa: BLE001 - remote fetch failure = invalid
            return None
        meta_p = os.path.join(local, _META)
        try:
            with open(meta_p) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return None
        for rel, want in meta.get("files", {}).items():
            p = os.path.join(local, rel)
            try:
                if os.path.getsize(p) != want["size"] or \
                        crc32_file(p) != want["crc32"]:
                    return None
            except OSError:
                return None
        return local

    def save_checkpoint(self, path, slists, trainer_id=None,
                        local_cache_path=".cache", max_keep=3) -> int:
        """Serialize each object into the next numbered checkpoint dir —
        staged locally, fsync'd, CRC-inventoried, then committed: an
        atomic rename on LocalFS, a stage-then-upload through the FS
        client for remote filesystems."""
        self._fs.mkdirs(path)
        # drop stage dirs a crashed/preempted save abandoned — on a pod
        # that restarts repeatedly they would otherwise pile up unboundedly
        stage_home = path if self._is_local else local_cache_path
        sweep_dead_stages(stage_home, ".tmp.__paddle_checkpoint__")
        # next number counts UNcommitted dirs too, so a crashed save never
        # gets silently overwritten by the next one reusing its number
        all_nums = self._ckpt_dirs(path, committed_only=False)
        no = (all_nums[-1] if all_nums else -1) + 1
        final = os.path.join(path, f"__paddle_checkpoint__.{no}")
        if self._is_local:
            stage = new_temp_path(final)
        else:
            os.makedirs(local_cache_path, exist_ok=True)
            stage = new_temp_path(os.path.join(
                local_cache_path, os.path.basename(final)))
        os.makedirs(stage)
        for i, s in enumerate(slists):
            s.serialize(os.path.join(stage, f"obj_{i}"))
        meta = {"no": no, "n_objs": len(slists), "trainer_id": trainer_id,
                "files": self._inventory(stage, fsync=self._is_local)}
        with open(os.path.join(stage, _META), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if self._is_local:
            # files fsync'd in _inventory; still persist the staged dir's
            # entries and (after publishing) the rename itself
            fsync_path(stage)
            commit_dir(stage, final, fsync=False)
            fsync_path(path)
        else:
            import shutil
            self._fs.upload(stage, final)
            shutil.rmtree(stage, ignore_errors=True)
        stat_add("checkpoint.saver_commits")
        self.clean_redundant_checkpoints(path, max_keep)
        return no

    def load_checkpoint(self, path, slists, trainer_id=None,
                        checkpoint_no=None, local_cache_path=".cache"):
        """Restore the newest VERIFIED checkpoint (or exactly
        `checkpoint_no`).  A checkpoint failing its CRC inventory is
        skipped with a warning and the previous number is tried."""
        if checkpoint_no is not None:
            d = os.path.join(path, f"__paddle_checkpoint__.{checkpoint_no}")
            local = self._verify(d, local_cache_path)
            if local is None:
                raise RuntimeError(
                    f"checkpoint {d} is missing, truncated, or corrupt")
            self.last_restore_dir = os.path.abspath(local)
            for i, s in enumerate(slists):
                s.deserialize(os.path.join(local, f"obj_{i}"))
            return checkpoint_no
        for no in reversed(self._ckpt_dirs(path)):
            d = os.path.join(path, f"__paddle_checkpoint__.{no}")
            local = self._verify(d, local_cache_path)
            if local is None:
                stat_add("checkpoint.load_fallbacks")
                warnings.warn(
                    f"checkpoint {d} failed integrity verification; "
                    "falling back to the previous checkpoint",
                    RuntimeWarning, stacklevel=2)
                continue
            self.last_restore_dir = os.path.abspath(local)
            for i, s in enumerate(slists):
                s.deserialize(os.path.join(local, f"obj_{i}"))
            return no
        return None

    def clean_redundant_checkpoints(self, root, max_keep=3):
        nums = self._ckpt_dirs(root)
        for n in nums[:-max_keep]:
            self._fs.delete(os.path.join(
                root, f"__paddle_checkpoint__.{n}"))
