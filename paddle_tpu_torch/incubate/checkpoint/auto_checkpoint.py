"""Auto-checkpoint — the elastic fault-recovery story.

Counterpart of paddle_tpu/incubate/checkpoint/auto_checkpoint.py (Paddle's
fluid auto_checkpoint): `AutoCheckpointChecker` reads PADDLE_RUNNING_ENV
/ PADDLE_JOB_ID / PADDLE_EDL_HDFS_CHECKPOINT_PATH; `train_epoch_range`
wraps the epoch loop, checkpointing program state (persistables + epoch
number) under the job id every save interval; the hook in Executor.run
attaches running programs.  On restart the generator resumes from the
last saved epoch.

Checkpoints are written through the FS abstraction (LocalFS or
HDFSClient per env); multi-host jobs write from rank 0.  A status blob
holds each persistable through the tensor codec (core/serialization.py),
so bf16 state round-trips bit-exact without ml_dtypes.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np

from .checkpoint_saver import CheckpointSaver, SerializableBase

__all__ = ["AutoCheckpointChecker", "train_epoch_range", "ExeTrainStatus",
           "_get_train_epoch_range", "_auto_checkpoint"]

g_train_epoch_range = None
g_checker = None


class AutoCheckpointChecker:
    """The reference's AutoCheckpointChecker — env-gated."""

    def __init__(self):
        self._run_env = os.environ.get("PADDLE_RUNNING_ENV")
        self._platform = os.environ.get("PADDLE_RUNNING_PLATFORM", "")
        self._job_id = os.environ.get("PADDLE_JOB_ID")
        self._hdfs_home = os.environ.get("PADDLE_EDL_HDFS_HOME", "")
        self._hdfs_name = os.environ.get("PADDLE_EDL_HDFS_NAME", "")
        self._hdfs_ugi = os.environ.get("PADDLE_EDL_HDFS_UGI", "")
        self._hdfs_ckpt_path = os.environ.get(
            "PADDLE_EDL_HDFS_CHECKPOINT_PATH", "")
        self._trainer_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self._save_checkpoint_inter = int(os.environ.get(
            "PADDLE_EDL_SAVE_CHECKPOINT_INTER", "900"))

    def valid(self) -> bool:
        return (self._run_env == "PADDLE_EDL_AUTO_CHECKPOINT"
                and bool(self._job_id)
                and bool(self._hdfs_ckpt_path))

    @property
    def trainer_id(self):
        return self._trainer_id

    @property
    def save_checkpoint_inter(self):
        return self._save_checkpoint_inter

    def get_job_checkpoint_path(self, name) -> str:
        return os.path.join(self._hdfs_ckpt_path, self._job_id, name)

    def make_fs(self):
        if self._hdfs_home and self._hdfs_name:
            from ...distributed.fleet.utils.fs import HDFSClient
            return HDFSClient(self._hdfs_home,
                              {"fs.default.name": self._hdfs_name,
                               "hadoop.job.ugi": self._hdfs_ugi})
        from ...distributed.fleet.utils.fs import LocalFS
        return LocalFS()


def _checker() -> AutoCheckpointChecker:
    global g_checker
    if g_checker is None:
        g_checker = AutoCheckpointChecker()
    return g_checker


class ExeTrainStatus(SerializableBase):
    """One (executor, program) training state."""

    def __init__(self, exe=None, program=None, key=None):
        self._exe = exe
        self._program = program
        self._key = key or "default"
        self._epoch_no = -1

    def serialize(self, path):
        os.makedirs(path, exist_ok=True)
        from ...static.executor import global_scope
        from ...static.executor import _persistable_names
        scope = global_scope()
        from ...core.serialization import encode_tensor
        state, tags = {}, {}
        if self._program is not None:
            for n in _persistable_names(self._program):
                v = scope.get(n)
                if v is not None:
                    state[n], tags[n] = encode_tensor(v)
        np.savez(os.path.join(path, f"{self._key}.npz"), **state)
        with open(os.path.join(path, f"{self._key}.json"), "w") as f:
            json.dump({"epoch_no": self._epoch_no, "key": self._key,
                       "dtypes": tags}, f)

    def deserialize(self, path):
        from ...core.serialization import decode_tensor
        from ...static.executor import global_scope
        meta_p = os.path.join(path, f"{self._key}.json")
        if not os.path.exists(meta_p):
            return
        with open(meta_p) as f:
            meta = json.load(f)
        self._epoch_no = meta["epoch_no"]
        tags = meta.get("dtypes", {})
        data = np.load(os.path.join(path, f"{self._key}.npz"))
        scope = global_scope()
        device = self._exe.device if self._exe is not None else None
        for n in data.files:
            arr = data[n]
            t = decode_tensor(arr, tags.get(n, arr.dtype.name))
            scope.set(n, t.to(device) if device is not None else t)


class TrainEpochRange(SerializableBase):
    """The reference's TrainEpochRange: resumable epoch generator."""

    def __init__(self, max_epoch_num, name, checkpoint_inter=None,
                 save_checkpoint=True):
        self._name = name
        self._max_epoch_num = max_epoch_num
        self._checker = _checker()
        self._save_checkpoint = save_checkpoint and self._checker.valid()
        self._inter = (checkpoint_inter
                       if checkpoint_inter is not None
                       else self._checker.save_checkpoint_inter
                       if self._checker.valid() else 0)
        self._last_ckpt_time = time.time()
        self._exe_statuses: Dict[str, ExeTrainStatus] = {}
        self._start_epoch = 0
        self._epoch_no = -1
        self._restore_dir = None  # newest checkpoint's obj_0 dir
        if self._save_checkpoint:
            self._fs = self._checker.make_fs()
            self._saver = CheckpointSaver(self._fs)
            self._path = self._checker.get_job_checkpoint_path(name)
            # load_checkpoint verifies integrity and may fall back to an
            # earlier number than the newest dir — trust ITS return value
            no = self._saver.load_checkpoint(self._path, [self])
            if no is not None:
                self._start_epoch = self._epoch_no + 1
                # statuses restore lazily at _attach (the programs don't
                # exist yet); the saver reports the exact (absolute) local
                # dir it verified and deserialized from — on a remote FS
                # that's the materialized cache copy, never the remote path
                self._restore_dir = os.path.join(
                    self._saver.last_restore_dir, "obj_0")

    @property
    def name(self):
        return self._name

    def get(self):
        """The resumable epoch iterator."""
        global g_train_epoch_range
        g_train_epoch_range = self
        try:
            for epoch in range(self._start_epoch, self._max_epoch_num):
                self._epoch_no = epoch
                yield epoch
                self._maybe_save(epoch)
        finally:
            g_train_epoch_range = None

    def _maybe_save(self, epoch, force=False):
        if not self._save_checkpoint:
            return
        now = time.time()
        if not force and (now - self._last_ckpt_time) < self._inter:
            return
        # serialize() writes the attached ExeTrainStatus blobs too
        self._saver.save_checkpoint(self._path, [self],
                                    trainer_id=self._checker.trainer_id)
        self._last_ckpt_time = now

    def save_checkpoint(self):
        self._maybe_save(self._epoch_no, force=True)

    # -- SerializableBase (epoch-range metadata) ----------------------------
    def serialize(self, path):
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "range.json"), "w") as f:
            json.dump({"name": self._name, "epoch_no": self._epoch_no,
                       "max_epoch_num": self._max_epoch_num}, f)
        for s in self._exe_statuses.values():
            s.serialize(path)

    def deserialize(self, path):
        with open(os.path.join(path, "range.json")) as f:
            d = json.load(f)
        self._epoch_no = d["epoch_no"]

    def _attach(self, exe, program):
        # stable across restarts (id(exe) is not): keyed by program
        key = f"exe_{program.fingerprint()[:12]}"
        if key not in self._exe_statuses:
            st = ExeTrainStatus(exe, program, key)
            self._exe_statuses[key] = st
            if self._restore_dir is not None:
                # resume: overwrite freshly initialized persistables with
                # the checkpointed weights
                st.deserialize(self._restore_dir)


def train_epoch_range(max_epoch_num, save_checkpoint_inter=None):
    """The reference's train_epoch_range — resumes after restart."""
    r = TrainEpochRange(max_epoch_num, "train_epoch_range",
                        checkpoint_inter=save_checkpoint_inter)
    yield from r.get()


def _get_train_epoch_range():
    return g_train_epoch_range


def _auto_checkpoint(exe, program):
    """Executor.run hook: attach the running
    (exe, program) to the active epoch range so its persistables are part
    of the checkpoint."""
    r = _get_train_epoch_range()
    if r is None or not _checker().valid():
        return
    from ...core.program import Program
    if isinstance(program, Program):
        r._attach(exe, program)
