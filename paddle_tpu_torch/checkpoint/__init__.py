"""paddle_tpu_torch.checkpoint — async atomic checkpointing + auto-resume.

Counterpart of paddle_tpu/checkpoint/.  The on-disk format (shards, the
manifest, the dtype tags, the CRCs) is the JAX package's, so a step
written by either package loads in the other, bf16 tensors included:

* ``CheckpointManager`` (manager.py) — async background persistence with
  a bounded in-flight budget, atomic temp-dir-then-rename commits, CRC
  manifests, keep-last-N / keep-every-M retention, ``latest_step()``
  discovery that skips truncated checkpoints, and SIGTERM/SIGINT final
  saves.
* atomic primitives (atomic.py) — ``atomic_write`` (write-temp-rename
  for single files, used by hapi ``Model.save`` and ``paddle.save``),
  ``commit_dir``, fsync helpers.

Integration points: ``Executor.enable_checkpointing`` /
``Executor.restore_from_checkpoint`` (static) and ``incubate.checkpoint.CheckpointSaver``
(fluid-parity surface re-based on the same atomic commit protocol).
"""
from .atomic import atomic_write, commit_dir, crc32_file, fsync_dir  # noqa: F401
from .manager import (  # noqa: F401
    Checkpoint, CheckpointError, CheckpointManager, FORMAT_VERSION,
)

__all__ = [
    "CheckpointManager", "Checkpoint", "CheckpointError", "FORMAT_VERSION",
    "atomic_write", "commit_dir", "crc32_file", "fsync_dir",
]
