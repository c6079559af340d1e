"""paddle_tpu_torch.distributed.fleet.utils: the filesystem clients
(fs.py).  fleet_wrapper.py belongs to the parameter-server tier and
waits for it (ROADMAP.md Queue 1, Distribution)."""
from .fs import LocalFS, HDFSClient, FS  # noqa: F401
