"""paddle_tpu_torch.reader — the feed prefetcher (prefetcher.py) that
`Executor.run_prefetched` drives.  The rest of paddle_tpu/reader/ waits
for ROADMAP.md Queue 1, The rest."""
from .prefetcher import Prefetcher, place_feed  # noqa: F401
