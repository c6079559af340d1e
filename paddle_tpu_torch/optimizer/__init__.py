"""paddle_tpu_torch.optimizer — the lr schedulers (`lr_scheduler`, also as
`lr`).  The 2.0 dygraph optimizers (paddle_tpu/optimizer/optimizer.py)
wait for the dygraph tape (ROADMAP.md Queue 1 item 4); the static ones
are `paddle_tpu_torch.static.optimizer`."""
from . import lr_scheduler  # noqa: F401
from .lr_scheduler import LRScheduler  # noqa: F401
from . import lr_scheduler as lr  # noqa: F401  (paddle.optimizer.lr alias)
