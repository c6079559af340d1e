"""paddle_tpu_torch.hapi — the high-level Model API (counterpart of
paddle_tpu/hapi/): `Model` (prepare, fit / evaluate / predict, the
single-batch ops, save / load, summary), `Input`, `summary`, the
callbacks (callbacks.py) and the progress bar (progressbar.py)."""
from .model import Input, Model, summary  # noqa: F401
from . import callbacks  # noqa: F401
from .callbacks import (  # noqa: F401
    Callback, CallbackList, ProgBarLogger, ModelCheckpoint, EarlyStopping,
    LRSchedulerCallback, config_callbacks,
)
