"""paddle_tpu_torch.optimizer — the 2.0 dygraph optimizers (optimizer.py:
SGD, Momentum, Adam, AdamW, Lamb; Adamax, Adagrad, Adadelta and RMSProp
raise), the lr schedulers (`lr_scheduler`, also as `lr`) and, as
paddle_tpu/optimizer/__init__.py:11-24 exports them, the gradient clips
`ClipGradByValue` / `ByNorm` / `ByGlobalNorm` (the static clips, which
also apply to dygraph gradients).  The static optimizers are
`paddle_tpu_torch.static.optimizer`."""
from .optimizer import (  # noqa: F401
    Optimizer, SGD, Momentum, Adam, AdamW, Adamax, Adagrad, Adadelta,
    RMSProp, Lamb,
)
from . import lr_scheduler  # noqa: F401
from .lr_scheduler import LRScheduler  # noqa: F401
from . import lr_scheduler as lr  # noqa: F401  (paddle.optimizer.lr alias)
from ..static.optimizer import (  # noqa: F401
    GradientClipByValue as ClipGradByValue,
    GradientClipByNorm as ClipGradByNorm,
    GradientClipByGlobalNorm as ClipGradByGlobalNorm,
    L1Decay, L2Decay,
)
