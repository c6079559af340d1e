"""paddle_tpu_torch.nn.layer — the layer classes the GPT slice runs
(counterpart of paddle_tpu/nn/layer/)."""
from .common import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403
