"""paddle_tpu_torch.nn.layer — the layer classes (counterpart of
paddle_tpu/nn/layer/; rnn waits for its family)."""
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .activation import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403
