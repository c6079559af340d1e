"""paddle_tpu_torch.nn — the paddle-2.0 neural-net API, as far as the GPT
`/generate` slice and the dygraph BERT training slice run it.

Counterpart of paddle_tpu/nn/: `Layer`, `Sequential`, `LayerList`,
`ParameterList` (dygraph/layers.py), the functional forms
(functional.py), `Identity`, `Linear`, `Embedding`, `Dropout`
(layer/common.py), `Conv2D` (layer/conv.py), `MaxPool2D`, `AvgPool2D`,
`AdaptiveAvgPool2D` (layer/pooling.py), `BatchNorm`, `BatchNorm2D`,
`LayerNorm` (layer/norm.py), `ReLU`, `Tanh`, `GELU`, `Softmax`,
`LogSoftmax` (layer/activation.py), `CrossEntropyLoss`, `MSELoss`
(layer/loss.py), `MultiHeadAttention`, `TransformerEncoderLayer`,
`TransformerEncoder`, `SwitchMoE` (layer/transformer.py), the default
initializers
(initializer.py) and, as paddle 2.0 exports them here, the gradient clips
`ClipGradByValue` / `ByNorm` / `ByGlobalNorm`.  The other layer families
(the other convolutions, pools and norms, rnn, the transformer decoder,
...) wait for ROADMAP.md Queue 1, The rest.
"""
from ..dygraph.layers import (  # noqa: F401
    Layer, Sequential, LayerList, ParameterList,
)
from ..dygraph.base import no_grad  # noqa: F401
from ..static.optimizer import (  # noqa: F401
    GradientClipByValue as ClipGradByValue,
    GradientClipByNorm as ClipGradByNorm,
    GradientClipByGlobalNorm as ClipGradByGlobalNorm,
)
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .layer import (  # noqa: F401
    activation, common, conv, loss, norm, pooling, transformer,
)
from .layer.activation import *  # noqa: F401,F403
from .layer.common import *  # noqa: F401,F403
from .layer.conv import *  # noqa: F401,F403
from .layer.loss import *  # noqa: F401,F403
from .layer.norm import *  # noqa: F401,F403
from .layer.pooling import *  # noqa: F401,F403
from .layer.transformer import *  # noqa: F401,F403
