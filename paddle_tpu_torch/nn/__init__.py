"""paddle_tpu_torch.nn — the paddle-2.0 neural-net API, as far as the GPT
`/generate` slice and the dygraph BERT training slice run it.

Counterpart of paddle_tpu/nn/: `Layer`, `Sequential`, `LayerList`,
`ParameterList` (dygraph/layers.py), the functional forms
(functional.py), the common layers (layer/common.py: Linear,
Embedding, Dropout, Flatten, Pad2D, Upsample*, PixelShuffle, Bilinear,
...), the convolutions (layer/conv.py: Conv1D / 2D / 3D and the
transposed ones), the pools (layer/pooling.py), the norms
(layer/norm.py: BatchNorm*, SyncBatchNorm, LayerNorm, GroupNorm,
InstanceNorm*, LocalResponseNorm, SpectralNorm), the activations
(layer/activation.py), the losses (layer/loss.py), the transformer
(layer/transformer.py: MultiHeadAttention, the encoder and decoder,
Transformer, SwitchMoE), the 2.0 initializers (initializer.py) and, as
paddle 2.0 exports them here, the gradient clips `ClipGradByValue` /
`ByNorm` / `ByGlobalNorm`.  rnn and the other activation and loss layers
wait for ROADMAP.md Queue 1, The rest.
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
