"""paddle_tpu_torch.nn — the paddle-2.0 neural-net API, as far as the GPT
`/generate` slice runs it.

Counterpart of paddle_tpu/nn/: `Layer` / `LayerList` (dygraph/layers.py),
the functional forms the slice calls (functional.py), `Linear`,
`Embedding`, `Dropout` (layer/common.py), `LayerNorm` (layer/norm.py),
`MultiHeadAttention` (layer/transformer.py) and the default initializers
(initializer.py).  The other layer families (conv, pooling, rnn, loss,
the transformer encoder/decoder classes, ...) wait for ROADMAP Queue 1
item 5.
"""
from ..dygraph.layers import Layer, LayerList  # noqa: F401
from ..dygraph.base import no_grad  # noqa: F401
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .layer import common, norm, transformer  # noqa: F401
from .layer.common import *  # noqa: F401,F403
from .layer.norm import *  # noqa: F401,F403
from .layer.transformer import *  # noqa: F401,F403
