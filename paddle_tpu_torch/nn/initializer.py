"""paddle.nn.initializer — the initializers the ported layers default to
(counterpart of paddle_tpu/nn/initializer.py): Constant (biases,
LayerNorm's scale), Normal (Embedding) and Xavier-uniform (Linear).  They
are the static initializers of paddle_tpu_torch/static/initializer.py; a
dygraph layer runs their op eagerly
(dygraph.layers.materialize_initializer).  The other 2.0 names wait for
ROADMAP.md Queue 1, The rest."""
from ..static.initializer import (  # noqa: F401
    Constant, Normal, Xavier, XavierInitializer,
)

__all__ = ["Constant", "Normal", "Xavier", "XavierInitializer"]
