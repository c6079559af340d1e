"""paddle_tpu_torch.tensor — the paddle-2.0 tensor functions the dygraph
training slices call (counterpart of paddle_tpu/tensor/): `matmul`
(linalg.py), the elementwise, scale and reduction functions (math.py)
and `flatten` (manipulation.py).  Each takes torch tensors, applies the
AMP cast of the op the JAX package traces for it
(dygraph.tracer.amp_inputs) and runs torch ops.  The rest of
paddle_tpu/tensor waits for ROADMAP.md Queue 1, The rest."""
from .linalg import matmul  # noqa: F401
from .manipulation import flatten  # noqa: F401
from .math import (  # noqa: F401
    add, subtract, multiply, divide, scale, mean, sum,
)

__all__ = ["matmul", "flatten", "add", "subtract", "multiply", "divide",
           "scale", "mean", "sum"]
