"""paddle_tpu_torch.tensor — the paddle-2.0 tensor functions the dygraph
training slice calls (counterpart of paddle_tpu/tensor/): `matmul`
(linalg.py) and the elementwise, scale and reduction functions
(math.py).  Each takes torch tensors, applies the AMP cast of the op the
JAX package traces for it (dygraph.tracer.amp_inputs) and runs torch
ops.  The rest of paddle_tpu/tensor waits for ROADMAP Queue 1 item 8."""
from .linalg import matmul  # noqa: F401
from .math import (  # noqa: F401
    add, subtract, multiply, divide, scale, mean, sum,
)

__all__ = ["matmul", "add", "subtract", "multiply", "divide", "scale",
           "mean", "sum"]
