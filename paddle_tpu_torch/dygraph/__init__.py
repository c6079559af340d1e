"""paddle_tpu_torch.dygraph — imperative (eager) mode.

Counterpart of paddle_tpu/dygraph/: mode switches and guards (base.py),
`to_tensor` (tensor.py) and the `Layer` module system (layers.py).  Eager
tensors are `torch.Tensor`s and autograd is torch's; the JAX package's own
`Tensor` wrapper, tape tracer and `engine.py` wait for the dygraph
training slice (ROADMAP Queue 1 item 5).
"""
from .base import enabled, guard, no_grad, current_place  # noqa: F401
from .tensor import to_tensor  # noqa: F401
from .layers import Layer, LayerList  # noqa: F401
