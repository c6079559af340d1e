"""paddle_tpu_torch.dygraph — imperative (eager) mode.

Counterpart of paddle_tpu/dygraph/: mode switches and grad guards
(base.py), `to_tensor` and the tensor-method functions (tensor.py), the
tracer's bookkeeping (tracer.py: the eager draw key and the AMP cast
hook), the autograd engine on torch autograd (engine.py) and the `Layer`
module system (layers.py).  Eager tensors are `torch.Tensor`s.
"""
from .base import (  # noqa: F401
    enabled, guard, no_grad, enable_grad, set_grad_enabled,
    is_grad_enabled, in_dygraph_mode, in_dynamic_mode, enable_static,
    disable_static, current_place,
)
from .tensor import (  # noqa: F401
    to_tensor, backward, gradient, clear_grad, clear_gradient, astype,
)
from .engine import grad, run_backward, register_tensor_hook  # noqa: F401
from .layers import (  # noqa: F401
    Layer, Sequential, LayerList, ParameterList,
)
