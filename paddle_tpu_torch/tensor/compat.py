"""paddle.tensor 2.0-alpha top-level compatibility functions (dual-mode; counterpart of
paddle_tpu/tensor/compat.py, the same names and ops, dispatched
through tensor/_dispatch.py)."""
from __future__ import annotations

from . import math as _math
from . import creation as _creation
from ._dispatch import dispatch

__all__ = ["einsum", "addcmul", "has_inf", "has_nan",
           "elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_mod", "elementwise_pow",
           "elementwise_floordiv", "elementwise_sum", "elementwise_max",
           "elementwise_min",
           "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
           "reduce_prod", "reduce_all", "reduce_any",
           "fill_constant", "create_parameter", "create_global_var",
           "crop_tensor", "get_tensor_from_selected_rows"]


def einsum(equation, *operands):
    """paddle.einsum over the named einsum op (ops/kernels/math.py), so
    both modes AND to_static capture work through one path."""
    return dispatch("einsum", {"Operands": list(operands)},
                    {"equation": equation})


def addcmul(input, tensor1, tensor2, value=1.0, name=None):
    """input + value * tensor1 * tensor2 (reference tensor/math.py
    addcmul)."""
    prod = _math.multiply(tensor1, tensor2)
    if value != 1.0:
        prod = _math.scale(prod, scale=value)
    return _math.add(input, prod)


def has_inf(x):
    return _math.any(_math.isinf(x))


def has_nan(x):
    return _math.any(_math.isnan(x))


# -- fluid spellings over the 2.0 functional surface ------------------------
def _ew_compat(op_type):
    def f(x, y, axis=-1, name=None):
        from ._dispatch import wrap_data
        y = wrap_data(y, like=x)
        x = wrap_data(x, like=y)
        return dispatch(op_type, {"X": x, "Y": y}, {"axis": axis})

    f.__name__ = op_type
    f.__doc__ = (f"fluid {op_type}(x, y, axis=-1): broadcasts y against "
                 f"x starting at `axis` like the reference layer.")
    return f


elementwise_add = _ew_compat("elementwise_add")
elementwise_sub = _ew_compat("elementwise_sub")
elementwise_mul = _ew_compat("elementwise_mul")
elementwise_div = _ew_compat("elementwise_div")
elementwise_mod = _ew_compat("elementwise_mod")
elementwise_pow = _ew_compat("elementwise_pow")
elementwise_floordiv = _ew_compat("elementwise_floordiv")
elementwise_max = _ew_compat("elementwise_max")
elementwise_min = _ew_compat("elementwise_min")


def elementwise_sum(inputs, name=None):
    out = inputs[0]
    for t in inputs[1:]:
        out = _math.add(out, t)
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _math.sum(input, axis=dim, keepdim=keep_dim)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _math.mean(input, axis=dim, keepdim=keep_dim)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _math.max(input, axis=dim, keepdim=keep_dim)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _math.min(input, axis=dim, keepdim=keep_dim)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _math.prod(input, axis=dim, keepdim=keep_dim)


def reduce_all(input, dim=None, keep_dim=False, name=None):
    return _math.all(input, axis=dim, keepdim=keep_dim)


def reduce_any(input, dim=None, keep_dim=False, name=None):
    return _math.any(input, axis=dim, keepdim=keep_dim)


def fill_constant(shape, dtype, value, force_cpu=False, out=None,
                  name=None):
    """Dual-mode fill: eager -> full; static -> the fill_constant
    layer.  `out` is honored in BOTH modes (eager writes the result
    into the given tensor, the fluid in-place idiom)."""
    from ..dygraph.base import in_dygraph_mode
    if in_dygraph_mode():
        result = _creation.full(shape, value, dtype=dtype)
        if out is not None:
            return _creation._set_value(out, result)
        return result
    from ..static import layers
    return layers.fill_constant(shape, dtype, value, force_cpu=force_cpu,
                                out=out, name=name)


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """Static-graph parameter creation (fluid layers.create_parameter):
    declares a persistable Parameter + its startup initializer."""
    from ..static.layer_helper import LayerHelper
    from ..static.initializer import Constant, Xavier
    helper = LayerHelper(name or "create_parameter")
    init = default_initializer or (Constant(0.0) if is_bias else Xavier())
    return helper.create_parameter(
        attr, shape, dtype, is_bias=is_bias, default_initializer=init)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    from ..static import layers
    return layers.create_global_var(shape, value, dtype,
                                    persistable=persistable, name=name)


def crop_tensor(x, shape=None, offsets=None, name=None):
    from ..static import layers
    return layers.crop_tensor(x, shape=shape, offsets=offsets, name=name)


def get_tensor_from_selected_rows(x, name=None):
    from ..static import layers
    return layers.get_tensor_from_selected_rows(x)
