"""Op recording for `jit.to_static`: the functional ops' `dispatch` and
the tensor-operator mode.

Counterpart of paddle_tpu/tensor/_dispatch.py.  There one `dispatch`
serves eager (trace_op through the kernel registry) and static mode.  The
port's eager ops are plain torch ops and record nothing; while a
`to_static` recorder is active (`dygraph.tracer.recording()`):

  * each functional op calls `dispatch(op_type, ins, attrs, outs)` with
    the op the JAX package dispatches for it: `dygraph.tracer.trace_op`
    runs the port registry's kernel and records the op;
  * `RecordingMode`, a torch function mode active around the traced
    function, records the tensor operators the JAX package's Tensor
    defines (`+ - * / ** % //`, `@`, unary `-`, `abs`, the comparisons,
    `sum` / `mean` / `max` / `min` / `prod`, `reshape`, `permute`,
    `flatten`, `clone`, `to(dtype)`) as the JAX Tensor's methods record
    them (a Python scalar operand becomes a 0-d constant of the tensor's
    dtype).  Reads that concretize a value at trace time (`bool(t)`,
    `float(t)`, `t.item()`, `t.shape`, ...) pass, as under the JAX
    trace.  A torch function with no tensor argument (a factory) passes:
    its result is captured as a constant where an op reads it.  Every
    other torch operation on a tensor raises (`tracer.refuse`), naming
    it, rather than record wrongly (indexing among them, as the JAX
    package's `trace_jax` raises for it).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from ..core.dtype import dtype_name
from ..dygraph import tracer as _tracer

__all__ = ["dispatch", "RecordingMode", "OUT"]

OUT = ("Out",)


def dispatch(op_type, ins, attrs=None, outs=OUT, name=None):
    """Run and record one op (while a recorder is active)."""
    return _tracer.trace_op(op_type, ins, attrs or {}, list(outs))


def _const(like, value):
    """A Python scalar operand as a 0-d tensor of `like`'s dtype (the JAX
    Tensor's `jnp.asarray(other, dtype=self.dtype)`)."""
    _tracer.eager_name()
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _op(type_, x, other=None, reverse=False, **attrs):
    ins = {"X": x}
    if other is not None:
        if not isinstance(other, torch.Tensor):
            other = _const(x, other)
        ins = {"X": other, "Y": x} if reverse else {"X": x, "Y": other}
    return dispatch(type_, ins, attrs)


def _cmp(type_):
    def f(x, other):
        if not isinstance(other, torch.Tensor):
            other = _const(x, other)
        return dispatch(type_, {"X": x, "Y": other})
    return f


def _binary(type_, reverse=False):
    def f(x, other, *a, **k):
        if a or k:
            _tracer.refuse(f"{type_} with extra arguments")
        return _op(type_, x, other, reverse=reverse)
    return f


def _axis_keepdim(args, kwargs):
    axis = kwargs.get("axis", kwargs.get("dim"))
    if axis is None and args:
        axis = args[0]
    keep = kwargs.get("keepdim", args[1] if len(args) > 1 else False)
    return axis, bool(keep)


def _reduce(type_):
    def f(x, *args, **kwargs):
        if kwargs.get("dtype") is not None:
            _tracer.refuse(f"{type_} with a dtype")
        axis, keep = _axis_keepdim(args, kwargs)
        attrs = {"keep_dim": keep}
        if axis is None:
            attrs["reduce_all"] = True
            attrs["dim"] = [0]
        else:
            attrs["dim"] = [axis] if isinstance(axis, int) else list(axis)
        return dispatch(type_, {"X": x}, attrs)
    return f


def _shape_arg(args):
    if len(args) == 1 and isinstance(args[0], (list, tuple, torch.Size)):
        return list(args[0])
    return list(args)


def _reshape(x, *args, **kwargs):
    shape = _shape_arg(args) if args else list(kwargs["shape"])
    return dispatch("reshape2", {"X": x}, {"shape": shape})


def _permute(x, *args, **kwargs):
    perm = _shape_arg(args) if args else list(kwargs["dims"])
    return dispatch("transpose2", {"X": x}, {"axis": perm})


def _flatten(x, start_dim=0, end_dim=-1):
    shape = list(x.shape)
    n = len(shape)
    new = shape[:start_dim % n] + [-1] + shape[end_dim % n + 1:]
    return _reshape(x, new)


def _to(x, *args, **kwargs):
    dtype = kwargs.get("dtype")
    for a in args:
        if isinstance(a, torch.dtype):
            dtype = a
    if dtype is None:
        return None  # a move between devices: not an op
    return dispatch("cast", {"X": x}, {"out_dtype": dtype_name(dtype)})


def _cast_to(dtype):
    def f(x, *a, **k):
        return dispatch("cast", {"X": x}, {"out_dtype": dtype_name(dtype)})
    return f


def _neg(x):
    return dispatch("scale", {"X": x}, {"scale": -1.0, "bias": 0.0})


def _eq(type_):
    cmp = _cmp(type_)

    def f(x, other):
        if isinstance(other, (torch.Tensor, int, float, np.ndarray)):
            return cmp(x, other)
        return NotImplemented
    return f


# torch function name -> recorder (first argument the tensor)
_SUGAR = {
    "add": _binary("elementwise_add"),
    "__add__": _binary("elementwise_add"),
    "__radd__": _binary("elementwise_add"),
    "sub": _binary("elementwise_sub"),
    "__sub__": _binary("elementwise_sub"),
    "__rsub__": _binary("elementwise_sub", reverse=True),
    "mul": _binary("elementwise_mul"),
    "__mul__": _binary("elementwise_mul"),
    "__rmul__": _binary("elementwise_mul"),
    "div": _binary("elementwise_div"),
    "__truediv__": _binary("elementwise_div"),
    "__rdiv__": _binary("elementwise_div", reverse=True),
    "__rtruediv__": _binary("elementwise_div", reverse=True),
    "pow": _binary("elementwise_pow"),
    "__pow__": _binary("elementwise_pow"),
    "remainder": _binary("elementwise_mod"),
    "__mod__": _binary("elementwise_mod"),
    "__floordiv__": _binary("elementwise_floordiv"),
    "floor_divide": _binary("elementwise_floordiv"),
    "matmul": lambda x, y: dispatch("matmul", {"X": x, "Y": y}),
    "__matmul__": lambda x, y: dispatch("matmul", {"X": x, "Y": y}),
    "neg": _neg,
    "__neg__": _neg,
    "abs": lambda x: _op("abs", x),
    "__abs__": lambda x: _op("abs", x),
    "lt": _cmp("less_than"),
    "__lt__": _cmp("less_than"),
    "le": _cmp("less_equal"),
    "__le__": _cmp("less_equal"),
    "gt": _cmp("greater_than"),
    "__gt__": _cmp("greater_than"),
    "ge": _cmp("greater_equal"),
    "__ge__": _cmp("greater_equal"),
    "eq": _eq("equal"),
    "__eq__": _eq("equal"),
    "ne": _eq("not_equal"),
    "__ne__": _eq("not_equal"),
    "sum": _reduce("reduce_sum"),
    "mean": _reduce("reduce_mean"),
    "amax": _reduce("reduce_max"),
    "amin": _reduce("reduce_min"),
    "max": _reduce("reduce_max"),
    "min": _reduce("reduce_min"),
    "prod": _reduce("reduce_prod"),
    "reshape": _reshape,
    "view": _reshape,
    "permute": _permute,
    "flatten": _flatten,
    "clone": lambda x, *a, **k: dispatch("assign", {"X": x}),
    "to": _to,
    "float": _cast_to(torch.float32),
    "double": _cast_to(torch.float64),
    "long": _cast_to(torch.int64),
    "int": _cast_to(torch.int32),
    "bool": _cast_to(torch.bool),
}

# operations that read or describe a tensor without computing a new one
_PASS = frozenset((
    "__get__", "__set__", "__bool__", "__float__", "__int__", "__index__",
    "__len__", "__repr__", "__str__", "__format__", "__hash__", "item",
    "tolist", "numpy", "dim", "size", "numel", "detach", "detach_",
    "requires_grad_", "register_hook", "is_floating_point", "is_complex",
    "data_ptr", "element_size", "stride", "storage_offset", "contiguous",
    "is_contiguous", "__reduce_ex__", "__deepcopy__", "__array__",
    "__setstate__", "retain_grad", "cpu", "cuda", "backward",
    "__contains__", "type", "get_device", "nelement", "ndimension",
    "__dlpack__", "__dlpack_device__", "untyped_storage", "_is_view",
))


def _has_tensor(args, kwargs) -> bool:
    def t(v):
        return isinstance(v, torch.Tensor) or (
            isinstance(v, (list, tuple)) and any(
                isinstance(x, torch.Tensor) for x in v))
    return any(t(a) for a in args) or any(t(v) for v in kwargs.values())


class RecordingMode(TorchFunctionMode):
    """The tensor operators of a traced function, recorded (module
    docstring)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rec = _tracer._PROGRAM_RECORDER
        if rec is None or rec.quiet:
            return func(*args, **kwargs)
        name = getattr(func, "__name__", "")
        if name in _PASS or not _has_tensor(args, kwargs):
            return func(*args, **kwargs)
        handler = _SUGAR.get(name)
        if handler is not None and args and \
                isinstance(args[0], torch.Tensor):
            out = handler(*args, **kwargs)
            if out is None:  # `to(device)`: no op
                return func(*args, **kwargs)
            return out
        if rec.replaying:  # an eager loop replay reads what it likes
            return func(*args, **kwargs)
        _tracer.refuse("getitem" if name == "__getitem__" else name)
