"""Dual-mode op dispatch for the paddle-2.0 tensor functions, and op
recording for `jit.to_static`.

Counterpart of paddle_tpu/tensor/_dispatch.py.  One `dispatch` serves
every mode, resolved from the inputs as the JAX package resolves it
(`is_eager`): a torch tensor among them runs the op eagerly, a graph
`VarDesc` appends it to the current Program, and a function with no
tensor input (creation, random) follows `dygraph.base.in_dygraph_mode()`
(`enable_static` / `disable_static`).

  * static: the op is appended to `default_main_program().current_block()`
    with one new var an output slot (`out_counts` vars for a duplicable
    one), named `unique_name(name or "<op>.<slot>")` as in the JAX
    package; `Block.append_op` infers their shapes;
  * eager: `dygraph.tracer.trace_op` runs the port registry's kernel on
    the torch tensors, after the AMP cast of the op (torch autograd is
    the tape).  While a `to_static` recorder is active the same call
    also records the op.  A random op takes the next eager uid for its
    draw key (the port advances it on random ops only).

The functions the dygraph training slices ported first (`add`, `scale`,
`mean`, `matmul`, `flatten`, ...) keep their own eager path (AMP cast,
then torch ops) and call `dispatch` under a recorder or on `VarDesc`s.

`RecordingMode`, a torch function mode active around a traced function,
records the tensor operators the JAX package's Tensor defines (`+ - * /
** % //`, `@`, unary `-`, `abs`, the comparisons, `sum` / `mean` / `max`
/ `min` / `prod`, `reshape`, `permute`, `flatten`, `squeeze`,
`unsqueeze`, `clone`, `to(dtype)`) as the JAX Tensor's methods record
them (a Python scalar operand becomes a 0-d constant of the tensor's
dtype).  Reads that concretize a value at trace time (`bool(t)`,
`float(t)`, `t.item()`, `t.shape`, ...) pass, as under the JAX trace.  A
torch function with no tensor argument (a factory) passes: its result is
captured as a constant where an op reads it.  Every other torch
operation on a tensor raises (`tracer.refuse`), naming it, rather than
record wrongly (indexing among them, as the JAX package's `trace_jax`
raises for it).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from ..core.dtype import dtype_name
from ..core.program import VarDesc, default_main_program, unique_name
from ..dygraph import tracer as _tracer
from ..dygraph.base import current_place, in_dygraph_mode

__all__ = ["dispatch", "is_eager", "wrap_data", "RecordingMode", "OUT"]

OUT = ("Out",)

# ops that draw: each eager call takes the next eager uid
RANDOM_OPS = frozenset((
    "uniform_random", "gaussian_random", "truncated_gaussian_random",
    "randint", "randperm", "bernoulli", "multinomial", "sampling_id"))


def _contains(ins, klass) -> bool:
    for v in ins.values():
        if isinstance(v, klass):
            return True
        if isinstance(v, (list, tuple)) and any(
                isinstance(t, klass) for t in v):
            return True
    return False


def is_eager(ins) -> bool:
    """Mode resolution: explicit tensor types win over the global flag, so
    static Programs can be built from inside dygraph code and vice versa."""
    if _contains(ins, torch.Tensor):
        return True
    if _contains(ins, VarDesc):
        return False
    return in_dygraph_mode()


def wrap_data(x, like=None, dtype=None):
    """Coerce a python scalar / ndarray operand to the mode-matching type,
    matching `like`'s dtype so scalar operands don't upcast int/bf16
    tensors through numpy's float64/int64 defaults."""
    if isinstance(x, (torch.Tensor, VarDesc)) or x is None:
        return x
    if like is not None and isinstance(like, VarDesc):
        from ..static import layers
        return layers.assign(np.asarray(x, dtype=dtype or like.dtype))
    if _tracer._PROGRAM_RECORDER is not None:
        _tracer.eager_name()  # the JAX package's Tensor takes a name
    if dtype is None and isinstance(like, torch.Tensor):
        return torch.tensor(x, dtype=like.dtype, device=like.device)
    return torch.as_tensor(np.asarray(x, dtype=dtype),
                           device=current_place().torch_device())


def _static(op_type, ins, attrs, outs, name, out_counts):
    from ..ops.registry import get_op_info
    info = get_op_info(op_type)
    block = default_main_program().current_block()
    out_vars, results = {}, []
    for slot in outs:
        decl = None if info is None else next(
            (s for s in info.outputs if s.name == slot), None)
        dup = decl is not None and decl.duplicable
        vs = [block.create_var(
            name=unique_name(name or f"{op_type}.{slot.lower()}"))
            for _ in range((out_counts or {}).get(slot, 1) if dup else 1)]
        out_vars[slot] = vs if dup else vs[0]
        results.append(out_vars[slot])
    block.append_op(op_type,
                    inputs={k: v for k, v in ins.items() if v is not None},
                    outputs=out_vars, attrs=attrs)
    return results[0] if len(outs) == 1 else tuple(results)


def dispatch(op_type, ins, attrs=None, outs=OUT, name=None,
             out_counts=None):
    """Run (eager, recorded under a recorder) or append (static) one op;
    the output of each slot of `outs` (one slot: the output itself).
    out_counts: for duplicable output slots in STATIC mode, how many vars
    to create per slot (eager mode learns the count from the kernel)."""
    attrs = dict(attrs or {})
    if not is_eager(ins):
        return _static(op_type, ins, attrs, outs, name, out_counts)
    if op_type in RANDOM_OPS:
        from ..core.generator import next_eager_uid
        attrs.setdefault("op_uid", next_eager_uid())
    return _tracer.trace_op(op_type, ins, attrs, list(outs))


def _op(type_, x, other=None, reverse=False, **attrs):
    ins = {"X": x}
    if other is not None:
        if not isinstance(other, torch.Tensor):
            other = wrap_data(other, like=x)
        ins = {"X": other, "Y": x} if reverse else {"X": x, "Y": other}
    return dispatch(type_, ins, attrs)


def _cmp(type_):
    def f(x, other):
        if not isinstance(other, torch.Tensor):
            other = wrap_data(other, like=x)
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


def reduce_attrs(axis, keepdim):
    """The reduce ops' attrs (`dim`, `keep_dim`, `reduce_all`) for a
    paddle axis (None: every axis)."""
    attrs = {"keep_dim": bool(keepdim)}
    if axis is None:
        attrs["reduce_all"] = True
        attrs["dim"] = [0]
    else:
        attrs["dim"] = [axis] if np.isscalar(axis) else list(axis)
    return attrs


def _reduce(type_):
    def f(x, *args, **kwargs):
        if kwargs.get("dtype") is not None:
            _tracer.refuse(f"{type_} with a dtype")
        axis, keep = _axis_keepdim(args, kwargs)
        return dispatch(type_, {"X": x}, reduce_attrs(axis, keep))
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


def _axes_arg(args, kwargs, key):
    axis = args[0] if args else kwargs.get(key, kwargs.get("axis"))
    if axis is None:
        return []
    return [int(a) for a in axis] if isinstance(axis, (list, tuple)) \
        else [int(axis)]


def _squeeze(x, *args, **kwargs):
    return dispatch("squeeze2", {"X": x},
                    {"axes": _axes_arg(args, kwargs, "dim")})


def _unsqueeze(x, *args, **kwargs):
    return dispatch("unsqueeze2", {"X": x},
                    {"axes": _axes_arg(args, kwargs, "dim")})


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
    "squeeze": _squeeze,
    "unsqueeze": _unsqueeze,
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
