"""paddle_tpu_torch.jit: dygraph-to-static translation, save and load.

Counterpart of paddle_tpu/jit/__init__.py (the reference's
fluid/dygraph/jit.py `declarative` / `to_static`, `jit.save`,
`jit.load`, `TranslatedLayer`, `TracedLayer`, and
dygraph_to_static/program_translator.py `ProgramTranslator`).

TRACE, DON'T TRANSPILE, as the JAX package: `to_static` records each op
into a Program while the eager forward runs, once per input signature
(shapes, dtypes and the Python arguments).  The recorder
(`_Recorder`, installed as `dygraph.tracer._PROGRAM_RECORDER`) gets the
JAX op's type, slots and attrs from each port functional op and from the
tensor operators (tensor/_dispatch.py `RecordingMode`), so the recorded
program is the JAX package's.  Tensor-dependent `if` / `while` / `for`
become `cond` / `while` ops through the AST transform of dy2static.py.

What differs: the JAX package runs a recorded program as ONE `jax.jit`
and bridges gradients to its tape with one `jax.vjp`.  The port replays
the recorded program through the executor's op loop
(`static.executor.run_block`) on the live parameters, under torch
autograd: each op's registry kernel runs as it is reached (the Hopper
kernels among them: the fused cross-entropy of a
`softmax_with_cross_entropy`), and `loss.backward()` reaches the
parameters through the kernels' own backward.  No CUDA graph of the
replayed step yet (ROADMAP.md Queue 1 item 1).  Buffer updates recorded
by `batch_norm` in training (the running statistics) are written back
to the live buffers after each replay, as the JAX package's `updates`.

`jit.save` writes the save_inference_model layout (`<path>.pdmodel`, the
JSON program, and `<path>.pdiparams`), which `jit.load`, the port's
Predictor and the JAX package all read; `jit.load` returns a
`TranslatedLayer` whose parameters train.
"""
from __future__ import annotations

import inspect
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.dtype import dtype_name, torch_dtype
from ..core.program import Program, unique_name
from ..dygraph import tracer as _tracer
from ..dygraph.layers import Layer

__all__ = ["to_static", "declarative", "save", "load", "TranslatedLayer",
           "ProgramTranslator", "InputSpec", "StaticFunction",
           "not_to_static", "TracedLayer", "set_code_level",
           "set_verbosity", "SaveLoadConfig"]


class InputSpec:
    """Shape/dtype spec for a traced input (paddle.static.InputSpec)."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name

    @staticmethod
    def from_tensor(t, name=None):
        return InputSpec(tuple(t.shape), dtype_name(t.dtype), name)

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype})"


# ---------------------------------------------------------------------------
# the op recorder
# ---------------------------------------------------------------------------
class _Recorder:
    """program_desc_tracer.cc analog: id(tensor) -> var name and an OpDesc
    append per recorded op.  `quiet` > 0 while the recorder's own torch
    ops run (dygraph.tracer.quiet)."""

    def __init__(self, program: Program, device=None):
        self.program = program
        self.block = program.global_block()
        self.names: Dict[int, str] = {}
        self.keepalive: List[torch.Tensor] = []   # id() stability
        self.params: Dict[str, torch.Tensor] = {}  # persistable captures
        self.updates: Dict[str, str] = {}  # buffer name -> new-value var
        self.quiet = 0
        self.replaying = 0  # > 0 while dy2static replays a loop eagerly
        self.device = device

    def name_of(self, t: torch.Tensor) -> str:
        key = id(t)
        if key in self.names:
            return self.names[key]
        # unseen tensor: a parameter or an eagerly created constant (a
        # buffer among them) — either way persistable state of the
        # program; captures land in block 0, visible from every block
        pname = getattr(t, "paddle_name", None)
        name = pname if pname is not None else unique_name("@captured")
        gb = self.program.global_block()
        stop = not t.requires_grad
        gb.create_var(name=name, shape=tuple(t.shape),
                      dtype=dtype_name(t.dtype), persistable=True,
                      stop_gradient=stop)
        if not stop:
            gb.vars[name].is_parameter = True
            gb.vars[name].trainable = True
        self.names[key] = name
        self.keepalive.append(t)
        self.params[name] = t
        return name

    def register(self, t, name: str):
        self.names[id(t)] = name
        self.keepalive.append(t)

    def record(self, op_type, ins, attrs, out_slot_tensors):
        in_names = {}
        for slot, v in ins.items():
            if v is None:
                continue
            if isinstance(v, (list, tuple)):
                in_names[slot] = [self.name_of(t) for t in v
                                  if isinstance(t, torch.Tensor)]
            elif isinstance(v, torch.Tensor):
                in_names[slot] = [self.name_of(v)]
        out_names = {}
        for slot, ts in out_slot_tensors.items():
            names = []
            for t in ts:
                # the JAX package's output Tensor takes an eager name,
                # and its var unique_name(that name)
                name = unique_name(_tracer.eager_name())
                shape = getattr(t, "shape", None)
                self.block.create_var(
                    name=name,
                    shape=tuple(shape) if shape is not None else None,
                    dtype=dtype_name(t.dtype)
                    if isinstance(t, torch.Tensor) else None)
                self.register(t, name)
                names.append(name)
            out_names[slot] = names
        a = {k: v for k, v in (attrs or {}).items() if k != "op_uid"}
        self.block.append_op(op_type, in_names, out_names, a)

    def update(self, buffer, new):
        """`buffer` (a captured tensor) takes the value of the recorded
        `new` after each replay (batch_norm's running statistics)."""
        self.updates[self.name_of(buffer)] = self.names[id(new)]


# ---------------------------------------------------------------------------
# concrete (per-signature) recorded program
# ---------------------------------------------------------------------------
class ConcreteProgram:
    """One traced signature: Program + feed/fetch names + captured state
    (program_translator.py ConcreteProgram).  `updates` maps a captured
    buffer name -> the program var holding its new value."""

    def __init__(self, program, feed_names, fetch_names, params,
                 out_struct, updates=None):
        self.program = program
        self.feed_names = feed_names
        self.fetch_names = fetch_names
        self.params = params            # name -> tensor (live)
        self.out_struct = out_struct    # "single" | "tuple" | "list"
        self.updates = dict(updates or {})

    def run(self, inputs, training: bool):
        """Replay the program on `inputs` (one tensor per feed) under
        torch autograd; the fetched tensors.  Recorded buffer updates are
        written to the live buffers."""
        from ..core.generator import global_seed
        from ..ops.registry import OpContext
        from ..static.executor import run_block
        env: Dict[str, Any] = dict(self.params)
        env.update(zip(self.feed_names, inputs))
        device = next((t.device for t in list(inputs) +
                       list(self.params.values())
                       if isinstance(t, torch.Tensor)), None)
        ctx = OpContext(seed=global_seed(), is_test=not training,
                        device=device)
        run_block(self.program, 0, env, ctx)
        missing = [n for n in self.fetch_names if n not in env]
        if missing:
            raise KeyError(f"to_static: fetches {missing} not produced")
        with torch.no_grad():
            for pname, vname in self.updates.items():
                self.params[pname].copy_(env[vname])
        return [env[n] for n in self.fetch_names]


def _pack(outs, struct):
    if struct == "single":
        return outs[0]
    return tuple(outs) if struct == "tuple" else list(outs)


class StaticFunction:
    """Callable produced by @to_static (program_translator.py
    StaticFunction): records once per input signature, then replays the
    recorded program (module docstring)."""

    def __init__(self, fn, input_spec=None, layer: Optional[Layer] = None):
        self._fn = self._maybe_ast_transform(fn) if fn is not None else None
        self._input_spec = input_spec
        self._layer = layer
        self._cache: Dict[Tuple, ConcreteProgram] = {}

    @staticmethod
    def _maybe_ast_transform(fn):
        """Rewrite tensor-dependent control flow into recorded cond /
        while ops (dy2static.py); anything the transform cannot express
        falls back to plain tracing."""
        from .dy2static import ast_transform
        target = fn.__func__ if inspect.ismethod(fn) else fn
        try:
            new = ast_transform(target)
        except Exception:
            # any transform failure (unsupported construct, unparseable
            # lambda source, empty closure cell, ...) falls back to plain
            # tracing — to_static must never be stricter than the tracer
            return fn
        if inspect.ismethod(fn):
            import types as _types
            return _types.MethodType(new, fn.__self__)
        return new

    @property
    def __name__(self):
        return getattr(self._fn, "__name__", "static_fn")

    def _sig(self, args):
        key = []
        for a in args:
            if isinstance(a, torch.Tensor):
                key.append((tuple(a.shape), a.dtype))
            else:
                key.append(("py", repr(a)))
        return tuple(key)

    def _to_tensors(self, args):
        from ..dygraph.tensor import to_tensor
        out = []
        for a in args:
            if isinstance(a, (np.ndarray, list, float, int)) and \
                    not isinstance(a, bool):
                out.append(to_tensor(np.asarray(a)))
            else:
                out.append(a)
        return out

    def concrete_program(self, *args) -> ConcreteProgram:
        args = self._to_tensors(args)
        key = self._sig(args)
        if key not in self._cache:
            self._cache[key] = self._trace(args)
        return self._cache[key]

    def _trace(self, args) -> ConcreteProgram:
        from ..tensor._dispatch import RecordingMode
        program = Program()
        device = next((a.device for a in args
                       if isinstance(a, torch.Tensor)), None)
        rec = _Recorder(program, device)
        feed_names = []
        for i, a in enumerate(args):
            if not isinstance(a, torch.Tensor):
                continue
            name = unique_name(f"feed_{i}")
            program.global_block().create_var(
                name=name, shape=tuple(a.shape), dtype=dtype_name(a.dtype),
                is_data=True)
            rec.register(a, name)
            feed_names.append(name)

        prev = _tracer._PROGRAM_RECORDER
        _tracer._PROGRAM_RECORDER = rec
        try:
            with torch.enable_grad(), RecordingMode():
                result = self._fn(*args)
        finally:
            _tracer._PROGRAM_RECORDER = prev

        if isinstance(result, (tuple, list)):
            struct = "tuple" if isinstance(result, tuple) else "list"
            outs = list(result)
        else:
            struct = "single"
            outs = [result]
        fetch_names = []
        for t in outs:
            if not isinstance(t, torch.Tensor) or id(t) not in rec.names:
                raise TypeError(
                    "to_static: traced function must return Tensors "
                    "produced by the traced ops, got "
                    f"{type(t).__name__}")
            nm = rec.names[id(t)]
            if not program.global_block().has_var(nm):
                raise TypeError(
                    f"to_static: returned tensor {nm!r} was produced "
                    "inside a tensor-dependent loop body and is not "
                    "loop-carried — assign it to a variable before the "
                    "loop (loop-carried state) or accumulate through "
                    "static.layers.create_array/array_write")
            fetch_names.append(nm)
        return ConcreteProgram(program, feed_names, fetch_names,
                               dict(rec.params), struct, rec.updates)

    def __call__(self, *args, **kwargs):
        if kwargs:
            raise TypeError("to_static functions take positional Tensor "
                            "arguments only (trace-time contract)")
        args = self._to_tensors(args)
        cp = self.concrete_program(*args)
        training = self._layer.training if self._layer is not None \
            else True
        outs = cp.run([a for a in args if isinstance(a, torch.Tensor)],
                      training)
        return _pack(outs, cp.out_struct)


def to_static(function=None, input_spec=None, build_strategy=None,
              **kwargs):
    """@paddle.jit.to_static (dygraph/jit.py declarative): wraps a
    function or a Layer's forward; tracing happens at the first call per
    input signature."""
    def wrap(fn):
        if isinstance(fn, Layer):
            layer = fn
            orig_forward = layer.forward  # bind BEFORE replacing
            sf = StaticFunction(orig_forward, input_spec, layer=layer)
            layer.forward = sf
            return layer
        return StaticFunction(fn, input_spec)
    if function is not None:
        return wrap(function)
    return wrap


declarative = to_static


def not_to_static(fn):
    """Marker passthrough (reference jit.not_to_static)."""
    return fn


class ProgramTranslator:
    """program_translator.py ProgramTranslator singleton (tracing is
    always available here)."""

    _instance = None
    enable_to_static = True

    @classmethod
    def get_instance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def enable(self, enable_to_static: bool):
        ProgramTranslator.enable_to_static = bool(enable_to_static)


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------
def save(layer, path, input_spec=None, **configs):
    """jit.save (dygraph/jit.py:230): trace the layer and persist it in
    the save_inference_model layout (<path>.pdmodel program JSON +
    <path>.pdiparams), which the Predictor and jit.load read."""
    if isinstance(layer, Layer):
        fwd = layer.forward
        sf = fwd if isinstance(fwd, StaticFunction) else StaticFunction(
            lambda *a: layer.forward(*a), input_spec, layer=layer)
    elif isinstance(layer, StaticFunction):
        sf = layer
    else:
        raise TypeError("jit.save expects a Layer or a @to_static "
                        f"function, got {type(layer).__name__}")
    if input_spec is None:
        raise ValueError("jit.save needs input_spec=[InputSpec(...)] to "
                         "know the traced signature")
    from ..dygraph.tensor import to_tensor
    example = [to_tensor(torch.zeros([1 if s == -1 else s
                                      for s in spec.shape],
                                     dtype=torch_dtype(spec.dtype)))
               for spec in input_spec]
    cp = sf.concrete_program(*example)
    _save_concrete_program(cp, path)
    return cp


def _save_concrete_program(cp, path, feed_names=None, fetch_names=None):
    """ONE writer for the jit on-disk layout (<path>.pdmodel JSON program
    + <path>.pdiparams), shared by jit.save and
    TracedLayer.save_inference_model."""
    from ..core.place import CPUPlace
    from ..io.framework_io import save_inference_model
    from ..static.executor import Executor, Scope, scope_guard

    dirname = os.path.dirname(path) or "."
    basename = os.path.basename(path)
    os.makedirs(dirname, exist_ok=True)
    scope = Scope()
    for name, t in cp.params.items():
        scope.set(name, t.detach())
    with scope_guard(scope):
        save_inference_model(
            dirname, list(feed_names or cp.feed_names),
            [cp.program.global_block().var(n)
             for n in (fetch_names or cp.fetch_names)],
            Executor(CPUPlace()), main_program=cp.program,
            model_filename=basename + ".pdmodel",
            params_filename=basename + ".pdiparams")


class TranslatedLayer(Layer):
    """jit.load product (reference dygraph/io.py TranslatedLayer): a Layer
    whose forward replays the loaded program; its parameters are
    trainable torch parameters, so fine-tuning works."""

    def __init__(self, program, feed_names, fetch_names, params):
        super().__init__()
        live = {}
        for name, val in params.items():
            var = program.global_block().vars.get(name)
            trainable = bool(var is not None and var.is_parameter
                             and var.trainable)
            key = name.replace("/", "_").replace(".", "_")
            if trainable:
                p = torch.nn.Parameter(val.detach().clone(),
                                       requires_grad=True)
                p.paddle_name = name
                self.register_parameter(key, p)
            else:
                p = val.detach().clone()
                self.register_buffer(key, p)
            live[name] = p
        struct = "list" if len(fetch_names) > 1 else "single"
        self._cp = ConcreteProgram(program, list(feed_names),
                                   list(fetch_names), live, struct)

    def forward(self, *args):
        from ..dygraph.tensor import to_tensor
        args = [a if isinstance(a, torch.Tensor) else to_tensor(
            np.asarray(a)) for a in args]
        return _pack(self._cp.run(args, self.training), self._cp.out_struct)

    def program(self):
        return self._cp.program


def load(path, **configs):
    """jit.load (dygraph/jit.py:426): a TranslatedLayer from a jit.save /
    save_inference_model artifact, its parameters on the eager place."""
    from ..dygraph.base import current_place
    from ..io.framework_io import load_inference_model
    from ..static.executor import Executor, Scope, scope_guard

    dirname = os.path.dirname(path) or "."
    basename = os.path.basename(path)
    scope = Scope()
    with scope_guard(scope):
        program, feed_names, fetch_vars = load_inference_model(
            dirname, Executor(current_place()),
            model_filename=basename + ".pdmodel",
            params_filename=basename + ".pdiparams")
        params = {}
        for b in program.blocks:
            for v in b.vars.values():
                if v.persistable and scope.get(v.name) is not None:
                    params[v.name] = scope.get(v.name)
    fetch_names = [v.name if hasattr(v, "name") else str(v)
                   for v in fetch_vars]
    return TranslatedLayer(program, feed_names, fetch_names, params)


# ---------------------------------------------------------------------------
# TracedLayer (dygraph/jit.py:1218) and the dy2static logging knobs
# ---------------------------------------------------------------------------
_VERBOSITY = {"code_level": 0, "verbosity": 0}


def set_code_level(level=100):
    """jit.set_code_level: how much transformed code dy2static logs
    (a stored knob)."""
    _VERBOSITY["code_level"] = int(level)


def set_verbosity(level=0):
    """jit.set_verbosity: dy2static logging verbosity (a stored knob)."""
    _VERBOSITY["verbosity"] = int(level)


class TracedLayer:
    """A data-independent dygraph Layer as a static-graph callable, traced
    from one forward (reference dygraph/jit.py TracedLayer): create with
    TracedLayer.trace(layer, inputs), call it with tensors, persist with
    save_inference_model()."""

    def __init__(self, static_function, layer, example_inputs):
        self._sf = static_function
        self._layer = layer
        self._inputs = example_inputs

    @staticmethod
    def trace(layer, inputs):
        if not isinstance(layer, Layer):
            raise TypeError("TracedLayer.trace needs a dygraph Layer")
        from ..dygraph.tensor import to_tensor
        inputs = [i if isinstance(i, torch.Tensor) else to_tensor(i)
                  for i in inputs]
        sf = StaticFunction(layer.forward, layer=layer)
        out = sf(*inputs)
        return out, TracedLayer(sf, layer, inputs)

    def __call__(self, inputs):
        from ..dygraph.tensor import to_tensor
        inputs = [i if isinstance(i, torch.Tensor) else to_tensor(i)
                  for i in inputs]
        return self._sf(*inputs)

    def set_strategy(self, build_strategy=None, exec_strategy=None):
        """Accepted for parity; the traced program replays as recorded."""

    def save_inference_model(self, path, feed=None, fetch=None, **kw):
        """feed/fetch are INDEX lists selecting which traced inputs /
        outputs the saved model exposes."""
        cp = self._sf.concrete_program(*self._inputs)
        feed_names = list(cp.feed_names)
        fetch_names = list(cp.fetch_names)
        if feed is not None:
            feed_names = [feed_names[i] for i in feed]
        if fetch is not None:
            fetch_names = [fetch_names[i] for i in fetch]
        _save_concrete_program(cp, path, feed_names, fetch_names)


class SaveLoadConfig:
    """jit save/load options bag (reference fluid/dygraph/jit.py
    SaveLoadConfig), accepted for parity."""

    def __init__(self):
        self.output_spec = None
        self.model_filename = None
        self.params_filename = None
        self.separate_params = False
        self.keep_name_table = False
