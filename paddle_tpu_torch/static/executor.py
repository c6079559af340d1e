"""Executor: runs a Program's ops one by one, eagerly, on one device.

Counterpart of paddle_tpu/static/executor.py (`Scope`, `scope_guard`,
`global_scope`, `Executor.run(program, feed, fetch_list)`).  The JAX
package traces a whole block into one jitted XLA computation; here each
op's torch kernel runs as it is reached, on the executor's device, with
no trace and no compile step.  So the JAX executor's compile cache and
its feed bucketing (`bucket_policy`, the Predictor's pow2 padding, which
only bounded retraces) have no counterpart: a batch runs at its own size.

`Executor(place=None)` runs on CUDAPlace(0) and raises when no CUDA device
is present; pass CPUPlace() to run on the CPU.

A training program runs the same way: its grad ops are ops like any other
(each replays its forward under torch.func.vjp), the optimizer ops'
outputs are bound to the persistable names they write, and every
persistable the run wrote goes back to the scope.  Grad vars can be
fetched by name.  Nothing reads a device value back to the host unless
it is fetched.

Not ported yet: CompiledProgram dispatch, `run_steps`, checkpoint hooks,
per-step telemetry (later slices, ROADMAP.md).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.dtype import torch_dtype
from ..core.place import Place, resolve_place
from ..core.program import Program, default_main_program
from ..ops.registry import get_op_info, OpContext

__all__ = ["Executor", "Scope", "global_scope", "scope_guard", "as_numpy"]


class Scope:
    """name -> tensor store (flat, like paddle_tpu's Scope)."""

    def __init__(self):
        self.vars: Dict[str, Any] = {}

    def find_var(self, name: str):
        return _VarView(self, name) if name in self.vars else None

    def var(self, name: str):
        self.vars.setdefault(name, None)
        return _VarView(self, name)

    def set(self, name: str, value):
        self.vars[name] = value

    def get(self, name: str):
        return self.vars.get(name)

    def keys(self):
        return self.vars.keys()


class _VarView:
    def __init__(self, scope, name):
        self._scope, self._name = scope, name

    def get_tensor(self):
        return self._scope.vars[self._name]

    def set(self, value, place: Optional[Place] = None):
        t = torch.as_tensor(value)
        if place is not None:
            t = t.to(resolve_place(place).torch_device())
        self._scope.vars[self._name] = t


_global_scope = Scope()
_scope_stack = threading.local()


def global_scope() -> Scope:
    stack = getattr(_scope_stack, "stack", None)
    return stack[-1] if stack else _global_scope


class scope_guard:
    def __init__(self, scope):
        self.scope = scope

    def __enter__(self):
        if not hasattr(_scope_stack, "stack"):
            _scope_stack.stack = []
        _scope_stack.stack.append(self.scope)
        return self.scope

    def __exit__(self, *a):
        _scope_stack.stack.pop()


def as_numpy(x):
    if isinstance(x, (list, tuple)):
        return [as_numpy(i) for i in x]
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _run_op(op, env: Dict[str, Any], ctx: OpContext):
    """Run one op's kernel over the environment of tensors (the eager
    counterpart of paddle_tpu's BlockTracer.run_op)."""
    info = get_op_info(op.type)
    if info is None:
        raise NotImplementedError(
            f"op {op.type!r} has no registered kernel in paddle_tpu_torch")
    ins: Dict[str, Any] = {}
    for slot in info.inputs:
        names = op.inputs.get(slot.name, [])
        if slot.duplicable:
            ins[slot.name] = [env[n] for n in names if n and n in env]
        else:
            n = names[0] if names else None
            ins[slot.name] = env.get(n) if n else None
        if not slot.optional and ins[slot.name] is None:
            raise RuntimeError(
                f"op {op.type!r}: input {slot.name!r} ({names}) has no "
                "value (missing feed, or startup program not run?)")
    outs = info.kernel(ins, dict(op.attrs), ctx)
    for slot in info.outputs:
        names = op.outputs.get(slot.name, [])
        val = outs.get(slot.name) if outs else None
        if not names or val is None:
            continue
        if slot.duplicable:
            for n, v in zip(names, val):
                if n and v is not None:
                    env[n] = v
        elif names[0]:
            env[names[0]] = val


def _persistable_names(program: Program) -> List[str]:
    return sorted(v.name for b in program.blocks for v in b.vars.values()
                  if v.persistable)


class Executor:
    """exe = Executor(CUDAPlace(0)); exe.run(startup); exe.run(main, feed,
    fetch_list) — the reference's two-program contract."""

    def __init__(self, place: Optional[Place] = None):
        self.place = resolve_place(place)
        self.device = self.place.torch_device()
        self._step = 0

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        program = program if program is not None else default_main_program()
        scope = scope or global_scope()
        feed = feed or {}
        fetch_names = [f.name if hasattr(f, "name") else str(f)
                       for f in (fetch_list or [])]
        block = program.global_block()
        # no_grad, not inference_mode: the grad ops' torch.func.vjp needs
        # tensors that autograd may save (it ignores an outer no_grad, but
        # refuses inference tensors and, in some torch versions, returns
        # zero gradients inside inference_mode)
        with torch.no_grad():
            env = {k: v for k, v in scope.vars.items() if v is not None}
            for name, val in feed.items():
                env[name] = self._coerce_feed(block, name, val)
            ctx = OpContext(seed=self._seed_for_step(program),
                            is_test=False, device=self.device)
            for op in block.ops:
                _run_op(op, env, ctx)
        self._step += 1
        # persistables written by the program (startup initializers) stay
        for n in _persistable_names(program):
            if n in env and env[n] is not scope.vars.get(n):
                scope.set(n, env[n])
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError(f"fetch targets {missing} were not produced")
        fetched = [env[n] for n in fetch_names]
        if return_numpy:
            return [as_numpy(f) for f in fetched]
        return fetched

    def _coerce_feed(self, block, name, val):
        t = val if isinstance(val, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(val))
        try:
            want = block.var(name).dtype
        except KeyError:
            want = None
        if want is not None:
            t = t.to(torch_dtype(want))
        return t.to(self.device, non_blocking=False)

    def _seed_for_step(self, program: Program) -> int:
        return (int(program.random_seed) * 1000003 + self._step) % (2 ** 31)
