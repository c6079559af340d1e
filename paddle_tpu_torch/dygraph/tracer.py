"""Dygraph tracer bookkeeping: the eager draw key and the AMP interception
point.

Counterpart of paddle_tpu/dygraph/tracer.py.  There `trace_op` runs each
eager op's kernel and records a GradNode on the JAX package's own tape;
here ops are torch ops and the tape is torch autograd, so what is left
of the tracer is its bookkeeping:

  * `eager_draw_key()`: the (seed, uid) an eager random op draws with,
    `global_seed()` and `next_eager_uid()` (core/generator.py), as
    `trace_op` hands them to its kernel (`:97-99`).  The port advances the
    uid on random ops only (the JAX package on every traced op), so the
    masks of a model differ between the packages; one op's draw does not;
  * `amp_inputs(op_type, *tensors)`: the AMP cast of `trace_op`
    (`:112-119`).  Every port functional op calls it with the op type the
    JAX package would trace for it (`F.linear` -> "matmul_v2" then
    "elementwise_add", `F.layer_norm` -> "layer_norm", ...), and under an
    active `amp.auto_cast` the floating inputs are cast as
    `amp.auto_cast.cast_for_op` decides, as the JAX package's
    `amp_cast_inputs` (paddle_tpu/amp/auto_cast.py:71-91).  The cast is
    a torch op, so its backward casts the gradient back to the input's
    dtype;
  * the program recorder of `jit.to_static` (`_PROGRAM_RECORDER`, the JAX
    package's hook of the same name, `:26,152-162`).  Outside a recorder
    nothing here runs and the dygraph path is plain torch.  While one is
    active (`recording()`), every port functional op that the JAX package
    dispatches calls `trace_op` with the JAX op's type, slots and attrs:
    the port registry's kernel for that op runs on the eager tensors (its
    torch ops pass the recorder's tensor-operator mode untouched,
    `quiet()`), and the recorder appends the op to its Program, so the
    recorded program and its replay agree by construction.  While
    dy2static replays a loop eagerly (`replaying`), the ops run the same
    way and record nothing, taking the names the JAX package's eager
    Tensors take.  Tensor
    operators (`x * 2.0`, `x.sum()`, `x > 0`) are recorded by the mode of
    tensor/_dispatch.py; anything else raises (`refuse`), naming the
    operation, as the JAX package's `trace_jax` does.
"""
from __future__ import annotations

import contextlib

from ..core.generator import global_seed, next_eager_uid

__all__ = ["eager_draw_key", "amp_inputs", "trace_op", "recording",
           "active_recorder", "quiet", "refuse", "eager_name"]

_QUEUE = "ROADMAP.md Queue 1, The rest"

# the active program recorder of jit.to_static (jit/__init__.py
# `_Recorder`), or None
_PROGRAM_RECORDER = None


def active_recorder():
    """The recorder that records ops now, or None (none installed, or one
    replaying a loop eagerly: dy2static's `_record_while`)."""
    rec = _PROGRAM_RECORDER
    return rec if rec is not None and not rec.replaying else None


def recording() -> bool:
    """True while a `to_static` trace records ops (and not inside
    `quiet()`)."""
    return _PROGRAM_RECORDER is not None and not _PROGRAM_RECORDER.quiet


@contextlib.contextmanager
def quiet():
    """Torch ops inside run unrecorded (a kernel's own ops, a merge of
    two traced values) while a recorder is active."""
    rec = _PROGRAM_RECORDER
    if rec is None:
        yield
        return
    rec.quiet += 1
    try:
        yield
    finally:
        rec.quiet -= 1


def eager_name() -> str:
    """Take the name the JAX package's eager Tensor constructor takes
    (`unique_name("eager_tmp")`), so that a recorded program names its
    values as the JAX package's does.  Only under a recorder."""
    from ..core.program import unique_name
    return unique_name("eager_tmp")


def refuse(what: str):
    """The refusal of an operation the recorder cannot record."""
    raise NotImplementedError(
        f"to_static cannot record {what!r}: it has no op recording in "
        f"paddle_tpu_torch yet ({_QUEUE}) — use the named layer / tensor "
        "functions in a traced forward")


def _amp_cast(op_type, info, raw):
    """The AMP cast of `trace_op` (the JAX package's `amp_cast_inputs`
    over the op's single-tensor slots)."""
    from ..amp.auto_cast import amp_state, cast_for_op
    if not amp_state().enabled:
        return raw
    keys = [s.name for s in info.inputs if not s.duplicable
            and raw.get(s.name) is not None]
    vals = cast_for_op(op_type, tuple(raw[k] for k in keys))
    out = dict(raw)
    out.update(zip(keys, vals))
    return out


def trace_op(op_type: str, ins, attrs=None, out_slots=("Out",)):
    """Run one op's registry kernel on eager tensors (the JAX package's
    `trace_op`): `ins` maps slot -> tensor (or list), the result is the
    output tensor of each slot of `out_slots` (one slot: the tensor
    itself).  Under an active recorder the op is also recorded."""
    import torch
    from ..ops.registry import get_op_info, OpContext
    info = get_op_info(op_type)
    if info is None:
        raise NotImplementedError(
            f"op {op_type!r} has no registered kernel in paddle_tpu_torch "
            f"({_QUEUE})")
    attrs = dict(attrs or {})
    raw = {}
    device = None
    for slot in info.inputs:
        v = ins.get(slot.name)
        raw[slot.name] = list(v or []) if slot.duplicable else v
        for t in (v if isinstance(v, (list, tuple)) else [v]):
            if device is None and isinstance(t, torch.Tensor):
                device = t.device
    if device is None:
        from .base import current_place
        device = current_place().torch_device()
    with quiet():
        raw = _amp_cast(op_type, info, raw)
        outs = info.kernel(raw, attrs, OpContext(seed=global_seed(),
                                                 device=device)) or {}
    # an output that IS an input (assign, print) gets a tensor of its own,
    # as the JAX package's output Tensor is a new object
    in_ids = {id(t) for v in raw.values()
              for t in (v if isinstance(v, list) else [v])}

    def fresh(t):
        if isinstance(t, torch.Tensor) and id(t) in in_ids:
            with quiet():
                return t.view_as(t)
        return t

    results, out_tensors = [], {}
    for slot_name in out_slots:
        slot = next(s for s in info.outputs if s.name == slot_name)
        val = outs.get(slot_name)
        if slot.duplicable:
            out_tensors[slot_name] = [fresh(t) for t in (val or [])]
            results.append(out_tensors[slot_name])
        elif val is None:
            results.append(None)
        else:
            out_tensors[slot_name] = [fresh(val)]
            results.append(out_tensors[slot_name][0])
    rec = _PROGRAM_RECORDER
    if rec is not None and rec.replaying:
        # an eager replay: the JAX package's eager Tensors take names
        for ts in out_tensors.values():
            for _ in ts:
                eager_name()
    elif rec is not None:
        rec.record(op_type, ins, attrs, out_tensors)
    return results[0] if len(out_slots) == 1 else tuple(results)


def eager_draw_key():
    """(seed, uid) of one eager random draw."""
    return global_seed(), next_eager_uid()


def amp_inputs(op_type: str, *tensors):
    """The inputs of one `op_type` op as AMP would cast them (unchanged
    outside `auto_cast`); returns a tuple, one entry per argument."""
    from ..amp.auto_cast import amp_state, cast_for_op
    if not amp_state().enabled:
        return tensors
    return cast_for_op(op_type, tensors)
