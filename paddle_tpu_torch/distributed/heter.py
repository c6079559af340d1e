"""Heterogeneous parameter-server training (the HeterWrapper role).

Counterpart of paddle_tpu/distributed/heter.py (the reference's
heter_wrapper / heterxpu_trainer: CPU trainer processes own the data and
sparse side, embedding pulls and pushes against the PS, while device
workers run the dense compute, the two bridged by RPC).  One program is
built, minimized and PS-transpiled as usual, then SPLIT at user-named
boundary activations into two section programs:

  * the CPU section: everything upstream of the boundary (the
    distributed_lookup_table pulls and feature plumbing) and everything
    downstream of the boundary GRADIENTS (the table's SelectedRows
    gradient and its sparse push), run in a CPU process against the KV
    tier;
  * the device section: the dense forward, loss, dense backward and local
    optimizer ops, run on the card.

The handoff is graph ops (`heter_send` / `heter_recv`,
ops/kernels/distributed_ops.py) over named blocking queues on the same KV
service the PS tier uses, so each section stays one program and the
relay rides the PS tier's RPC plane.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from ..core.program import Block, OpDesc, Program, VarDesc

__all__ = ["split_heter_program", "HeterSection"]


class HeterSection:
    """One side of the split: a runnable Program plus the feed names it
    still consumes from the host."""

    def __init__(self, program: Program, feeds: List[str]):
        self.program = program
        self.feeds = feeds


def _copy_var(block: Block, v: VarDesc):
    if v.name in block.vars:
        return
    nv = block.create_var(
        name=v.name, shape=v.shape, dtype=v.dtype,
        persistable=v.persistable, stop_gradient=v.stop_gradient,
        is_parameter=v.is_parameter, initializer=v.initializer,
        trainable=v.trainable, lod_level=v.lod_level, is_data=v.is_data)
    nv.attrs = dict(v.attrs)


def _copy_ops(src_block: Block, dst: Program, ops: Sequence[OpDesc]):
    blk = dst.global_block()
    for op in ops:
        for n in op.input_names() + op.output_names():
            if src_block.has_var(n):
                _copy_var(blk, src_block.var(n))
        blk.ops.append(OpDesc(op.type, op.inputs, op.outputs,
                              dict(op.attrs)))


def _grad_name(program: Program, block: Block, name: str) -> str:
    """Resolve the gradient var of `name` (append_backward suffixes grad
    names, e.g. x@GRAD_0 — prefer the program's grad map, fall back to a
    unique @GRAD-prefixed var)."""
    gmap = getattr(program, "_grad_map", None)
    if gmap and name in gmap:
        return gmap[name]
    prefix = name + "@GRAD"
    cands = [n for n in block.vars if n == prefix
             or n.startswith(prefix + "_")]
    if len(cands) != 1:
        raise ValueError(
            f"cannot resolve the gradient of boundary var {name!r}: "
            f"candidates {cands} — was backward appended?")
    return cands[0]


def _static_shape(v: VarDesc, batch_size: int) -> Tuple[int, ...]:
    if v.shape is None:
        raise ValueError(
            f"heter boundary var {v.name!r} has no static shape — the "
            "relay needs one (set shapes on the data layers)")
    return tuple(batch_size if s in (-1, None) else int(s)
                 for s in v.shape)


def split_heter_program(program: Program, boundary: Sequence,
                        endpoints: Sequence[str], batch_size: int,
                        channel: str = "heter", timeout: float = 60.0):
    """Partition a minimized (+PS-transpiled) main program at `boundary`
    (vars or names) into (cpu_section, device_section).

    CPU section = ancestor ops of the boundary vars + descendant ops of
    their gradients (the sparse-table backward + push).  Device section =
    the rest.  heter_send/heter_recv pairs are inserted at the cut in
    both directions.  Raises if any non-boundary value would have to
    cross the cut — the boundary the caller named must be the complete
    interface."""
    if len(program.blocks) > 1:
        raise ValueError(
            "split_heter_program supports single-block programs only — "
            "the section copies would drop control-flow sub-blocks "
            f"(program has {len(program.blocks)} blocks)")
    block = program.global_block()
    bnames = [b if isinstance(b, str) else b.name for b in boundary]
    gnames = [_grad_name(program, block, n) for n in bnames]

    # ---- CPU-forward: ops whose outputs transitively reach the boundary
    need = set(bnames)
    cpu_fwd = []
    for op in reversed(block.ops):
        if any(n in need for n in op.output_names()):
            cpu_fwd.append(op)
            need.update(op.input_names())
    cpu_fwd.reverse()
    fwd_set = set(map(id, cpu_fwd))

    # ---- CPU-backward: ops consuming the boundary grads (transitively)
    avail = set(gnames)
    cpu_bwd = []
    for op in block.ops:
        if id(op) in fwd_set:
            continue
        if any(n in avail for n in op.input_names()):
            cpu_bwd.append(op)
            avail.update(op.output_names())
    bwd_set = set(map(id, cpu_bwd))

    device_ops = [op for op in block.ops
                  if id(op) not in fwd_set and id(op) not in bwd_set]

    # ---- the named boundary must be the complete interface
    cpu_out = {n for op in cpu_fwd for n in op.output_names()}
    dev_out = {n for op in device_ops for n in op.output_names()}
    leak = [n for op in device_ops for n in op.input_names()
            if n in cpu_out and n not in bnames]
    if leak:
        raise ValueError(
            f"device section reads CPU-section values {sorted(set(leak))} "
            "that are not in the declared boundary")
    leak = [n for op in cpu_bwd for n in op.input_names()
            if n in dev_out and n not in gnames]
    if leak:
        raise ValueError(
            f"CPU backward section reads device values "
            f"{sorted(set(leak))} outside the boundary gradients")

    b_vars = [block.var(n) for n in bnames]
    shapes = [_static_shape(v, batch_size) for v in b_vars]
    dtypes = [v.dtype for v in b_vars]
    wire = {"endpoints": list(endpoints), "channel": channel,
            "timeout": float(timeout)}

    # ---- CPU section: fwd -> send(acts) -> recv(act grads) -> bwd ------
    cpu_prog = Program()
    cb = cpu_prog.global_block()
    _copy_ops(block, cpu_prog, cpu_fwd)
    dummy = cb.create_var(shape=[1], dtype="float32")
    cb.ops.append(OpDesc("heter_send", {"X": bnames},
                         {"Dummy": [dummy.name]},
                         dict(wire, send_varnames=bnames)))
    for n, s, d in zip(gnames, shapes, dtypes):
        cb.create_var(name=n, shape=s, dtype=d)
    cb.ops.append(OpDesc("heter_recv", {"Dummy": [dummy.name]},
                         {"Out": gnames},
                         dict(wire, recv_varnames=gnames,
                              shapes=[list(s) for s in shapes],
                              dtypes=dtypes)))
    _copy_ops(block, cpu_prog, cpu_bwd)

    # ---- device section: recv(acts) -> dense step -> send(act grads) --
    dev_prog = Program()
    db = dev_prog.global_block()
    for v, s in zip(b_vars, shapes):
        _copy_var(db, v)
        db.var(v.name).shape = s
    ddummy = db.create_var(shape=[1], dtype="float32")
    db.ops.append(OpDesc("heter_recv", {"Dummy": [ddummy.name]},
                         {"Out": bnames},
                         dict(wire, recv_varnames=bnames,
                              shapes=[list(s) for s in shapes],
                              dtypes=dtypes)))
    _copy_ops(block, dev_prog, device_ops)
    db.ops.append(OpDesc("heter_send", {"X": gnames},
                         {"Dummy": [ddummy.name + "_s"]},
                         dict(wire, send_varnames=gnames)))
    db.create_var(name=ddummy.name + "_s", shape=(1,), dtype="float32")

    def _feeds(prog):
        used = {n for op in prog.global_block().ops
                for n in op.input_names()}
        return [n for n, v in prog.global_block().vars.items()
                if v.is_data and n in used]

    return HeterSection(cpu_prog, _feeds(cpu_prog)), \
        HeterSection(dev_prog, _feeds(dev_prog))
