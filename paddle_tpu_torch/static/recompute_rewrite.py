"""Recompute (activation checkpointing) as a backward-pass graph rewrite.

Counterpart of paddle_tpu/static/recompute_rewrite.py (the reference's
backward.py:689 `_append_backward_ops_with_checkpoints_`): forward ops
are divided into segments at checkpoint vars; during the backward each
segment's forward ops are replayed from its stored inputs before its grad
ops run, under `@RC`-renamed outputs, and the grad ops read the replayed
values.  So the original activations die at the end of the forward (the
executor's release plan drops a value after its last reader) and only
the checkpoints stay live through the backward sweep.

The program is the JAX package's op for op, the `optimization_barrier`
over each replayed segment's inputs included: there it keeps XLA from
merging the replay with the original forward; the eager port has no such
merge, and its barrier is a copy (ops/kernels/control.py).  Replayed ops
keep their `op_uid`, so a replayed dropout draws the mask it drew in the
forward, and each replayed grad op's vjp replays its forward from the
`@RC` inputs.

Two entry points: `append_backward_with_checkpoints` (at build time,
from append_backward's `checkpoints=` or FLAGS_recompute="always") and
`apply_recompute` (on a finished, minimized program).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

from ..core.program import Block, OpDesc, OpRole, unique_name
from ..ops.registry import get_op_info

GRAD_SUFFIX = "@GRAD"


def apply_recompute(program, checkpoints=None):
    """The activation-checkpointing rewrite of an already-minimized
    training program (forward + backward + optimizer tail in one block),
    the same transformation `append_backward_with_checkpoints` makes at
    build time, on the finished op list:

      * forward ops are segmented at `checkpoints` (default: the same
        `select_layer_checkpoints` picks FLAGS_recompute uses);
      * the first backward op that reads a non-stored activation of
        segment S triggers S's replay: an `optimization_barrier` over
        the segment's non-stored external inputs followed by the
        segment's ops re-emitted with ``@RC``-renamed outputs;
      * every later backward read of a segment-S activation is renamed
        to its ``@RC`` alias, so the original activation's live range
        ends in the forward sweep.

    Replayed ops keep their original ``op_uid`` (PRNG-keyed kernels like
    dropout replay the same mask — the build-time rewrite's contract).
    Numerics are unchanged: the replay computes the same values the
    backward would have read.  Idempotent via the applied-passes
    registry: a program that already carries the "recompute" pass (from
    either rewrite path) is returned untouched.  Returns `program`.
    """
    from ..core.pass_framework import has_applied, finish_pass
    from .memory_analysis import _phase_of, select_layer_checkpoints
    if has_applied(program, "recompute"):
        return program
    if checkpoints is None:
        checkpoints = select_layer_checkpoints(program)
    ckpt_names = {c.name if hasattr(c, "name") else str(c)
                  for c in checkpoints}
    block = program.global_block()
    if not ckpt_names:
        return program

    ops = block.ops
    n_fwd = 0
    for op in ops:
        if op.type != "feed" and _phase_of(op) != "forward":
            break
        n_fwd += 1
    fwd_ops = ops[:n_fwd]
    seg_of, fresh_seg = _segment_ids(fwd_ops, ckpt_names)
    if fresh_seg == 0:
        return program  # no checkpoint var is actually produced here

    prod_seg: Dict[str, int] = {}
    for op, s in zip(fwd_ops, seg_of):
        if s == fresh_seg:
            continue
        for n in op.output_names():
            if n:
                prod_seg[n] = s

    def _stored(name: str) -> bool:
        """Safe to read in backward WITHOUT triggering a replay."""
        if name in ckpt_names:
            return True
        v = block.vars.get(name)
        return v is not None and (v.persistable or v.is_data)

    def _barrier_free(name: str) -> bool:
        """Params/data feed both passes identically; everything else a
        replay reads, the checkpoints included, goes through the barrier
        (the build-time rewrite's `_is_barrier_free` contract)."""
        v = block.vars.get(name)
        return v is not None and (v.persistable or v.is_data)

    new_tail: List[OpDesc] = []
    replay_maps: Dict[int, Dict[str, str]] = {}

    def _emit_replay(seg_id: int):
        ops_in_seg = [op for op, s in zip(fwd_ops, seg_of)
                      if s == seg_id and op.type not in ("feed", "fetch")]
        produced = {n for op in ops_in_seg for n in op.output_names()}
        ext_inputs = sorted({
            n for op in ops_in_seg for n in op.input_names()
            if n and n not in produced})
        rmap: Dict[str, str] = {}

        def _alias(name: str, suffix: str) -> str:
            # replay aliases inherit the original var's shape/dtype (the
            # replayed op computes the same value)
            orig = block.vars.get(name)
            alias = unique_name(name + suffix)
            block.create_var(
                name=alias,
                shape=orig.shape if orig is not None else None,
                dtype=orig.dtype if orig is not None else None,
                stop_gradient=True)
            rmap[name] = alias
            return alias

        barrier_ins = [n for n in ext_inputs if not _barrier_free(n)]
        if barrier_ins:
            bar_outs = [_alias(n, "@RCB") for n in barrier_ins]
            new_tail.append(OpDesc(
                "optimization_barrier", {"X": barrier_ins},
                {"Out": bar_outs},
                {OpRole.KEY: OpRole.Backward,
                 "op_uid": program._next_uid()}))
        for op in ops_in_seg:
            new_ins = {k: [rmap.get(n, n) for n in v]
                       for k, v in op.inputs.items()}
            new_outs = {k: [_alias(n, "@RC") for n in v]
                        for k, v in op.outputs.items()}
            attrs = dict(op.attrs)  # same op_uid: replayed PRNG matches
            attrs[OpRole.KEY] = OpRole.Backward
            new_tail.append(OpDesc(op.type, new_ins, new_outs, attrs))
        replay_maps[seg_id] = rmap

    for op in ops[n_fwd:]:
        if _phase_of(op) == "backward":
            needed = sorted({
                prod_seg[n] for n in op.input_names()
                if n and n in prod_seg and not _stored(n)})
            for s in needed:
                if s not in replay_maps:
                    _emit_replay(s)
            if needed:
                for k, v in op.inputs.items():
                    op.inputs[k] = [
                        replay_maps.get(prod_seg.get(n, -1), {}).get(n, n)
                        for n in v]
        new_tail.append(op)
    block.ops = fwd_ops + new_tail
    program._fingerprint_cache = None
    finish_pass(program, "recompute", checkpoints=len(ckpt_names),
                post_hoc=True)
    return program


def _segment_ids(fwd_ops: List[OpDesc], checkpoints: Set[str]):
    """Assign each forward op a segment id; segment boundary AFTER an op that
    produces a checkpoint var.  Ops after the last checkpoint form the final
    'fresh' segment which is never replayed (its activations are still hot
    when backward starts)."""
    seg = []
    cur = 0
    for op in fwd_ops:
        seg.append(cur)
        if any(n in checkpoints for n in op.output_names()):
            cur += 1
    return seg, cur  # cur == id of the fresh (non-replayed) segment


def append_backward_with_checkpoints(block: Block, loss, parameter_list,
                                     no_grad: Set[str], checkpoints,
                                     seed=None):
    from .backward import _find_loss_op_idx, _requires_grad_vars, \
        grad_var_name
    program = block.program
    ckpt_names = {c.name if hasattr(c, "name") else str(c)
                  for c in checkpoints}
    loss_idx = _find_loss_op_idx(block, loss.name)
    fwd_ops = block.ops[: loss_idx + 1]
    seg_of, fresh_seg = _segment_ids(fwd_ops, ckpt_names)
    req = _requires_grad_vars(block, fwd_ops) - set(no_grad)

    # names safe to read without replay: checkpoints, persistables (params),
    # data inputs — everything else produced inside a replayed segment gets
    # a per-segment @RC alias
    def _stored(name: str) -> bool:
        if name in ckpt_names:
            return True
        try:
            v = block.var(name)
        except KeyError:
            return False
        return v.persistable or v.is_data

    with program._op_role_guard(OpRole.Backward):
        g_loss = block.create_var(
            name=grad_var_name(loss.name), shape=loss.shape,
            dtype=loss.dtype, stop_gradient=True)
        if seed is not None:  # gradients()' target_gradients
            block.append_op("assign", inputs={"X": [seed.name]},
                            outputs={"Out": g_loss})
        else:
            block.append_op(
                "fill_constant", outputs={"Out": g_loss},
                attrs={"shape": (list(loss.shape) if loss.shape is not None
                                 else [1]),
                       "dtype": loss.dtype, "value": 1.0})

        pending: Dict[str, List[str]] = {loss.name: [g_loss.name]}
        grad_map: Dict[str, str] = {}

        def _settle(name):
            pieces = pending.get(name)
            if not pieces:
                return None
            if len(pieces) == 1:
                grad_map[name] = pieces[0]
                return pieces[0]
            out = unique_name(grad_var_name(name) + "@SUM")
            block.create_var(name=out, stop_gradient=True)
            block.append_op("sum", inputs={"X": list(pieces)},
                            outputs={"Out": out})
            pending[name] = [out]
            grad_map[name] = out
            return out

        # replay maps: segment id -> {orig name -> replayed name}
        replay_maps: Dict[int, Dict[str, str]] = {}

        def _emit_replay(seg_id: int):
            """Re-emit segment seg_id's forward ops with @RC-renamed outputs,
            inputs routed through an optimization_barrier."""
            if seg_id in replay_maps or seg_id == fresh_seg:
                return
            ops_in_seg = [op for op, s in zip(fwd_ops, seg_of) if s == seg_id]
            produced = {n for op in ops_in_seg for n in op.output_names()}
            ext_inputs = sorted({
                n for op in ops_in_seg for n in op.input_names()
                if n not in produced})
            rmap: Dict[str, str] = {}
            barrier_ins = [n for n in ext_inputs if not _is_barrier_free(n)]
            if barrier_ins:
                bar_outs = []
                for n in barrier_ins:
                    alias = unique_name(n + "@RCB")
                    block.create_var(name=alias, stop_gradient=True)
                    rmap[n] = alias
                    bar_outs.append(alias)
                block.append_op("optimization_barrier",
                                inputs={"X": barrier_ins},
                                outputs={"Out": bar_outs})
            for op in ops_in_seg:
                new_ins = {k: [rmap.get(n, n) for n in v]
                           for k, v in op.inputs.items()}
                new_outs = {}
                for k, v in op.outputs.items():
                    outs = []
                    for n in v:
                        alias = unique_name(n + "@RC")
                        block.create_var(name=alias, stop_gradient=True)
                        rmap[n] = alias
                        outs.append(alias)
                    new_outs[k] = outs
                rop = block.append_op(op.type, new_ins, new_outs,
                                      attrs=dict(op.attrs))
                rop.attrs["op_uid"] = op.attrs.get("op_uid", 0)  # same RNG
            replay_maps[seg_id] = rmap

        def _is_barrier_free(name: str) -> bool:
            # params/data feed both passes identically; the barrier takes
            # the vars whose live range the rewrite cuts
            try:
                v = block.var(name)
            except KeyError:
                return False
            return v.persistable or v.is_data

        for i in range(len(fwd_ops) - 1, -1, -1):
            op = fwd_ops[i]
            info = get_op_info(op.type)
            if info is None or not info.has_grad:
                continue
            out_has_grad = any(n in pending for n in op.output_names())
            in_requires = any(
                n in req
                for slot in info.inputs if not slot.no_grad
                for n in op.inputs.get(slot.name, []))
            if not (out_has_grad and in_requires):
                continue

            seg_id = seg_of[i]
            _emit_replay(seg_id)
            rmap = replay_maps.get(seg_id, {})

            g_inputs: Dict[str, List[str]] = {}
            for slot in info.inputs:
                names = op.inputs.get(slot.name, [])
                if names:
                    g_inputs[slot.name] = [rmap.get(n, n) for n in names]
            for slot in info.outputs:
                names = op.outputs.get(slot.name, [])
                if names:
                    g_inputs[slot.name] = [rmap.get(n, n) for n in names]
                    gnames = []
                    for n in names:
                        g = _settle(n)
                        gnames.append(g if g is not None else "")
                    if any(gnames):
                        g_inputs[slot.name + GRAD_SUFFIX] = gnames

            g_outputs: Dict[str, List[str]] = {}
            for slot in info.inputs:
                if slot.no_grad:
                    continue
                names = op.inputs.get(slot.name, [])
                outs = []
                for n in names:
                    if n not in req or n in no_grad:
                        outs.append("")
                        continue
                    piece = unique_name(grad_var_name(n))
                    block.create_var(name=piece, stop_gradient=True)
                    pending.setdefault(n, []).append(piece)
                    outs.append(piece)
                if any(outs):
                    g_outputs[slot.name + GRAD_SUFFIX] = outs
            if not g_outputs:
                continue
            gop = block.append_op(info.grad_op_type(), g_inputs, g_outputs,
                                  attrs=dict(op.attrs))
            gop.attrs[OpRole.KEY] = OpRole.Backward
            gop.attrs["fwd_uid"] = op.attrs.get("op_uid", 0)

        for name in list(pending):
            _settle(name)

    program._grad_map.update(grad_map)

    from ..core.program import VarDesc
    if parameter_list is not None:
        params = [p if isinstance(p, VarDesc) else
                  program.global_block().var(p) for p in parameter_list]
    else:
        params = [p for p in program.all_parameters() if p.trainable]
    result = []
    for p in params:
        g = grad_map.get(p.name)
        if g is None:
            continue
        gv = block.var(g)
        gv.shape = p.shape
        gv.dtype = gv.dtype or p.dtype
        result.append((p, gv))
    from ..core.pass_framework import finish_pass
    finish_pass(program, "recompute", checkpoints=len(ckpt_names))
    return result
