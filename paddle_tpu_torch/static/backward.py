"""append_backward: graph-level reverse-mode autodiff by op rewriting.

Counterpart of paddle_tpu/static/backward.py (`append_backward`,
`gradients`, `grad_var_name`).  Walks the block's ops in reverse,
appending each op's `<type>_grad` op (slot convention of
ops/registry.py), and accumulates the gradient pieces of a var that
feeds several ops with a `sum` op.  The rewrite is the same as the JAX
package's, so a training program built here serializes equal to one
built there.

Recompute: `checkpoints=` (a list of vars or names) routes the backward
through static/recompute_rewrite.py; with `checkpoints=None`,
FLAGS_recompute="always" checkpoints every transformer layer boundary
(`memory_analysis.select_layer_checkpoints`), and `checkpoints=[]` forces
the plain backward whatever the flag says.  FLAGS_recompute="auto"
builds the plain backward on a clone, walks its liveness
(`memory_analysis.analyze_program`, with 2x the trainable parameters'
bytes reserved for the optimizer's moments) and rewrites at the layer
checkpoints only when the predicted peak exceeds the memory budget.  The
estimate's backward leaves the unique-name counters as it found them, so
the program "auto" builds is the plain build's, or the "always" build's,
exactly (the JAX package's estimate advances them: its "auto" programs
name their gradients one suffix later).

One difference from the JAX package: `gradients(target_gradients=...)`
seeds the backward with the given gradient; the JAX package accepts the
argument and seeds ones (ROADMAP.md Queue 3).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

from ..core.program import Block, OpDesc, Program, VarDesc, OpRole, unique_name
from ..ops.registry import get_op_info

__all__ = ["append_backward", "grad_var_name", "gradients"]

GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


def _requires_grad_vars(block: Block, ops: List[OpDesc]) -> Set[str]:
    """Forward sweep: vars that (transitively) depend on a trainable param
    or a non-stop-gradient data var."""
    req: Set[str] = set()
    for v in block.program.global_block().vars.values():
        if (v.is_parameter and v.trainable) or \
                (v.is_data and not v.stop_gradient):
            req.add(v.name)
    for v in block.vars.values():
        if v.is_data and not v.stop_gradient:
            req.add(v.name)
    for op in ops:
        info = get_op_info(op.type)
        if info is None or not info.has_grad:
            continue
        if any(n in req for slot in info.inputs if not slot.no_grad
               for n in op.inputs.get(slot.name, [])):
            for n in op.output_names():
                try:
                    if not block.var(n).stop_gradient:
                        req.add(n)
                except KeyError:
                    req.add(n)
    return req


def _find_loss_op_idx(block: Block, loss_name: str) -> int:
    for i in range(len(block.ops) - 1, -1, -1):
        if loss_name in block.ops[i].output_names():
            return i
    raise ValueError(f"loss var {loss_name!r} is not produced in this block")


# reentrancy guard: the auto-remat estimate builds a plain backward on a
# CLONE of the program; that nested append_backward must not re-enter
# the auto hook
_in_auto_remat_estimate = False


def _auto_remat_checkpoints(loss, block: Block, no_grad: Set[str]):
    """FLAGS_recompute-driven checkpoint selection (None = plain
    backward).  ``always``: checkpoint every transformer-layer boundary.
    ``auto``: additionally build the UNREWRITTEN backward on a clone,
    walk its liveness (memory_analysis), and rewrite only when the
    predicted peak exceeds the HBM budget — so remat's extra FLOPs are
    paid exactly when the memory is actually needed."""
    global _in_auto_remat_estimate
    if _in_auto_remat_estimate:
        return None
    from ..core.flags import flag
    mode = str(flag("recompute", "") or "").strip().lower()
    if mode in ("", "0", "off", "false", "none"):
        return None
    from .memory_analysis import select_layer_checkpoints, analyze_program
    program = block.program
    ckpts = select_layer_checkpoints(program)
    if not ckpts:
        return None
    if mode == "auto":
        clone = program.clone()
        try:
            clone_loss = clone.global_block().var(loss.name)
        except KeyError:
            return None
        # the estimate's backward must not consume unique names: the real
        # backward then names its vars as a plain (or "always") build
        # does, so "auto" gives that build's program exactly
        from ..core.program import _names
        saved = dict(_names.counters)
        _in_auto_remat_estimate = True
        try:
            append_backward(clone_loss, None, set(no_grad), checkpoints=())
        finally:
            _in_auto_remat_estimate = False
            _names.counters.clear()
            _names.counters.update(saved)
        report = analyze_program(clone)
        # The decision runs BEFORE minimize() appends optimizer ops, so
        # the clone walk is missing the optimizer's persistable slots.
        # Reserve 2x trainable-param bytes for them (Adam/Lamb moments,
        # the common case) so this verdict matches the post-minimize
        # walk — without the reserve a config could be declared fitting
        # here and over-budget after minimize.
        from ..core.dtype import torch_dtype
        reserve = 0
        for p in program.all_parameters():
            if p.trainable and p.shape is not None and p.dtype is not None:
                n = 1
                for d in p.shape:
                    n *= 1 if d in (-1, None) else int(d)
                reserve += n * torch_dtype(p.dtype).itemsize
        # world-size-aware slot accounting: under ZeRO-1 sharding
        # (FLAGS_hbm_dp_shard, distributed/sharding.py) the moments this
        # reserve models are split 1/N per chip — the verdict must match
        # the sharded post-minimize walk, not the replicated one
        ds = int(flag("hbm_dp_shard", 0)) or 1
        if report["peak_bytes"] + 2 * reserve // ds \
                <= report["fits_budget_bytes"]:
            return None
    return ckpts


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None, _seed=None):
    """Append grad ops for `loss` to its program; returns
    [(param VarDesc, grad VarDesc)].

    `checkpoints`: vars (or names) to segment the forward at for
    recompute (static/recompute_rewrite.py).  With None, FLAGS_recompute
    decides ("always": every layer boundary); [] forces the plain
    backward.  `_seed`: a var holding d loss (gradients()'
    target_gradients) instead of ones."""
    block = loss.block
    if block is None:
        from ..core.program import default_main_program
        block = default_main_program().global_block()
    program: Program = block.program
    loss_name = loss.name
    no_grad = set(no_grad_set or ())

    if checkpoints is None:
        checkpoints = _auto_remat_checkpoints(loss, block, no_grad)
    if checkpoints:
        from .recompute_rewrite import append_backward_with_checkpoints
        return append_backward_with_checkpoints(
            block, loss, parameter_list, no_grad, checkpoints, seed=_seed)

    loss_idx = _find_loss_op_idx(block, loss_name)
    fwd_ops = block.ops[: loss_idx + 1]
    req = _requires_grad_vars(block, fwd_ops) - no_grad

    # mark the loss op (op_role Loss), as the reference does
    block.ops[loss_idx].attrs[OpRole.KEY] = int(OpRole.Forward | OpRole.Loss)

    with program._op_role_guard(OpRole.Backward):
        # seed: d loss / d loss = 1 (or the given target gradient)
        g_loss = block.create_var(
            name=grad_var_name(loss_name), shape=loss.shape,
            dtype=loss.dtype, stop_gradient=True)
        static_shape = (loss.shape is not None
                        and all(d is not None and d >= 0
                                for d in loss.shape))
        if _seed is not None:
            block.append_op("assign", inputs={"X": [_seed.name]},
                            outputs={"Out": g_loss},
                            attrs={OpRole.KEY: OpRole.Backward})
        elif static_shape:
            block.append_op(
                "fill_constant", outputs={"Out": g_loss},
                attrs={"shape": list(loss.shape), "dtype": loss.dtype,
                       "value": 1.0, OpRole.KEY: OpRole.Backward})
        else:
            # a target with a dynamic batch dim (gradients() on an
            # intermediate var): seed ones at the runtime shape
            block.append_op(
                "fill_any_like", inputs={"X": [loss_name]},
                outputs={"Out": g_loss},
                attrs={"value": 1.0, OpRole.KEY: OpRole.Backward})

        # pending grad pieces per var: var -> [grad piece names]
        pending: Dict[str, List[str]] = {loss_name: [g_loss.name]}
        grad_map: Dict[str, str] = {}

        def _settle(name: str) -> Optional[str]:
            """Collapse the accumulated grad pieces of `name` into one
            var (a `sum` op when there are several)."""
            pieces = pending.get(name)
            if not pieces:
                return None
            if len(pieces) == 1:
                grad_map[name] = pieces[0]
                return pieces[0]
            out = grad_var_name(name)
            if out in pieces or block.has_var(out):
                out = unique_name(grad_var_name(name) + "@SUM")
            block.create_var(name=out, stop_gradient=False)
            block.append_op("sum", inputs={"X": list(pieces)},
                            outputs={"Out": out})
            pending[name] = [out]
            grad_map[name] = out
            return out

        for op in reversed(fwd_ops):
            info = get_op_info(op.type)
            if info is None or not info.has_grad:
                continue
            out_has_grad = any(n in pending for n in op.output_names())
            in_requires = any(
                n in req for slot in info.inputs if not slot.no_grad
                for n in op.inputs.get(slot.name, []))
            if not (out_has_grad and in_requires):
                continue

            g_inputs: Dict[str, List[str]] = {}
            for slot in info.inputs:
                names = op.inputs.get(slot.name, [])
                if names:
                    g_inputs[slot.name] = list(names)
            for slot in info.outputs:
                names = op.outputs.get(slot.name, [])
                if names:
                    g_inputs[slot.name] = list(names)
                    gnames = [_settle(n) or "" for n in names]
                    if any(gnames):
                        g_inputs[slot.name + GRAD_SUFFIX] = gnames

            g_outputs: Dict[str, List[str]] = {}
            for slot in info.inputs:
                if slot.no_grad:
                    continue
                outs = []
                for n in op.inputs.get(slot.name, []):
                    if n not in req or n in no_grad:
                        outs.append("")
                        continue
                    piece = unique_name(grad_var_name(n))
                    block.create_var(name=piece, stop_gradient=False)
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

        # settle every remaining pending var (params & inputs)
        for name in list(pending):
            _settle(name)

    program._grad_map.update(grad_map)

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
    return result


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """fluid.gradients: grads of one target w.r.t. arbitrary inputs;
    `target_gradients` (a var, or a one-element list) seeds d target
    instead of ones."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if len(targets) != 1:
        raise ValueError("gradients(): a single target is supported")
    seed = None
    if target_gradients is not None:
        tg = target_gradients if isinstance(target_gradients,
                                            (list, tuple)) \
            else [target_gradients]
        if len(tg) != 1:
            raise ValueError("gradients(): one target gradient per target")
        seed = tg[0]
    append_backward(targets[0], parameter_list=None, no_grad_set=no_grad_set,
                    _seed=seed)
    block = targets[0].block
    program = block.program
    outs = []
    for x in inputs:
        g = program._grad_map.get(x.name)
        outs.append(block.var(g) if g else None)
    return outs
