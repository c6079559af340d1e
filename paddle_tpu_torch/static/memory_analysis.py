"""Checkpoint selection for recompute: the part of
paddle_tpu/static/memory_analysis.py that FLAGS_recompute="always" and
`apply_recompute` read (`_phase_of`, `_is_score_softmax`,
`select_layer_checkpoints`, copied from there).

The rest of that module, `analyze_program` (the liveness walk that prices
a program's peak HBM bytes) and the budget behind FLAGS_recompute="auto",
belongs to ROADMAP.md Queue 1, "Analysis and planner tiers".
"""
from __future__ import annotations

from typing import List, Set

from ..core.program import OpRole, Program

__all__ = ["select_layer_checkpoints"]

# the attention cores select_layer_checkpoints keys on, besides a score
# softmax
_ATTENTION_CORE_OPS = ("flash_attention", "ring_attention",
                       "multihead_matmul")


def _phase_of(op) -> str:
    role = op.attrs.get(OpRole.KEY, OpRole.Forward)
    try:
        role = int(role)
    except (TypeError, ValueError):
        return "forward"
    if role & OpRole.Backward:
        return "backward"
    if role & (OpRole.Optimize | OpRole.LRSched) or role == OpRole.Dist:
        return "optimize"
    return "forward"


def _is_score_softmax(block, op) -> bool:
    """A softmax over an attention score tensor (rank >= 3): the one
    softmax per transformer layer that is not the loss head."""
    if op.type != "softmax":
        return False
    names = op.inputs.get("X", [])
    if not names or not block.has_var(names[0]):
        return False
    shape = block.var(names[0]).shape
    return shape is not None and len(shape) >= 3


def select_layer_checkpoints(program: Program) -> List[str]:
    """Checkpoint vars at transformer layer boundaries: for each attention
    core in the forward ops (a softmax over a rank >= 3 score tensor,
    flash_attention, ring_attention, multihead_matmul) the nearest
    preceding layer_norm output, one checkpoint per layer at its entry.
    Every layer_norm output when the program has norms but no attention;
    [] (no recompute) for a program with neither."""
    block = program.global_block()
    fwd_ops = [op for op in block.ops
               if _phase_of(op) == "forward" and op.type != "feed"]
    ln_outs: List[str] = []
    picks: List[str] = []
    seen: Set[str] = set()
    for op in fwd_ops:
        if op.type == "layer_norm":
            outs = op.outputs.get("Y") or op.outputs.get("Out") or []
            if outs and outs[0]:
                ln_outs.append(outs[0])
        elif op.type in _ATTENTION_CORE_OPS or _is_score_softmax(block, op):
            if ln_outs and ln_outs[-1] not in seen:
                picks.append(ln_outs[-1])
                seen.add(ln_outs[-1])
    if picks:
        return picks
    return list(dict.fromkeys(ln_outs))
