"""Graph pass framework — registry + pipeline over Program IR.

Copy of paddle_tpu/core/pass_framework.py (the registry, PassContext,
apply_passes, the applied-pass history, `built_tp_degree` and
`finish_pass`, the epilogue of a program rewrite such as AMP, recompute,
gradient merge, ZeRO sharding or the elastic fold, with its
PADDLE_TPU_VERIFY post-rewrite self-check, and `sync_batch_norm_pass`,
which `CompiledProgram` applies for `BuildStrategy.sync_batch_norm`).
Passes walk and rewrite the IR only; no tensor math happens here.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from .program import Program

__all__ = ["register_pass", "get_pass", "apply_passes", "PassContext",
           "all_passes", "record_applied", "applied_passes", "has_applied",
           "finish_pass", "built_tp_degree"]

_PASSES: Dict[str, Callable] = {}


# ---------------------------------------------------------------------------
# applied-passes registry
# ---------------------------------------------------------------------------
# One place that answers "which rewrites ran on this Program, in what
# order" — replacing the ad-hoc idempotency stamps each pass grew on its
# own (`zero_sharded` op attrs, `_gm_meta`, `_elastic_meta`, ...).  The
# per-pass metadata attrs stay (they carry rewrite-specific payloads the
# checkpoint/restore machinery needs), but ORDER lives here, and the
# verifier's pass-composition checks (static/verifier.py V501-V503) read
# it.  Deliberately NOT serialized into to_dict(): like _gm_meta and
# _zero_shard_plan it is build-session state; it does ride clone()'s
# deepcopy, so a cloned rewritten program keeps its history.
APPLIED_PASSES_ATTR = "_applied_passes"


def record_applied(program: Program, name: str, **meta) -> dict:
    """Append `name` (+ free-form metadata) to `program`'s applied-pass
    history and return the recorded entry."""
    entry = {"pass": str(name)}
    entry.update(meta)
    hist = getattr(program, APPLIED_PASSES_ATTR, None)
    if hist is None:
        hist = []
        setattr(program, APPLIED_PASSES_ATTR, hist)
    hist.append(entry)
    return entry


def applied_passes(program: Program) -> List[dict]:
    """The ordered rewrite history: a list of ``{"pass": name, ...meta}``
    dicts (earliest first).  Empty for a virgin program."""
    return list(getattr(program, APPLIED_PASSES_ATTR, None) or [])


def has_applied(program: Program, name: str) -> bool:
    return any(e.get("pass") == name for e in applied_passes(program))


def built_tp_degree(program: Program) -> int:
    """The tensor-parallel degree a program was BUILT with (0 for plain
    builds): the `tensor_parallel` builders record themselves in this
    registry and stamp their ops with ``tp_degree``."""
    d = max([int(e.get("tp_degree") or 0) for e in applied_passes(program)
             if e.get("pass") == "tensor_parallel"] or [0])
    if d:
        return d
    return max([int(op.attrs.get("tp_degree") or 0)
                for b in program.blocks for op in b.ops] or [0])


def finish_pass(program: Program, name: str, startup=None, **meta):
    """The rewrite-pass epilogue every pass shares: record the
    application in the registry, then run the env-gated post-rewrite
    verification (static/verifier.py self_check — a no-op unless
    PADDLE_TPU_VERIFY is set; strict mode raises AT THE REWRITE SITE
    with `name` in the message)."""
    record_applied(program, name, **meta)
    from ..static.verifier import self_check
    return self_check(program, name, startup=startup)


class PassContext:
    """Carries the scope (loaded params) for weight-rewriting passes, free
    attributes for pass-specific knobs (e.g. graphviz path), and stats."""

    def __init__(self, scope=None, **attrs):
        self.scope = scope
        self.stats: Dict[str, int] = {}
        self.attrs: Dict[str, object] = dict(attrs)

    def hit(self, name, n=1):
        self.stats[name] = self.stats.get(name, 0) + n


def register_pass(name: str):
    def deco(fn):
        _PASSES[name] = fn
        return fn
    return deco


def get_pass(name: str) -> Callable:
    return _PASSES[name]


def all_passes() -> List[str]:
    return sorted(_PASSES)


def apply_passes(program: Program, names: List[str],
                 ctx: Optional[PassContext] = None) -> Program:
    ctx = ctx or PassContext()
    for n in names:
        program = _PASSES[n](program, ctx)
        record_applied(program, n)
        program._fingerprint_cache = None
    return program


# ---------------------------------------------------------------------------
# general (training-graph) passes
# ---------------------------------------------------------------------------
@register_pass("sync_batch_norm_pass")
def sync_batch_norm_pass(program: Program, ctx: PassContext) -> Program:
    """Rewrite every training-mode batch_norm into sync_batch_norm, whose
    kernel allreduces the batch sums over the ring `ring_id` names (ring
    0: the data-parallel group), and each batch_norm_grad that reads a
    rewritten op's outputs into sync_batch_norm_grad in lockstep: the
    port's batch_norm_grad is explicit and would otherwise use the local
    statistics (the JAX package's replays its forward under vjp)."""
    for block in program.blocks:
        rewritten_outs = set()
        for op in block.ops:
            if op.type == "batch_norm" and not op.attrs.get("is_test"):
                op.type = "sync_batch_norm"
                op.attrs.setdefault("ring_id", 0)
                rewritten_outs.update(op.output_names())
                ctx.hit("sync_batch_norm_pass")
            elif op.type == "batch_norm_grad" and \
                    not op.attrs.get("is_test") and \
                    any(n in rewritten_outs for n in op.input_names()):
                op.type = "sync_batch_norm_grad"
                op.attrs.setdefault("ring_id", 0)
    return program
