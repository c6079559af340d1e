"""Commit-tail hoisting for the K-step window of `run_steps`.

Counterpart of paddle_tpu/distributed/scan_window.py: the same split,
serialized op for op.  Under gradient merge the rewritten program is
straight-line: every micro-step runs the masked optimizer commit (update
+ ZeRO publish allgather) and `where(mask, ...)` throws K-1 of K results
away.  `split_commit_tail` splits the gm window at the `gm_role` stamps
the rewrites leave behind (fleet/meta_optimizers/rewrite_utils.py,
gradient_merge_optimizer.py):

  * BODY: forward/backward, the per-bucket reduce-scatter fold into the
    ``dp_shard`` accumulator (ZeRO-2), the full-size ``acc += g``
    accumulates and the counter increment: everything that must run
    once per micro-step;
  * TAIL: the averaging scales, the (masked) optimizer update, the
    publish allgather chain, the merged-grad allreduce spliced by
    `with_data_parallel`, the where-commits and the accumulator resets:
    a pure function of persistable state, run once per window.

`CompiledProgram._run_steps` (distributed/compiled_program.py) runs the
hoisted window: the body gm-k times, then the tail once, captured as two
CUDA graphs under NCCL on the card, eagerly under gloo and on the CPU.
The split refuses (returns None), and the caller runs the unhoisted
steps, whenever the program's dataflow crosses the boundary through a
non-persistable temp (an lr computed in forward, AMP's found_inf, a fetch
written by the commit), because then "body x K + tail x 1" is no longer
the original program run K times.

`scan_window_wire_bytes` prices the cut with the static verifier's
`entry_wire_bytes`: the looped window's bytes a step against the hoisted
one's (body + tail / K).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

__all__ = ["WindowSplit", "split_commit_tail", "mark_scan_hoist",
           "scan_window_wire_bytes"]


class WindowSplit:
    """The two halves of a hoisted gm window.

    ``body``/``tail`` are full Programs (clones sharing var
    declarations with the original): ``body`` is one micro-step with
    the commit removed, ``tail`` recomputes the mask from the final
    counter value and commits once.  ``k`` is the window length (the
    gm K), ``counter`` the persistable step counter whose phase gates
    the hoist (a window may only start on a commit boundary).
    """

    def __init__(self, body, tail, k: int, counter: str,
                 n_tail_ops: int):
        self.body = body
        self.tail = tail
        self.k = int(k)
        self.counter = counter
        self.n_tail_ops = int(n_tail_ops)

    def __repr__(self):
        return (f"WindowSplit(k={self.k}, counter={self.counter!r}, "
                f"n_tail_ops={self.n_tail_ops})")


def _reads(op) -> List[str]:
    return [n for ns in op.inputs.values() for n in ns if n]


def _writes(op) -> List[str]:
    return [n for ns in op.outputs.values() for n in ns if n]


def split_commit_tail(program, fetch_names: Iterable[str] = ()
                      ) -> Optional[WindowSplit]:
    """Split a gradient-merge program into (scan body, commit tail).

    Returns None — the caller runs the plain unhoisted scan — when the
    program has no gm window, is elastic (the elastic schedule IS a
    masked window; V501 keeps the two apart), predates the ``gm_role``
    stamps, or has dataflow that crosses the hoist boundary through a
    non-persistable temp.
    """
    meta = getattr(program, "_gm_meta", None)
    if not meta or int(meta.get("k", 1)) <= 1:
        return None
    if getattr(program, "_elastic_meta", None) is not None:
        return None
    if len(program.blocks) != 1:
        # control-flow sub-blocks hide reads/writes from the classifier
        return None
    block = program.global_block()
    roles = [op.attrs.get("gm_role") for op in block.ops]
    if "tail" not in roles:
        return None  # pre-stamping build: nothing to classify

    persist = {n for n, v in block.vars.items() if v.persistable}

    # classify: stamped tail ops seed the commit set; unstamped ops
    # whose inputs flow from commit-produced temps (the merged-grad
    # c_allreduce_sum `with_data_parallel` splices onto the optimizer's
    # Grad input reads the @GM_AVG scale output) are commit work too
    tail_idx = set()
    tail_defs = set()
    for i, op in enumerate(block.ops):
        role = op.attrs.get("gm_role")
        if role == "tail" or (role is None and
                              any(n in tail_defs for n in _reads(op))):
            tail_idx.add(i)
            tail_defs.update(_writes(op))

    # soundness 1: the body must not consume a non-persistable value
    # only the commit produces (persistables the tail writes — params,
    # reset accumulators — are the carried state; the body reading
    # them is exactly the looped semantics, since the looped commit
    # also happens after the step's forward/backward)
    for i, op in enumerate(block.ops):
        if i in tail_idx or op.attrs.get("gm_role") == "mask":
            continue
        if any(n in tail_defs and n not in persist for n in _reads(op)):
            return None

    # soundness 2: the tail (mask replay + commit) may read only
    # persistable state and its own temps — anything else means the
    # commit depends on per-micro-step activations and cannot be
    # hoisted behind the last step
    avail = set(persist)
    for i, op in enumerate(block.ops):
        if i not in tail_idx and op.attrs.get("gm_role") != "mask":
            continue
        if any(n not in avail for n in _reads(op)):
            return None
        avail.update(_writes(op))

    # soundness 3: a fetch the commit writes would change value
    # mid-window under the hoist (the looped path publishes it every
    # masked step) — refuse rather than return stale reads
    if any(n in tail_defs for n in fetch_names):
        return None

    body = program.clone()
    bb = body.global_block()
    bb.ops = [op for i, op in enumerate(bb.ops) if i not in tail_idx]
    body._fingerprint_cache = None

    tail = program.clone()
    tb = tail.global_block()
    tb.ops = [op for i, op in enumerate(tb.ops)
              if i in tail_idx or op.attrs.get("gm_role") == "mask"]
    tail._fingerprint_cache = None

    return WindowSplit(body=body, tail=tail, k=int(meta["k"]),
                       counter=meta["counter"],
                       n_tail_ops=len(tail_idx))


def mark_scan_hoist(program) -> WindowSplit:
    """Validate that `program`'s window is hoistable and record the
    ``scan_hoist`` pass entry (the JAX package's verifier and planner
    read it); raises ValueError on an unhoistable program."""
    split = split_commit_tail(program)
    if split is None:
        raise ValueError(
            "scan_hoist: program has no hoistable commit tail (needs "
            "an applied gradient_merge window, no elastic rewrite, and "
            "a commit that reads only persistable state — see "
            "distributed/scan_window.split_commit_tail)")
    from ..core.pass_framework import record_applied
    record_applied(program, "scan_hoist", k=split.k,
                   n_tail_ops=split.n_tail_ops)
    return split


def scan_window_wire_bytes(program, world: int,
                           batch: Optional[int] = None) -> Dict[str, float]:
    """Per-step ring-accounted ICI bytes of the looped vs hoisted
    window, on `verifier.entry_wire_bytes` accounting (the same
    formulas `collective_wire_bytes` and the planner roofline use):

      * ``per_step_looped``  — every collective runs every micro-step;
      * ``per_step_hoisted`` — body collectives every micro-step, tail
        collectives (publish allgather, merged-grad allreduce) once
        per K-step window: body + tail/K.

    On an unsplittable program both numbers are the looped cost.
    """
    from ..static.verifier import (collective_sequence, entry_wire_bytes,
                                   _ring_degrees_from_seq)

    def _wire(prog):
        seq = collective_sequence(prog)
        degrees = _ring_degrees_from_seq(seq)
        return sum(entry_wire_bytes(e, world, degrees, batch)
                   for e in seq)

    looped = _wire(program)
    split = split_commit_tail(program)
    if split is None:
        return {"per_step_looped": looped, "per_step_hoisted": looped,
                "body": looped, "tail": 0.0, "k": 1}
    body = _wire(split.body)
    tail = _wire(split.tail)
    return {"per_step_looped": looped,
            "per_step_hoisted": body + tail / split.k,
            "body": body, "tail": tail, "k": split.k}
