"""One canonicalizer for the mesh-axis naming seam.

Copy of paddle_tpu/core/mesh_axes.py (stdlib only).

The model-parallel axis has two spellings that grew up on different
sides of the stack: the RUNTIME mesh (`CompiledProgram._get_mesh`,
`distributed/tensor_parallel.py` ``dist_attr`` annotations) says
``"tp"``, while the static analyzers (`static/layout_analysis.py`, the
ROADMAP's ``dp × mp`` vocabulary, `partition_spec.MP_COL/MP_ROW`) say
``"mp"``.  Both are the SAME axis; before this module each side kept a
private alias table, and the V604 ring/axis checks could only stay
consistent by accident.

This module is the single source of truth both sides import:

  * `canonical_axis(name)` — the analyzer spelling (``"tp"`` → ``"mp"``,
    everything else unchanged).  `layout_analysis._canon` and
    `verifier.ring_axis` route through it.
  * `runtime_axis(name)` — the mesh spelling (``"mp"`` → ``"tp"``).
    `CompiledProgram._get_mesh` builds its axis tuple from it.
  * `RING_AXIS` — the default ring-id → canonical-axis binding (ring 0 =
    the dp world, 101 = the sequence ring, 102 = the tensor ring),
    matching `CompiledProgram._traced_step`'s ``dist_info`` ring
    registry.

No imports beyond the stdlib: this sits below both `static/` and
`distributed/` so either side can import it without a cycle.
"""
from __future__ import annotations

from typing import Optional

__all__ = ["DP_AXIS", "MP_AXIS_CANONICAL", "MP_AXIS_RUNTIME", "SP_AXIS",
           "AXIS_ALIASES", "RING_AXIS", "canonical_axis", "runtime_axis"]

DP_AXIS = "dp"
SP_AXIS = "sp"
# the model-parallel axis: analyzer spelling vs runtime mesh spelling
MP_AXIS_CANONICAL = "mp"
MP_AXIS_RUNTIME = "tp"

# runtime spelling -> canonical spelling (the only alias today; a future
# second model axis joins HERE, not in a per-module table)
AXIS_ALIASES = {MP_AXIS_RUNTIME: MP_AXIS_CANONICAL}

_RUNTIME_ALIASES = {v: k for k, v in AXIS_ALIASES.items()}

# default ring-id -> canonical-axis binding, mirroring the dist_info
# ring registry CompiledProgram._traced_step hands the kernels (ring 0 =
# dp world, SP_RING_ID = 101, TP_RING_ID = 102)
RING_AXIS = {0: DP_AXIS, 101: SP_AXIS, 102: MP_AXIS_CANONICAL}


def canonical_axis(axis: Optional[str]) -> Optional[str]:
    """The analyzer spelling of a mesh-axis name (``"tp"`` → ``"mp"``;
    None and unknown names pass through)."""
    if not axis:
        return axis
    return AXIS_ALIASES.get(axis, axis)


def runtime_axis(axis: Optional[str]) -> Optional[str]:
    """The runtime-mesh spelling of a mesh-axis name (``"mp"`` →
    ``"tp"``; None and unknown names pass through)."""
    if not axis:
        return axis
    return _RUNTIME_ALIASES.get(axis, axis)
