"""Auto-parallel planner: compile-time cost-model search over the three
static-analysis substrates.

Closes the ROADMAP loop the previous tiers opened one leg at a time:

  * HBM      — `static.analyze_program` (the memory tier): op-IR
               liveness walk, prediction == applied under dp_shard.
  * wire     — `static.collective_wire_bytes` (the verifier tier):
               ordered collective schedule with ring accounting.
  * compute  — `static.analyze_flops` (the telemetry tier): per-op
               FLOPs walk that prices rewrites (remat replays, ring
               degradation) the analytic 6N formula cannot see.

Until now these estimators answered questions a HUMAN asked — the
docs/perf.md decision table was hand-tuned by a reviewer reading them.
`plan_program` asks all the questions itself: it enumerates the knob
lattice (batch bucket × remat × ZeRO dp_shard degree × ZeRO stage 1/2/3
× gradient-merge K × shard bucket-MB × ring-attention variant), applies
each candidate
as a REAL program rewrite on a clone (every knob already is one:
`recompute_rewrite.apply_recompute`, `sharding.shard_optimizer_states`,
`static.gradient_merge`, `insert_grad_allreduce`; ring rides as a
pre-built program variant because `nets.scaled_dot_product_attention`
emits the op at build time), prices it with an overlap-aware roofline,
gates feasibility on the HBM walker and correctness on
`static.check_program(level="collective")` — the search space never
contains a deadlocking plan — and returns the argmax `Plan`.

Roofline (per chip, per dispatched step):

    compute_s      = walked FLOPs / peak_flops_per_chip()
    wire_overlap_s = ring-accounted bytes of the gradient REDUCTION
                     collectives / ICI bandwidth   (XLA overlaps these
                     with backward compute)
    wire_serial_s  = everything else (the allgather publish runs after
                     the sharded update; forward collectives sit on the
                     critical path) / ICI bandwidth
    step_s         = max(compute_s, wire_overlap_s) + wire_serial_s

This is a RANKING model, not a wall-clock oracle: it assumes peak MXU
rate, so absolute times are lower bounds — but a constant efficiency
factor cancels in the argmax, which is all the planner needs (the same
reasoning the analytic MFU accounting has always used).  The objective
is samples/sec/chip = batch / step_s: at equal step time the bigger
feasible batch wins.

Knobs the model deliberately prices as no-wins so the trace shows WHY:
gradient_merge runs its (masked) commit and its reduction every
micro-step in the LOOPED dispatch, so alone it never improves predicted
throughput — it exists to hit an EFFECTIVE batch a bigger per-chip
batch can't fit, and the trace table says so instead of hiding it.
The `scan_hoist` knob changes that: under the scanned-window dispatch
(`distributed/scan_window.split_commit_tail`) the commit tail — the
optimizer update and the ZeRO publish allgather — runs ONCE per
K-step window instead of every micro-step, so the publish-role wire
bytes price at 1/K and a gm×ZeRO candidate can win on wire, not just
on effective batch.

The roofline is a RANKING model by default; `calibrate(pairs)` fits
per-class efficiency coefficients (compute, overlappable wire, serial
wire, plus a per-dispatch overhead intercept) from (predicted
component, measured step) pairs so `predicted_step_ms` approaches
wall-clock on the calibrated host.  `plan_program` loads the fit that
``PADDLE_TPU_ROOFLINE_CALIBRATION`` names once its residual is under
`DEFAULT_CALIBRATION_RESIDUAL_PCT`; with the env unset (or "0") it
prices raw roofline numbers.

`apply_plan(program, startup, plan)` applies the chosen knobs to the
real program, recording the plan in the `core/pass_framework`
applied-passes registry first — the verifier's V504 plan-drift check
then flags any later hand-edit whose applied passes disagree with the
recorded plan.  `bench.py --auto` is the end-to-end wiring: plan, apply,
run on the local mesh.

Port notes (paddle_tpu_torch): a copy of paddle_tpu/static/planner.py.
Its defaults are the card's: the roofline divides by the port's
`peak_flops_per_chip()` (the H100's data-sheet bf16 peak on a CUDA
device), the wire by `ici_bytes_per_chip()` (the H100 SXM's data-sheet
NVLink rate a direction), the budget is `hbm_budget_bytes()` (the card's
memory); no calibration is loaded unless the env names one.
"""
from __future__ import annotations

import itertools
import math
import os
from typing import Dict, List, Optional, Tuple

from ..core.compile_cache import next_pow2 as _next_pow2
from ..core.program import Program

__all__ = ["Plan", "plan_program", "apply_plan", "ici_bytes_per_chip",
           "page_budget", "ICI_ENV", "DEFAULT_ICI_BYTES_PER_S",
           "Calibration", "calibrate", "default_calibration",
           "CALIBRATION_ENV", "DEFAULT_CALIBRATION_RESIDUAL_PCT"]

ICI_ENV = "PADDLE_TPU_ICI_BYTES_PER_S"

# roofline calibration: env points at a `calibrate()` JSON ("0" or unset:
# none).  A fit is only trusted when its held-in residual is under this
# bound.
CALIBRATION_ENV = "PADDLE_TPU_ROOFLINE_CALIBRATION"
DEFAULT_CALIBRATION_RESIDUAL_PCT = 15.0

# NVIDIA H100 SXM NVLink 4: 900 GB/s a card in both directions together,
# 450 GB/s a direction — a data-sheet figure for that card, not a
# measurement.
DEFAULT_ICI_BYTES_PER_S = 450e9

# knob lattice defaults (override per-knob via plan_program(knobs={...}))
DEFAULT_BATCH_BUCKETS = (8, 16, 32, 64, 96, 128)
DEFAULT_GRAD_MERGE = (1, 2)
DEFAULT_BUCKET_MB = (32,)
# ZeRO stages searched when a dp_shard degree is on the lattice: 1 =
# optimizer slots, 2 = + sharded gradient accumulation (only distinct
# from 1 under gradient_merge), 3 = + full parameter sharding with JIT
# gathers (distributed/sharding.py)
DEFAULT_ZERO_STAGES = (1, 2, 3)

# the full knob tuple one lattice point carries, in table order.
# tp_degree is a BUILD-VARIANT axis (0 = the base build): candidates
# are whole alternative builds of the transformer blocks via the
# tensor_parallel builders, entering the lattice like the ring knob —
# pre-built pairs in `variants={"tp": {degree: (main, startup)}}`, or
# auto-generated from `model_config=`.
KNOB_KEYS = ("batch", "remat", "dp_shard", "zero_stage", "grad_merge",
             "bucket_mb", "ring", "tp_degree", "scan_hoist")

# gradient reduction collectives XLA overlaps with backward compute —
# on ring 0 (the dp axis) only: an mp-ring collective sits on the
# forward/backward critical path of the very matmuls it completes, so
# tensor-ring bytes are serial no matter the op type
_OVERLAPPABLE = frozenset((
    "c_allreduce_sum", "c_reducescatter", "mp_allreduce_sum",
    "c_elastic_fold",
))


def ici_bytes_per_chip() -> float:
    """Per-card interconnect bandwidth (bytes/s) the wire leg of the
    roofline divides by (``PADDLE_TPU_ICI_BYTES_PER_S`` env; default the
    H100 SXM's data-sheet NVLink rate a direction, 450 GB/s)."""
    raw = os.environ.get(ICI_ENV, "")
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    return DEFAULT_ICI_BYTES_PER_S


# ---------------------------------------------------------------------------
# roofline calibration
# ---------------------------------------------------------------------------
class Calibration:
    """A fitted mapping from the roofline's predicted components to
    wall-clock step time on one host class:

        step_ms = max(compute_ms / eff_compute,
                      wire_overlap_ms / eff_wire_overlap)
                  + wire_serial_ms / eff_wire_serial
                  + overhead_ms

    The three ``eff_*`` coefficients are per-class efficiencies in
    (0, 1] — the fraction of the peak rate that leg actually sustains —
    and ``overhead_ms`` is the per-dispatch constant (tracing epilogue,
    host transfer, runtime launch) the pure roofline prices at zero.
    ``overhead_ms_by_world`` refines the intercept per MESH CLASS
    (world size): a world=8 dispatch pays shard_map splitting and an
    8-way runtime launch a world=1 dispatch never sees, so one shared
    intercept fits whichever class dominates the ladder and misses the
    other.  `step_ms`
    consults it when the caller passes ``world=``; unknown worlds fall
    back to the shared intercept.  A coefficient whose component is
    zero in every fitted pair is unidentifiable and stays at 1.0
    (recorded in ``unidentified``).

    Produced by `calibrate(pairs)`; consumed by `plan_program` (every
    priced candidate's ``step_ms``/``samples_per_sec`` pass through
    `step_ms()` and the record is stamped ``calibrated=True``)."""

    __slots__ = ("eff_compute", "eff_wire_overlap", "eff_wire_serial",
                 "overhead_ms", "overhead_ms_by_world", "residual_pct",
                 "n_pairs", "unidentified", "source")

    def __init__(self, eff_compute: float = 1.0,
                 eff_wire_overlap: float = 1.0,
                 eff_wire_serial: float = 1.0,
                 overhead_ms: float = 0.0,
                 overhead_ms_by_world: Optional[Dict[int, float]] = None,
                 residual_pct: float = 0.0, n_pairs: int = 0,
                 unidentified: Tuple[str, ...] = (),
                 source: str = ""):
        self.eff_compute = float(eff_compute)
        self.eff_wire_overlap = float(eff_wire_overlap)
        self.eff_wire_serial = float(eff_wire_serial)
        self.overhead_ms = float(overhead_ms)
        self.overhead_ms_by_world = {
            int(w): float(v)
            for w, v in (overhead_ms_by_world or {}).items()}
        self.residual_pct = float(residual_pct)
        self.n_pairs = int(n_pairs)
        self.unidentified = tuple(unidentified)
        self.source = str(source)

    def overhead_for(self, world: Optional[int] = None) -> float:
        if world is not None:
            hit = self.overhead_ms_by_world.get(int(world))
            if hit is not None:
                return hit
        return self.overhead_ms

    def step_ms(self, compute_ms: float, wire_overlap_ms: float,
                wire_serial_ms: float,
                world: Optional[int] = None) -> float:
        return (max(compute_ms / self.eff_compute,
                    wire_overlap_ms / self.eff_wire_overlap) +
                wire_serial_ms / self.eff_wire_serial +
                self.overhead_for(world))

    def to_dict(self) -> Dict:
        return {
            "eff_compute": round(self.eff_compute, 6),
            "eff_wire_overlap": round(self.eff_wire_overlap, 6),
            "eff_wire_serial": round(self.eff_wire_serial, 6),
            "overhead_ms": round(self.overhead_ms, 6),
            "overhead_ms_by_world": {
                str(w): round(v, 6)
                for w, v in sorted(self.overhead_ms_by_world.items())},
            "residual_pct": round(self.residual_pct, 4),
            "n_pairs": self.n_pairs,
            "unidentified": list(self.unidentified),
        }

    @classmethod
    def from_dict(cls, d: Dict, source: str = "") -> "Calibration":
        return cls(eff_compute=d.get("eff_compute", 1.0),
                   eff_wire_overlap=d.get("eff_wire_overlap", 1.0),
                   eff_wire_serial=d.get("eff_wire_serial", 1.0),
                   overhead_ms=d.get("overhead_ms", 0.0),
                   overhead_ms_by_world=d.get("overhead_ms_by_world"),
                   residual_pct=d.get("residual_pct", 0.0),
                   n_pairs=d.get("n_pairs", 0),
                   unidentified=tuple(d.get("unidentified") or ()),
                   source=source)

    def save(self, path: str, extra: Optional[Dict] = None):
        import json
        rec = {"calibration": self.to_dict()}
        if extra:
            rec.update(extra)
        with open(path, "w") as f:
            json.dump(rec, f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "Calibration":
        import json
        with open(path) as f:
            rec = json.load(f)
        return cls.from_dict(rec.get("calibration") or rec, source=path)

    def __repr__(self):
        return (f"Calibration(eff_compute={self.eff_compute:.3f}, "
                f"eff_wire_overlap={self.eff_wire_overlap:.3f}, "
                f"eff_wire_serial={self.eff_wire_serial:.3f}, "
                f"overhead_ms={self.overhead_ms:.3f}, "
                f"residual_pct={self.residual_pct:.1f}, "
                f"n_pairs={self.n_pairs})")


def calibrate(pairs: List[Dict]) -> Calibration:
    """Fit a `Calibration` from (predicted components, measured) pairs.

    Each pair is a dict with ``compute_ms``, ``wire_overlap_ms``,
    ``wire_serial_ms`` (the planner's per-candidate roofline legs, e.g.
    straight out of a `Plan.trace` record) and ``measured_ms`` (the
    wall-clock per-step time of the SAME candidate on the target host).
    A pair may also carry ``world`` (the mesh size the measurement ran
    on); when two or more world classes are present the dispatch
    intercept is fitted PER CLASS — a world=8 dispatch pays shard_map
    splitting and an 8-way launch a world=1 dispatch never sees, and
    sharing one intercept across both makes whichever class is rarer in
    the ladder fit worst.  The shared ``overhead_ms`` remains the
    pair-weighted mean of the class intercepts, the fallback for worlds
    the ladder never measured.

    The fit is a deterministic coordinate descent minimizing the mean
    squared RELATIVE error (so a 10 ms shape and a 1000 ms shape weigh
    equally), each coordinate refined over a shrinking log/linear grid.
    ``residual_pct`` is the mean absolute percent error of the final
    fit over the fitted pairs — the number the default-on gate
    (`DEFAULT_CALIBRATION_RESIDUAL_PCT`) compares against."""
    pts = [(max(0.0, float(p["compute_ms"])),
            max(0.0, float(p["wire_overlap_ms"])),
            max(0.0, float(p["wire_serial_ms"])),
            float(p["measured_ms"]),
            int(p["world"]) if p.get("world") is not None else None)
           for p in pairs if float(p.get("measured_ms") or 0) > 0]
    if not pts:
        raise ValueError("calibrate: no pairs with measured_ms > 0")

    ident_c = any(c > 0 for c, _, _, _, _ in pts)
    ident_w = any(w > 0 for _, w, _, _, _ in pts)
    ident_s = any(s > 0 for _, _, s, _, _ in pts)

    # one intercept coordinate per world class when ≥2 classes measured;
    # otherwise a single shared "oh" (the pre-per-world behaviour).
    worlds = sorted({wd for *_, wd in pts if wd is not None})
    per_world = len(worlds) >= 2
    oh_keys = ([f"oh@{wd}" for wd in worlds] +
               (["oh"] if any(wd is None for *_, wd in pts) else [])
               ) if per_world else ["oh"]

    def _oh_key(wd):
        return f"oh@{wd}" if per_world and wd is not None else "oh"

    def _err(trial):
        tot = 0.0
        ec, ew, es = trial["ec"], trial["ew"], trial["es"]
        for c, w, s, m, wd in pts:
            pred = max(c / ec, w / ew) + s / es + trial[_oh_key(wd)]
            rel = (pred - m) / m
            tot += rel * rel
        return tot / len(pts)

    # coefficient search windows: efficiencies in (1e-4, 1]; each
    # intercept in [0, min measured in its class] (an intercept above
    # the class's fastest pair would fit negative work).  Shrink rounds
    # of 17-point per-coordinate grids ≈ 1e-3 relative resolution,
    # deterministic and dependency-free.
    coords = {"ec": 0.5 if ident_c else 1.0,
              "ew": 0.5 if ident_w else 1.0,
              "es": 0.5 if ident_s else 1.0}
    spans = {"ec": (1e-4, 1.0), "ew": (1e-4, 1.0), "es": (1e-4, 1.0)}
    for k in oh_keys:
        cls = [m for _, _, _, m, wd in pts if _oh_key(wd) == k]
        coords[k] = 0.0
        spans[k] = (0.0, min(cls) if cls else 0.0)
    active = ([k for k, flag in (("ec", ident_c), ("ew", ident_w),
                                 ("es", ident_s)) if flag] + oh_keys)
    for _round in range(4):
        for key in active:
            lo, hi = spans[key]
            best_v, best_e = coords[key], None
            n = 17
            for i in range(n):
                if key.startswith("oh"):
                    v = lo + (hi - lo) * i / (n - 1) if hi > lo else lo
                else:  # log-spaced: efficiencies vary over decades
                    v = math.exp(math.log(max(lo, 1e-4)) +
                                 (math.log(hi) - math.log(max(lo, 1e-4))) *
                                 i / (n - 1))
                trial = dict(coords)
                trial[key] = v
                e = _err(trial)
                if best_e is None or e < best_e:
                    best_v, best_e = v, e
            coords[key] = best_v
            # shrink the window around the winner for the next round
            width = (hi - lo) / 4
            spans[key] = (max(spans[key][0], best_v - width),
                          min(spans[key][1], best_v + width))

    ec, ew, es = coords["ec"], coords["ew"], coords["es"]
    resid = sum(abs(max(c / ec, w / ew) + s / es + coords[_oh_key(wd)] - m)
                / m for c, w, s, m, wd in pts) / len(pts) * 100.0
    unident = tuple(n for n, flag in (("compute", ident_c),
                                      ("wire_overlap", ident_w),
                                      ("wire_serial", ident_s)) if not flag)
    by_world = ({wd: coords[f"oh@{wd}"] for wd in worlds}
                if per_world else {})
    if per_world:
        # shared fallback intercept = pair-weighted mean of the fitted
        # class intercepts (worlds the ladder never measured get this)
        oh = (sum(coords[_oh_key(wd)] for *_, wd in pts) / len(pts))
    else:
        oh = coords["oh"]
    return Calibration(eff_compute=ec, eff_wire_overlap=ew,
                       eff_wire_serial=es, overhead_ms=oh,
                       overhead_ms_by_world=by_world,
                       residual_pct=resid, n_pairs=len(pts),
                       unidentified=unident)


_CALIB_CACHE: Dict[Tuple, Optional[Calibration]] = {}


def default_calibration() -> Optional[Calibration]:
    """The calibration `plan_program` applies when the caller passes
    none: the file named by ``PADDLE_TPU_ROOFLINE_CALIBRATION`` (unset or
    "0"/"off" → none: raw roofline numbers), trusted only when its
    recorded residual is under `DEFAULT_CALIBRATION_RESIDUAL_PCT`.
    Cached per (path, mtime)."""
    raw = os.environ.get(CALIBRATION_ENV, "")
    if raw.lower() in ("", "0", "off", "false", "none"):
        return None
    path = raw
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return None
    key = (path, mtime)
    if key not in _CALIB_CACHE:
        try:
            calib = Calibration.load(path)
        except Exception:
            calib = None
        if calib is not None and not (
                calib.residual_pct < DEFAULT_CALIBRATION_RESIDUAL_PCT):
            calib = None  # fit exists but isn't trusted yet
        _CALIB_CACHE.clear()  # one live entry; stale mtimes never pile up
        _CALIB_CACHE[key] = calib
    return _CALIB_CACHE[key]


class Plan:
    """The argmax of one `plan_program` search.

    ``knobs``: {"batch", "remat", "dp_shard", "zero_stage", "grad_merge",
    "bucket_mb", "ring"} — the applied spelling of the lattice point.
    ``predicted`` fields are the roofline numbers for the chosen
    candidate; ``trace`` is the full per-candidate table (one dict per
    lattice point, priced and gated — the docs/perf.md decision-table
    source)."""

    def __init__(self, knobs: Dict, world: int, hbm_budget_bytes: int,
                 chosen: Dict, trace: List[Dict]):
        self.knobs = dict(knobs)
        self.world = int(world)
        self.hbm_budget_bytes = int(hbm_budget_bytes)
        self.trace = list(trace)
        self.predicted_step_ms = float(chosen["step_ms"])
        self.predicted_samples_per_sec = float(chosen["samples_per_sec"])
        self.predicted_peak_bytes = int(chosen["peak_bytes"])
        self.predicted_fits = bool(chosen["fits"])
        self.predicted_wire_bytes = int(chosen["wire_bytes"])
        self.predicted_wire_bytes_per_axis = dict(
            chosen.get("wire_bytes_per_axis") or {})
        self.predicted_compute_ms = float(chosen["compute_ms"])
        self.predicted_wire_ms = float(chosen["wire_overlap_ms"] +
                                       chosen["wire_serial_ms"])
        self.predicted_flops = int(chosen["flops"])
        self.predicted_effective_global_batch = int(
            chosen.get("effective_global_batch") or 0)
        self.predicted_calibrated = bool(chosen.get("calibrated"))
        # the Calibration the prices passed through (plan_program fills
        # this in; None = raw roofline ranking numbers)
        self.calibration: Optional[Calibration] = None
        # tp build pairs (plan_program fills this in): {degree: (main,
        # startup[, loss_name])} so callers can train the winning build
        self.build_variants: Dict[int, Tuple] = {}

    @property
    def batch(self) -> int:
        return int(self.knobs["batch"])

    def to_dict(self) -> Dict:
        return {
            "knobs": dict(self.knobs),
            "world": self.world,
            "hbm_budget_bytes": self.hbm_budget_bytes,
            "predicted_step_ms": round(self.predicted_step_ms, 4),
            "predicted_samples_per_sec":
                round(self.predicted_samples_per_sec, 2),
            "predicted_peak_bytes": self.predicted_peak_bytes,
            "predicted_fits": self.predicted_fits,
            "predicted_wire_bytes": self.predicted_wire_bytes,
            "predicted_wire_bytes_per_axis":
                dict(self.predicted_wire_bytes_per_axis),
            "predicted_compute_ms": round(self.predicted_compute_ms, 4),
            "predicted_wire_ms": round(self.predicted_wire_ms, 4),
            "predicted_effective_global_batch":
                self.predicted_effective_global_batch,
            "calibrated": self.predicted_calibrated,
            "calibration_residual_pct":
                (round(self.calibration.residual_pct, 4)
                 if self.calibration is not None else None),
            "n_candidates": len(self.trace),
        }

    def render_table(self) -> str:
        """The per-candidate trace as a markdown table (the docs/perf.md
        decision-table source)."""
        head = ("| batch | remat | dp_shard | stage | gm K | bucket MB | "
                "ring | tp | scan | peak GiB | fits | step ms | verdict |")
        sep = "|---|---|---|---|---|---|---|---|---|---|---|---|---|"
        rows = [head, sep]
        for c in self.trace:
            rows.append(
                "| {batch} | {remat} | {dp_shard} | {zero_stage} | "
                "{grad_merge} | {bucket_mb} | {ring} | {tp_degree} | "
                "{scan_hoist} | "
                "{gib:.2f} | {fits} | {step_ms:.2f} | {verdict} |".format(
                    gib=c["peak_bytes"] / 2 ** 30,
                    fits="yes" if c["fits"] else "no",
                    **{k: c.get(k, 0)
                       for k in ("batch", "remat", "dp_shard",
                                 "zero_stage", "grad_merge",
                                 "bucket_mb", "ring", "tp_degree",
                                 "scan_hoist", "step_ms", "verdict")}))
        return "\n".join(rows)

    def __repr__(self):
        return (f"Plan(knobs={self.knobs}, world={self.world}, "
                f"step_ms={self.predicted_step_ms:.2f}, "
                f"fits={self.predicted_fits})")


class _QuietVerify:
    """Disable the env-gated per-pass self-checks while the planner
    applies CANDIDATE rewrites: the planner gates every surviving
    candidate through `check_program(level="collective")` itself, so a
    second full verification inside every rewrite of every lattice point
    would only multiply the search cost.  `apply_plan` (the real
    application) keeps the self-checks armed."""

    def __enter__(self):
        from .verifier import VERIFY_ENV
        self._prev = os.environ.get(VERIFY_ENV)
        if self._prev:
            os.environ[VERIFY_ENV] = ""
        return self

    def __exit__(self, *exc):
        from .verifier import VERIFY_ENV
        if self._prev is not None:
            os.environ[VERIFY_ENV] = self._prev
        return False


def _knob_lattice(world: int, batch: Optional[int], knobs: Optional[Dict],
                  have_ring_variant: bool,
                  can_remat: bool, can_gm: bool,
                  tp_candidates: Tuple[int, ...] = ()) -> List[Dict]:
    """Enumerate the candidate lattice points (dicts of knob values),
    deduplicating no-op combinations (bucket_mb only matters when
    sharding; remat only when checkpoints exist; gm only when the
    program recorded its param/grad pairs).  `tp_candidates` are the
    tensor-parallel degrees build variants exist for; each tp degree
    carves the world into dp×tp, so the dp_shard axis under tp `d`
    ranges over divisors of world//d."""
    knobs = dict(knobs or {})
    batches = tuple(knobs.get("batch") or
                    ((int(batch),) if batch else DEFAULT_BATCH_BUCKETS))
    remats = tuple(knobs.get("remat") or
                   ((False, True) if can_remat else (False,)))
    stages = tuple(knobs.get("zero_stage") or DEFAULT_ZERO_STAGES)
    gms = tuple(knobs.get("grad_merge") or
                (DEFAULT_GRAD_MERGE if can_gm else (1,)))
    buckets = tuple(knobs.get("bucket_mb") or DEFAULT_BUCKET_MB)
    rings = tuple(knobs.get("ring") or
                  ((False, True) if have_ring_variant else (False,)))
    # scan_hoist is a DISPATCH knob, not a rewrite: it rides any
    # gradient-merge candidate (the hoisted window needs a commit tail
    # to hoist) and shares the gm candidate's rewrite point
    hoists = tuple(knobs.get("scan_hoist") or
                   ((False, True) if can_gm else (False,)))
    tps = tuple(knobs.get("tp_degree")
                if knobs.get("tp_degree") is not None
                else ((0,) + tuple(sorted(tp_candidates))))

    seen = set()
    out = []
    for tp in tps:
        tp = int(tp)
        if tp > 1 and tp not in tp_candidates:
            continue  # no build variant for this degree
        if tp > 1 and world % tp != 0:
            continue
        dp_world = world // tp if tp > 1 else world
        dps_raw = knobs.get("dp_shard") or \
            ((0, dp_world) if dp_world > 1 else (0,))
        # under tp the dp sub-axis shrinks: a requested shard degree
        # that no longer divides it is dropped, not mis-padded
        dps = tuple(d for d in dps_raw
                    if d == 0 or (d <= dp_world and dp_world % d == 0)) \
            or (0,)
        for b, r, dp, z, gm, mb, ring, sh in itertools.product(
                batches, remats, dps, stages, gms, buckets, rings, hoists):
            if ring and not have_ring_variant:
                continue
            if ring and tp > 1:
                continue  # one model axis per mesh (ring = sp)
            if not can_remat and r and tp == 0:
                continue
            if not can_gm and gm > 1 and tp == 0:
                continue
            mb_eff = int(mb) if dp > 1 else 0  # bucket size is a ZeRO knob
            # the stage axis only exists once a dp degree does; stage 2
            # without gradient_merge IS stage 1 (the sharded accumulator
            # only materializes under a merge window), so it collapses
            z_eff = int(z) if dp > 1 else 0
            if z_eff == 2 and gm <= 1:
                z_eff = 1
            # the hoist needs a commit tail: no merge window, nothing
            # to hoist — the knob collapses to the looped dispatch
            sh_eff = bool(sh) and int(gm) > 1
            key = (int(b), bool(r), int(dp), z_eff, int(gm), mb_eff,
                   bool(ring), tp, sh_eff)
            if key in seen:
                continue
            seen.add(key)
            out.append({"batch": int(b), "remat": bool(r),
                        "dp_shard": int(dp), "zero_stage": z_eff,
                        "grad_merge": int(gm), "bucket_mb": mb_eff,
                        "ring": bool(ring), "tp_degree": tp,
                        "scan_hoist": sh_eff})
    return out


def _apply_knobs(main: Program, startup: Optional[Program],
                 cand: Dict) -> Tuple[Program, Optional[Program]]:
    """Apply one lattice point as REAL rewrites on clones of
    (main, startup) and return the rewritten pair.  Order matters:
    remat touches fwd/bwd only, sharding rewrites the optimizer tail,
    gradient_merge must come after sharding (verifier V502).  Knobs the
    base program already carries (pinned lattice points) are skipped —
    the clone inherits the applied-passes registry, and each guard
    below mirrors `apply_plan`'s."""
    from ..core.pass_framework import has_applied
    from ..core.program import Program as _P
    m = main.clone()
    s = startup.clone() if startup is not None else _P()
    if cand["remat"] and not has_applied(m, "recompute"):
        from .recompute_rewrite import apply_recompute
        apply_recompute(m)
    if cand["dp_shard"] > 1 and not has_applied(m, "zero1_sharding"):
        from ..distributed.sharding import shard_optimizer_states
        shard_optimizer_states(
            m, s, dp_degree=cand["dp_shard"],
            bucket_bytes=(cand["bucket_mb"] * 2 ** 20
                          if cand["bucket_mb"] else None),
            stage=int(cand.get("zero_stage") or 1))
    if cand["grad_merge"] > 1 and not has_applied(m, "gradient_merge"):
        from .optimizer import gradient_merge
        gradient_merge(m, cand["grad_merge"], s)
    return m, s


class _RewritePoint:
    """One (remat, dp_shard, grad_merge, bucket_mb, ring, tp_degree)
    rewrite tuple, applied and wire-priced ONCE and shared by every
    batch bucket — batch is a feed-time binding, not a rewrite, so
    re-cloning and re-verifying per batch would multiply the dominant
    cost by the bucket count for byte-identical IR.  Wire bytes are kept
    as (fixed, per-batch-unit) pairs: weight-shaped collectives price
    once, activation collectives (the mp ring's whole traffic — partial
    sums and the f-operator's backward psum ride [-1, ...] operands)
    scale with the batch bucket at `_price` time."""

    __slots__ = ("main", "startup", "reduced", "tp", "dp_world",
                 "wire_overlap", "wire_serial", "wire_by_axis",
                 "wire_publish", "wire_publish_by_axis",
                 "mp_sharded", "error", "verify_verdict", "price_cache")

    def __init__(self, base_main, base_startup, cand, world):
        from .verifier import (collective_sequence, entry_wire_bytes,
                               _ring_degrees_from_seq, ring_axis)
        self.error = None
        self.verify_verdict = None  # lazily computed, cached
        # (peak_bytes, mem_fits, flops) per batch bucket: the HBM and
        # FLOPs walks are scan_hoist-independent, so the hoisted and
        # looped spellings of one rewrite point share them
        self.price_cache: Dict[int, Tuple[int, bool, int]] = {}
        self.tp = int(cand.get("tp_degree") or 0)
        self.dp_world = world // self.tp if self.tp > 1 else world
        # (fixed, per-batch-unit) accumulators
        self.wire_overlap = [0.0, 0.0]
        self.wire_serial = [0.0, 0.0]
        self.wire_by_axis: Dict[str, List[float]] = {}
        # publish-role bytes tracked SEPARATELY (a subset of the serial
        # bucket): the scan_hoist knob prices them at 1/K because the
        # hoisted commit tail publishes once per merge window
        self.wire_publish = [0.0, 0.0]
        self.wire_publish_by_axis: Dict[str, List[float]] = {}
        self.mp_sharded = None
        try:
            self.main, self.startup = _apply_knobs(base_main, base_startup,
                                                   cand)
        except Exception as e:  # a refused composition is a verdict
            self.main = self.startup = self.reduced = None
            self.error = e
            return
        if self.tp > 1:
            # batch-independent: computed once here, shared by every
            # batch bucket's HBM walk instead of re-running propagation
            from .memory_analysis import mp_sharded_vars
            self.mp_sharded = mp_sharded_vars(self.main, self.tp)
        self.reduced = self.main
        if self.dp_world > 1:
            from ..distributed.compiled_program import insert_grad_allreduce
            self.reduced = insert_grad_allreduce(self.main)
        if self.dp_world > 1 or self.tp > 1:
            # each ring priced at its OWN degree (a tensor-parallel
            # collective on a dp×tp candidate moves mp-ring bytes, not
            # dp-world bytes) — the stamps are the authority; one
            # sequence extraction serves both the degrees and the walk.
            # Ring 0's fallback degree is the DP SUB-world: on a 4×2
            # candidate the grad allreduce crosses 4 ranks, not 8.
            seq = collective_sequence(self.reduced)
            ring_degrees = _ring_degrees_from_seq(seq)
            for e in seq:
                fixed = entry_wire_bytes(e, self.dp_world, ring_degrees)
                per_unit = entry_wire_bytes(e, self.dp_world, ring_degrees,
                                            batch=1) - fixed
                # XLA overlaps dp-ring gradient reductions with backward
                # compute; mp-ring collectives sit on the critical path
                # of the matmuls they complete, so they price serial
                bucket = (self.wire_overlap
                          if e["type"] in _OVERLAPPABLE
                          and e["ring_id"] == 0 else self.wire_serial)
                bucket[0] += fixed
                bucket[1] += per_unit
                axis = ring_axis(e["ring_id"], e.get("mp_axis"))
                ax = self.wire_by_axis.setdefault(axis, [0.0, 0.0])
                ax[0] += fixed
                ax[1] += per_unit
                if e.get("zero_role") == "publish":
                    self.wire_publish[0] += fixed
                    self.wire_publish[1] += per_unit
                    pa = self.wire_publish_by_axis.setdefault(
                        axis, [0.0, 0.0])
                    pa[0] += fixed
                    pa[1] += per_unit

    def verify(self) -> str:
        """check_program on the reduced program — once per rewrite point
        (the verdict is batch-independent).  1-D candidates gate at
        level "collective"; 2-D (tp) candidates gate the full layout
        analyzer too (level "layout", V601-V605) so the search space
        never contains a mis-reduced layout."""
        if self.verify_verdict is None:
            from .verifier import check_program
            level = "layout" if self.tp > 1 else "collective"
            report = check_program(self.reduced, level=level,
                                   startup=self.startup)
            if report.errors:
                self.verify_verdict = "dropped: " + ",".join(
                    sorted({d.code for d in report.errors}))
            else:
                self.verify_verdict = "verified"
        return self.verify_verdict


def _price(point: _RewritePoint, cand: Dict, hbm_budget: Optional[int],
           peak_flops: float, ici_bps: float, world: int,
           global_batch: Optional[int] = None,
           calib: Optional[Calibration] = None) -> Dict:
    """Roofline-price one (rewrite point, batch) candidate.

    2-D accounting: compute divides the mp-STAMPED ops' walked FLOPs by
    the tp degree (the Megatron col/row matmuls and their grads carry
    the builders' ``mp_axis`` stamp, which autodiff copies onto the grad
    ops; the attention core's per-head work is already walked at its
    local shard shapes), the HBM walker charges 1/tp of mp-sharded
    param/activation bytes (`analyze_program(tp_degree=)`), and wire
    combines each ring's fixed and batch-proportional legs.  The
    objective stays samples/sec/CHIP: a tp candidate's batch feeds
    world/tp data-parallel replicas, so its per-chip rate is
    batch·dp_world/world per step — pure-dp candidates reduce to the
    classic batch/step.

    `global_batch` is the effective-global-batch constraint: a
    candidate whose batch × dp replicas × grad-merge window falls short
    of the demanded global batch is infeasible no matter how fast."""
    from .memory_analysis import analyze_program
    from .flops_analysis import analyze_flops

    batch = cand["batch"]
    tp = point.tp
    cached = point.price_cache.get(batch)
    if cached is None:
        mem = analyze_program(point.main, batch=batch,
                              budget_bytes=hbm_budget,
                              tp_degree=tp if tp > 1 else None,
                              tp_sharded=point.mp_sharded)
        rep = analyze_flops(point.main, batch=batch)
        flops = rep["total_flops"]
        if tp > 1:
            block = point.main.global_block()
            sharded = sum(
                r["flops"] for r in rep["per_op"]
                if block.ops[r["index"]].attrs.get("mp_axis"))
            flops = (flops - sharded) + sharded / tp
        cached = (int(mem["peak_bytes"]), bool(mem["fits"]), flops)
        point.price_cache[batch] = cached
    peak_bytes, mem_fits, flops = cached
    compute_s = flops / peak_flops if peak_flops else 0.0
    wo = point.wire_overlap[0] + batch * point.wire_overlap[1]
    ws = point.wire_serial[0] + batch * point.wire_serial[1]
    gm_k = max(1, int(cand["grad_merge"]))
    axis_discount: Dict[str, float] = {}
    if cand.get("scan_hoist") and gm_k > 1:
        # hoisted commit tail: the publish allgather runs once per
        # K-step window, so its per-step bytes price at 1/K (publish is
        # always serial — allgather after the sharded update)
        pub = point.wire_publish[0] + batch * point.wire_publish[1]
        ws -= pub * (1.0 - 1.0 / gm_k)
        axis_discount = {
            a: (f + batch * u) * (1.0 - 1.0 / gm_k)
            for a, (f, u) in point.wire_publish_by_axis.items()}
    wo_s = wo / ici_bps if ici_bps else 0.0
    ws_s = ws / ici_bps if ici_bps else 0.0
    if calib is not None:
        step_s = calib.step_ms(compute_s * 1e3, wo_s * 1e3,
                               ws_s * 1e3, world=int(world)) / 1e3
    else:
        step_s = max(compute_s, wo_s) + ws_s
    eff_batch = batch * point.dp_world * gm_k
    rec = dict(cand)
    rec.update({
        "peak_bytes": peak_bytes,
        "fits": mem_fits,
        "flops": int(flops),
        "wire_bytes": int(wo + ws),
        "wire_bytes_per_axis": {
            a: int(f + batch * u - axis_discount.get(a, 0.0))
            for a, (f, u) in sorted(point.wire_by_axis.items())},
        "compute_ms": compute_s * 1e3,
        "wire_overlap_ms": wo_s * 1e3,
        "wire_serial_ms": ws_s * 1e3,
        "step_ms": step_s * 1e3,
        "calibrated": calib is not None,
        "effective_global_batch": int(eff_batch),
        "samples_per_sec": (batch * point.dp_world / max(1, world) / step_s)
        if step_s > 0 else 0.0,
        "verdict": "",
    })
    if global_batch and eff_batch < int(global_batch):
        rec["fits"] = False
        rec["verdict"] = (f"under global batch "
                          f"({eff_batch} < {int(global_batch)})")
    return rec


def _tp_variants_from_config(model_config: Dict, world: int,
                             degrees=None) -> Dict[int, Tuple]:
    """Auto-generate tensor-parallel BUILD variants from a model config:
    each candidate degree rebuilds the transformer blocks through the
    `tensor_parallel` builders (`models.build_transformer_lm` with
    ``tensor_parallel_degree=``) and minimizes the same optimizer, so
    the planner can search tp without the caller hand-feeding the
    winner.  Config keys: ``vocab_size``, ``hidden``, ``num_layers``,
    ``num_heads``, ``seq_len``; optional ``learning_rate`` (default
    1e-3) and ``optimizer`` ("adam" | "sgd", default "adam").  Candidate
    degrees (when not given): powers of two ≥ 2 dividing the world,
    the head count and the hidden width.  Returns {degree: (main,
    startup, loss_name)}."""
    from .. import static
    from ..models.static_lm import build_transformer_lm
    cfg = dict(model_config)
    heads = int(cfg["num_heads"])
    hidden = int(cfg["hidden"])
    if degrees is None:
        degrees, d = [], 2
        while d <= min(int(world), heads):
            if world % d == 0 and heads % d == 0 and hidden % d == 0:
                degrees.append(d)
            d *= 2
    out: Dict[int, Tuple] = {}
    lr = float(cfg.get("learning_rate", 1e-3))
    opt_name = str(cfg.get("optimizer", "adam")).lower()
    for d in degrees:
        d = int(d)
        if d < 2:
            continue
        main, startup, loss, _ = build_transformer_lm(
            vocab_size=int(cfg["vocab_size"]), hidden=hidden,
            num_layers=int(cfg["num_layers"]), num_heads=heads,
            seq_len=int(cfg["seq_len"]), tensor_parallel_degree=d)
        with static.program_guard(main, startup):
            opt = (static.SGD(learning_rate=lr) if opt_name == "sgd"
                   else static.Adam(learning_rate=lr))
            opt.minimize(loss)
        out[d] = (main, startup, loss.name)
    return out


def _built_tp_degree(program: Program) -> int:
    """The tp degree a program was BUILT with (0 for plain builds) —
    the shared registry rule (`core.pass_framework.built_tp_degree`),
    so the planner's pinning and the verifier's V504 drift check can
    never disagree."""
    from ..core.pass_framework import built_tp_degree
    return built_tp_degree(program)


def plan_program(program: Program, startup: Optional[Program] = None,
                 world: int = 1, hbm_budget: Optional[int] = None,
                 knobs: Optional[Dict] = None, batch: Optional[int] = None,
                 variants: Optional[Dict[str, Tuple[Program,
                                                    Program]]] = None,
                 model_config: Optional[Dict] = None,
                 global_batch: Optional[int] = None,
                 peak_flops: Optional[float] = None,
                 ici_bytes_per_s: Optional[float] = None,
                 verify: bool = True,
                 calibration: Optional[Calibration] = None) -> Plan:
    """Compile-time search for the best training configuration of
    `program` on a `world`-chip mesh (data-parallel, or 2-D dp×tp when
    tensor-parallel build variants are in the lattice).  Returns a
    `Plan`.

    * `program`/`startup` — a minimized (optimizer ops appended)
      training program pair.  Neither is modified: every candidate is
      applied to clones; call `apply_plan` (or `bench.py --auto`) to
      apply the winner for real.
    * `world` — total chip count the wire costs and shard candidates
      target (1 = single chip, no wire).  A tp-degree-`d` candidate
      carves it into a (world/d) × d dp×tp mesh.
    * `hbm_budget` — per-card budget bytes for the fits gate (default
      `PADDLE_TPU_HBM_BYTES`, else the card's memory).
    * `knobs` — per-knob candidate overrides, e.g. ``{"batch": (64, 96),
      "grad_merge": (1,)}``; unset knobs use the default lattice.
    * `batch` — pin the batch bucket (equivalent to
      ``knobs={"batch": (b,)}``).  Under tp this is the per-dp-replica
      batch (all tp shards of a replica consume the same rows).
    * `variants` — alternative BUILDS of the same model keyed by knob:
      ``{"ring": (main, startup)}`` for ring attention, and
      ``{"tp": {degree: (main, startup)}}`` for Megatron tensor
      parallelism — tp is emitted at build time by the
      `distributed/tensor_parallel` builders, so each searched degree
      enters the lattice as a pre-built pair like the ring knob.
    * `model_config` — auto-generate the tp variants instead of
      hand-feeding them: a dict of `models.build_transformer_lm`
      geometry (``vocab_size``/``hidden``/``num_layers``/``num_heads``/
      ``seq_len`` + optional ``learning_rate``/``optimizer``); the
      planner rebuilds the blocks through the tensor_parallel builders
      for every viable power-of-two degree.  The generated pairs ride
      ``plan.build_variants`` so the caller can train the winner.
    * `global_batch` — the effective-global-batch constraint: every
      candidate must reach ``batch × dp_replicas × grad_merge ≥
      global_batch`` or it is infeasible — this is how gradient-merge ×
      tp candidates WIN when the user demands a batch no single-chip
      plan can hold, instead of the search returning
      ``predicted_fits=False``.
    * `peak_flops` / `ici_bytes_per_s` — roofline denominators (default:
      `peak_flops_per_chip()` and `ici_bytes_per_chip()`; with no card
      and no ``PADDLE_TPU_PEAK_FLOPS`` there is no peak to price compute
      against, and the planner raises).
    * `verify` — gate every HBM-feasible candidate through
      `check_program` and drop any with error diagnostics: level
      "collective" for 1-D candidates, level "layout" (the V6xx
      sharding-propagation analyzer) for every 2-D tp candidate — the
      search space never contains a deadlocking or mis-reduced plan.
      Leave on; it exists as a switch only for estimator-sweep modes
      that re-plan the same program family many times
      (`bench.py --seq-ladder`).
    * `calibration` — a `Calibration` every candidate's price passes
      through (``calibrated=True`` in the trace records).  Default
      (None) consults `default_calibration()`: the fit
      ``PADDLE_TPU_ROOFLINE_CALIBRATION`` names, when its residual is
      under `DEFAULT_CALIBRATION_RESIDUAL_PCT`; none when the env is
      unset.  Pass ``False`` to force raw roofline ranking numbers.

    Selection: among verified fitting candidates, maximize predicted
    samples/sec/chip (ties prefer fewer knobs, then lower peak bytes).
    If NOTHING fits, the minimum-peak candidate is returned with
    ``predicted_fits=False`` — callers (seq-ladder, bench) surface that
    verdict instead of executing.

    The search cost is estimator-cheap by construction: every candidate
    is clone + rewrite + three IR walks — no compilation, no device.
    """
    from .flops_analysis import peak_flops_per_chip
    from .memory_analysis import hbm_budget_bytes
    from ..core.pass_framework import applied_passes, has_applied

    world = max(1, int(world))
    budget = int(hbm_budget) if hbm_budget else hbm_budget_bytes()
    peak = float(peak_flops) if peak_flops else peak_flops_per_chip()
    if not peak:
        raise RuntimeError(
            "plan_program: no peak FLOPs rate to price compute against "
            "(no CUDA device and PADDLE_TPU_PEAK_FLOPS unset): set the "
            "env or pass peak_flops=")
    ici = float(ici_bytes_per_s) if ici_bytes_per_s else ici_bytes_per_chip()
    calib = default_calibration() if calibration is None else \
        (calibration or None)
    variants = dict(variants or {})

    # tensor-parallel build variants: hand-fed pairs win; a model config
    # auto-generates the rest (only degrees not already supplied)
    tp_builds: Dict[int, Tuple] = {
        int(d): tuple(pair) for d, pair in (variants.get("tp") or {}).items()
        if int(d) > 1}
    if model_config is not None:
        want = None
        if knobs and knobs.get("tp_degree") is not None:
            want = [int(d) for d in knobs["tp_degree"] if int(d) > 1]
        generated = _tp_variants_from_config(model_config, world,
                                             degrees=want)
        for d, triple in generated.items():
            tp_builds.setdefault(d, triple)

    from .memory_analysis import select_layer_checkpoints
    can_remat = (has_applied(program, "recompute") or
                 bool(select_layer_checkpoints(program)))
    # knobs already burned into the input program are PINNED, not
    # re-searched: a pre-rematerialized program can't un-remat, a
    # pre-sharded one can't unshard, a pre-merged one can't un-merge,
    # and a ring-built program can't drop its ring op — the lattice
    # must describe clones that can actually exist, and the recorded
    # plan must match the applied state (V504)
    pre_remat = has_applied(program, "recompute")
    pre_dp = pre_bucket_mb = pre_stage = 0
    if has_applied(program, "zero1_sharding"):
        zs = next((e for e in reversed(applied_passes(program))
                   if e["pass"] == "zero1_sharding"), {})
        zplan = getattr(program, "_zero_shard_plan", None)
        pre_dp = int(zplan.dp_degree) if zplan is not None else world
        pre_stage = int(getattr(zplan, "stage", 0) or
                        zs.get("stage", 1)) if zplan is not None else \
            int(zs.get("stage", 1))
        if zs.get("bucket_bytes"):
            pre_bucket_mb = max(1, int(zs["bucket_bytes"]) // 2 ** 20)
    pre_gm = 0
    if has_applied(program, "gradient_merge"):
        gm_meta = getattr(program, "_gm_meta", None) or {}
        pre_gm = int(gm_meta.get("k", 0)) or 1
    pre_ring = any(op.type == "ring_attention"
                   for b in program.blocks for op in b.ops)
    can_gm = bool(getattr(program, "_ps_params_grads", None)) or pre_gm > 0
    # a program BUILT through the tensor_parallel builders can't drop
    # its Megatron collectives — the tp axis pins like the ring knob
    pre_tp = _built_tp_degree(program)
    pre_hoist = has_applied(program, "scan_hoist")

    eff_knobs = dict(knobs or {})
    if pre_hoist:
        eff_knobs["scan_hoist"] = (True,)
    if pre_remat:
        eff_knobs["remat"] = (True,)
    if pre_gm:
        eff_knobs["grad_merge"] = (pre_gm,)
    if pre_ring:
        eff_knobs["ring"] = (True,)
    if pre_tp:
        eff_knobs["tp_degree"] = (pre_tp,)
        tp_builds[pre_tp] = (program, startup)
    if pre_dp:
        # pin through the axis (NOT a post-filter: a pre-sharded degree
        # outside the default (0, world) axis would otherwise empty the
        # lattice and silently discard the batch search)
        eff_knobs["dp_shard"] = (pre_dp,)
        eff_knobs["zero_stage"] = (pre_stage or 1,)
        if pre_bucket_mb:
            eff_knobs["bucket_mb"] = (pre_bucket_mb,)
    tp_candidates = tuple(sorted(tp_builds))
    lattice = _knob_lattice(world, batch, eff_knobs,
                            pre_ring or "ring" in variants,
                            can_remat, can_gm, tp_candidates)
    if not lattice:
        # over-constrained knob lists (e.g. remat forced on a model with
        # no checkpointable layers): fall back to pricing the program
        # as-is so the caller still gets a verdict
        lattice = [{"batch": int(batch or 1), "remat": pre_remat,
                    "dp_shard": pre_dp, "zero_stage": pre_stage,
                    "grad_merge": pre_gm or 1,
                    "bucket_mb": pre_bucket_mb, "ring": pre_ring,
                    "tp_degree": pre_tp, "scan_hoist": bool(pre_hoist)}]

    trace: List[Dict] = []
    points: Dict[Tuple, _RewritePoint] = {}
    with _QuietVerify():
        for cand in lattice:
            base_main, base_startup = (program, startup)
            if cand["ring"] and not pre_ring:
                base_main, base_startup = variants["ring"]
            tp = int(cand.get("tp_degree") or 0)
            if tp > 1 and tp != pre_tp:
                pair = tp_builds[tp]
                base_main, base_startup = pair[0], pair[1]
            rkey = (cand["remat"], cand["dp_shard"], cand["zero_stage"],
                    cand["grad_merge"], cand["bucket_mb"], cand["ring"],
                    tp)
            point = points.get(rkey)
            if point is None:
                point = points[rkey] = _RewritePoint(
                    base_main, base_startup, cand, world)
            if point.error is not None:
                rec = dict(cand)
                rec.update({"peak_bytes": 0, "fits": False, "flops": 0,
                            "wire_bytes": 0, "wire_bytes_per_axis": {},
                            "compute_ms": 0.0,
                            "wire_overlap_ms": 0.0, "wire_serial_ms": 0.0,
                            "step_ms": float("inf"), "samples_per_sec": 0.0,
                            "effective_global_batch": 0,
                            "calibrated": False,
                            "verdict": f"rewrite refused: {point.error!r}"})
                trace.append(rec)
                continue
            rec = _price(point, cand, budget, peak, ici, world,
                         global_batch, calib)
            if verify and rec["fits"]:
                verdict = point.verify()
                rec["verdict"] = verdict
                if verdict != "verified":
                    rec["fits"] = False
            elif rec["fits"]:
                rec["verdict"] = "unverified"
            elif not rec["verdict"]:
                rec["verdict"] = "over budget"
            trace.append(rec)

    feasible = [r for r in trace if r["fits"]]

    def _n_knobs(r):
        # higher ZeRO stages count as extra knobs so ties prefer the
        # least-invasive rewrite (plain < zero1 < zero2 < zero3); a tp
        # build variant counts like any other knob
        return (int(r["remat"]) + int(r["dp_shard"] > 1) +
                max(0, int(r.get("zero_stage") or 0) - 1) +
                int(r["grad_merge"] > 1) + int(r["ring"]) +
                int((r.get("tp_degree") or 0) > 1) +
                int(bool(r.get("scan_hoist"))))

    if feasible:
        chosen = max(feasible,
                     key=lambda r: (r["samples_per_sec"], -_n_knobs(r),
                                    -r["peak_bytes"]))
        chosen = dict(chosen)
        chosen["verdict"] = (chosen["verdict"] + "; chosen").lstrip("; ")
    else:
        # nothing fits: return the least-infeasible point so callers can
        # report HOW far over budget the shape is (seq-ladder rungs)
        pool = [r for r in trace if r["peak_bytes"] > 0] or trace
        chosen = dict(min(pool, key=lambda r: r["peak_bytes"]))
        chosen["verdict"] = (chosen["verdict"] +
                             "; chosen (nothing fits)").lstrip("; ")
    for r in trace:
        if all(r[k] == chosen[k] for k in KNOB_KEYS):
            r["verdict"] = chosen["verdict"]
    knob_dict = {k: chosen[k] for k in KNOB_KEYS}
    plan = Plan(knob_dict, world, budget, chosen, trace)
    plan.calibration = calib
    # the tp build pairs (hand-fed AND auto-generated) ride the plan so
    # a caller can apply/train the winning variant without rebuilding:
    # {degree: (main, startup)} or (main, startup, loss_name) for
    # config-generated builds
    plan.build_variants = dict(tp_builds)
    # non-registry attachment for inspection/telemetry; the REGISTRY
    # entry is written by apply_plan, at application time, so the V504
    # drift check compares a recorded plan only against a program the
    # plan was actually applied to
    program._auto_plan = plan.to_dict()
    return plan


def apply_plan(program: Program, startup: Optional[Program], plan) -> Program:
    """Apply a `Plan` (or its ``knobs`` dict) to the REAL program pair,
    recording the plan in the applied-passes registry so the verifier's
    V504 drift check can flag later hand-edits.  Rewrites run with the
    env-gated self-checks armed (unlike candidate enumeration).

    The ring and tp knobs cannot be applied post-hoc — both are emitted
    at build time — so ``plan.knobs["ring"]=True`` demands the caller
    pass the ring-built program, and ``plan.knobs["tp_degree"]=d``
    demands the degree-`d` tensor-parallel build (``plan.build_variants
    [d]`` when the planner generated it; raises otherwise).  Batch is a
    feed-time binding, not a rewrite; read it from
    ``plan.knobs["batch"]``.
    """
    from ..core.pass_framework import has_applied
    knobs = plan.knobs if isinstance(plan, Plan) else dict(plan)
    has_ring = any(op.type == "ring_attention"
                   for b in program.blocks for op in b.ops)
    if bool(knobs.get("ring")) != has_ring:
        raise ValueError(
            f"apply_plan: plan says ring={bool(knobs.get('ring'))} but the "
            f"program was built with ring_attention={has_ring} — apply the "
            f"plan to the matching build variant "
            f"(nets.scaled_dot_product_attention(sequence_parallel=...))")
    built_tp = _built_tp_degree(program)
    plan_tp = int(knobs.get("tp_degree") or 0)
    if plan_tp != built_tp:
        raise ValueError(
            f"apply_plan: plan says tp_degree={plan_tp} but the program "
            f"was built with tp_degree={built_tp} — apply the plan to "
            f"the matching tensor-parallel build variant "
            f"(plan.build_variants[{plan_tp}], or rebuild through the "
            f"tensor_parallel builders)")
    meta = {k: knobs.get(k) for k in KNOB_KEYS}
    if isinstance(plan, Plan):
        meta["predicted_step_ms"] = round(plan.predicted_step_ms, 4)
        meta["predicted_peak_bytes"] = plan.predicted_peak_bytes
        meta["world"] = plan.world
    if knobs.get("remat") and not has_applied(program, "recompute"):
        from .recompute_rewrite import apply_recompute
        apply_recompute(program)
    if int(knobs.get("dp_shard") or 0) > 1 and \
            not has_applied(program, "zero1_sharding"):
        from ..distributed.sharding import shard_optimizer_states
        shard_optimizer_states(
            program, startup, dp_degree=int(knobs["dp_shard"]),
            bucket_bytes=(int(knobs["bucket_mb"]) * 2 ** 20
                          if knobs.get("bucket_mb") else None),
            stage=int(knobs.get("zero_stage") or 1))
    if int(knobs.get("grad_merge") or 1) > 1 and \
            not has_applied(program, "gradient_merge"):
        from .optimizer import gradient_merge
        gradient_merge(program, int(knobs["grad_merge"]), startup)
    if knobs.get("scan_hoist") and not has_applied(program, "scan_hoist"):
        # dispatch-level knob: validates the window splits cleanly and
        # records it so run_steps' hoisted path + V504 see the intent
        from ..distributed.scan_window import mark_scan_hoist
        mark_scan_hoist(program)
    # record LAST (the rewrites' own self-checks run mid-application;
    # recording first would make them see a plan whose passes aren't
    # applied yet and V504 at the rewrite site), then self-check the
    # final composition with the plan on record — finish_pass is the
    # shared rewrite epilogue every pass uses
    from ..core.pass_framework import finish_pass
    finish_pass(program, "auto_parallel_plan", startup=startup, **meta)
    return program


# ---------------------------------------------------------------------------
# serving KV-pool sizing (planner follow-up (d))
# ---------------------------------------------------------------------------
def _model_config(model=None, config=None) -> Dict:
    """Normalize the decode model's geometry to a plain dict.  Accepts a
    ``GPTForGeneration``/``GPTModel`` (anything carrying ``.config``),
    a ``GPTConfig``-shaped object, or an already-plain dict."""
    if config is None:
        if model is None:
            raise ValueError("page_budget needs a model or a config")
        config = getattr(model, "gpt", model).config
    if isinstance(config, dict):
        src = dict(config)
    else:
        src = {k: getattr(config, k)
               for k in ("num_layers", "num_heads", "hidden_size",
                         "vocab_size", "max_position", "intermediate_size")}
    out = {k: int(src[k]) for k in ("num_layers", "num_heads",
                                    "hidden_size", "vocab_size",
                                    "max_position")}
    out["intermediate_size"] = int(
        src.get("intermediate_size") or out["hidden_size"] * 4)
    if out["hidden_size"] % out["num_heads"]:
        raise ValueError(
            f"hidden_size {out['hidden_size']} not divisible by "
            f"num_heads {out['num_heads']}")
    return out


def _decode_weight_bytes(cfg: Dict) -> int:
    """Parameter bytes of the decode model — the same shape x dtype
    persistable accounting `memory_analysis.analyze_program` charges; in
    dygraph the parameters ARE the persistables, and their shapes are
    closed forms of the config (fp32)."""
    hd, inter = cfg["hidden_size"], cfg["intermediate_size"]
    per_block = (4 * (hd * hd + hd)       # q/k/v/out projections + bias
                 + 2 * 2 * hd             # ln1/ln2 scale + shift
                 + hd * inter + inter     # fc1
                 + inter * hd + hd)       # fc2
    n = (cfg["vocab_size"] * hd           # wte (tied LM head)
         + cfg["max_position"] * hd       # wpe
         + cfg["num_layers"] * per_block
         + 2 * hd)                        # ln_f
    return n * 4


def _decode_shardable_bytes(cfg: Dict) -> int:
    """The Megatron-splittable subset of `_decode_weight_bytes`: per
    block, the q/k/v/out projection matrices (col/row split), the qkv
    biases (ride the col shard), and fc1 weight+bias / fc2 weight (col
    then row).  Embeddings, layer norms, the out-proj and fc2 biases
    (row-parallel bias applies after the allreduce) stay replicated —
    `distributed.tensor_parallel`'s exact shard set."""
    hd, inter = cfg["hidden_size"], cfg["intermediate_size"]
    per_block = (4 * hd * hd              # q/k/v/out projection matrices
                 + 3 * hd                 # q/k/v biases (col-sharded)
                 + hd * inter + inter     # fc1 weight + bias (col)
                 + inter * hd)            # fc2 weight (row)
    return cfg["num_layers"] * per_block * 4


def _decode_quantizable_counts(cfg: Dict):
    """Matrix elements and out-channels of the decode matmuls the int8
    weight stamp rewrites — q/k/v/out projections, fc1, fc2.  Biases,
    layer norms, embeddings and the tied logits matmul stay fp32.
    Out-channels split by shard class: col-parallel scales (q/k/v, fc1)
    shard with the out dim, row-parallel scales (out-proj, fc2) cover
    the full out dim on every chip."""
    hd, inter = cfg["hidden_size"], cfg["intermediate_size"]
    L = cfg["num_layers"]
    elems = L * (4 * hd * hd + 2 * hd * inter)
    col_channels = L * (3 * hd + inter)
    row_channels = L * (2 * hd)
    return elems, col_channels, row_channels


def page_budget(model=None, config=None, *, page_tokens: int = 16,
                max_context: Optional[int] = None,
                hbm_bytes: Optional[int] = None,
                weight_bytes: Optional[int] = None,
                kv_dtype: str = "float32",
                weight_dtype: str = "float32",
                max_slots_cap: Optional[int] = None,
                headroom: float = 0.08,
                draft_layers: int = 0,
                tp_degree: int = 1) -> Dict:
    """Size the serving tier's paged KV pool from the HBM walker's
    budget instead of a hand-set page count (ROADMAP planner follow-up
    (d): the same sizing authority that answers training fits/OOM).

    Accounting, per chip::

        usable    = hbm_budget_bytes() * (1 - headroom) - weight_bytes
        workspace = max_slots * (dense K+V gather view at the pow2
                    max-context bucket + a logits row)   # the decode
                    step's transient, priced because the gather-by-
                    page-table view coexists with the pool every step
        pages     = (usable - workspace) / page_bytes

    ``weight_bytes`` defaults to summing the live model's parameters —
    the identical shape x dtype persistable accounting
    ``memory_analysis.analyze_program`` performs (dygraph parameters are
    the persistables) — or the closed-form config walk when only a
    config is given.  ``hbm_bytes`` defaults to
    ``memory_analysis.hbm_budget_bytes()`` (``PADDLE_TPU_HBM_BYTES``),
    so the serving verdict and the training fits/OOM verdict share one
    budget source.

    The batch ceiling (``max_slots``) spends at most ~35% of the usable
    budget on per-step workspace — pages are the asset, the gather view
    is rent — and ``max_context`` is clamped down when the pool cannot
    hold even one worst-case sequence at the requested context.

    ``draft_layers`` charges a speculative-decoding draft model (a
    ``draft_layers``-layer sibling of the same config): its parameter
    bytes come off the usable budget and its per-slot dense KV rides
    the step workspace, so pools sized for speculative serving never
    overcommit HBM the draft needs.  The plan also carries
    ``retained_watermarks`` — the free-page low/high marks
    ``serving.RadixPrefixCache`` bounds retention with (evict LRU when
    free falls below ``low``, release down to ``high``).

    ``tp_degree`` sizes the pool for a tensor-parallel decode mesh:
    every chip holds 1/tp of the Megatron-splittable weights
    (`_decode_shardable_bytes` — attention/MLP matrices; embeddings,
    layer norms and row-parallel biases stay replicated) and 1/tp of
    every KV byte (heads shard, so each chip's page slab is
    ``[L, P, H/tp, T, Dh]``), while the logits row is replicated (the
    row-parallel head allreduces the full vocab onto every chip).  The
    HBM budget stays PER CHIP — the whole point is that a model
    infeasible at tp=1 under a pinned ``PADDLE_TPU_HBM_BYTES`` carves a
    real page pool at tp=2 because the per-chip charge shrank.  Page
    counts and contexts in the plan remain GLOBAL token geometry
    (page tables are host-side and replicated); only the byte
    accounting divides.

    ``kv_dtype="int8"`` prices pages at the int8 itemsize PLUS the
    per-(layer, page, head) fp32 scale sidecar ``PagedKVPool`` keeps
    for both K and V — that is what carves ~2× the pages at equal HBM
    (composing multiplicatively with ``tp_degree``: 2×tp× per-chip
    capacity).  The dense gather workspace stays priced at fp32: the
    pool dequantizes on read, so the decode step's transient view is
    full-precision regardless of what the pages store.  The draft's
    dense KV charge shrinks with the same itemsize (+ its scale rows).

    ``weight_dtype="int8"`` re-prices the decode weights for the
    weight-only quantization stamp: the quantizable matmul matrices
    (q/k/v/out projections, fc1, fc2) drop to 1 byte/element plus
    per-out-channel fp32 scales; biases, norms, embeddings and the
    tied logits matmul stay fp32.  Col-parallel scales shard with tp,
    row-parallel scales are replicated — the per-chip charge accounts
    for both.  The plan records the raw fp32 parameter bytes as
    ``weight_bytes_fp32`` so ``budget_drift`` can re-derive.

    Returns the plan dict ``PagedKVPool.from_plan`` consumes; every
    input is recorded in it so ``serving.kv_pool.budget_drift`` can
    re-derive the numbers and flag hand-edits, V504-style.
    """
    import numpy as np
    from .memory_analysis import hbm_budget_bytes
    cfg = _model_config(model, config)
    L, H = cfg["num_layers"], cfg["num_heads"]
    Dh = cfg["hidden_size"] // H
    T = int(page_tokens)
    if T < 1:
        raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
    tp = int(tp_degree) if tp_degree else 1
    if tp < 1:
        raise ValueError(f"tp_degree must be >= 1, got {tp_degree}")
    if H % tp:
        raise ValueError(
            f"page_budget: num_heads {H} not divisible by tp_degree "
            f"{tp} — the KV slab shards on the head dim")
    itemsize = np.dtype(kv_dtype).itemsize
    budget = int(hbm_bytes) if hbm_bytes else hbm_budget_bytes()
    if weight_bytes is None:
        if model is not None:
            weight_bytes = int(sum(
                p.numel() * p.element_size()
                for p in getattr(model, "gpt", model).parameters()))
        else:
            weight_bytes = _decode_weight_bytes(cfg)
    weight_bytes = int(weight_bytes)
    weight_bytes_fp32 = weight_bytes
    shardable = min(weight_bytes, _decode_shardable_bytes(cfg))
    weight_dtype = str(weight_dtype)
    if weight_dtype not in ("float32", "int8"):
        raise ValueError(
            f"page_budget: weight_dtype must be float32 or int8, got "
            f"{weight_dtype!r}")
    if weight_dtype == "int8":
        elems, col_ch, row_ch = _decode_quantizable_counts(cfg)
        # matrices go 4B -> 1B; fp32 scales come back per out-channel
        weight_bytes -= elems * 3 - (col_ch + row_ch) * 4
        # the shardable set holds the matrices (now 1B) and the
        # col-parallel scales; row-parallel scales are replicated
        shardable = min(weight_bytes, shardable - elems * 3 + col_ch * 4)
    # per-chip weights: the Megatron-splittable subset divides by tp,
    # the replicated remainder (embeddings/LN/row biases) is paid whole
    weight_bytes_pc = weight_bytes - (shardable - shardable // tp)
    cap = int(max_slots_cap) if max_slots_cap else 64
    # ctx_req is the pre-clamp INPUT (recorded for budget_drift: feeding
    # the pool-clamped max_context back in would re-derive a different
    # workspace split and report drift on an untouched plan)
    ctx_req = min(int(max_context) if max_context
                  else cfg["max_position"], cfg["max_position"])
    ctx = ctx_req

    token_bytes = 2 * L * H * Dh * itemsize       # one K+V column, all layers
    page_bytes = token_bytes * T                  # global (all tp shards)
    H_loc = H // tp                               # heads resident per chip
    token_bytes_pc = 2 * L * H_loc * Dh * itemsize
    page_bytes_pc = token_bytes_pc * T
    quant_kv = np.dtype(kv_dtype) == np.int8
    if quant_kv:
        # the pool's per-(layer, page, head) fp32 scale sidecars (K and
        # V) ride every page — charged so the ~2x carve is honest
        page_bytes += 2 * L * H * 4
        page_bytes_pc += 2 * L * H_loc * 4
    # the decode step's dense gather view is DEQUANTIZED on read, so
    # the per-slot workspace stays fp32 even over int8 pages
    ws_item = 4 if quant_kv else itemsize
    ws_col_pc = 2 * L * H_loc * Dh * ws_item
    # speculative draft charge: a draft_layers-layer sibling's weights
    # are resident beside the target, and every decode slot carries a
    # dense draft KV cache at the same pow2 context bucket (both shard
    # on heads with the target, so the per-chip charge divides too)
    draft_layers = max(0, int(draft_layers))
    draft_weight_bytes = 0
    draft_weight_bytes_pc = 0
    draft_kv_slot_pc = 0
    if draft_layers:
        draft_cfg = dict(cfg)
        draft_cfg["num_layers"] = draft_layers
        draft_weight_bytes = _decode_weight_bytes(draft_cfg)
        d_shard = _decode_shardable_bytes(draft_cfg)
        draft_weight_bytes_pc = draft_weight_bytes \
            - (d_shard - d_shard // tp)
        draft_kv_slot_pc = 2 * draft_layers * H_loc * _next_pow2(ctx) \
            * Dh * itemsize
        if quant_kv:
            # the draft's dense int8 KV carries per-(layer, head)
            # fp32 scales, same sidecar layout as the pool's pages
            draft_kv_slot_pc += 2 * draft_layers * H_loc * 4
    usable = int(budget * (1.0 - float(headroom))) - weight_bytes_pc \
        - draft_weight_bytes_pc
    if usable < page_bytes_pc + ws_col_pc * _next_pow2(ctx):
        raise ValueError(
            f"page_budget: {budget} B HBM/chip leaves {usable} B after "
            f"{weight_bytes_pc} B of per-chip weights"
            + (f" + {draft_weight_bytes_pc} B of draft weights"
               if draft_layers else "") +
            f" — not enough for one decode "
            f"slot at context {ctx} at tp={tp} (raise "
            f"PADDLE_TPU_HBM_BYTES, raise tp_degree, or shrink the "
            f"model)")
    # per-slot step workspace: the dense [L, H/tp, lpad, Dh] K+V gather
    # view at the largest pow2 KV bucket, plus this row's REPLICATED
    # logits (the row-parallel head allreduces full vocab everywhere),
    # and the draft model's per-slot dense KV when speculating
    ws_slot = ws_col_pc * _next_pow2(ctx) \
        + cfg["vocab_size"] * 4 + draft_kv_slot_pc
    max_slots = max(1, min(cap, int(usable * 0.35) // ws_slot))
    pages = (usable - max_slots * ws_slot) // page_bytes_pc
    while pages < 1 and max_slots > 1:      # tiny budgets: trade slots back
        max_slots -= 1
        pages = (usable - max_slots * ws_slot) // page_bytes_pc
    if pages < 1:
        raise ValueError(
            f"page_budget: workspace for one slot leaves no room for "
            f"pages ({usable} usable, {ws_slot} per slot)")
    pages = int(pages)
    # the honest advertised max-context: ANY prompt shape within it must
    # fit its admission reservation (pages_for_request), which includes
    # the +1 COW allowance for a partial final prompt page — so the top
    # page cannot be promised (ctx = pages*T would reject in-limit
    # requests as "can never fit")
    ctx = min(ctx, max(T, (pages - 1) * T))
    max_slots = int(min(max_slots, pages))
    # retention watermarks, in FREE pages: the radix cache evicts LRU
    # leaves when free drops below `low` and releases until free climbs
    # back to `high` — retention is bounded, admission never starves
    wm_low = max(1, pages // 8)
    wm_high = max(wm_low + 1, pages // 4)
    return {
        "pages": pages,
        "page_tokens": T,
        "max_slots": max_slots,
        "max_context": int(ctx),
        "retained_watermarks": {"low": int(wm_low),
                                "high": int(min(wm_high, pages))},
        "draft_layers": draft_layers,
        "draft_weight_bytes": int(draft_weight_bytes),
        "draft_kv_bytes": int(max_slots * draft_kv_slot_pc * tp),
        "max_context_requested": int(ctx_req),
        "num_layers": L,
        "num_heads": H,
        "head_dim": Dh,
        "kv_dtype": str(kv_dtype),
        "weight_dtype": weight_dtype,
        "page_bytes": int(page_bytes),
        "kv_bytes": int(pages * page_bytes),
        "workspace_bytes": int(max_slots * ws_slot),
        "weight_bytes": weight_bytes,
        "weight_bytes_fp32": weight_bytes_fp32,
        "tp_degree": tp,
        "weight_bytes_per_chip": int(weight_bytes_pc),
        "page_bytes_per_chip": int(page_bytes_pc),
        "hbm_bytes": int(budget),
        "headroom": float(headroom),
        "max_slots_cap": cap,
        "config": cfg,
        "source": "static.page_budget (memory_analysis.hbm_budget_bytes "
                  "+ parameter persistable walk)",
    }
