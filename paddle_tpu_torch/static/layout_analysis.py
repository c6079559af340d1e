"""Sharding-propagation analyzer: static SPMD layout inference over a
2-D mesh, with reshard detection and wire pricing.

GSPMD's core move — whole-graph sharding propagation from a handful of
annotations — applied to this framework's op IR: `propagate_shardings`
assigns every var in a Program a PartitionSpec-shaped layout over named
mesh axes (``dp`` for the data-parallel world, ``mp`` for the
tensor/model-parallel ring — the runtime "tp" mesh axis under its
canonical analysis name, ``sp`` for the sequence ring), starting from

  * ``dist_attr`` parameter annotations (`tensor_parallel.shard_param`),
  * ``dp_shard`` ZeRO bucket stamps (`distributed/sharding.py`),
  * caller partition rules matched through
    `distributed.partition_spec.match_partition_rules` (the tp row/col
    vocabulary lives there: ``MP_COL``/``MP_ROW``/
    ``tensor_parallel_rules``),

and running per-op propagation rules to a forward/backward fixed point:
matmul contraction/batch dims (a row-parallel contraction mints a
PARTIAL sum pending its reduction), elementwise broadcast joins,
reshape/transpose dim tracking (attention head splits ride the split
heads dim), and collectives as explicit layout converters
(``c_identity`` the Megatron f, ``mp_allreduce_sum`` the g clearing the
partial, ``c_concat``/``c_split`` gather/scatter of the feature dim).

On top of the inferred layouts the analyzer reports the V6xx diagnostic
family (stable codes, `static.check_program(level="layout")` — see
docs/static_analysis.md):

  V601  layout conflict — an op consumes operands whose inferred specs
        are incompatible with its kernel contract (the row-parallel fc
        fed a replicated input it would double-count).
  V602  missing reduction — a partial-sum output is read as if complete
        (the dropped-``mp_allreduce_sum``-after-row-parallel bug).
  V603  redundant reshard — a gather/reduction the program pays wire
        for that propagation proves unnecessary.
  V604  mesh-axis disagreement — a collective stamped/rung for one mesh
        axis whose operand is sharded or partial over another.
  V605  tp-degree ∤ dim — a sharded dim's declared size does not divide
        the mesh degree of its axis.

It also emits the **reshard table**: one row per layout-converting
collective (var, from-spec, to-spec, axis, bytes), priced through
`verifier.entry_wire_bytes` with each ring's OWN degree — the per-axis
wire substrate the auto-parallel planner needs before it can search
``dp × tp`` plans, and the correctness gate every 2-D candidate runs
through.

Diagnostics are conservative by construction: they concern the MODEL
axes only (``mp``/``sp``) — ``dp`` batch semantics are the V2xx
collective checker's jurisdiction — so a program with no
tensor-parallel structure can never produce a V6xx finding, and an op
the analyzer cannot model taints its outputs instead of guessing
(tainted vars are exempt from the redundant-reshard check).

Port notes (paddle_tpu_torch): a copy of
paddle_tpu/static/layout_analysis.py; reshard bytes are priced through
the port's `verifier.entry_wire_bytes`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..core.program import Block, OpDesc, OpRole, Program
from .verifier import (Diagnostic, ERROR, _dtype_bytes, _numel,
                       entry_wire_bytes, ring_axis)

__all__ = ["LayoutSpec", "ShardingLayout", "propagate_shardings",
           "MODEL_AXES"]

# axes whose layouts this analyzer adjudicates; "dp" is tracked (ZeRO
# bucket shards, reshard-table rows) but never generates V6xx findings
MODEL_AXES = frozenset(("mp", "sp"))

# the runtime mesh spells the model axis "tp" (CompiledProgram); the
# analyzer canonicalizes to "mp" (the ROADMAP's dp × mp vocabulary) —
# both via the ONE shared table in core/mesh_axes.py
from ..core.mesh_axes import canonical_axis as _canon


class LayoutSpec:
    """One var's inferred layout: a PartitionSpec-shaped tuple (axis
    name per dim, None = replicated dim, trailing Nones trimmed) plus
    the set of axes the value is a PARTIAL sum over (a pending
    reduction: reading it as complete is the V602 bug)."""

    __slots__ = ("spec", "partial")

    def __init__(self, spec: Sequence = (), partial=()):
        spec = tuple(spec)
        while spec and spec[-1] is None:
            spec = spec[:-1]
        self.spec = spec
        self.partial = frozenset(partial)

    def axis_at(self, dim: int) -> Optional[str]:
        return self.spec[dim] if 0 <= dim < len(self.spec) else None

    def dim_of(self, axis: str) -> Optional[int]:
        for i, a in enumerate(self.spec):
            if a == axis:
                return i
        return None

    def axes(self) -> Set[str]:
        return {a for a in self.spec if a}

    def model_axes(self) -> Set[str]:
        return self.axes() & MODEL_AXES

    def model_partial(self) -> Set[str]:
        return set(self.partial) & MODEL_AXES

    @property
    def replicated(self) -> bool:
        return not self.spec and not self.partial

    def with_axis(self, dim: int, axis: Optional[str]) -> "LayoutSpec":
        spec = list(self.spec) + [None] * max(0, dim + 1 - len(self.spec))
        spec[dim] = axis
        return LayoutSpec(spec, self.partial)

    def without_axis(self, axis: str) -> "LayoutSpec":
        return LayoutSpec([None if a == axis else a for a in self.spec],
                          self.partial - {axis})

    def with_partial(self, *axes) -> "LayoutSpec":
        return LayoutSpec(self.spec, self.partial | set(axes))

    def cleared(self, axis: str) -> "LayoutSpec":
        return LayoutSpec(self.spec, self.partial - {axis})

    def __eq__(self, other):
        return (isinstance(other, LayoutSpec) and self.spec == other.spec
                and self.partial == other.partial)

    def __hash__(self):
        return hash((self.spec, self.partial))

    def render(self) -> str:
        body = ", ".join("None" if a is None else repr(a)
                         for a in self.spec)
        s = f"P({body})"
        if self.partial:
            s += "+partial(" + ",".join(sorted(self.partial)) + ")"
        return s

    def __repr__(self):
        return f"LayoutSpec({self.render()})"


_REPL = LayoutSpec()


# ---------------------------------------------------------------------------
# op classification
# ---------------------------------------------------------------------------
# layout-preserving ops: output layout == input layout, forward AND
# backward (the fill-in direction of the fixed point)
_COPY_OPS = frozenset((
    "relu", "gelu", "sigmoid", "tanh", "scale", "cast", "assign",
    "dropout", "exp", "log", "sqrt", "square", "abs", "clip", "elu",
    "leaky_relu", "relu6", "softplus", "softsign", "swish",
    "hard_sigmoid", "hard_swish", "sin", "cos", "rsqrt", "floor",
    "ceil", "round", "logical_not", "increment", "c_identity",
    "scale_by_world_size", "share_data", "print",
))

_EW_BINARY = frozenset((
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_pow", "elementwise_min",
    "elementwise_max", "less_than", "less_equal", "greater_than",
    "greater_equal", "equal", "not_equal", "logical_and", "logical_or",
))

_REDUCTION_COLLECTIVES = frozenset((
    "c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
    "c_allreduce_prod", "mp_allreduce_sum", "c_reducescatter",
    "c_elastic_fold",
))

_GATHER_COLLECTIVES = frozenset((
    "c_concat", "c_allgather", "partial_allgather",
))

# ops that reduce over explicit dims (attrs decide which)
_REDUCE_OPS = frozenset((
    "mean", "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
    "reduce_prod",
))


def _role(op: OpDesc) -> int:
    return int(op.attrs.get(OpRole.KEY, OpRole.Forward))


def _is_optimize(op: OpDesc) -> bool:
    return bool(_role(op) & OpRole.Optimize)


def _shape_of(block: Block, name: Optional[str]):
    if not name:
        return None
    try:
        v = block.var(name)
    except KeyError:
        return None
    return tuple(v.shape) if v.shape is not None else None


def _first(names) -> Optional[str]:
    return names[0] if names else None


# ---------------------------------------------------------------------------
# result object
# ---------------------------------------------------------------------------
class ShardingLayout:
    """`propagate_shardings`' verdict: per-var layouts, V6xx
    diagnostics, and the priced reshard table."""

    def __init__(self, specs: Dict[str, LayoutSpec],
                 diagnostics: List[Diagnostic],
                 reshard_table: List[dict],
                 mesh_shape: Dict[str, int], iterations: int):
        self.specs = dict(specs)
        self.diagnostics = list(diagnostics)
        self.reshard_table = list(reshard_table)
        self.mesh_shape = dict(mesh_shape)
        self.iterations = int(iterations)

    def spec(self, name: str) -> LayoutSpec:
        return self.specs.get(name, _REPL)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def ok(self) -> bool:
        return not self.errors

    def codes(self) -> List[str]:
        return sorted({d.code for d in self.diagnostics})

    def wire_bytes_per_axis(self) -> Dict[str, int]:
        """Per-mesh-axis ICI bytes one rank moves per step across the
        reshard table (ring-algorithm accounting via
        `verifier.entry_wire_bytes`, each ring priced at its own
        degree)."""
        out: Dict[str, float] = {}
        for row in self.reshard_table:
            out[row["axis"]] = out.get(row["axis"], 0.0) + row["bytes"]
        return {a: int(b) for a, b in out.items()}

    def wire_bytes(self, axis: Optional[str] = None) -> int:
        per = self.wire_bytes_per_axis()
        if axis is not None:
            return per.get(_canon(axis), 0)
        return int(sum(per.values()))

    def render_reshard_table(self) -> str:
        head = "| var | op | axis | from | to | bytes |"
        rows = [head, "|---|---|---|---|---|---|"]
        for r in self.reshard_table:
            rows.append(f"| {r['var']} | {r['op_type']} | {r['axis']} | "
                        f"{r['from']} | {r['to']} | {r['bytes']} |")
        return "\n".join(rows)

    def __repr__(self):
        n_model = sum(1 for s in self.specs.values() if s.model_axes()
                      or s.model_partial())
        return (f"ShardingLayout({len(self.specs)} vars, {n_model} "
                f"model-sharded, {len(self.errors)} errors, "
                f"{len(self.reshard_table)} reshards)")


# ---------------------------------------------------------------------------
# the propagation engine
# ---------------------------------------------------------------------------
class _Engine:
    def __init__(self, program: Program, mesh_shape: Dict[str, int],
                 batch: Optional[int]):
        self.program = program
        self.block = program.global_block()
        self.mesh = mesh_shape
        self.batch = batch
        self.specs: Dict[str, LayoutSpec] = {}
        self.pinned: Set[str] = set()
        self.tainted: Set[str] = set()
        self.diags: List[Diagnostic] = []
        self.reshard: List[dict] = []
        self.collect = False
        # cascade control: a partial/conflicted var is reported once
        self._reported: Set[Tuple[str, str]] = set()
        self._changed = False

    # -- state ---------------------------------------------------------------
    def get(self, name: Optional[str]) -> LayoutSpec:
        if not name:
            return _REPL
        return self.specs.get(name, _REPL)

    def set(self, name: Optional[str], spec: LayoutSpec):
        if not name or name in self.pinned:
            return
        if self.specs.get(name, _REPL) != spec:
            self.specs[name] = spec
            self._changed = True

    def taint(self, *names):
        for n in names:
            if n and n not in self.tainted:
                self.tainted.add(n)
                self._changed = True

    def pin(self, name: str, spec: LayoutSpec):
        self.specs[name] = spec
        self.pinned.add(name)

    # -- diagnostics ---------------------------------------------------------
    def diag(self, code: str, msg: str, op: Optional[OpDesc] = None,
             op_idx: Optional[int] = None, var: Optional[str] = None,
             severity: str = ERROR):
        if not self.collect:
            return
        key = (code, var or (f"op{op_idx}" if op_idx is not None else msg))
        if key in self._reported:
            return
        self._reported.add(key)
        self.diags.append(Diagnostic(
            code, severity, msg, block_idx=0, op_idx=op_idx,
            op_type=op.type if op is not None else None,
            op_uid=op.attrs.get("op_uid") if op is not None else None,
            var=var))

    # -- wire pricing --------------------------------------------------------
    def _nbytes(self, name: Optional[str]) -> Optional[int]:
        shape = _shape_of(self.block, name)
        if shape is None:
            return None
        if self.batch and shape and int(shape[0]) < 0:
            shape = (int(self.batch),) + tuple(shape[1:])
        n = _numel(shape)
        if n is None:
            return None
        try:
            dt = self.block.var(name).dtype
        except KeyError:
            dt = None
        return n * _dtype_bytes(dt)

    def _reshard_row(self, op: OpDesc, op_idx: int, axis: Optional[str],
                     in_name: Optional[str], from_spec: LayoutSpec,
                     to_spec: LayoutSpec):
        if not self.collect or axis is None:
            return
        degree = int(self.mesh.get(axis) or 0)
        nbytes = self._nbytes(in_name)
        try:
            x_dp_shard = int(self.block.var(in_name).attrs.get("dp_shard")
                             or 0) if in_name else 0
        except KeyError:
            x_dp_shard = 0
        entry = {
            "type": op.type, "ring_id": int(op.attrs.get("ring_id", 0)),
            "nbytes": nbytes, "dp_degree": degree if axis == "dp" else None,
            "tp_degree": degree if axis != "dp" else None,
            "mp_axis": axis if axis in MODEL_AXES else None,
            "x_dp_shard": x_dp_shard,
        }
        priced = entry_wire_bytes(entry, degree or 1) if degree else 0.0
        self.reshard.append({
            "var": in_name, "op_type": op.type,
            "op_uid": op.attrs.get("op_uid"), "block": 0, "index": op_idx,
            "axis": axis, "ring_id": entry["ring_id"],
            "degree": degree or None,
            "from": from_spec.render(), "to": to_spec.render(),
            "bytes": int(priced),
        })

    # -- axis resolution -----------------------------------------------------
    def _op_axis(self, op: OpDesc) -> Optional[str]:
        """The mesh axis a collective's RING binds to.  Deliberately
        ignores the ``mp_axis`` stamp: the ring is what the program
        actually executes, the stamp is the builder's declared intent —
        V604 is their disagreement (`_stamped_axis` vs this)."""
        return _canon(ring_axis(int(op.attrs.get("ring_id", 0))))

    def _stamped_axis(self, op: OpDesc) -> Optional[str]:
        return _canon(op.attrs.get("mp_axis"))

    # -- the partial gate ----------------------------------------------------
    def _consume(self, op: OpDesc, op_idx: int,
                 name: Optional[str]) -> LayoutSpec:
        """Read `name` for a non-reduction consumption: a model-axis
        partial sum read here is the missing-reduction bug (V602).
        Returns the spec with reported partials cleared so one dropped
        reduction reports once, not at every downstream op."""
        spec = self.get(name)
        pend = spec.model_partial()
        if pend and name:
            self.diag(
                "V602",
                f"op reads {name!r}, a PARTIAL sum over mesh axis(es) "
                f"{sorted(pend)} that no reduction collective has "
                f"completed — the value is 1/degree of the true result "
                f"on every rank (a row-parallel allreduce was dropped "
                f"or mis-placed)", op=op, op_idx=op_idx, var=name)
            for a in pend:
                spec = spec.cleared(a)
            if not self.collect:
                return spec
            # persist the clearing so downstream ops don't cascade
            if name not in self.pinned:
                self.specs[name] = spec
        return spec

    # -- transfer functions --------------------------------------------------
    def transfer(self, op: OpDesc, op_idx: int):
        t = op.type
        if t in ("feed", "fetch"):
            return
        if t.endswith("_grad") or _is_optimize(op):
            # backward/optimizer tails: cotangent slot conventions and
            # in-place sharded updates are out of scope here (V2xx/V3xx
            # own them) — outputs default replicated, no diagnostics
            for n in op.output_names():
                self.set(n, _REPL)
            return

        if t in _COPY_OPS:
            return self._copy(op, op_idx)
        if t in _EW_BINARY or t == "where":
            return self._elementwise(op, op_idx)
        if t == "sum":
            return self._ew_join(op, op_idx, op.inputs.get("X", []))
        if t == "mul":
            return self._mul(op, op_idx)
        if t == "int8_matmul":
            return self._int8_matmul(op, op_idx)
        if t == "matmul":
            return self._matmul(op, op_idx)
        if t in ("reshape", "reshape2"):
            return self._reshape(op, op_idx)
        if t in ("transpose", "transpose2"):
            return self._transpose(op, op_idx)
        if t in ("softmax", "log_softmax"):
            return self._softmax(op, op_idx)
        if t == "softmax_with_cross_entropy":
            return self._softmax_xent(op, op_idx)
        if t == "layer_norm":
            return self._layer_norm(op, op_idx)
        if t in _REDUCE_OPS:
            return self._reduce(op, op_idx)
        if t in _REDUCTION_COLLECTIVES:
            return self._reduction_collective(op, op_idx)
        if t in _GATHER_COLLECTIVES:
            return self._gather(op, op_idx)
        if t == "c_split":
            return self._split_collective(op, op_idx)
        if t in ("c_broadcast", "broadcast"):
            x = _first(op.inputs.get("X", []))
            self._consume(op, op_idx, x)
            self.set(_first(op.outputs.get("Out", [])), _REPL)
            return
        if t == "flash_attention":
            q = _first(op.inputs.get("Q", []))
            spec = self._consume(op, op_idx, q)
            self.set(_first(op.outputs.get("Out", [])), spec)
            return
        if t == "concat":
            return self._concat(op, op_idx)
        # unknown op: partial reads still gate; model-sharded inputs
        # taint the outputs rather than guessing a layout
        model_in = False
        for n in op.input_names():
            spec = self._consume(op, op_idx, n)
            if spec.model_axes() or n in self.tainted:
                model_in = True
        for n in op.output_names():
            self.set(n, _REPL)
            if model_in:
                self.taint(n)

    # -- per-family rules ----------------------------------------------------
    def _copy(self, op: OpDesc, op_idx: int):
        x = _first(op.inputs.get("X", []))
        spec = self._consume(op, op_idx, x)
        out = _first(op.output_names())
        self.set(out, spec)
        if x in self.tainted:
            self.taint(out)

    def _align(self, out_rank: int, in_rank: int, axis_attr: int) -> int:
        """Fluid elementwise broadcast: Y dim j aligns to X dim
        offset+j, offset = axis attr (or trailing alignment).  The axis
        attr only positions the lower-rank (broadcast) operand — a
        full-rank operand always aligns at 0, so a bias add with
        axis=rank-1 must not shift the activation's own dims."""
        if out_rank is not None and in_rank >= out_rank:
            return 0
        if axis_attr is not None and axis_attr >= 0:
            return int(axis_attr)
        return max(0, out_rank - in_rank)

    def _ew_join(self, op: OpDesc, op_idx: int, names):
        out = _first(op.output_names())
        out_shape = _shape_of(self.block, out)
        out_rank = len(out_shape) if out_shape is not None else None
        joined: Dict[int, str] = {}
        conflict = None
        tainted = False
        for n in names:
            spec = self._consume(op, op_idx, n)
            tainted |= n in self.tainted
            in_shape = _shape_of(self.block, n)
            in_rank = len(in_shape) if in_shape is not None else \
                len(spec.spec)
            off = self._align(out_rank if out_rank is not None else in_rank,
                              in_rank, op.attrs.get("axis", -1)
                              if op.type in _EW_BINARY else -1)
            for j in range(len(spec.spec)):
                a = spec.spec[j]
                if not a:
                    continue
                d = off + j
                prev = joined.get(d)
                if prev is not None and prev != a and \
                        a in MODEL_AXES and prev in MODEL_AXES:
                    conflict = (d, prev, a, n)
                joined[d] = a
        # one operand sharded on a model axis where another operand
        # carries a real (>1) extent replicated: the kernel would add a
        # local shard to a full tensor — a layout conflict
        for n in names:
            spec = self.get(n)
            in_shape = _shape_of(self.block, n)
            if in_shape is None:
                continue
            in_rank = len(in_shape)
            off = self._align(out_rank if out_rank is not None else in_rank,
                              in_rank, op.attrs.get("axis", -1)
                              if op.type in _EW_BINARY else -1)
            for d, a in joined.items():
                if a not in MODEL_AXES:
                    continue
                j = d - off
                if 0 <= j < in_rank and spec.axis_at(j) != a and \
                        int(in_shape[j]) not in (1,) and \
                        int(in_shape[j]) >= 0 and n not in self.tainted:
                    # a -1 (batch) dim can't be a feature shard target;
                    # skip unknown extents to stay conservative
                    self.diag(
                        "V601",
                        f"elementwise {op.type!r} mixes a {a!r}-sharded "
                        f"operand with {n!r}, replicated over the same "
                        f"dim (extent {in_shape[j]}): each rank would "
                        f"combine a local shard with a full tensor",
                        op=op, op_idx=op_idx, var=n)
        if conflict is not None:
            d, a1, a2, n = conflict
            self.diag(
                "V601",
                f"elementwise {op.type!r} operands disagree on dim {d} "
                f"layout ({a1!r} vs {a2!r})", op=op, op_idx=op_idx, var=n)
        if out_rank is None and joined:
            out_rank = max(joined) + 1
        spec_list = [None] * (out_rank or 0)
        for d, a in joined.items():
            if d < len(spec_list):
                spec_list[d] = a
        self.set(out, LayoutSpec(spec_list))
        if tainted:
            self.taint(out)

    def _elementwise(self, op: OpDesc, op_idx: int):
        names = [n for slot in ("Condition", "X", "Y")
                 for n in op.inputs.get(slot, [])]
        if not names:
            names = op.input_names()
        self._ew_join(op, op_idx, names)

    def _mul(self, op: OpDesc, op_idx: int):
        """fluid `mul`: X flattened at x_num_col_dims (m), Y at
        y_num_col_dims (k).  Out = X[:m] ⊗ Y[k:]; contraction = X[m:]
        against Y[:k].  The Megatron contracts live here: a
        column-parallel weight (Y out-dim sharded) shards the output
        features; a row-parallel weight (Y in-dim sharded) demands a
        matching feature-sharded X and mints a PARTIAL output."""
        x = _first(op.inputs.get("X", []))
        y = _first(op.inputs.get("Y", []))
        out = _first(op.outputs.get("Out", []))
        m = int(op.attrs.get("x_num_col_dims", 1))
        k = int(op.attrs.get("y_num_col_dims", 1))
        self._mul_like(op, op_idx, x, y, out, m, k)

    def _int8_matmul(self, op: OpDesc, op_idx: int):
        """Weight-only int8 matmul (the serving decode stamp): X
        contracts its LAST dim against W [K, N] — `mul` semantics with
        m = rank(X) - 1, k = 1, so the Megatron col/row contracts carry
        over unchanged.  WScale is per-out-channel: it must shard with
        W's out dim (column-parallel) or stay replicated
        (row-parallel); anything else rescales one chip's channels
        with another's scales."""
        x = _first(op.inputs.get("X", []))
        w = _first(op.inputs.get("W", []))
        out = _first(op.outputs.get("Out", []))
        s = _first(op.inputs.get("WScale", []))
        ws = self.get(w)
        a_col = next((a for j, a in enumerate(ws.spec)
                      if a in MODEL_AXES and j >= 1), None)
        if s is not None:
            ss = self._consume(op, op_idx, s)
            if ss.axis_at(0) != a_col and s not in self.tainted \
                    and w not in self.tainted:
                self.diag(
                    "V601",
                    f"int8_matmul scale {s!r} is laid out "
                    f"{ss.render()} but weight {w!r}'s out-channels "
                    f"are {'sharded over ' + repr(a_col) if a_col else 'replicated'}"
                    f" — per-channel dequant would apply the wrong "
                    f"chip's scales", op=op, op_idx=op_idx, var=s)
        for n in op.inputs.get("Bias", []):
            self._consume(op, op_idx, n)
        x_shape = _shape_of(self.block, x)
        xs = self.get(x)
        rank = len(x_shape) if x_shape is not None \
            else max(len(xs.spec), 2)
        self._mul_like(op, op_idx, x, w, out, rank - 1, 1)

    def _mul_like(self, op: OpDesc, op_idx: int, x, y, out,
                  m: int, k: int):
        xs = self._consume(op, op_idx, x)
        ys = self._consume(op, op_idx, y)

        a_x = next((a for j, a in enumerate(xs.spec)
                    if a in MODEL_AXES and j >= m), None)
        a_row = next((a for j, a in enumerate(ys.spec)
                      if a in MODEL_AXES and j < k), None)
        a_col = next((a for j, a in enumerate(ys.spec)
                      if a in MODEL_AXES and j >= k), None)

        partial: Set[str] = set()
        if a_row and a_x == a_row:
            partial.add(a_row)       # proper row-parallel contraction
        elif a_row and not (x in self.tainted):
            self.diag(
                "V601",
                f"row-parallel weight {y!r} (in-features sharded over "
                f"{a_row!r}) consumes {x!r} whose contraction dims are "
                f"{'sharded over ' + repr(a_x) if a_x else 'replicated'}"
                f" — each rank would contract the FULL input against "
                f"its weight shard and the reduced sum double-counts "
                f"(feed it a column-parallel output)",
                op=op, op_idx=op_idx, var=x)
            partial.add(a_row)
        elif a_x and not a_row and y is not None and \
                x not in self.tainted:
            self.diag(
                f"V601",
                f"op contracts {x!r}, feature-sharded over {a_x!r}, "
                f"against replicated weight {y!r}: each rank sees only "
                f"1/degree of the features (missing gather, or the "
                f"weight lost its row-parallel annotation)",
                op=op, op_idx=op_idx, var=x)

        out_spec = list(xs.spec[:m]) + [None]
        # Y's out dims land at out dim m.. ; y dims k.. map in order
        y_shape = _shape_of(self.block, y)
        y_rank = len(y_shape) if y_shape is not None else len(ys.spec)
        for j in range(k, max(y_rank, len(ys.spec))):
            a = ys.axis_at(j)
            d = m + (j - k)
            while len(out_spec) <= d:
                out_spec.append(None)
            out_spec[d] = a
        self.set(out, LayoutSpec(out_spec, partial))
        if x in self.tainted or y in self.tainted:
            self.taint(out)

    def _matmul(self, op: OpDesc, op_idx: int):
        x = _first(op.inputs.get("X", []))
        y = _first(op.inputs.get("Y", []))
        out = _first(op.outputs.get("Out", []))
        tx = bool(op.attrs.get("transpose_X"))
        ty = bool(op.attrs.get("transpose_Y"))
        xs = self._consume(op, op_idx, x)
        ys = self._consume(op, op_idx, y)
        x_shape = _shape_of(self.block, x)
        y_shape = _shape_of(self.block, y)
        if x_shape is None or y_shape is None or len(x_shape) < 2 or \
                len(y_shape) < 2:
            self.set(out, _REPL)
            if xs.model_axes() or ys.model_axes():
                self.taint(out)
            return
        rx, ry = len(x_shape), len(y_shape)
        out_rank = max(rx, ry)
        # batch dims broadcast-align from the TRAILING side (out dim i
        # ↔ x dim i-(out_rank-rx) ↔ y dim i-(out_rank-ry)); a
        # rank-mismatched operand simply has no counterpart for the
        # leading out dims
        out_spec: List[Optional[str]] = [None] * out_rank
        conflict_var = None
        for i in range(out_rank - 2):
            ix, iy = i - (out_rank - rx), i - (out_rank - ry)
            xa = xs.axis_at(ix) if ix >= 0 else None
            ya = ys.axis_at(iy) if iy >= 0 else None
            if xa and ya and xa != ya and xa in MODEL_AXES and \
                    ya in MODEL_AXES:
                conflict_var = x
            out_spec[i] = xa or ya
        if conflict_var:
            self.diag(
                "V601",
                f"matmul batch dims of {x!r} and {y!r} are sharded over "
                f"different mesh axes", op=op, op_idx=op_idx,
                var=conflict_var)
        xc = rx - 2 if tx else rx - 1            # x contraction dim
        yc = ry - 1 if ty else ry - 2            # y contraction dim
        xo = rx - 1 if tx else rx - 2            # x out (row) dim
        yo = ry - 2 if ty else ry - 1            # y out (col) dim
        partial: Set[str] = set()
        ca, cb = xs.axis_at(xc), ys.axis_at(yc)
        if ca and ca in MODEL_AXES and ca == cb:
            partial.add(ca)
        elif (ca in MODEL_AXES or cb in MODEL_AXES) and ca != cb and \
                x not in self.tainted and y not in self.tainted:
            one = ca if ca in MODEL_AXES else cb
            self.diag(
                "V601",
                f"matmul contraction dim sharded over {one!r} on one "
                f"operand only ({x!r} vs {y!r}): the local products "
                f"contract mismatched slices", op=op, op_idx=op_idx,
                var=x if ca else y)
        out_spec[out_rank - 2] = xs.axis_at(xo)
        out_spec[out_rank - 1] = ys.axis_at(yo)
        self.set(out, LayoutSpec(out_spec, partial))
        if x in self.tainted or y in self.tainted:
            self.taint(out)

    def _reshape(self, op: OpDesc, op_idx: int):
        x = _first(op.inputs.get("X", []))
        out = _first(op.outputs.get("Out", []))
        spec = self._consume(op, op_idx, x)
        in_shape = _shape_of(self.block, x)
        out_shape = _shape_of(self.block, out) or \
            tuple(op.attrs.get("shape", ()))
        if not spec.axes():
            self.set(out, LayoutSpec((), spec.partial))
            if x in self.tainted:
                self.taint(out)
            return
        if in_shape is None or not out_shape:
            self.set(out, LayoutSpec((), spec.partial))
            self.taint(out)
            return
        # dim tracking: equal-size leading dims map identity; the FIRST
        # dim past that prefix absorbs the split/merge (the attention
        # head split [b,t,H]→[b,t,h,d] and its inverse merge keep the
        # shard on the heads dim).  A shard deeper than that is beyond
        # this tracker — taint instead of guessing.
        p = 0
        while p < min(len(in_shape), len(out_shape)) and \
                (int(in_shape[p]) == int(out_shape[p]) or
                 int(in_shape[p]) < 0 or int(out_shape[p]) < 0):
            # a -1 dim is the symbolic batch — it matches any extent,
            # so a concrete-batch producer feeding a -1-declared
            # reshape still maps the prefix identity
            p += 1
        out_spec: List[Optional[str]] = [None] * len(out_shape)
        lost = False
        for i, a in enumerate(spec.spec):
            if not a:
                continue
            if i < p and i < len(out_spec):
                out_spec[i] = a
            elif i == p and p < len(out_spec):
                out_spec[p] = a
            else:
                lost = a in MODEL_AXES
        self.set(out, LayoutSpec(out_spec, spec.partial))
        if lost or x in self.tainted:
            self.taint(out)
        xshape = _first(op.outputs.get("XShape", []))
        if xshape:
            self.set(xshape, _REPL)

    def _transpose(self, op: OpDesc, op_idx: int):
        x = _first(op.inputs.get("X", []))
        out = _first(op.outputs.get("Out", []))
        spec = self._consume(op, op_idx, x)
        perm = [int(a) for a in (op.attrs.get("axis") or ())]
        if not perm:
            self.set(out, spec)
            return
        out_spec = [spec.axis_at(perm[j]) for j in range(len(perm))]
        self.set(out, LayoutSpec(out_spec, spec.partial))
        if x in self.tainted:
            self.taint(out)
        xshape = _first(op.outputs.get("XShape", []))
        if xshape:
            self.set(xshape, _REPL)

    def _softmax(self, op: OpDesc, op_idx: int):
        x = _first(op.inputs.get("X", []))
        spec = self._consume(op, op_idx, x)
        shape = _shape_of(self.block, x)
        ax = int(op.attrs.get("axis", -1))
        if shape is not None and ax < 0:
            ax += len(shape)
        a = spec.axis_at(ax) if ax >= 0 else None
        if a in MODEL_AXES and x not in self.tainted:
            self.diag(
                "V601",
                f"{op.type} normalizes over dim {ax} of {x!r}, which is "
                f"sharded over {a!r}: each rank normalizes its local "
                f"slice only (gather first, or shard a different dim)",
                op=op, op_idx=op_idx, var=x)
        self.set(_first(op.outputs.get("Out", [])), spec)

    def _softmax_xent(self, op: OpDesc, op_idx: int):
        logits = _first(op.inputs.get("Logits", []))
        spec = self._consume(op, op_idx, logits)
        shape = _shape_of(self.block, logits)
        last = len(shape) - 1 if shape is not None else None
        if last is not None and spec.axis_at(last) in MODEL_AXES and \
                logits not in self.tainted:
            self.diag(
                "V601",
                f"softmax_with_cross_entropy over {logits!r} whose class "
                f"dim is sharded over {spec.axis_at(last)!r}: the local "
                f"softmax normalizes 1/degree of the vocabulary",
                op=op, op_idx=op_idx, var=logits)
        for slot in ("Softmax", "Loss"):
            self.set(_first(op.outputs.get(slot, [])), _REPL)

    def _layer_norm(self, op: OpDesc, op_idx: int):
        x = _first(op.inputs.get("X", []))
        spec = self._consume(op, op_idx, x)
        shape = _shape_of(self.block, x)
        bna = int(op.attrs.get("begin_norm_axis", 1))
        if shape is not None and x not in self.tainted:
            for d in range(bna, len(shape)):
                if spec.axis_at(d) in MODEL_AXES:
                    self.diag(
                        "V601",
                        f"layer_norm normalizes dims {bna}.. of {x!r} "
                        f"but dim {d} is sharded over "
                        f"{spec.axis_at(d)!r}: per-rank statistics "
                        f"diverge from the full-row norm",
                        op=op, op_idx=op_idx, var=x)
                    break
        self.set(_first(op.outputs.get("Y", [])), spec)
        for slot in ("Mean", "Variance"):
            self.set(_first(op.outputs.get(slot, [])), _REPL)

    def _reduce(self, op: OpDesc, op_idx: int):
        x = _first(op.inputs.get("X", []))
        out = _first(op.outputs.get("Out", []))
        spec = self._consume(op, op_idx, x)
        shape = _shape_of(self.block, x)
        rank = len(shape) if shape is not None else len(spec.spec)
        if op.type == "mean" or op.attrs.get("reduce_all"):
            dims = list(range(rank))
        else:
            dims = [int(d) % rank if rank else int(d)
                    for d in (op.attrs.get("dim") or [0])]
        partial = set(spec.partial)
        for d in dims:
            a = spec.axis_at(d)
            if a in MODEL_AXES:
                # summing/averaging a locally-sharded dim yields a
                # partial result pending a cross-rank reduction
                partial.add(a)
        keep = op.attrs.get("keep_dim") or op.attrs.get("keepdim")
        out_spec = [a if (i not in dims) else None
                    for i, a in enumerate(spec.spec)]
        if not keep:
            out_spec = [a for i, a in enumerate(out_spec) if i not in dims]
        self.set(out, LayoutSpec(out_spec, partial))
        if x in self.tainted:
            self.taint(out)

    # -- collectives as layout converters ------------------------------------
    def _reduction_collective(self, op: OpDesc, op_idx: int):
        x = _first(op.inputs.get("X", []))
        out = _first(op.outputs.get("Out", []))
        ring_ax = self._op_axis(op)
        stamp_ax = self._stamped_axis(op)
        spec = self.get(x)
        pend = spec.model_partial()
        if stamp_ax and ring_ax != stamp_ax:
            self.diag(
                "V604",
                f"collective {op.type!r} is stamped for mesh axis "
                f"{stamp_ax!r} but rides ring "
                f"{int(op.attrs.get('ring_id', 0))} "
                f"({ring_ax!r}): the reduction completes over the wrong "
                f"device group", op=op, op_idx=op_idx, var=x)
        if pend and ring_ax not in pend:
            self.diag(
                "V604",
                f"{op.type!r} reduces over {ring_ax!r} but its operand "
                f"{x!r} is partial over {sorted(pend)}: the pending "
                f"sum is never completed on the right axis",
                op=op, op_idx=op_idx, var=x)
            # clear anyway so the miss reports here, not at every
            # downstream read
            new = spec
            for a in pend:
                new = new.cleared(a)
            self.set(out, new)
            return
        if ring_ax in MODEL_AXES:
            if ring_ax in spec.axes():
                self.diag(
                    "V604",
                    f"{op.type!r} reduces over {ring_ax!r} but {x!r} is "
                    f"SHARDED over that axis: ranks would sum disjoint "
                    f"slices elementwise", op=op, op_idx=op_idx, var=x)
            elif not pend and x not in self.tainted:
                self.diag(
                    "V603",
                    f"{op.type!r} on the {ring_ax!r} ring reduces "
                    f"{x!r}, which propagation proves complete (not a "
                    f"partial sum): the program pays "
                    f"2(g-1)/g wire for a no-op (or scales the value "
                    f"by the ring degree)", op=op, op_idx=op_idx, var=x)
        new = spec.cleared(ring_ax) if ring_ax else spec
        self.set(out, new)
        if x in self.tainted:
            self.taint(out)
        self._reshard_row(op, op_idx, ring_ax, x, spec, new)

    def _gather(self, op: OpDesc, op_idx: int):
        x = _first(op.inputs.get("X", []))
        out = _first(op.outputs.get("Out", []))
        ring_ax = self._op_axis(op)
        stamp_ax = self._stamped_axis(op)
        spec = self._consume(op, op_idx, x)
        if stamp_ax and ring_ax != stamp_ax:
            self.diag(
                "V604",
                f"gather {op.type!r} is stamped for mesh axis "
                f"{stamp_ax!r} but rides ring "
                f"{int(op.attrs.get('ring_id', 0))} ({ring_ax!r})",
                op=op, op_idx=op_idx, var=x)
        if ring_ax in MODEL_AXES:
            if ring_ax in spec.axes():
                new = spec.without_axis(ring_ax)
            else:
                if x not in self.tainted:
                    self.diag(
                        "V603",
                        f"{op.type!r} gathers {x!r} over {ring_ax!r}, "
                        f"but propagation proves it already replicated "
                        f"on that axis: the program pays (g-1)× wire "
                        f"for an implicit reshard it does not need",
                        op=op, op_idx=op_idx, var=x)
                new = spec
        else:
            # dp-ring gathers (ZeRO publishes/JIT gathers) re-replicate
            new = spec.without_axis("dp") if ring_ax == "dp" else spec
        self.set(out, new)
        if x in self.tainted:
            self.taint(out)
        self._reshard_row(op, op_idx, ring_ax, x, spec, new)

    def _split_collective(self, op: OpDesc, op_idx: int):
        x = _first(op.inputs.get("X", []))
        out = _first(op.outputs.get("Out", []))
        ring_ax = self._op_axis(op)
        spec = self._consume(op, op_idx, x)
        new = spec
        if ring_ax in MODEL_AXES:
            shape = _shape_of(self.block, out) or \
                _shape_of(self.block, x)
            last = (len(shape) - 1) if shape else 0
            new = spec.with_axis(last, ring_ax)
        self.set(out, new)
        self._reshard_row(op, op_idx, ring_ax, x, spec, new)

    def _concat(self, op: OpDesc, op_idx: int):
        names = op.inputs.get("X", [])
        specs = [self._consume(op, op_idx, n) for n in names]
        out = _first(op.outputs.get("Out", []))
        ax = int(op.attrs.get("axis", 0))
        if specs and all(s == specs[0] for s in specs) and \
                specs[0].axis_at(ax) is None:
            self.set(out, specs[0])
        else:
            self.set(out, _REPL)
            if any(s.model_axes() for s in specs):
                self.taint(out)

    # -- backward (fill-in) sweep --------------------------------------------
    def backward_fill(self, op: OpDesc):
        """The backward leg of the fixed point: layout-preserving and
        dim-permuting ops pull a consumer-side spec back onto inputs no
        forward rule assigned (rule-seeded intermediates, vars whose
        producer the tracker had to taint)."""
        t = op.type
        if t in _COPY_OPS:
            x = _first(op.inputs.get("X", []))
            out = _first(op.output_names())
            if x and x not in self.specs and out in self.specs:
                spec = self.specs[out]
                if spec.axes():
                    self.set(x, LayoutSpec(spec.spec))
        elif t in ("transpose", "transpose2"):
            x = _first(op.inputs.get("X", []))
            out = _first(op.outputs.get("Out", []))
            perm = [int(a) for a in (op.attrs.get("axis") or ())]
            if x and perm and x not in self.specs and out in self.specs:
                spec = self.specs[out]
                if spec.axes():
                    inv: List[Optional[str]] = [None] * len(perm)
                    for j, p in enumerate(perm):
                        if p < len(inv):
                            inv[p] = spec.axis_at(j)
                    self.set(x, LayoutSpec(inv))

    # -- the propagation loop -------------------------------------------------
    def run(self) -> int:
        iters = 0
        while iters < 16:
            iters += 1
            self._changed = False
            for i, op in enumerate(self.block.ops):
                self.transfer(op, i)
            for op in reversed(self.block.ops):
                self.backward_fill(op)
            if not self._changed:
                break
        self.collect = True
        for i, op in enumerate(self.block.ops):
            self.transfer(op, i)
        self._check_divisibility()
        return iters

    def _local_shape_region(self) -> Set[str]:
        """Vars whose DECLARED shapes are build-time LOCAL shards: the
        downstream closure of every head-split reshape whose known-dim
        numel drops by exactly the degree of a model axis THE OUTPUT IS
        SHARDED OVER (parallel_attention reshapes [b, t, H] globals
        into [b, t, H/tp/d, d] locals — the division is baked into the
        target shape).  V605 must not judge these extents against the
        mesh degree: they are already divided.  The closure ends where
        the local representation does — at the reduction/gather
        collectives that return values to the global representation
        (the row-parallel g, tensor-ring gathers), so vars after the
        block boundary are judged normally again."""
        local: Set[str] = set()
        for op in self.block.ops:
            if op.type in _REDUCTION_COLLECTIVES or \
                    op.type in _GATHER_COLLECTIVES:
                continue  # outputs are global-representation again
            seeded = False
            if op.type in ("reshape", "reshape2"):
                x = _first(op.inputs.get("X", []))
                out = _first(op.outputs.get("Out", []))
                in_shape = _shape_of(self.block, x)
                out_shape = _shape_of(self.block, out)
                out_axes = self.get(out).model_axes() if out else set()
                if in_shape is not None and out_shape is not None and \
                        out_axes:
                    pin = pout = 1
                    for v in in_shape:
                        if int(v) > 0:
                            pin *= int(v)
                    for v in out_shape:
                        if int(v) > 0:
                            pout *= int(v)
                    for a in out_axes:
                        g = int(self.mesh.get(a) or 0)
                        if g > 1 and pout > 0 and pin == pout * g:
                            seeded = True
            if seeded or any(n in local for n in op.input_names()):
                local.update(n for n in op.output_names() if n)
        return local

    def _check_divisibility(self):
        """V605: a model-axis shard whose declared dim does not divide
        the mesh degree of its axis.  Vars in the build-time-local
        region (see `_local_shape_region`) are exempt — their extents
        already encode the division."""
        producers: Dict[str, Tuple[int, OpDesc]] = {}
        for i, op in enumerate(self.block.ops):
            for n in op.output_names():
                if n and n not in producers:
                    producers[n] = (i, op)
        local = self._local_shape_region()
        for name, spec in sorted(self.specs.items()):
            if name in local:
                continue
            for d, a in enumerate(spec.spec):
                if a not in MODEL_AXES:
                    continue
                g = int(self.mesh.get(a) or 0)
                if g <= 1:
                    continue
                shape = _shape_of(self.block, name)
                if shape is None or d >= len(shape):
                    continue
                s = int(shape[d])
                if s > 0 and s % g != 0:
                    i, op = producers.get(name, (None, None))
                    self.diag(
                        "V605",
                        f"var {name!r} dim {d} (extent {s}) is sharded "
                        f"over {a!r} but does not divide the mesh "
                        f"degree {g}: the shard split is ill-formed",
                        op=op, op_idx=i, var=name)


# ---------------------------------------------------------------------------
# seeding + entry point
# ---------------------------------------------------------------------------
def _infer_mesh_shape(program: Program) -> Dict[str, int]:
    """Best-effort mesh degrees when the caller passes none: the mp
    degree from the builders' ``tp_degree`` stamps / registry entries,
    the dp degree from the recorded ZeRO plan or collective stamps."""
    mesh: Dict[str, int] = {}
    from ..core.pass_framework import applied_passes
    for e in applied_passes(program):
        if e.get("pass") == "tensor_parallel" and e.get("tp_degree"):
            mesh["mp"] = max(mesh.get("mp", 0), int(e["tp_degree"]))
    for b in program.blocks:
        for op in b.ops:
            if op.attrs.get("tp_degree"):
                mesh["mp"] = max(mesh.get("mp", 0),
                                 int(op.attrs["tp_degree"]))
            if op.attrs.get("dp_degree"):
                mesh["dp"] = max(mesh.get("dp", 0),
                                 int(op.attrs["dp_degree"]))
    plan = getattr(program, "_zero_shard_plan", None)
    if plan is not None and getattr(plan, "buckets", None):
        mesh["dp"] = int(plan.dp_degree)
    return mesh


def _seed(engine: _Engine, rules) -> None:
    program = engine.program
    # 1. builder annotations: dist_attr = [axis, dim]
    for b in program.blocks:
        for v in b.vars.values():
            da = v.attrs.get("dist_attr")
            if da:
                axis, dim = _canon(da[0]), int(da[1])
                engine.pin(v.name, LayoutSpec(
                    [None] * dim + [axis]))
            elif v.attrs.get("dp_shard"):
                engine.pin(v.name, LayoutSpec(("dp",)))
    # 2. caller partition rules over qualified names (param:/var:),
    #    first match wins; rule specs use the partition_spec spelling
    if rules:
        from ..distributed.partition_spec import match_partition_rules
        names, backing = [], {}
        for b in program.blocks:
            for v in b.vars.values():
                q = (f"param:{v.name}" if v.is_parameter
                     else f"var:{v.name}")
                names.append(q)
                backing[q] = v.name
        assignment = match_partition_rules(rules, names)
        for q, spec in assignment.specs.items():
            if assignment.rule_of.get(q) is None:
                continue  # fallback no-match: leave to propagation
            name = backing[q]
            if name in engine.pinned:
                continue  # builder annotations outrank name rules
            engine.pin(name, LayoutSpec([_canon(a) for a in spec]))


def propagate_shardings(program: Program,
                        mesh_shape: Optional[Dict[str, int]] = None,
                        rules=None,
                        batch: Optional[int] = None) -> ShardingLayout:
    """Infer a full SPMD layout for `program` over a named 2-D mesh and
    report V6xx layout diagnostics plus the priced reshard table.

    * ``mesh_shape`` — axis degrees, e.g. ``{"dp": 4, "mp": 2}`` (the
      runtime spelling ``{"dp": 4, "tp": 2}`` is accepted).  Omitted
      axes default to the degrees stamped on the program (builder
      ``tp_degree`` stamps, ZeRO ``dp_degree``); degrees the analyzer
      cannot learn disable the divisibility check (V605) and zero the
      wire pricing for that axis.
    * ``rules`` — ordered partition rules (`distributed.partition_spec`
      spelling) matched against ``param:<name>`` / ``var:<name>``
      qualified names as extra layout seeds; builder ``dist_attr``
      annotations always win.
    * ``batch`` — bind the leading -1 feed dim for wire pricing
      (activations' reshard bytes are batch-proportional; unbound they
      price 0 and the table row records the shapes anyway).

    Returns a `ShardingLayout`: ``specs`` (var → `LayoutSpec`),
    ``diagnostics`` (V601-V605 with op provenance), ``reshard_table``
    (one row per layout-converting collective: var, from-spec, to-spec,
    axis, ring-accounted bytes via `verifier.entry_wire_bytes` at the
    ring's own degree), ``wire_bytes_per_axis()``.

    Wired as level 5 (``"layout"``) of `static.check_program`; the
    auto-parallel planner consumes ``wire_bytes_per_axis`` as the
    mp-ring wire substrate for 2-D plan search.
    """
    inferred = _infer_mesh_shape(program)
    mesh: Dict[str, int] = dict(inferred)
    for k, v in (mesh_shape or {}).items():
        mesh[_canon(k)] = int(v)
    engine = _Engine(program, mesh, batch)
    _seed(engine, rules)
    iters = engine.run()
    return ShardingLayout(engine.specs, engine.diags, engine.reshard,
                          mesh, iters)
