"""Declarative partition-spec engine: regex rules over var names decide
the sharding plan.

Counterpart of paddle_tpu/distributed/partition_spec.py.  The rule
engine (`PartitionRule`, `match_partition_rules`, `zero_stage_rules`,
`tensor_parallel_rules`, `build_sharding_specs`) is the JAX package's,
rule for rule and spec for spec.  Only the placements differ: the JAX
package hands `shard_map` a `jax.sharding.PartitionSpec` per var; the
port's `state_partition_specs` / `feed_partition_specs` give each var a
placement of its own spelling, ``"replicated"`` or ``(axis, dim)`` (dim
`dim` cut over the ranks of mesh axis `axis`, "dp" or "tp"), which
`CompiledProgram` consumes to keep each rank's shard in its scope.

Reference pattern: the `match_partition_rules` idiom from the pjit
training stacks (SNIPPETS.md [2]) — an ordered list of
``(regex, PartitionSpec)`` pairs is matched against every leaf name and
the first hit wins, scalars are never partitioned, and a name no rule
covers is an explicit decision, not an accident.  SNIPPETS.md [1] is the
same idea from the measurement side: the pjit sharding schemes being
priced are *data*, not code.

This module is the declarative layer the ZeRO pass family
(`distributed/sharding.py` stages 1-3) selects its surface through:
instead of each stage hard-coding "slots shard, params don't", every
stage IS a rule list over qualified var names, and a new model shape
(or a model that wants its embedding replicated under ZeRO-3) gets a
plan by *prepending a rule*, not by writing a new pass.

Qualified names
---------------
Rules match against ``"<category>:<var name>"`` so one ordered rule list
can speak about every class of trainable state at once:

  * ``param:<name>``     — a trainable parameter (ZeRO-3 shards these);
  * ``slot:<name>``      — an optimizer accumulator (moments, velocity —
                           ZeRO-1 shards these);
  * ``grad_acc:<name>``  — a gradient-merge accumulator (ZeRO-2 keeps
                           these reduce-scattered at 1/N);
  * ``scalar:<name>``    — shape-[1] state (beta pows, counters): never
                           partitioned, mirroring the exemplar's
                           "don't partition scalar values" guard.

Specs are mesh-axis tuples in the `jax.sharding.PartitionSpec` spelling:
``DP_SHARD = ("dp",)`` (shard dim 0 over the data-parallel axis) and
``REPLICATED = ()``.  `CompiledProgram` turns the stamps they lead to
into placements (`state_partition_specs`).

Contracts (tests/test_partition_spec.py):

  * **precedence** — first matching rule wins, exactly like the
    exemplar's ``re.search`` loop;
  * **no-match fallback** — a name no rule matches is REPLICATED and
    recorded in ``PartitionAssignment.unmatched`` (pass
    ``require_match=True`` to make it an error instead);
  * **over-match refusal** — a *strict* rule (user-written; the built-in
    stage defaults are non-strict) that assigns a sharded spec to a var
    the pass cannot actually partition (unsupported optimizer, sparse
    gradient, explicit MasterParam, dynamic shape) raises ``ValueError``
    naming the rule and the var, so a plan never silently claims memory
    the rewrite will not deliver.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "REPLICATED", "DP_SHARD", "MP_COL", "MP_ROW", "PLACE_REPLICATED",
    "Mesh", "PartitionRule",
    "PartitionAssignment", "match_partition_rules", "zero_stage_rules",
    "tensor_parallel_rules", "build_sharding_specs",
    "state_partition_specs", "feed_partition_specs",
]

# spec spelling: tuple of mesh-axis names per dim (None = replicated dim,
# trailing Nones may be omitted), () = fully replicated
REPLICATED: Tuple = ()
DP_SHARD: Tuple = ("dp",)
# tensor-parallel (Megatron) weight splits over the model axis "mp":
# column-parallel fc shards the OUT features (dim 1), row-parallel fc
# shards the IN features (dim 0).  The layout analyzer
# (static/layout_analysis.py) consumes these as seed specs; the runtime
# "tp" mesh axis (distributed/tensor_parallel.py dist_attr) is the same
# axis under its CompiledProgram name.
MP_COL: Tuple = (None, "mp")
MP_ROW: Tuple = ("mp", None)

# a var's placement on the ranks: whole on every rank, or (axis, dim)
PLACE_REPLICATED = "replicated"


class Mesh:
    """The ranks' grid as the placements read it: axis name -> size, in
    order ("dp", then "tp"; the tp index is the fast one)."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = {str(k): int(v) for k, v in shape.items()}
        self.axis_names = tuple(self.shape)

    def __repr__(self):
        return f"Mesh({self.shape})"


def _placed(spec: List) -> object:
    """(axis, dim) of the one sharded dim of a per-dim spec list, or
    PLACE_REPLICATED."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            return (axis, dim)
    return PLACE_REPLICATED


class PartitionRule:
    """One ``(pattern, spec)`` rule.  ``strict=True`` (the default for
    user-written rules) arms over-match refusal: matching a var the pass
    cannot shard is an error, not a silent fallback."""

    __slots__ = ("pattern", "spec", "strict", "_rx")

    def __init__(self, pattern: str, spec: Sequence, strict: bool = True):
        self.pattern = str(pattern)
        self.spec = tuple(spec)
        self.strict = bool(strict)
        self._rx = re.compile(self.pattern)

    def matches(self, name: str) -> bool:
        return self._rx.search(name) is not None

    def __repr__(self):
        return (f"PartitionRule({self.pattern!r}, {self.spec!r}"
                f"{', strict' if self.strict else ''})")


def _as_rule(r) -> PartitionRule:
    if isinstance(r, PartitionRule):
        return r
    if isinstance(r, (tuple, list)) and len(r) in (2, 3):
        return PartitionRule(r[0], r[1], *(r[2:] or ()))
    raise TypeError(
        f"partition rule must be PartitionRule or (pattern, spec[, "
        f"strict]), got {r!r}")


class PartitionAssignment:
    """The engine's verdict for one program: qualified name → spec, with
    provenance (which rule decided each name) and the no-match record."""

    def __init__(self, specs: Dict[str, Tuple],
                 rule_of: Dict[str, Optional[PartitionRule]],
                 unmatched: List[str]):
        self.specs = dict(specs)
        self.rule_of = dict(rule_of)
        self.unmatched = list(unmatched)

    def spec(self, qualified: str) -> Tuple:
        return self.specs.get(qualified, REPLICATED)

    def sharded(self, qualified: str) -> bool:
        return bool(self.specs.get(qualified))

    def __repr__(self):
        n_sharded = sum(1 for s in self.specs.values() if s)
        return (f"PartitionAssignment({len(self.specs)} vars, "
                f"{n_sharded} sharded, {len(self.unmatched)} unmatched)")


def match_partition_rules(rules: Iterable, names: Iterable[str],
                          numels: Optional[Dict[str, int]] = None,
                          require_match: bool = False) \
        -> PartitionAssignment:
    """Match ordered `rules` against qualified `names`; first hit wins.

    ``numels`` (qualified name → element count) arms the exemplar's
    scalar guard: a var with <= 1 element is REPLICATED no matter what
    rule matches (beta-pow scalars must never be split).  A name no
    rule matches falls back to REPLICATED and is recorded in
    ``unmatched`` — unless ``require_match=True``, which raises instead
    (the exemplar's ``Partition rule not found`` behaviour).
    """
    rules = [_as_rule(r) for r in rules]
    numels = numels or {}
    specs: Dict[str, Tuple] = {}
    rule_of: Dict[str, Optional[PartitionRule]] = {}
    unmatched: List[str] = []
    for name in names:
        if numels.get(name, 2) <= 1:
            specs[name] = REPLICATED  # scalars are never partitioned
            rule_of[name] = None
            continue
        for rule in rules:
            if rule.matches(name):
                specs[name] = rule.spec
                rule_of[name] = rule
                break
        else:
            if require_match:
                raise ValueError(
                    f"partition rule not found for var: {name!r}")
            specs[name] = REPLICATED
            rule_of[name] = None
            unmatched.append(name)
    return PartitionAssignment(specs, rule_of, unmatched)


def zero_stage_rules(stage: int) -> List[PartitionRule]:
    """The ZeRO ladder as data: the default rule list for each stage.

    stage 0 — pure DP, everything replicated;
    stage 1 — optimizer slots shard over dp;
    stage 2 — slots + gradient(-merge) accumulators shard;
    stage 3 — slots + grad accumulators + the parameters themselves.

    Every stage is the previous stage plus one rule; the rules are
    non-strict (a var the pass can't shard degrades to replicated with
    the pass's own warning) so the DEFAULTS never refuse a model —
    refusal is reserved for user rules that name vars explicitly.
    """
    stage = int(stage)
    if stage not in (0, 1, 2, 3):
        raise ValueError(f"ZeRO stage must be 0-3, got {stage}")
    rules: List[PartitionRule] = [
        PartitionRule(r"^scalar:", REPLICATED, strict=False),
    ]
    if stage >= 3:
        rules.append(PartitionRule(r"^param:", DP_SHARD, strict=False))
    if stage >= 2:
        rules.append(PartitionRule(r"^grad_acc:", DP_SHARD, strict=False))
    if stage >= 1:
        rules.append(PartitionRule(r"^slot:", DP_SHARD, strict=False))
    rules.append(PartitionRule(r".*", REPLICATED, strict=False))
    return rules


def tensor_parallel_rules() -> List[PartitionRule]:
    """The Megatron col/row split discipline as data: seed rules for the
    layout analyzer (`static.propagate_shardings`) matching the default
    parameter names `distributed/tensor_parallel.py`'s builders mint
    (``col_parallel_fc_<n>.w_<k>`` etc.).  Parameters the builders
    annotated with ``dist_attr`` don't need these — the rules exist for
    programs rebuilt from serialized IR that predates the annotation,
    and as the vocabulary user rule lists extend (prepend a rule to
    shard a custom projection).  Non-strict: a name that matches but
    cannot shard degrades to replicated."""
    return [
        PartitionRule(r"^param:col_parallel_fc.*\.w_", MP_COL,
                      strict=False),
        PartitionRule(r"^param:col_parallel_fc.*\.b_", ("mp",),
                      strict=False),
        PartitionRule(r"^param:row_parallel_fc.*\.w_", MP_ROW,
                      strict=False),
        PartitionRule(r"^param:row_parallel_fc.*\.b_", REPLICATED,
                      strict=False),
    ]


def build_sharding_specs(program, stage: int,
                         extra_rules: Iterable = ()) -> PartitionAssignment:
    """Run the (user rules + stage defaults) rule list over `program`'s
    trainable-state surface and return the assignment the ZeRO pass
    executes.

    The shardable surface is exactly what `shard_optimizer_states` can
    partition (shared candidate walk, so the plan never promises what
    the pass can't do): each candidate optimizer op contributes its
    ``param:``, ``slot:`` and ``scalar:`` names; ``grad_acc:`` names are
    the per-bucket gradient accumulators `gradient_merge` would create.
    Params the pass must skip (unsupported optimizer, MasterParam,
    sparse grad, dynamic shape) are still matched — a *strict* rule
    landing a sharded spec on one of them is the over-match refusal.
    """
    from .sharding import _collect_candidates, _SHARDABLE
    rules = [_as_rule(r) for r in extra_rules] + zero_stage_rules(stage)
    block = program.global_block()
    cands = _collect_candidates(block, warn=False)
    cand_params = set()
    names: List[str] = []
    numels: Dict[str, int] = {}

    # NOTE: the scalar never-partition guard applies to the ``scalar:``
    # CATEGORY (beta pows — shape-[1] state that must not be split),
    # not to 1-element params/slots: a [1] bias is concatenated into a
    # bucket, never partitioned alone, so it buckets like anything else.
    for _, op in cands:
        spec = _SHARDABLE[op.type]
        pname = op.inputs["Param"][0]
        cand_params.add(pname)
        names.append(f"param:{pname}")
        names.append(f"grad_acc:{op.inputs['Grad'][0]}")
        for in_slot, _out in spec["slots"]:
            for n in op.inputs.get(in_slot, []):
                if n:
                    names.append(f"slot:{n}")
        for in_slot, _out, _k, _d in spec["scalars"]:
            for n in op.inputs.get(in_slot, []):
                if n:
                    names.append(f"scalar:{n}")
                    numels[f"scalar:{n}"] = 1

    # the UN-shardable surface: matched too, so strict rules can refuse.
    # Params come from the var table; their accumulators come from the
    # accum_of link (an Adamax moment has no _SHARDABLE spec to
    # enumerate, but the optimizer stamped its owner at creation).
    unshardable: set = set()
    for v in block.vars.values():
        if v.is_parameter and v.name not in cand_params:
            q = f"param:{v.name}"
            names.append(q)
            unshardable.add(q)
    for v in block.vars.values():
        owner = v.attrs.get("accum_of")
        if owner and owner not in cand_params:
            q = f"slot:{v.name}"
            names.append(q)
            unshardable.add(q)

    assignment = match_partition_rules(rules, names, numels)
    for q in unshardable:
        rule = assignment.rule_of.get(q)
        if assignment.sharded(q) and rule is not None and rule.strict:
            raise ValueError(
                f"partition rule {rule!r} assigns a sharded spec to "
                f"{q!r}, but the sharding pass cannot partition it "
                f"(unsupported optimizer op, MasterParam slot, sparse "
                f"gradient, or dynamic shape) — over-match refused; "
                f"drop the rule or mark it strict=False")
    return assignment


def state_partition_specs(program, mesh, state_names: Iterable[str]):
    """The placement of each of a program's persistables on the ranks:

    * every ``dp_shard``-marked var (the ZeRO passes' stamped spec) is
      ``("dp", 0)`` — on a dp×tp mesh that cuts the bucket over the dp
      index only, the same on every tp rank of it (each tp rank holds
      and updates the same slot shard — the ZeRO×tp composition's
      placement contract);
    * when the mesh carries a ``tp`` axis, parameters annotated
      ``dist_attr`` (`tensor_parallel.shard_param`) are ``("tp", dim)``
      at their declared dim, and optimizer accumulators inherit their
      param's placement through the ``accum_of`` link (name-prefix +
      equal shape as the legacy fallback);
    * everything else is ``"replicated"``.

    The single consumption point `CompiledProgram` routes through (the
    JAX package's returns the same decisions as PartitionSpecs), so the
    spec the engine decided and the shard a rank keeps can never drift
    apart."""
    block = program.global_block()
    has_tp = "tp" in getattr(mesh, "axis_names", ())
    specs = {}
    annotated = {}
    for n in state_names:
        try:
            v = block.var(n)
        except KeyError:
            specs[n] = PLACE_REPLICATED
            continue
        marked = int(v.attrs.get("dp_shard") or 0)
        if marked:
            dp = mesh.shape["dp"]
            if not v.shape or int(v.shape[0]) % dp != 0:
                raise ValueError(
                    f"ZeRO-sharded var {n!r} (shape {v.shape}) does not "
                    f"divide the mesh dp degree {dp}; re-run "
                    f"shard_optimizer_states for this mesh")
            specs[n] = ("dp", 0)
            continue
        da = v.attrs.get("dist_attr") if has_tp else None
        if da:
            axis, dim = da
            spec = [None] * len(v.shape or ())
            spec[int(dim)] = axis
            specs[n] = _placed(spec)
            annotated[n] = (tuple(v.shape or ()), specs[n])
            continue
        specs[n] = PLACE_REPLICATED
    if annotated:
        # optimizer accumulators inherit their param's tp sharding
        for n in state_names:
            if n in annotated or specs.get(n) != PLACE_REPLICATED:
                continue
            try:
                v = block.var(n)
            except KeyError:
                continue
            shape = tuple(v.shape or ())
            # explicit accumulator→param link (set by
            # Optimizer._add_accumulator) — the old name-prefix+shape
            # heuristic could match an unrelated var whose name
            # happened to extend an annotated param's
            owner = v.attrs.get("accum_of")
            if owner is not None:
                hit = annotated.get(owner)
                if hit is not None and shape == hit[0]:
                    specs[n] = hit[1]
                continue
            for pname, (pshape, pspec) in annotated.items():
                if n.startswith(pname + "_") and shape == pshape:
                    specs[n] = pspec
                    break
    return specs


def feed_partition_specs(program, mesh, feed_names: Iterable[str]):
    """The placement of each of a program's FEEDS — the serving sibling
    of `state_partition_specs`.

    Training feeds are batches: dim 0 splits over the data-parallel
    axis, ``("dp", 0)``, always.  A tensor-parallel decode program's
    per-layer KV-cache feeds shard on the HEAD dim over ``tp``
    (`tensor_parallel.shard_param`'s ``dist_attr`` spelling, stamped on
    the feed var by the decode builder), and its token/position/mask
    feeds stamped ``replicated_feed`` are ``"replicated"``.  Vars the
    program does not declare fall back to ``("dp", 0)``, the training
    contract."""
    block = program.global_block()
    has_tp = "tp" in getattr(mesh, "axis_names", ())
    specs = {}
    for n in feed_names:
        try:
            v = block.var(n)
        except KeyError:
            specs[n] = ("dp", 0)
            continue
        da = v.attrs.get("dist_attr") if has_tp else None
        if da:
            axis, dim = da
            spec = [None] * len(v.shape or ())
            spec[int(dim)] = axis
            specs[n] = _placed(spec)
        elif v.attrs.get("replicated_feed"):
            specs[n] = PLACE_REPLICATED
        else:
            specs[n] = ("dp", 0)
    return specs
