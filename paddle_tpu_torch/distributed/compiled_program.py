"""CompiledProgram.with_data_parallel: data-parallel static training.

Counterpart of paddle_tpu/distributed/compiled_program.py
(`BuildStrategy`, `ExecutionStrategy`, `insert_grad_allreduce`,
`CompiledProgram`).  Both packages rewrite the program the same way,
op for op: a `c_allreduce_sum` (and, under
GradientScaleStrategy.CoeffNumDevice with more than one rank, a
`scale_by_world_size`) on every gradient an optimizer op reads, bf16
casts around it under fp16_allreduce, idempotent where the gradient is
already reduced.  They run it differently.  The JAX package is one
controller tracing the block once under `shard_map` over a mesh; the
port runs one process per rank (`distributed.spawn` / `launch`), each
running the rewritten program eagerly on its own device, and the
collectives go through torch.distributed (ops/kernels/collective.py).
Outside an initialised process group the world is 1.

What each rank does on `Executor.run(compiled, feed, fetch_list)`:

  * **Start.** On the first run over a scope every persistable in it is
    broadcast from rank 0: the counterpart of the mesh's replicated
    state, and the reference's collective-mode start broadcast, so the
    replicas start equal however each scope was filled.
  * **Feed.** Every rank is handed the same global feed, as the JAX
    package's run is, and keeps its dim-0 shard where dim 0 divides by
    the dp degree, the whole array otherwise (the JAX package's
    `place_feed` rule).  `run_steps` shards the per-step axis 1 and
    raises where it does not divide, as the JAX package's scan does.
  * **Seed.** The step seed plus the dp index, as the JAX package
    decorrelates the replicas' draws (the tp ranks of one dp index draw
    alike); under dp × sp that times 7919 plus the sp index.
  * **Fetches.** BuildStrategy.fetch_aggregation "reduce": float fetches
    are the mean over the dp ranks (under dp × sp over the whole world),
    others the max; "concat": gathered along dim 0 in rank order, a
    scalar stacked to [W] (under dp × sp a sequence-sharded fetch first
    gathered along dim 1 over sp, other floats averaged over sp).

`Executor.run_steps(compiled, ...)` under NCCL captures one step, its
collectives and the fetch reduction included, as a CUDA graph and
replays it K times; a failed capture raises.  Under gloo (host
collectives, which a graph cannot hold) and on the CPU the K steps run
eagerly, one `run` each.  A gradient-merge window runs HOISTED where
distributed/scan_window.py can split it and K is a whole number of
windows starting on a window boundary: the commit-free body every step,
the commit tail (optimizer update, ZeRO publish all-gathers, merged
allreduce) once a window, as two captured steps over one set of state
buffers under NCCL, eagerly otherwise; bitwise the unhoisted losses and
state.  PADDLE_TPU_SCAN_HOIST=0 forces the unhoisted form.

The world is a dp × tp grid (BuildStrategy.tensor_parallel_degree = tp,
dp = W / tp): rank r has dp index r // tp and tp index r % tp, the JAX
mesh's `devs.reshape(dp, tp)` order.  Ring 0 is the rank's dp group
(the ranks of its tp index) and TP_RING_ID (102) its tp group (the ranks
of its dp index); every rank makes every group, in the same order.  At
tp = 1 ring 0 is the whole world and TP_RING_ID the identity.  Or it is
a dp × sp grid (BuildStrategy.sequence_parallel_degree = sp): rank r has
dp index r // sp and sp index r % sp, ring 0 is the WHOLE world (the
gradients are partial over batch and sequence shards), SP_RING_ID (101)
the rank's sp group (ring attention's) and TP_RING_ID the identity; a
feed whose declared dim 1 is longer than 1 and divides by sp is cut on
dim 1 over sp too.  sp with tp, and ZeRO under sp, raise as in the JAX
package.

State lives sharded, as the JAX package's `shard_map` places it
(partition_spec.state_partition_specs decides): after the start
broadcast each rank's scope keeps its dp slice of dim 0 of a `dp_shard`
var (ZeRO's buckets, distributed/sharding.py), its tp slice of a
`dist_attr` parameter (tensor_parallel.shard_param) and of the
accumulators that inherit from it, and everything else whole.
`global_state(scope)` gathers a rank's scope back to the global arrays
the JAX package's scope holds.  A scope already holding shards (the
carry function, io.load_params_from_numpy(..., compiled=)) is synced
within the ranks that share each shard.

Elastic programs (distributed/elastic.py): a run is one micro-step of
the window; K = logical_dp / W is resolved from the process group at
each run (`_anchor_elastic`, which also re-anchors the executor's
counters after a topology-shifted restore).  A micro-step's seed is the
GLOBAL step's (one stream a global step) plus its logical rank j W + r,
so every world draws alike; the folded fetches (`<loss>@ELASTIC_AVG`,
the accumulators) are the same on every rank and are handed back as they
are, never averaged over the ranks (that would round differently per
world).  `run_steps` runs K micro-steps a call: one captured micro-step
replayed under NCCL, eager steps under gloo; never hoisted.  Elastic
programs compose with plain dp only: under sp or tp they raise.

Not ported (ROADMAP.md Queue 1, Distribution; raises): sync_batch_norm.
The BuildStrategy knobs
the JAX package leaves to XLA (fusions, memory options,
debug_graphviz_path) are accepted and do nothing here either.
"""
from __future__ import annotations

import contextlib
import copy
import os
import weakref
from typing import Any, Dict, List

import numpy as np
import torch

from ..core.program import Program, OpRole, unique_name
from ..ops.kernels import collective as _kc
from .partition_spec import (Mesh, PLACE_REPLICATED, state_partition_specs,
                             feed_partition_specs)
from .tensor_parallel import TP_RING_ID

__all__ = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy",
           "insert_grad_allreduce"]

_LATER = "ROADMAP.md Queue 1, Distribution"


class ReduceStrategy:
    AllReduce = 0
    Reduce = 1


class GradientScaleStrategy:
    CoeffNumDevice = 0
    One = 1
    Customized = 2


class BuildStrategy:
    """The knobs of details/build_strategy.h, as the JAX package keeps
    them."""
    ReduceStrategy = ReduceStrategy
    GradientScaleStrategy = GradientScaleStrategy

    def __init__(self):
        self.reduce_strategy = ReduceStrategy.AllReduce
        self.gradient_scale_strategy = GradientScaleStrategy.CoeffNumDevice
        self.fuse_all_reduce_ops = True
        self.fuse_all_optimizer_ops = True
        self.fuse_elewise_add_act_ops = True
        self.fuse_bn_act_ops = True
        self.enable_inplace = True
        self.memory_optimize = True
        self.sync_batch_norm = False
        self.num_trainers = 1
        self.trainer_id = 0
        self.nccl_comm_num = 1
        self.use_hierarchical_allreduce = False
        self.hierarchical_allreduce_inter_nranks = 0
        self.enable_sequential_execution = False
        self.remove_unnecessary_lock = True
        self.cache_runtime_context = True
        self.trainers_endpoints = []
        self.debug_graphviz_path = ""
        self.sequence_parallel_degree = 1
        self.tensor_parallel_degree = 1
        # "reduce": float fetches averaged over the ranks, others the max;
        # "concat": gathered along dim 0 (scalars stacked to [W])
        self.fetch_aggregation = "reduce"


class ExecutionStrategy:
    """details/execution_strategy.h, kept for signature parity."""

    class ExecutorType:
        Default = 0
        Experimental = 1

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 100
        self.num_iteration_per_run = 1
        self.allow_op_delay = False
        self.use_thread_barrier = True


# op types a reduced gradient legitimately flows through between the
# reduction collective and the optimizer op's Grad slot (scaling, AMP
# casts, gradient-merge accumulate/mask plumbing, ZeRO bucket plumbing)
_REDUCE_TRANSPARENT_OPS = frozenset((
    "scale_by_world_size", "scale", "cast", "elementwise_add", "where",
    "reshape", "reshape2", "concat", "pad", "slice", "assign",
    "check_finite_and_unscale", "update_loss_scaling",
))
_REDUCE_OPS = frozenset(("c_allreduce_sum", "c_reducescatter",
                         "c_elastic_fold"))


def _grad_already_reduced(producers: Dict[str, List[Any]], name: str,
                          limit: int = 96) -> bool:
    """True when `name`'s producer chain already holds a gradient
    reduction, walking back only through the ops a reduction pass
    inserts (the first real backward op ends the walk).  `producers`
    maps each var to all its writers.  This makes insert_grad_allreduce
    idempotent."""
    seen, frontier = set(), [name]
    while frontier and limit > 0:
        limit -= 1
        n = frontier.pop()
        if n in seen:
            continue
        seen.add(n)
        for op in producers.get(n, ()):
            if op.type in _REDUCE_OPS:
                return True
            if op.type not in _REDUCE_TRANSPARENT_OPS:
                continue
            frontier.extend(op.input_names())
    return False


def insert_grad_allreduce(program: Program, num_replicas_axis="dp",
                          scale=True, fp16_allreduce=None) -> Program:
    """A clone of `program` with c_allreduce_sum (and, with `scale`, a
    1/W scale_by_world_size) on every Grad input of an optimizer op.
    Idempotent: a gradient already reduced is left alone.  With
    `fp16_allreduce` (default: the program's `_fp16_allreduce` mark,
    fleet's FP16AllReduceOptimizer) the allreduce runs on bf16 casts."""
    if fp16_allreduce is None:
        fp16_allreduce = getattr(program, "_fp16_allreduce", False)
    p = copy.deepcopy(program)
    block = p.global_block()
    producers: Dict[str, Any] = {}
    for op in block.ops:
        for n in op.output_names():
            producers.setdefault(n, []).append(op)
    new_ops = []
    inserted = 0
    done: Dict[str, str] = {}
    for op in block.ops:
        if op.attrs.get("zero_sharded"):
            new_ops.append(op)
            continue
        if op.attrs.get(OpRole.KEY) == OpRole.Optimize and "Grad" in op.inputs:
            gnames = op.inputs["Grad"]
            new_gnames = []
            for g in gnames:
                if g in done:
                    new_gnames.append(done[g])
                    continue
                if _grad_already_reduced(producers, g):
                    new_gnames.append(g)
                    continue
                from ..core.program import OpDesc
                src = g
                if fp16_allreduce:
                    low = unique_name(g + "@BF16")
                    block.create_var(name=low, stop_gradient=True,
                                     dtype="bfloat16")
                    new_ops.append(OpDesc(
                        "cast", {"X": [g]}, {"Out": [low]},
                        {"in_dtype": "float32", "out_dtype": "bfloat16",
                         OpRole.KEY: OpRole.Dist,
                         "op_uid": p._next_uid()}))
                    src = low
                red = unique_name(g + "@ALLREDUCE")
                block.create_var(name=red, stop_gradient=True)
                ar = OpDesc("c_allreduce_sum", {"X": [src]}, {"Out": [red]},
                            {"ring_id": 0, OpRole.KEY: OpRole.Dist,
                             "op_uid": p._next_uid()})
                new_ops.append(ar)
                inserted += 1
                if fp16_allreduce:
                    back = unique_name(g + "@FP32")
                    block.create_var(name=back, stop_gradient=True,
                                     dtype="float32")
                    new_ops.append(OpDesc(
                        "cast", {"X": [red]}, {"Out": [back]},
                        {"in_dtype": "bfloat16", "out_dtype": "float32",
                         OpRole.KEY: OpRole.Dist,
                         "op_uid": p._next_uid()}))
                    red = back
                if scale:
                    scaled = unique_name(g + "@SCALED")
                    block.create_var(name=scaled, stop_gradient=True)
                    sc = OpDesc("scale_by_world_size", {"X": [red]},
                                {"Out": [scaled]},
                                {"ring_id": 0, OpRole.KEY: OpRole.Dist,
                                 "op_uid": p._next_uid()})
                    new_ops.append(sc)
                    red = scaled
                done[g] = red
                new_gnames.append(red)
            op.inputs["Grad"] = new_gnames
        new_ops.append(op)
    block.ops = new_ops
    if inserted:
        # only effective applications: an idempotent re-apply inserts
        # nothing and records nothing
        from ..core.pass_framework import record_applied
        record_applied(p, "grad_allreduce", scale=bool(scale),
                       fp16=bool(fp16_allreduce), reductions=inserted)
    return p


def _shard_rows(v, axis: int, w: int, r: int):
    """Rank r's slice of `v` along `axis` (a numpy array or a tensor; a
    tensor's slice is a copy, so the whole array can be freed)."""
    n = v.shape[axis] // w
    if isinstance(v, torch.Tensor):
        return v.narrow(axis, r * n, n).clone(
            memory_format=torch.contiguous_format)
    return np.ascontiguousarray(
        np.take(v, np.arange(r * n, (r + 1) * n), axis=axis))


def _reduce(v: torch.Tensor, group) -> torch.Tensor:
    """A fetch across `group`: floats averaged, others the max."""
    if v.is_floating_point():
        return _kc.all_reduce(v, "sum", group) / torch.full(
            (), _kc.world_of(group), dtype=v.dtype, device=v.device)
    if v.dtype == torch.bool:
        return _kc.all_reduce(v.to(torch.uint8), "max", group).bool()
    return _kc.all_reduce(v, "max", group)


class _World:
    """One rank's place in the dp × tp or dp × sp grid and its groups
    (None where no process group is initialised)."""

    def __init__(self, tp: int, sp: int = 1):
        import torch.distributed as dist
        self.tp, self.sp = max(1, int(tp)), max(1, int(sp))
        if self.tp > 1 and self.sp > 1:
            raise NotImplementedError(
                "sequence_parallel_degree and tensor_parallel_degree "
                "cannot both exceed 1 in one CompiledProgram")
        # the model axis: "sp" (sequence shards) or "tp" (weight shards)
        self.axis = "sp" if self.sp > 1 else "tp"
        m = self.sp if self.sp > 1 else self.tp
        self.whole = None
        w, r = 1, 0
        if dist.is_available() and dist.is_initialized():
            self.whole = dist.group.WORLD
            w, r = dist.get_world_size(), dist.get_rank()
        if w % m:
            knob = "sequence" if self.sp > 1 else "tensor"
            raise ValueError(
                f"BuildStrategy.{knob}_parallel_degree={m} does not "
                f"divide the world of {w} ranks")
        self.size = w
        self.dp = w // m
        self.dp_index, m_index = r // m, r % m
        self.tp_index = m_index if self.axis == "tp" else 0
        self.sp_index = m_index if self.axis == "sp" else 0
        self.dp_group, model_group = self.whole, None
        if self.whole is not None and m > 1:
            # every rank makes every group, in the same order
            for t in range(m):
                g = dist.new_group([d * m + t for d in range(self.dp)])
                if t == m_index:
                    self.dp_group = g
            for d in range(self.dp):
                g = dist.new_group([d * m + t for t in range(m)])
                if d == self.dp_index:
                    model_group = g
        self.tp_group = model_group if self.axis == "tp" else None
        self.sp_group = model_group if self.axis == "sp" else None
        self.mesh = Mesh({"dp": self.dp, self.axis: m} if m > 1
                         else {"dp": self.dp})

    def __deepcopy__(self, memo):
        # process groups are handles of this process: a program deep copy
        # (insert_grad_allreduce) that reaches the CompiledProgram (fleet
        # keeps it on the program) shares them
        return self

    def index(self, axis):
        return {"dp": self.dp_index, "tp": self.tp_index,
                "sp": self.sp_index}[axis]

    def degree(self, axis):
        return {"dp": self.dp, "tp": self.tp, "sp": self.sp}[axis]

    def group(self, axis):
        return {"dp": self.dp_group, "tp": self.tp_group,
                "sp": self.sp_group}[axis]

    def sharers(self, axis):
        """The group of the ranks that hold the same `axis` shard."""
        return (self.tp_group or self.sp_group) if axis == "dp" \
            else self.dp_group

    @property
    def reduce_group(self):
        """The ranks a gradient (and a "reduce" fetch) is partial over:
        the dp group, or under dp × sp the whole world (batch and
        sequence shards)."""
        return self.whole if self.sp > 1 else self.dp_group

    def seed(self, step_seed: int) -> int:
        """This rank's seed of a step: the step seed plus the dp index
        (the tp ranks of one dp index draw alike); under dp × sp that
        times 7919 plus the sp index, wrapped to 32 bits (the JAX
        package's uint32 rule)."""
        s = int(step_seed) + self.dp_index
        if self.sp > 1:
            s = (s * 7919 + self.sp_index) % (2 ** 32)
        return s

    @contextlib.contextmanager
    def bind(self):
        """Ring 0, TP_RING_ID and SP_RING_ID bound to this rank's groups
        while a step runs (the bindings before are restored after): under
        dp × tp ring 0 is the dp group and TP_RING_ID the tp group; under
        dp × sp ring 0 is the whole world and SP_RING_ID the sp group; an
        axis the grid lacks binds to None (its ops are the identity, the
        ring op plain attention)."""
        from ..ops.attention import SP_RING_ID
        if self.sp > 1:
            rings = {0: self.whole, SP_RING_ID: self.sp_group,
                     TP_RING_ID: None}
        elif self.tp > 1:
            rings = {0: self.dp_group, TP_RING_ID: self.tp_group,
                     SP_RING_ID: None}
        else:
            rings = {TP_RING_ID: None, SP_RING_ID: None}
        saved = {k: _kc._RINGS[k] for k in rings if k in _kc._RINGS}
        for k, g in rings.items():
            _kc.register_ring(k, g)
        try:
            yield
        finally:
            for k in rings:
                if k in saved:
                    _kc._RINGS[k] = saved[k]
                else:
                    _kc._RINGS.pop(k, None)


class CompiledProgram:
    """`CompiledProgram(main).with_data_parallel(loss_name=...)`, run by
    `Executor.run` and `Executor.run_steps` on every rank."""

    def __init__(self, program_or_graph, build_strategy: BuildStrategy = None):
        self._program: Program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = ExecutionStrategy()
        self._is_data_parallel = False
        self._loss_name = None
        self._places = None
        self._share_vars_from = None
        self._rewritten = None
        self._world = None
        self._synced = weakref.WeakSet()  # scopes synced and sharded

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        self._is_data_parallel = True
        self._loss_name = loss_name
        if build_strategy is not None:
            self._build_strategy = build_strategy
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        self._share_vars_from = share_vars_from
        self._places = places
        return self

    # -- the world ---------------------------------------------------------
    def _get_world(self) -> _World:
        if self._world is None:
            self._check_supported()
            bs = self._build_strategy
            self._world = _World(
                int(getattr(bs, "tensor_parallel_degree", 1)),
                int(getattr(bs, "sequence_parallel_degree", 1)))
        return self._world

    def _check_supported(self):
        bs = self._build_strategy
        if bs.sync_batch_norm:
            raise NotImplementedError(
                f"BuildStrategy.sync_batch_norm is not ported yet "
                f"({_LATER})")
        if getattr(self._program, "_elastic_meta", None) is not None:
            if int(getattr(bs, "sequence_parallel_degree", 1)) > 1:
                raise NotImplementedError(
                    "elastic programs (distributed/elastic.elasticize) "
                    "compose with a dp world only; the ordered fold "
                    "reduces ring 0's dp axis, but under dp×sp gradients "
                    "are partial over both axes "
                    "(sequence_parallel_degree must be 1)")
            if int(getattr(bs, "tensor_parallel_degree", 1)) > 1:
                # the JAX package composes elastic with dp×tp (the fold
                # on the dp sub-axis); the port does not have that yet
                raise NotImplementedError(
                    f"elastic programs under tensor parallelism are not "
                    f"ported yet (tensor_parallel_degree must be 1; "
                    f"{_LATER})")
        if bs.fetch_aggregation not in ("reduce", "concat"):
            raise ValueError(
                f"BuildStrategy.fetch_aggregation must be 'reduce' or "
                f"'concat', got {bs.fetch_aggregation!r}")

    def _get_program(self) -> Program:
        """The program each rank runs (rewritten once, at the first run:
        the world is read then)."""
        if self._rewritten is None:
            world = self._get_world()
            n = world.size
            if self._places is not None and len(self._places) != n:
                raise ValueError(
                    f"with_data_parallel(places=...) names "
                    f"{len(self._places)} places, the process group has "
                    f"{n} ranks (one process and one place a rank)")
            if world.sp > 1 and any(
                    v.attrs.get("dp_shard") for b in self._program.blocks
                    for v in b.vars.values()):
                raise NotImplementedError(
                    "ZeRO-1 sharded programs (shard_optimizer_states) "
                    "compose with dp or dp×tp meshes only; the bucket "
                    "reduce-scatter rides ring 0's dp axis, but under "
                    "dp×sp gradients are partial over both axes "
                    "(sequence_parallel_degree must be 1)")
            if self._is_data_parallel:
                scale = (self._build_strategy.gradient_scale_strategy ==
                         GradientScaleStrategy.CoeffNumDevice and n > 1)
                self._rewritten = insert_grad_allreduce(self._program,
                                                        scale=scale)
            else:
                self._rewritten = self._program
        return self._rewritten

    # -- placement ---------------------------------------------------------
    def _placements(self, names):
        return state_partition_specs(self._get_program(),
                                     self._get_world().mesh, names)

    def _declared(self, name):
        try:
            return tuple(self._get_program().global_block().var(name).shape
                         or ())
        except KeyError:
            return None

    def _is_global(self, name, t, place) -> bool:
        """Whether `t` (the scope's value of `name`) is the whole array
        rather than this rank's shard of it."""
        axis, dim = place
        shape = self._declared(name)
        if not shape or shape[dim] is None or int(shape[dim]) < 0:
            return True
        return int(t.shape[dim]) == int(shape[dim])

    def shard_of(self, name, value):
        """This rank's shard of the global array `value` of persistable
        `name` (the value itself where the var is replicated)."""
        place = self._placements([name])[name]
        if place == PLACE_REPLICATED:
            return value
        world = self._get_world()
        axis, dim = place
        return _shard_rows(value, dim, world.degree(axis), world.index(axis))

    def _sync_start(self, scope, state_names, world):
        """Once a scope: every persistable broadcast from rank 0 and cut
        to this rank's shard; a value that already is a shard is
        broadcast within the ranks that share it."""
        if scope in self._synced:
            return
        places = self._placements(state_names)
        for n in state_names:
            t, place = scope.get(n), places[n]
            if place == PLACE_REPLICATED:
                if world.whole is not None:
                    scope.set(n, _kc.broadcast(t, 0, world.whole))
                continue
            axis, dim = place
            if self._is_global(n, t, place):
                if world.whole is not None:
                    t = _kc.broadcast(t, 0, world.whole)
                if world.degree(axis) > 1:
                    t = _shard_rows(t, dim, world.degree(axis),
                                    world.index(axis))
            elif world.sharers(axis) is not None:
                t = _kc.broadcast(t, 0, world.sharers(axis))
            scope.set(n, t)
        self._synced.add(scope)

    def global_state(self, scope=None, names=None) -> Dict[str, Any]:
        """The persistables of `scope` (default: the global scope) in
        their global layout, as the JAX package's scope holds them: each
        shard gathered over its axis's group.  Every rank must call it
        (it runs collectives), in the same order."""
        from ..static.executor import global_scope, _persistable_names
        scope = scope or global_scope()
        world = self._get_world()
        if names is None:
            names = [n for n in _persistable_names(self._get_program())
                     if scope.get(n) is not None]
        places = self._placements(names)
        out = {}
        for n in names:
            t, place = scope.get(n), places[n]
            if place == PLACE_REPLICATED or self._is_global(n, t, place):
                out[n] = t
                continue
            axis, dim = place
            g = world.group(axis)
            moved = t.movedim(dim, 0)
            out[n] = _kc.gather_rows(moved, g).movedim(0, dim).contiguous() \
                if g is not None else t
        return out

    def _holds_shards(self, names) -> bool:
        """Whether any of the persistables `names` lives sharded (a ZeRO
        bucket, a tp slice) rather than whole on every rank."""
        places = self._placements(list(names))
        return any(p != PLACE_REPLICATED for p in places.values())

    def _aggregate(self, fetched, world, fetch_names, keep=()):
        """The fetches across the ranks (BuildStrategy.fetch_aggregation):
        "reduce" averages floats (others the max) over the ranks a
        gradient is partial over (world.reduce_group); "concat" gathers
        along dim 0 over dp, after, under dp × sp, gathering a
        sequence-sharded fetch along dim 1 over sp (averaging other
        floats over sp, the max of the rest)."""
        agg = self._build_strategy.fetch_aggregation
        out = []
        for n, v in zip(fetch_names, fetched):
            if not isinstance(v, torch.Tensor) or n in keep:
                out.append(v)
            elif agg == "concat":
                if world.sp > 1:
                    v = self._over_sp(n, v, world)
                out.append(_kc.gather_rows(v, world.dp_group))
            else:
                out.append(_reduce(v, world.reduce_group))
        return out

    def _over_sp(self, name, v, world):
        """A "concat" fetch across the sp ranks: a sequence-sharded one
        (declared dim 1 cut by the feed rule) gathered along dim 1, other
        floats averaged (per-example reductions are partial means), the
        rest the max."""
        if v.dim() >= 2 and self._sp_sharded(name, world.sp):
            return _kc.gather_rows(v.movedim(1, 0), world.sp_group) \
                .movedim(0, 1).contiguous()
        return _reduce(v, world.sp_group)

    def _sp_sharded(self, name, sp):
        """Whether var `name`'s dim 1 rides the sp axis: declared longer
        than 1 and divisible by sp (the JAX package's feed rule)."""
        shape = self._declared(name) or ()
        return len(shape) >= 2 and shape[1] is not None and \
            int(shape[1]) > 1 and int(shape[1]) % sp == 0

    def _prepare(self, scope):
        from ..static.executor import _persistable_names
        program = self._get_program()
        world = self._get_world()
        state_names = [n for n in _persistable_names(program)
                       if scope.get(n) is not None]
        self._sync_start(scope, state_names, world)
        return program, world

    def _local_feed(self, program, feed, world, axis_offset=0):
        """Each feed cut as its placement says: a batch to this rank's dp
        rows (where they divide), a tp-placed feed to its tp slice."""
        places = feed_partition_specs(program, world.mesh, list(feed))
        local = {}
        for n, v in feed.items():
            if not isinstance(v, torch.Tensor):
                v = np.asarray(v)
            place = places[n]
            if place != PLACE_REPLICATED and v.ndim > place[1] + \
                    axis_offset:
                axis, dim = place
                dim += axis_offset
                deg = world.degree(axis)
                if axis_offset and axis == "dp" and v.shape[dim] % deg:
                    raise ValueError(
                        f"run_steps feed {n!r} per-step batch "
                        f"{v.shape[dim]} does not divide the dp world "
                        f"{deg} (stacked feeds shard axis 1 over dp, like "
                        "run() shards axis 0)")
                if v.shape[dim] % deg == 0:
                    v = _shard_rows(v, dim, deg, world.index(axis))
            if world.sp > 1 and self._sp_sharded(n, world.sp) and \
                    v.ndim >= 2 + axis_offset and \
                    v.shape[1 + axis_offset] % world.sp == 0:
                # the sequence (dim 1) over sp
                v = _shard_rows(v, 1 + axis_offset, world.sp,
                                world.sp_index)
            local[n] = v
        return local

    # -- the elastic schedule -----------------------------------------------
    @staticmethod
    def _elastic_kept(elastic):
        """The fetches an elastic step hands back as they are: the folded
        loss and the accumulators, the same on every rank."""
        if elastic is None:
            return ()
        return (elastic.get("loss_avg"),) + tuple(elastic.get("accs", ()))

    def _anchor_elastic(self, executor, scope, elastic, world) -> int:
        """K = logical_dp / W for this process group; after a
        topology-shifted restore (which left the position in GLOBAL
        steps) the executor's micro-step counters and the persistable
        counter are re-anchored to it.  Returns K."""
        n_logical = int(elastic["logical_dp"])
        n_dev = int(world.dp)
        if n_logical % n_dev != 0:
            raise ValueError(
                f"elastic logical_dp={n_logical} is not divisible by "
                f"the mesh dp degree {n_dev}")
        micro_k = n_logical // n_dev
        rebase = getattr(executor, "_elastic_rebase_global", None)
        if rebase is not None:
            from ..observability.journal import emit as _jemit
            _jemit("reanchor", world=int(n_dev), k=int(micro_k),
                   global_step=int(rebase))
            executor._step = int(rebase) * micro_k
            executor._elastic_steps = int(rebase) * micro_k
            cnt = scope.get(elastic["counter"])
            scope.set(elastic["counter"], torch.full(
                (1,), int(rebase) * micro_k, dtype=torch.int32,
                device=cnt.device if cnt is not None else executor.device))
            executor._elastic_rebase_global = None
        executor._last_elastic_world = n_dev
        executor._last_elastic_k = micro_k
        return micro_k

    @staticmethod
    def _elastic_seed(program, executor, micro_k, world, i=0) -> int:
        """The seed of elastic micro-step `_elastic_steps + i` on this rank:
        the global step's seed plus the logical rank j W + r (j the
        micro-step within the window), as the JAX package draws."""
        e = executor._elastic_steps + i
        base = (int(program.random_seed) * 1000003 + e // micro_k) \
            % (2 ** 31)
        return (base + (e % micro_k) * world.dp + world.dp_index) \
            % (2 ** 32)

    def _chaos_dispatch(self, executor, program):
        """The chaos collective-failure hook before a training dispatch
        (step numbering as the kill hook's: the n-th training run)."""
        from ..testing import chaos as _chaos
        if not _chaos.enabled():
            return
        from ..static.executor import _training_cached
        if _training_cached(program):
            _chaos.collective_hook(executor._train_runs + 1)

    # -- Executor.run / run_steps ------------------------------------------
    def _run(self, executor, feed, fetch_list, scope, return_numpy):
        from ..static.executor import global_scope, as_numpy, _fetch_names
        scope = scope or global_scope()
        program, world = self._prepare(scope)
        local = self._local_feed(program, feed or {}, world)
        elastic = getattr(program, "_elastic_meta", None)
        self._chaos_dispatch(executor, program)
        fetch_names = _fetch_names(fetch_list)
        with world.bind():
            if elastic is None:
                fetched = self._step(executor, program, local, fetch_names,
                                     scope, world)
            else:
                k = self._anchor_elastic(executor, scope, elastic, world)
                fetched = executor._run_program(
                    program, local, fetch_names, scope,
                    self._elastic_seed(program, executor, k, world))
                executor._step += 1
                executor._elastic_steps += 1
                fetched = self._aggregate(fetched, world, fetch_names,
                                          keep=self._elastic_kept(elastic))
        return as_numpy(fetched) if return_numpy else fetched

    def _run_local(self, executor, local, fetch_names, scope):
        """One step from feeds already cut to this rank (a caller that
        distributes the shards itself: serving/tp_decode.py's leader and
        followers): the aggregated fetched tensors."""
        program, world = self._prepare(scope)
        with world.bind():
            return self._step(executor, program, local, fetch_names, scope,
                              world)

    def _step(self, executor, program, feed, fetch_names, scope, world):
        seed = world.seed(executor._seed_for_step(program))
        fetched = executor._run_program(program, feed, fetch_names, scope,
                                        seed)
        executor._step += 1
        return self._aggregate(fetched, world, fetch_names)

    def _window_split(self, program, fetch_names):
        """scan_window.split_commit_tail, memoized per (fingerprint,
        fetches): the split walks and clones the whole program."""
        key = (program.fingerprint(), tuple(fetch_names))
        cached = getattr(self, "_scan_split_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        from .scan_window import split_commit_tail
        split = split_commit_tail(program, fetch_names)
        self._scan_split_cache = (key, split)
        return split

    def _hoist_split(self, program, k, fetch_names, scope):
        """The WindowSplit to run K steps hoisted, or None: a splittable
        gradient-merge window, K a whole number of windows, the counter
        on a window boundary (a start mid-window replays the masked
        per-step form), and PADDLE_TPU_SCAN_HOIST not 0 / false / off."""
        if os.environ.get("PADDLE_TPU_SCAN_HOIST", "1").lower() in \
                ("0", "false", "off"):
            return None
        split = self._window_split(program, fetch_names)
        if split is None or k % split.k:
            return None
        cval = scope.get(split.counter)
        if cval is None or int(torch.as_tensor(cval).reshape(-1)[0]) \
                % split.k:
            return None
        return split

    def _run_steps(self, executor, stacked, k, fetch_names, scope):
        """K steps from feeds stacked [K, global batch, ...] (device
        tensors): the stacked fetches.  NCCL (or no process group) on
        CUDA: one captured step replayed; gloo or CPU: K eager steps.
        A gradient-merge window runs hoisted where it can
        (`_hoist_split`): the commit-free body each micro-step, the
        commit tail once a window (two captured steps on CUDA, eager
        otherwise), bitwise the per-step form's losses and state with the
        tail's collectives (the ZeRO publish all-gathers, the merged
        allreduce) run once a window instead of once a step."""
        from ..static.executor import _persistable_names
        program, world = self._prepare(scope)
        local = self._local_feed(program, stacked, world, axis_offset=1)
        elastic = getattr(program, "_elastic_meta", None)
        if elastic is not None:
            return self._run_elastic_steps(executor, program, world, local,
                                           k, fetch_names, scope, elastic)
        split = self._hoist_split(program, k, fetch_names, scope)
        self._last_hoisted = split is not None
        self._chaos_dispatch(executor, program)
        gloo = self._gloo(world)
        with world.bind():
            if executor.device.type == "cuda" and not gloo:
                agg = self._build_strategy.fetch_aggregation
                kw = dict(seed_of=world.seed,
                          finish=lambda f: self._aggregate(f, world,
                                                           fetch_names),
                          key_extra=("data_parallel", agg, world.size,
                                     world.tp, world.sp))
                if split is not None:
                    state_names = [n for n in _persistable_names(program)
                                   if scope.get(n) is not None]
                    return executor._replay_windows(
                        split, state_names, local, k, fetch_names, scope,
                        **kw)
                return executor._replay_steps(program, local, k,
                                              fetch_names, scope, **kw)
            steps = []
            for i in range(k):
                steps.append(self._step(
                    executor, split.body if split else program,
                    {n: v[i] for n, v in local.items()}, fetch_names,
                    scope, world))
                if split is not None and (i + 1) % split.k == 0:
                    # the commit: no feeds, no fetches, no draws
                    executor._run_program(split.tail, {}, [], scope, 0)
        return [torch.stack([s[j] for s in steps])
                for j in range(len(fetch_names))]

    @staticmethod
    def _gloo(world) -> bool:
        import torch.distributed as dist
        return world.whole is not None and \
            dist.get_backend(world.whole) == "gloo"

    def _run_elastic_steps(self, executor, program, world, local, k,
                           fetch_names, scope, elastic):
        """K elastic micro-steps (any K; a whole window when K is the
        program's): one captured micro-step replayed K times under NCCL
        (or on one CUDA device), each replay with its micro-step's seed;
        K eager steps under gloo and on the CPU.  Bitwise the looped
        `run` form."""
        self._last_hoisted = False
        self._chaos_dispatch(executor, program)
        keep = self._elastic_kept(elastic)
        with world.bind():
            micro_k = self._anchor_elastic(executor, scope, elastic, world)
            seeds = [self._elastic_seed(program, executor, micro_k, world, i)
                     for i in range(k)]
            if executor.device.type == "cuda" and not self._gloo(world):
                agg = self._build_strategy.fetch_aggregation
                out = executor._replay_steps(
                    program, local, k, fetch_names, scope, seeds=seeds,
                    finish=lambda f: self._aggregate(f, world, fetch_names,
                                                     keep=keep),
                    key_extra=("elastic", agg, world.size))
                executor._elastic_steps += k
                return out
            steps = []
            for i in range(k):
                fetched = executor._run_program(
                    program, {n: v[i] for n, v in local.items()},
                    fetch_names, scope, seeds[i])
                executor._step += 1
                executor._elastic_steps += 1
                steps.append(self._aggregate(fetched, world, fetch_names,
                                             keep=keep))
        return [torch.stack([s[j] for s in steps])
                for j in range(len(fetch_names))]
