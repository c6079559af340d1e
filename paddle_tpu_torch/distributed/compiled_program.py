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
    alike).
  * **Fetches.** BuildStrategy.fetch_aggregation "reduce": float fetches
    are the mean over the dp ranks, others the max; "concat": gathered
    along dim 0 in rank order, a scalar stacked to [W].

`Executor.run_steps(compiled, ...)` under NCCL captures one step, its
collectives and the fetch reduction included, as a CUDA graph and
replays it K times; a failed capture raises.  Under gloo (host
collectives, which a graph cannot hold) and on the CPU the K steps run
eagerly, one `run` each.

The world is a dp × tp grid (BuildStrategy.tensor_parallel_degree = tp,
dp = W / tp): rank r has dp index r // tp and tp index r % tp, the JAX
mesh's `devs.reshape(dp, tp)` order.  Ring 0 is the rank's dp group
(the ranks of its tp index) and TP_RING_ID (102) its tp group (the ranks
of its dp index); every rank makes every group, in the same order.  At
tp = 1 ring 0 is the whole world and TP_RING_ID the identity.

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

Not ported (ROADMAP.md Queue 1, Distribution; each raises):
sequence_parallel_degree above 1, elastic programs (`_elastic_meta`)
and sync_batch_norm.  The BuildStrategy knobs the JAX package leaves to XLA
(fusions, memory options, debug_graphviz_path) are accepted and do
nothing here either.
"""
from __future__ import annotations

import contextlib
import copy
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


class _World:
    """One rank's place in the dp × tp grid and its groups (None where
    no process group is initialised)."""

    def __init__(self, tp: int):
        import torch.distributed as dist
        self.tp = max(1, int(tp))
        self.whole = None
        w, r = 1, 0
        if dist.is_available() and dist.is_initialized():
            self.whole = dist.group.WORLD
            w, r = dist.get_world_size(), dist.get_rank()
        if w % self.tp:
            raise ValueError(
                f"BuildStrategy.tensor_parallel_degree={self.tp} does not "
                f"divide the world of {w} ranks")
        self.size = w
        self.dp = w // self.tp
        self.dp_index, self.tp_index = r // self.tp, r % self.tp
        self.dp_group, self.tp_group = self.whole, None
        if self.whole is not None and self.tp > 1:
            # every rank makes every group, in the same order
            for t in range(self.tp):
                g = dist.new_group([d * self.tp + t for d in range(self.dp)])
                if t == self.tp_index:
                    self.dp_group = g
            for d in range(self.dp):
                g = dist.new_group([d * self.tp + t for t in range(self.tp)])
                if d == self.dp_index:
                    self.tp_group = g
        self.mesh = Mesh({"dp": self.dp, "tp": self.tp} if self.tp > 1
                         else {"dp": self.dp})

    def __deepcopy__(self, memo):
        # process groups are handles of this process: a program deep copy
        # (insert_grad_allreduce) that reaches the CompiledProgram (fleet
        # keeps it on the program) shares them
        return self

    def index(self, axis):
        return self.dp_index if axis == "dp" else self.tp_index

    def degree(self, axis):
        return self.dp if axis == "dp" else self.tp

    def group(self, axis):
        return self.dp_group if axis == "dp" else self.tp_group

    def sharers(self, axis):
        """The group of the ranks that hold the same `axis` shard."""
        return self.tp_group if axis == "dp" else self.dp_group

    @contextlib.contextmanager
    def bind(self):
        """Ring 0 and TP_RING_ID bound to this rank's dp and tp groups
        while a step runs (the bindings before are restored after)."""
        rings = {0: self.dp_group, TP_RING_ID: self.tp_group} \
            if self.tp > 1 else {TP_RING_ID: None}
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
            self._world = _World(int(getattr(
                self._build_strategy, "tensor_parallel_degree", 1)))
        return self._world

    def _check_supported(self):
        bs = self._build_strategy
        if int(getattr(bs, "sequence_parallel_degree", 1)) > 1:
            raise NotImplementedError(
                f"BuildStrategy.sequence_parallel_degree > 1 (sequence "
                f"parallel) is not ported yet ({_LATER})")
        if bs.sync_batch_norm:
            raise NotImplementedError(
                f"BuildStrategy.sync_batch_norm is not ported yet "
                f"({_LATER})")
        if getattr(self._program, "_elastic_meta", None) is not None:
            raise NotImplementedError(
                f"elastic programs (elasticize) are not ported yet "
                f"({_LATER})")
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

    def _aggregate(self, fetched, group):
        """The fetches across the dp ranks
        (BuildStrategy.fetch_aggregation)."""
        w = _kc.world_of(group)
        out = []
        for v in fetched:
            if not isinstance(v, torch.Tensor):
                out.append(v)
            elif self._build_strategy.fetch_aggregation == "concat":
                out.append(_kc.gather_rows(v, group))
            elif v.is_floating_point():
                out.append(_kc.all_reduce(v, "sum", group) / torch.full(
                    (), w, dtype=v.dtype, device=v.device))
            elif v.dtype == torch.bool:
                out.append(_kc.all_reduce(v.to(torch.uint8), "max", group)
                           .bool())
            else:
                out.append(_kc.all_reduce(v, "max", group))
        return out

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
            local[n] = v
        return local

    # -- Executor.run / run_steps ------------------------------------------
    def _run(self, executor, feed, fetch_list, scope, return_numpy):
        from ..static.executor import global_scope, as_numpy, _fetch_names
        scope = scope or global_scope()
        program, world = self._prepare(scope)
        local = self._local_feed(program, feed or {}, world)
        with world.bind():
            fetched = self._step(executor, program, local, _fetch_names(
                fetch_list), scope, world)
        return as_numpy(fetched) if return_numpy else fetched

    def _step(self, executor, program, feed, fetch_names, scope, world):
        seed = executor._seed_for_step(program) + world.dp_index
        fetched = executor._run_program(program, feed, fetch_names, scope,
                                        seed)
        executor._step += 1
        return self._aggregate(fetched, world.dp_group)

    def _run_steps(self, executor, stacked, k, fetch_names, scope):
        """K steps from feeds stacked [K, global batch, ...] (device
        tensors): the stacked fetches.  NCCL (or no process group) on
        CUDA: one captured step replayed; gloo or CPU: K eager steps."""
        program, world = self._prepare(scope)
        local = self._local_feed(program, stacked, world, axis_offset=1)
        import torch.distributed as dist
        gloo = world.whole is not None and \
            dist.get_backend(world.whole) == "gloo"
        with world.bind():
            if executor.device.type == "cuda" and not gloo:
                agg = self._build_strategy.fetch_aggregation
                return executor._replay_steps(
                    program, local, k, fetch_names, scope,
                    seed_offset=world.dp_index,
                    finish=lambda f: self._aggregate(f, world.dp_group),
                    key_extra=("data_parallel", agg, world.size, world.tp))
            steps = [self._step(executor, program,
                                {n: v[i] for n, v in local.items()},
                                fetch_names, scope, world)
                     for i in range(k)]
        return [torch.stack([s[j] for s in steps])
                for j in range(len(fetch_names))]
