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
    the world size W, the whole array otherwise (the JAX package's
    `place_feed` rule).  `run_steps` shards the per-step axis 1 and
    raises where it does not divide, as the JAX package's scan does.
  * **Seed.** The step seed plus the rank, as the JAX package
    decorrelates the replicas' draws.
  * **Fetches.** BuildStrategy.fetch_aggregation "reduce": float fetches
    are the mean over the ranks, others the max; "concat": gathered
    along dim 0 in rank order, a scalar stacked to [W].

`Executor.run_steps(compiled, ...)` under NCCL captures one step, its
collectives and the fetch reduction included, as a CUDA graph and
replays it K times; a failed capture raises.  Under gloo (host
collectives, which a graph cannot hold) and on the CPU the K steps run
eagerly, one `run` each.

Not ported (ROADMAP.md Queue 1, Distribution; each raises):
sequence_parallel_degree or tensor_parallel_degree above 1, ZeRO
programs (`dp_shard` vars), elastic programs (`_elastic_meta`) and
sync_batch_norm.  The BuildStrategy knobs the JAX package leaves to XLA
(fusions, memory options, debug_graphviz_path) are accepted and do
nothing here either.
"""
from __future__ import annotations

import copy
import weakref
from typing import Any, Dict, List

import numpy as np
import torch

from ..core.program import Program, OpRole, unique_name
from ..ops.kernels import collective as _kc

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
    """Rank r's slice of `v` along `axis` (a numpy array or a tensor)."""
    n = v.shape[axis] // w
    if isinstance(v, torch.Tensor):
        return v.narrow(axis, r * n, n).contiguous()
    return np.ascontiguousarray(
        np.take(v, np.arange(r * n, (r + 1) * n), axis=axis))


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
        self._synced = weakref.WeakSet()  # scopes broadcast from rank 0

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
    @staticmethod
    def _group():
        return _kc.ring_group(0)

    def _check_supported(self):
        bs = self._build_strategy
        for knob in ("sequence_parallel_degree", "tensor_parallel_degree"):
            if int(getattr(bs, knob, 1)) > 1:
                raise NotImplementedError(
                    f"BuildStrategy.{knob} > 1 (sequence / tensor "
                    f"parallel) is not ported yet ({_LATER})")
        if bs.sync_batch_norm:
            raise NotImplementedError(
                f"BuildStrategy.sync_batch_norm is not ported yet "
                f"({_LATER})")
        if any(v.attrs.get("dp_shard") for b in self._program.blocks
               for v in b.vars.values()):
            raise NotImplementedError(
                f"ZeRO programs (shard_optimizer_states, dp_shard vars) "
                f"are not ported yet ({_LATER})")
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
            self._check_supported()
            n = _kc.world_of(self._group())
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

    def _sync_start(self, scope, state_names, group):
        """Broadcast every persistable in `scope` from rank 0, once a
        scope."""
        if group is None or scope in self._synced:
            return
        for n in state_names:
            scope.set(n, _kc.broadcast(scope.get(n), 0, group))
        self._synced.add(scope)

    def _aggregate(self, fetched, group):
        """The fetches across the ranks (BuildStrategy.fetch_aggregation)."""
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
        group = self._group()
        state_names = [n for n in _persistable_names(program)
                       if scope.get(n) is not None]
        self._sync_start(scope, state_names, group)
        return program, group

    # -- Executor.run / run_steps ------------------------------------------
    def _run(self, executor, feed, fetch_list, scope, return_numpy):
        from ..static.executor import global_scope, as_numpy, _fetch_names
        scope = scope or global_scope()
        program, group = self._prepare(scope)
        w, r = _kc.world_of(group), _kc.rank_of(group)
        local = {}
        for n, v in (feed or {}).items():
            if not isinstance(v, torch.Tensor):
                v = np.asarray(v)
            if v.ndim >= 1 and v.shape[0] % w == 0:
                v = _shard_rows(v, 0, w, r)
            local[n] = v
        fetched = self._step(executor, program, local, _fetch_names(
            fetch_list), scope, group, r)
        return as_numpy(fetched) if return_numpy else fetched

    def _step(self, executor, program, feed, fetch_names, scope, group, r):
        seed = executor._seed_for_step(program) + r
        fetched = executor._run_program(program, feed, fetch_names, scope,
                                        seed)
        executor._step += 1
        return self._aggregate(fetched, group)

    def _run_steps(self, executor, stacked, k, fetch_names, scope):
        """K steps from feeds stacked [K, global batch, ...] (device
        tensors): the stacked fetches.  NCCL (or no process group) on
        CUDA: one captured step replayed; gloo or CPU: K eager steps."""
        program, group = self._prepare(scope)
        w, r = _kc.world_of(group), _kc.rank_of(group)
        local = {}
        for n, v in stacked.items():
            if v.dim() >= 2:
                if v.shape[1] % w:
                    raise ValueError(
                        f"run_steps feed {n!r} per-step batch "
                        f"{v.shape[1]} does not divide the dp world {w} "
                        "(stacked feeds shard axis 1 over dp, like run() "
                        "shards axis 0)")
                v = _shard_rows(v, 1, w, r)
            local[n] = v
        import torch.distributed as dist
        gloo = group is not None and dist.get_backend(group) == "gloo"
        if executor.device.type == "cuda" and not gloo:
            agg = self._build_strategy.fetch_aggregation
            return executor._replay_steps(
                program, local, k, fetch_names, scope, seed_offset=r,
                finish=lambda f: self._aggregate(f, group),
                key_extra=("data_parallel", agg, w))
        steps = [self._step(executor, program,
                            {n: v[i] for n, v in local.items()},
                            fetch_names, scope, group, r)
                 for i in range(k)]
        return [torch.stack([s[j] for s in steps])
                for j in range(len(fetch_names))]
