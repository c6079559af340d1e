"""Executor: runs a Program's ops one by one, eagerly, on one device.

Counterpart of paddle_tpu/static/executor.py (`Scope`, `scope_guard`,
`global_scope`, `Executor.run(program, feed, fetch_list)`).  The JAX
package traces a whole block into one jitted XLA computation; here each
op's torch kernel runs as it is reached, on the executor's device, with
no trace and no compile step.  So the JAX executor's compile cache and
its feed bucketing (`bucket_policy`, the Predictor's pow2 padding, which
only bounded retraces) have no counterpart: a batch runs at its own size.

`Executor(place=None)` runs on CUDAPlace(0) and raises when no CUDA device
is present; pass CPUPlace() to run on the CPU.

A training program runs the same way: its grad ops are ops like any other
(each replays its forward under torch.func.vjp, or has an explicit
gradient), the optimizer ops' outputs are bound to the persistable names
they write, and every persistable the run wrote goes back to the scope.
Grad vars can be fetched by name.  A value that is neither persistable
nor fetched is dropped after the last op that reads or writes it (the
reference's eager deletion), so a step holds the live activations, not
every value it made.  Nothing reads a device value back to the host
unless it is fetched.

A sub-block op (`while`, `cond`, `conditional_block`,
ops/kernels/control.py) runs its block through `run_block`, this
module's op loop, over the program the executor set on the op context.

`run_steps(program, feed, fetch_list)` runs K steps with every feed
stacked on a leading steps axis and returns each fetch stacked [K, ...],
the reference's contract (its `lax.scan` amortizes dispatch over K).  On
the CPU it loops over `run()`.  On CUDA it captures one step into a CUDA
graph and replays it K times: eager dispatch of the step's ops (the grad
ops' vjp replays, Adam) is what bounds the step on the card, and a replay
launches the same kernels without it.  For the capture every persistable
of the step lives in a static buffer that the step updates in place (the
buffers ARE the scope's tensors afterwards) and feeds are copied into
static per-step buffers before each replay.  Graphs are cached per
(program, per-step feed shapes and dtypes, fetch names, persistable
names, flags), so a short final chunk replays the same graph and a new
per-step batch size captures a new one (no feed bucketing).  The step
seed is a one-element device buffer the graph reads (the dropout kernel
takes it by pointer), refilled before each replay with the seed of that
step in the walk of K `run()` calls, so a replayed step draws the masks
of the same step run eagerly; so do the random ops (`uniform_random`,
`gaussian_random`, dpsgd's noise), whose Philox kernel reads the same
buffer.

A value of the environment need not be a tensor: the `is_sparse`
embedding's gradient is a SelectedRows (core/selected_rows.py), carried
and released by name like any other.  A step may bind one tensor to two
persistable names (`assign` returns its input); the capture gives each
name a buffer of its own, and the in-place writes of a captured step
copy a value that is another name's buffer before any write.

`run` and `run_steps` also take a `CompiledProgram`
(distributed/compiled_program.py: data parallel, one process a rank) and
hand it the call.  Its `run_steps` under NCCL captures the step with
its collectives and replays it like any other; under gloo, whose
collectives run on the host and cannot be captured, it runs the K steps
eagerly, one `run` each, as on the CPU.  Neither takes the other's
place: a failed NCCL capture raises.  `run` also takes the pipeline
(pipeline/pipeline_program.py) and the parameter-server trainer program
(distributed/ps/ps_optimizer.py), each running its own `_run`
(`run_steps` refuses them, as the JAX package's has no path for them);
`run` of a transpiler's pserver program serves the KV store.  A program
holding a parameter-server op (ops/kernels/distributed_ops.py
`HOST_OPS`: a host round-trip no CUDA graph holds), a `while`,
`cond`, `print` or `assert` (whose kernels read a device value on the
host), or a `masked_select`, `where_index` or `unique` (whose output
shape depends on the data: ops/kernels/manip.py `DYNAMIC_SHAPE_OPS`),
runs its `run_steps` eagerly, one `run` each.  `train_from_dataset` / `infer_from_dataset`
run one pass over a dataset (distributed/dataset.py), a step a batch.

Checkpointing (checkpoint/, as in the JAX package): `enable_checkpointing
(manager, every_n_steps=...)` snapshots the persistables of the training
program (parameters and optimizer state), the executor step, the RNG
state and the sidecars a world change needs (the ZeRO plan, the elastic
schedule position, the gradient-merge counter) every N steps, after a
`run` or a whole `run_steps` call (so a replayed window is snapshotted at
its boundary only), and hands them to the manager's async writer.
`restore_from_checkpoint` loads the newest valid step, converts a ZeRO
layout to the target program's plan, and re-derives the elastic and
gradient-merge schedules for the world and program it resumes in.
`run_prefetched` drives `run` from a feed iterator whose placement rides
a worker thread (reader/prefetcher.py); its position rides the snapshot.
Every training run also counts toward the chaos fault injector's step
index (testing/chaos.py), beats the rank's heartbeat and writes a `step`
journal event when those are armed (observability/).  The rest of the
JAX executor's per-step telemetry (tokens/s, MFU, HBM gauges) is not
ported (ROADMAP.md Queue 1, The rest).
"""
from __future__ import annotations

import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import flags as _flags
from ..core.dtype import torch_dtype
from ..core.monitor import stat_add
from ..core.place import Place, resolve_place
from ..core.program import Program, default_main_program
from ..ops.registry import get_op_info, OpContext
from ..ops.kernels.distributed_ops import has_host_ops
from ..testing import chaos as _chaos

__all__ = ["Executor", "Scope", "global_scope", "scope_guard", "as_numpy",
           "run_block"]


class Scope:
    """name -> tensor store (flat, like paddle_tpu's Scope)."""

    def __init__(self):
        self.vars: Dict[str, Any] = {}

    def find_var(self, name: str):
        return _VarView(self, name) if name in self.vars else None

    def var(self, name: str):
        self.vars.setdefault(name, None)
        return _VarView(self, name)

    def set(self, name: str, value):
        self.vars[name] = value

    def get(self, name: str):
        return self.vars.get(name)

    def keys(self):
        return self.vars.keys()


class _VarView:
    def __init__(self, scope, name):
        self._scope, self._name = scope, name

    def get_tensor(self):
        return self._scope.vars[self._name]

    def set(self, value, place: Optional[Place] = None):
        t = torch.as_tensor(value)
        if place is not None:
            t = t.to(resolve_place(place).torch_device())
        self._scope.vars[self._name] = t


_global_scope = Scope()
_scope_stack = threading.local()


def global_scope() -> Scope:
    stack = getattr(_scope_stack, "stack", None)
    return stack[-1] if stack else _global_scope


class scope_guard:
    def __init__(self, scope):
        self.scope = scope

    def __enter__(self):
        if not hasattr(_scope_stack, "stack"):
            _scope_stack.stack = []
        _scope_stack.stack.append(self.scope)
        return self.scope

    def __exit__(self, *a):
        _scope_stack.stack.pop()


def as_numpy(x):
    """A fetch on the host.  numpy has no bfloat16: a bf16 tensor comes
    back as its exact float32 upcast."""
    if isinstance(x, (list, tuple)):
        return [as_numpy(i) for i in x]
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _run_op(op, env: Dict[str, Any], ctx: OpContext):
    """Run one op's kernel over the environment of tensors (the eager
    counterpart of paddle_tpu's BlockTracer.run_op)."""
    info = get_op_info(op.type)
    if info is None:
        raise NotImplementedError(
            f"op {op.type!r} has no registered kernel in paddle_tpu_torch")
    ins: Dict[str, Any] = {}
    for slot in info.inputs:
        names = op.inputs.get(slot.name, [])
        if slot.duplicable:
            ins[slot.name] = [env[n] for n in names if n and n in env]
        else:
            n = names[0] if names else None
            ins[slot.name] = env.get(n) if n else None
        if not slot.optional and ins[slot.name] is None:
            raise RuntimeError(
                f"op {op.type!r}: input {slot.name!r} ({names}) has no "
                "value (missing feed, or startup program not run?)")
    outs = info.kernel(ins, dict(op.attrs), ctx)
    for slot in info.outputs:
        names = op.outputs.get(slot.name, [])
        val = outs.get(slot.name) if outs else None
        if not names or val is None:
            continue
        if slot.duplicable:
            for n, v in zip(names, val):
                if n and v is not None:
                    env[n] = v
        elif names[0]:
            env[names[0]] = val


_OPTIMIZER_OP_TYPES = frozenset(
    ("sgd", "momentum", "adam", "adamw", "adagrad", "rmsprop", "lamb",
     "lars_momentum", "dgc_momentum", "ftrl", "adamax", "adadelta"))


def _is_training(program: Program) -> bool:
    """A program that updates state: has backward or optimizer ops (the
    training program, not a startup or an eval program)."""
    return any(op.type.endswith("_grad") or op.type in _OPTIMIZER_OP_TYPES
               for b in program.blocks for op in b.ops)


def _training_cached(program: Program) -> bool:
    cached = getattr(program, "_chaos_is_training", None)
    if cached is None:
        cached = isinstance(program, Program) and _is_training(program)
        program._chaos_is_training = cached
    return cached


def _unwrap_program(program):
    """The Program under a CompiledProgram (or the Program itself)."""
    if program is None or isinstance(program, Program):
        return program
    return getattr(program, "_program", program)


def _wrapper_chips(program) -> int:
    """Ranks of a CompiledProgram's (already-formed) world — the MFU
    denominator must scale with the cards that shared the step, since
    the feed (and the walked FLOPs) is the global batch.  1 when no
    world is known yet, or for the other wrappers."""
    world = getattr(program, "_world", None)
    return world.size if world is not None else 1


def _is_startup(program: Program) -> bool:
    """The startup program: marked by program_guard, else every op an
    initializer."""
    if program._role is not None:
        return program._role == "startup"
    init_types = {"fill_constant", "uniform_random", "gaussian_random",
                  "truncated_gaussian_random", "assign_value", "eye",
                  "c_broadcast", "broadcast", "seed", "range", "linspace"}
    ops = program.global_block().ops
    return len(ops) > 0 and all(op.type in init_types for op in ops)


class _CkptHook:
    """Periodic-checkpoint registration (enable_checkpointing): `program`
    is latched onto the first training program run when None; `compiled`
    is the CompiledProgram it last ran through (its global_state gathers a
    sharded scope); `run_scope` the scope it last ran in; `last` the
    executor step of the latest save."""

    __slots__ = ("manager", "program", "every", "scope", "last",
                 "run_scope", "compiled")

    def __init__(self, manager, program, every, scope, last):
        self.manager, self.program, self.every = manager, program, every
        self.scope, self.last = scope, last
        self.run_scope = None
        self.compiled = None


def _to_tensor(value, device) -> torch.Tensor:
    """A restored value (a CPU tensor, or a numpy array from a layout
    conversion) as a tensor on `device`, owning its memory."""
    if not isinstance(value, torch.Tensor):
        a = np.asarray(value)
        value = torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))
    return value.to(device, copy=True)


def _fetch_names(fetch_list) -> List[str]:
    return [f.name if hasattr(f, "name") else str(f)
            for f in (fetch_list or [])]


def _is_compiled(program) -> bool:
    """True for a CompiledProgram; False for a Program or a runnable
    wrapper (`_is_wrapper`); raises for any other kind."""
    from ..distributed.compiled_program import CompiledProgram
    if isinstance(program, CompiledProgram):
        return True
    if isinstance(program, Program) or _is_wrapper(program):
        return False
    raise TypeError(
        f"the executor takes a Program, a CompiledProgram, a pipeline or a "
        f"parameter-server trainer program, got {type(program).__name__}")


def _is_wrapper(program) -> bool:
    """A runnable program wrapper that is not a CompiledProgram: the
    pipeline (pipeline/pipeline_program.py) and the parameter-server
    trainer program (distributed/ps/ps_optimizer.py) run through their
    own `_run(executor, feed, fetch_list, scope, return_numpy)`."""
    from ..distributed.compiled_program import CompiledProgram
    return program is not None and not isinstance(
        program, (Program, CompiledProgram)) and hasattr(program, "_run")


def _serve_pserver(program) -> list:
    """exe.run of a transpiler's pserver program: serve the KV store
    (listen_and_serv) until a trainer's shutdown rpc."""
    from ..distributed.ps.kv_server import KVServer
    cfg = program._ps_server_config
    KVServer(cfg["endpoint"],
             num_trainers=cfg.get("num_trainers", 1)).serve()
    return []


def _persistable_names(program: Program) -> List[str]:
    return sorted(v.name for b in program.blocks for v in b.vars.values()
                  if v.persistable)


def _release_plan(program: Program, keep) -> List[List[str]]:
    """For each op of the global block, the names no later op reads or
    writes: values to drop from the environment after it, leaving out the
    persistables and `keep` (the fetches)."""
    keep = set(keep) | set(_persistable_names(program))
    ops = program.global_block().ops
    last = {}
    for i, op in enumerate(ops):
        for n in op.input_names() + op.output_names():
            if n:
                last[n] = i
    plan: List[List[str]] = [[] for _ in ops]
    for n, i in last.items():
        if n not in keep:
            plan[i].append(n)
    return plan


def _run_ops(ops, plan, env, ctx):
    """Run `ops` in order over `env`, dropping each value after its last
    use (`plan`, from _release_plan)."""
    for op, dead in zip(ops, plan):
        _run_op(op, env, ctx)
        for n in dead:
            env.pop(n, None)


def run_block(program: Program, block_idx: int, env: Dict[str, Any],
              ctx: OpContext) -> Dict[str, Any]:
    """Run block `block_idx` of `program` over `env` (in place, nothing
    released) with the op loop of `run`: the entry of the sub-block ops
    (`while`, `cond`, `conditional_block`), as the JAX package's
    BlockTracer is, and of a recorded `to_static` program's replay
    (jit/).  `ctx.program` is set to `program`, where the sub-block ops
    find their blocks."""
    ctx.program = program
    for op in program.blocks[block_idx].ops:
        if op.type in ("feed", "fetch"):
            continue
        _run_op(op, env, ctx)
    return env


def _comm_calls() -> Dict[str, int]:
    from ..ops.kernels.collective import COMM_STATS
    return dict(COMM_STATS["calls_by_op"])


def _count_replayed(comm: Dict[str, int]) -> None:
    """Add a captured step's collectives (by op) to COMM_STATS'
    "replayed_by_op": the Python-side counts move only while capturing,
    so a replay's collectives are counted from its capture."""
    if not comm:
        return
    from ..ops.kernels.collective import COMM_STATS
    rep = COMM_STATS.setdefault("replayed_by_op", {})
    for n, c in comm.items():
        rep[n] = rep.get(n, 0) + c


class _StepGraph:
    """One captured step: the CUDA graph, the static per-step feed buffers
    and the step-seed buffer it reads, the persistable buffers it reads
    and updates in place, and the fetch tensors each replay overwrites."""

    def __init__(self, graph, feeds: Dict[str, torch.Tensor],
                 seed: torch.Tensor, state: Dict[str, torch.Tensor],
                 fetches: List[torch.Tensor]):
        self.graph, self.feeds, self.seed, self.state, self.fetches = \
            graph, feeds, seed, state, fetches
        self.comm: Dict[str, int] = {}  # collectives by op, per replay

    def bind_state(self, scope: "Scope"):
        """Point the scope at the buffers.  `run()` rebinds the scope's
        persistables to new tensors, so a scope tensor that is not the
        buffer holds the newer value: copy it in first."""
        for n, buf in self.state.items():
            cur = scope.vars.get(n)
            if cur is buf:
                continue
            if cur is None or tuple(cur.shape) != tuple(buf.shape):
                raise ValueError(
                    f"run_steps: persistable {n!r} is "
                    f"{None if cur is None else tuple(cur.shape)} in the "
                    f"scope, the captured step holds {tuple(buf.shape)}")
            buf.copy_(cur)
            scope.set(n, buf)


class Executor:
    """exe = Executor(CUDAPlace(0)); exe.run(startup); exe.run(main, feed,
    fetch_list) — the reference's two-program contract."""

    def __init__(self, place: Optional[Place] = None):
        self.place = resolve_place(place)
        self.device = self.place.torch_device()
        self._step = 0
        self._graphs: Dict[Tuple, _StepGraph] = {}
        self._stats = {"hits": 0, "misses": 0, "traces": 0}
        # training runs only (run_steps calls count once): the chaos step
        # index, "kill@<n>" meaning after the n-th training run
        self._train_runs = 0
        # elastic micro-steps run (elastic CompiledProgram runs only, so
        # global step = _elastic_steps // K survives startup/eval runs)
        self._elastic_steps = 0
        self._last_elastic_k = 1
        self._last_elastic_world = 1
        self._elastic_rebase_global = None
        self._ckpt: Optional[_CkptHook] = None
        self._ckpt_barrier = None
        self._active_prefetcher = None
        self.last_restored_extra = None  # the sidecar of the last resume
        # step telemetry: the card's peak rate (resolved once) and the
        # training steps observed (the device peak is read every 64)
        self._peak_flops = None
        self._observed_steps = 0

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        program = program if program is not None else default_main_program()
        t0 = time.perf_counter()
        if _is_compiled(program) or _is_wrapper(program):
            results = program._run(self, feed, fetch_list, scope,
                                   return_numpy)
            self._after_train_run(program, scope or global_scope(),
                                  time.perf_counter() - t0, 1, feed or {},
                                  chips=_wrapper_chips(program))
            return results
        if getattr(program, "_ps_server_config", None):
            return _serve_pserver(program)
        scope = scope or global_scope()
        if not _is_startup(program):
            from ..incubate.checkpoint.auto_checkpoint import \
                _auto_checkpoint
            _auto_checkpoint(self, program)
        fetch_names = _fetch_names(fetch_list)
        # env-gated IR verification (PADDLE_TPU_VERIFY, static/verifier.py)
        # of each (program, fetch set) once: a no-op when the env is unset
        from .verifier import verify_first_compile
        verify_first_compile(program, fetch_list=fetch_names)
        fetched = self._run_one(program, feed or {}, fetch_names, scope)
        self._after_train_run(program, scope, time.perf_counter() - t0, 1,
                              feed or {})
        if return_numpy:
            return [as_numpy(f) for f in fetched]
        return fetched

    def _run_one(self, program, feed, fetch_names, scope):
        """One step of a Program (no hooks): the fetched tensors."""
        fetched = self._run_program(program, feed, fetch_names, scope,
                                    self._seed_for_step(program))
        self._step += 1
        return fetched

    def _after_train_run(self, program, scope, dt, steps, feed_vals,
                         stacked=False, chips=1):
        """The hooks of a finished run / run_steps call: telemetry (the
        gauges, the heartbeat and the journal's step event), the periodic
        checkpoint and the chaos step, each for training programs only.
        They run after the call returned, never inside a captured
        `run_steps` window."""
        p = _unwrap_program(program)
        training = _training_cached(p)
        if training:
            self._observe_step(p, dt, feed_vals, steps, chips, stacked)
        self._maybe_checkpoint(program, scope)
        if training:
            self._chaos_step()

    @staticmethod
    def _feed_tokens(feed_vals, stacked: bool) -> int:
        """Tokens processed by one dispatch, inferred from the feed: the
        largest >=2-D integer feed's numel (ids-style models — the
        labels feed ties, max() is stable); else batch rows (x-style
        models).  `stacked` marks run_steps feeds ([K, B, ...]: rows
        are the two leading dims)."""
        best_int = 0
        rows = 0
        for v in feed_vals.values():
            shape = tuple(getattr(v, "shape", ()) or ())
            if not shape:
                continue
            dt = getattr(v, "dtype", None)
            if isinstance(dt, torch.dtype):
                kind = "i" if not (dt.is_floating_point or dt.is_complex
                                   or dt == torch.bool) else "f"
            else:
                try:
                    kind = np.dtype(str(dt)).kind if dt is not None \
                        else "?"
                except TypeError:  # a dtype numpy can't parse
                    kind = "?"
            if kind in ("i", "u") and len(shape) >= 2:
                n = 1
                for d in shape:
                    n *= int(d)
                best_int = max(best_int, n)
            lead = int(shape[0])
            if stacked and len(shape) >= 2:
                lead *= int(shape[1])
            rows = max(rows, lead)
        return best_int or rows

    @staticmethod
    def _feed_batch(feed_vals, stacked: bool) -> int:
        """Per-step batch from the feed's leading dims (the -1 binding
        for the cached FLOPs/HBM walks); `stacked` = run_steps feeds
        whose per-step batch is axis 1.  The MOST COMMON candidate wins
        (ties -> largest) so a lone non-batch feed — a fed lr of shape
        [1], a lookup table — cannot poison the per-program cache."""
        counts: Dict[int, int] = {}
        for v in feed_vals.values():
            shape = tuple(getattr(v, "shape", ()) or ())
            if len(shape) >= (2 if stacked else 1):
                b = int(shape[1] if stacked else shape[0])
                counts[b] = counts.get(b, 0) + 1
        if not counts:
            return 0
        return max(counts, key=lambda b: (counts[b], b))

    def _flops_per_step(self, p, batch) -> Optional[int]:
        """analyze_flops total for this program at `batch`, cached on
        the program (one IR walk per distinct batch, then a dict hit)."""
        cache = p.__dict__.setdefault("_flops_by_batch", {})
        if batch not in cache:
            try:
                from .flops_analysis import analyze_flops
                cache[batch] = analyze_flops(p, batch=batch)[
                    "total_flops"]
            except Exception:
                cache[batch] = None  # telemetry never kills training
        return cache[batch]

    def _observe_step(self, p, dt, feed_vals, steps=1, chips=1,
                      stacked=False):
        """Per-train-step telemetry: wall time, tokens/s, walked-FLOPs
        MFU, predicted and measured peak memory into core/monitor; one
        journal event; one heartbeat.  The metrics sidecar starts at the
        first training step where PADDLE_TPU_METRICS_PORT is set.  Fully
        fenced: telemetry must never kill a training run, so ANY failure
        here degrades to a silently skipped observation."""
        try:
            self._observe_step_inner(p, dt, feed_vals, steps, chips,
                                     stacked)
        except Exception:
            pass

    def _observe_step_inner(self, p, dt, feed_vals, steps, chips,
                            stacked):
        from ..core.monitor import gauge_set, hist_observe
        from ..observability import heartbeat as _hb
        from ..observability import journal as _journal
        from ..observability.sidecar import maybe_start_from_env
        maybe_start_from_env()
        self._observed_steps += steps
        stat_add("train.steps", steps)
        step_ms = dt * 1e3 / max(1, steps)
        hist_observe("train.step_ms", step_ms)
        tokens = self._feed_tokens(feed_vals, stacked=stacked)
        tps = None
        if tokens and dt > 0:
            tps = tokens / dt
            gauge_set("train.tokens_per_sec", tps)
        mfu = None
        if self._peak_flops is None:
            from .flops_analysis import peak_flops_per_chip
            try:
                self._peak_flops = float(peak_flops_per_chip())
            except Exception:
                self._peak_flops = 0.0
        if self._peak_flops and dt > 0:
            batch = self._feed_batch(feed_vals, stacked=stacked)
            flops = self._flops_per_step(p, batch) if batch else None
            if flops:
                mfu = (flops * steps) / dt / (self._peak_flops
                                              * max(1, chips))
                gauge_set("train.mfu", mfu)
        # predicted-vs-measured peak memory: the estimate once per
        # program and batch, the allocator's answer every 64 steps
        if self._observed_steps == steps or \
                self._observed_steps % 64 < steps:
            self._observe_hbm(p, feed_vals, stacked)
        _hb.maybe_beat(self._step, wall_ms=round(step_ms, 3))
        if _journal.journal_enabled():
            ev = {"step": self._step, "wall_ms": round(step_ms, 3)}
            if steps > 1:
                ev["micro_steps"] = steps
            if tps is not None:
                ev["tokens_per_sec"] = round(tps, 1)
            if mfu is not None:
                ev["mfu"] = round(mfu, 5)
            _journal.emit("step", **ev)

    def _observe_hbm(self, p, feed_vals, stacked):
        from ..core.monitor import gauge_set
        try:
            batch = self._feed_batch(feed_vals, stacked=stacked)
            cache = p.__dict__.setdefault("_hbm_by_batch", {})
            if batch and batch not in cache:
                from .memory_analysis import estimate_peak_bytes
                cache[batch] = estimate_peak_bytes(p, batch=batch)
            if batch and cache.get(batch):
                gauge_set("hbm.predicted_peak_bytes", cache[batch])
            if self.device.type == "cuda":
                # the caching allocator's counter: a host read, no sync
                peak = torch.cuda.max_memory_allocated(self.device)
                if peak:
                    gauge_set("hbm.device_peak_bytes", int(peak))
        except Exception:
            pass  # exotic programs; telemetry never fails a step

    def _chaos_step(self):
        if not _chaos.enabled():
            return
        self._train_runs += 1
        _chaos.step_hook(self._train_runs)

    def _run_program(self, program, feed, fetch_names, scope, seed):
        """One step of `program` with the step seed `seed`: the fetched
        tensors; the persistables it wrote go back to `scope`."""
        block = program.global_block()
        # no_grad, not inference_mode: the grad ops' torch.func.vjp needs
        # tensors that autograd may save (it ignores an outer no_grad, but
        # refuses inference tensors and, in some torch versions, returns
        # zero gradients inside inference_mode)
        with torch.no_grad():
            env = {k: v for k, v in scope.vars.items() if v is not None}
            for name, val in feed.items():
                env[name] = self._coerce_feed(block, name, val)
            ctx = OpContext(seed=seed, is_test=False, device=self.device)
            ctx.program = program
            _run_ops(block.ops, _release_plan(program, fetch_names), env,
                     ctx)
        # persistables written by the program (startup initializers) stay
        for n in _persistable_names(program):
            if n in env and env[n] is not scope.vars.get(n):
                scope.set(n, env[n])
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError(f"fetch targets {missing} were not produced")
        return [env[n] for n in fetch_names]

    def run_steps(self, program=None, feed=None, fetch_list=None,
                  scope=None, return_numpy=True):
        """Run K consecutive steps; every array in `feed` carries a leading
        steps axis K and each fetch comes back stacked [K, ...].  The
        scope ends holding the state after the K-th step, and the per-step
        seeds follow the walk of K `run()` calls.  On the CPU this loops
        over `run()`; on CUDA one captured step (a CUDA graph) is replayed
        K times, each step drawing with its own seed (dropout, the random
        ops).  A CompiledProgram runs its own steps (module docstring).
        FLAGS_check_nan_inf raises after the K steps on a non-finite fetch
        or persistable."""
        program = program if program is not None else default_main_program()
        if _is_wrapper(program):
            raise TypeError(
                f"run_steps takes a Program or a CompiledProgram, got "
                f"{type(program).__name__}: run it a step at a time with "
                "run()")
        compiled = None
        if _is_compiled(program):
            compiled, program = program, program._get_program()
        scope = scope or global_scope()
        fetch_names = _fetch_names(fetch_list)
        block = program.global_block()
        stacked = {n: self._coerce_feed(block, n, v)
                   for n, v in (feed or {}).items()}
        if not stacked:
            raise ValueError("run_steps needs at least one stacked feed "
                             "to define the number of steps")
        k = None
        for n, v in stacked.items():
            if v.dim() == 0:
                raise ValueError(
                    f"run_steps feed {n!r} is a scalar; every feed needs "
                    f"a leading steps axis (stack K per-step values)")
            k = v.shape[0] if k is None else k
            if v.shape[0] != k:
                raise ValueError(
                    f"feed {n!r} leading (steps) dim {v.shape[0]} != {k}")
        if k == 0:
            raise ValueError("run_steps feeds have 0 steps")
        if compiled is None:
            # a CompiledProgram verifies on each rank's first run itself
            from .verifier import verify_first_compile
            verify_first_compile(program, fetch_list=fetch_names)
        t0 = time.perf_counter()
        if compiled is not None:
            fetched = compiled._run_steps(self, stacked, k, fetch_names,
                                          scope)
        elif self.device.type == "cuda" and not has_host_ops(program):
            fetched = self._replay_steps(program, stacked, k, fetch_names,
                                         scope)
        else:
            steps = [self._run_one(program,
                                   {n: v[i] for n, v in stacked.items()},
                                   fetch_names, scope)
                     for i in range(k)]
            fetched = [torch.stack([s[j] for s in steps])
                       for j in range(len(fetch_names))]
        arrays = as_numpy(fetched) if return_numpy or \
            _flags.flag("check_nan_inf", False) else None
        if _flags.flag("check_nan_inf", False):
            _check_nan_inf(program, fetch_names, arrays, scope, k)
        self._after_train_run(compiled if compiled is not None else program,
                              scope, time.perf_counter() - t0, k, stacked,
                              stacked=True,
                              chips=_wrapper_chips(compiled)
                              if compiled is not None else 1)
        return arrays if return_numpy else fetched

    def memory_report(self, program=None, feed=None, scope=None,
                      batch=None, dp_shard=None):
        """Build-time memory accounting for one training step of
        `program` (static/memory_analysis.py): the op-IR liveness
        estimate always; on a CUDA device with `feed` given, also one
        measured step's ``torch.cuda.max_memory_allocated`` (after
        ``reset_peak_memory_stats``), where the JAX package returns
        XLA's ``memory_analysis``.  The measured step runs in a scratch
        scope over the same tensors (the kernels are functional), so the
        caller's state and the executor's step count do not move.

        Returns ``{"estimate": <analyze_program dict>, "peak_bytes",
        "budget_bytes", "fits", "device": {...} | None}``.  `batch`
        binds symbolic -1 dims for the estimate; when omitted it is
        inferred from the feed's leading dim."""
        from .memory_analysis import analyze_program
        program = _unwrap_program(program or default_main_program())
        if batch is None and feed:
            for v in feed.values():
                shape = tuple(getattr(v, "shape", None) or np.shape(v))
                if len(shape):
                    batch = int(shape[0])
                    break
        est = analyze_program(program, batch=batch, dp_shard=dp_shard)
        report = {"estimate": est, "peak_bytes": est["peak_bytes"],
                  "budget_bytes": est["budget_bytes"],
                  "fits": est["fits"], "device": None}
        if feed and self.device.type == "cuda":
            scope = scope or global_scope()
            scratch = Scope()
            scratch.vars = dict(scope.vars)
            torch.cuda.synchronize(self.device)
            base = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            self._run_program(program, feed, [], scratch,
                              self._seed_for_step(program))
            torch.cuda.synchronize(self.device)
            peak = torch.cuda.max_memory_allocated(self.device)
            del scratch
            report["device"] = {
                "max_memory_allocated": int(peak),
                "allocated_before_step": int(base),
                "device_name": torch.cuda.get_device_name(self.device)}
        return report

    # -- dataset-driven training (the reference's MultiTrainer loop) -------
    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100,
                           fetch_handler=None):
        """One pass over `dataset` (distributed/dataset.py), a step per
        batch; returns the last step's fetches."""
        from ..distributed.dataset import run_from_dataset
        if fetch_handler is not None:
            raise NotImplementedError(
                "fetch_handler callbacks are not supported; poll "
                "fetch_list/print_period instead")
        program = program if program is not None else default_main_program()
        if thread:
            dataset.set_thread(thread)
        return run_from_dataset(self, program, dataset, scope,
                                fetch_list, fetch_info, print_period, debug)

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100,
                           fetch_handler=None):
        """train_from_dataset on a test-mode clone with the backward,
        optimizer and lr-schedule ops stripped: it leaves the parameters
        as they were."""
        from ..core.program import OpRole
        program = program if program is not None else default_main_program()
        infer = program.clone(for_test=True)
        blk = infer.global_block()
        train_roles = (OpRole.Backward, OpRole.Optimize, OpRole.LRSched,
                       OpRole.Optimize | OpRole.LRSched)
        blk.ops = [op for op in blk.ops
                   if op.attrs.get(OpRole.KEY, OpRole.Forward)
                   not in train_roles]
        return self.train_from_dataset(infer, dataset, scope, thread,
                                       debug, fetch_list, fetch_info,
                                       print_period)

    # -- the prefetch-driven step loop ------------------------------------
    def run_prefetched(self, program, feeds, fetch_list=None, scope=None,
                       return_numpy=True, prefetch_depth=2):
        """Generator over `feeds` (an iterable of feed dicts) whose
        placement on the executor's device rides a worker thread
        (reader/prefetcher.py) while the previous batch computes.  Yields
        each step's fetch list; a checkpoint taken meanwhile records the
        batches consumed (`extra["dataset_position"]`)::

            for out in exe.run_prefetched(main, batches, fetch_list=[loss]):
                ...
        """
        from ..reader.prefetcher import Prefetcher
        pf = Prefetcher(feeds, depth=prefetch_depth, device=self.device)
        self._active_prefetcher = pf
        try:
            for feed in pf:
                yield self.run(program, feed=feed, fetch_list=fetch_list,
                               scope=scope, return_numpy=return_numpy)
        finally:
            self._active_prefetcher = None
            pf.close()

    # -- checkpointing (checkpoint/) ---------------------------------------
    def enable_checkpointing(self, manager, program=None, every_n_steps=100,
                             scope=None, barrier=None):
        """Periodic async checkpoints of `program`'s persistable state.

        After every run() / run_steps() that advances the executor step
        across an ``every_n_steps`` boundary, the persistables (params AND
        optimizer accumulators), the executor step and the RNG state are
        snapshotted and handed to `manager`.  Also registers the manager's
        preemption state provider (CheckpointManager.
        install_preemption_handler).

        With ``program=None`` the hook binds to the first TRAINING program
        run after enabling; startup and eval programs neither trigger
        saves nor hijack the snapshot.  With a ``world_size > 1`` manager,
        `barrier` (e.g. ``paddle_tpu_torch.distributed.barrier``) lets the
        hook publish each staged checkpoint during the run: save → wait →
        barrier → rank-0 commit.  Without one, stages stay pending until
        the next rank-0 startup recovers them."""
        if every_n_steps < 1:
            raise ValueError("every_n_steps must be >= 1")
        self._ckpt = _CkptHook(manager=manager, program=program,
                               every=int(every_n_steps), scope=scope,
                               last=self._step)
        self._ckpt_barrier = barrier
        if getattr(manager, "world_size", 1) > 1 and barrier is None:
            warnings.warn(
                "multi-host CheckpointManager without barrier=: periodic "
                "checkpoints are only STAGED during the run and get "
                "committed at the next rank-0 startup; pass barrier= "
                "(e.g. paddle_tpu_torch.distributed.barrier) to publish "
                "them as training goes", RuntimeWarning, stacklevel=2)

        def _provider():
            # the preemption save runs in a signal handler: no collective
            # there (the peers are not in it), so a sharded scope is saved
            # as this rank's shards
            hook = self._ckpt
            prog = (hook.program if hook else None) or program
            sc = (hook.scope or hook.run_scope) if hook else scope
            return self.checkpoint_snapshot(prog, sc)

        manager.set_state_provider(_provider)

    def disable_checkpointing(self):
        if self._ckpt is not None:
            self._ckpt.manager.set_state_provider(None)
        self._ckpt = None

    def checkpoint_snapshot(self, program=None, scope=None, compiled=None):
        """(step, state, extra) for CheckpointManager.save: the persistable
        scope values, the executor step, the RNG state and the sidecars
        of a world change (ZeRO plan, elastic schedule, gradient merge,
        dataset position).  `program` may be a CompiledProgram; with one
        (or `compiled=`) whose scope holds shards, the state is its
        `global_state` (a collective: every rank must snapshot)."""
        program = program or default_main_program()
        if compiled is None and _is_compiled(program):
            compiled = program
        program = _unwrap_program(program)
        scope = scope or global_scope()
        names = [n for n in _persistable_names(program)
                 if scope.get(n) is not None]
        if compiled is not None and compiled._world is not None and \
                compiled._world.size > 1 and compiled._holds_shards(names):
            state = compiled.global_state(scope, names)
        else:
            state = {n: scope.get(n) for n in names}
        from ..core.generator import get_rng_state
        extra = {"executor_step": self._step, "rng": get_rng_state(),
                 "program_fingerprint": program.fingerprint()}
        plan = getattr(program, "_zero_shard_plan", None)
        if plan is not None and getattr(plan, "buckets", None):
            extra["zero_shard_plan"] = plan.to_dict()
            extra["dp_degree"] = int(plan.dp_degree)
        el = getattr(program, "_elastic_meta", None)
        if el is not None:
            cnt = scope.get(el["counter"])
            extra["elastic"] = {
                "logical_dp": int(el["logical_dp"]),
                "k": int(self._last_elastic_k),
                "world": int(self._last_elastic_world),
                "counter": el["counter"], "accs": list(el["accs"]),
                # the program's persistable micro counter is the
                # authoritative schedule position
                "counter_value": int(cnt.reshape(-1)[0])
                if cnt is not None else self._elastic_steps}
        gm = getattr(program, "_gm_meta", None)
        if gm is not None:
            extra["gradient_merge"] = dict(gm)
        pf = self._active_prefetcher
        if pf is not None:
            extra["dataset_position"] = pf.position
        return self._step, state, extra

    def _maybe_checkpoint(self, program, scope):
        hook = self._ckpt
        if hook is None:
            return
        run_p = _unwrap_program(program)
        if hook.program is None:
            if not (isinstance(run_p, Program) and _training_cached(run_p)):
                return
            hook.program = run_p
        if run_p is not _unwrap_program(hook.program):
            return
        hook.run_scope = scope
        if _is_compiled(program):
            hook.compiled = program
        if self._step - hook.last < hook.every:
            return
        step, state, extra = self.checkpoint_snapshot(
            hook.program, hook.scope or scope, compiled=hook.compiled)
        hook.manager.save(step, state, extra=extra)
        if getattr(hook.manager, "world_size", 1) > 1 and \
                self._ckpt_barrier is not None:
            # every rank staged and fsync'd, then rank 0 publishes
            hook.manager.wait()
            self._ckpt_barrier()
            hook.manager.commit(step)
        hook.last = self._step

    def restore_from_checkpoint(self, manager, program=None, scope=None,
                                step=None, world=None,
                                on_mismatch="convert"):
        """Auto-resume: load the newest VALID checkpoint (the manager skips
        corrupt ones), write the state into the scope on this executor's
        device, and restore the executor step and RNG state so the step
        seeds replay.  Returns the restored step, or None when the root
        holds no checkpoint.

        A fingerprint mismatch with `program` (a CompiledProgram or a
        Program) is a topology shift: a ZeRO layout is converted through
        ``unshard_state`` → ``reshard_state`` for the target plan; an
        elastic program's micro-step counter and executor step are
        re-derived for K = logical_dp / `world` (default: this process's
        world; the CompiledProgram re-anchors for its own group at its
        first run); a gradient-merge counter is re-denominated for the
        target k.  ``on_mismatch``: "convert" (default), "error" (raise
        CheckpointError on an unconvertible mismatch) or "warn".  The
        sidecar stays on ``self.last_restored_extra``; its
        ``dataset_position`` is where the feed source resumes."""
        if on_mismatch not in ("convert", "error", "warn"):
            raise ValueError(
                f"on_mismatch must be 'convert', 'error' or 'warn', "
                f"got {on_mismatch!r}")
        import inspect
        load_kwargs = {"step": step}
        try:
            if "on_mismatch" in inspect.signature(
                    manager.load).parameters:
                load_kwargs["on_mismatch"] = on_mismatch
        except (TypeError, ValueError):
            pass
        ckpt = manager.load(**load_kwargs)
        if ckpt is None:
            self.last_restored_extra = None
            return None
        scope = scope or global_scope()
        compiled = program if program is not None and \
            _is_compiled(program) else None
        extra = dict(ckpt.extra)
        state = dict(ckpt.state)
        target = _unwrap_program(program) if program is not None else None
        saved_fp = extra.get("program_fingerprint")
        if target is not None and saved_fp is not None and \
                target.fingerprint() != saved_fp:
            state = self._convert_topology_shift(
                state, extra, target, on_mismatch)
        for name, val in state.items():
            scope.set(name, _to_tensor(val, self.device))
        if compiled is not None:
            # the scope holds global arrays now: the next run re-syncs and
            # cuts them to this rank's shards
            compiled._synced.discard(scope)
        self._step = int(extra.get("executor_step", ckpt.step))
        self._rederive_elastic(target, scope, extra, world)
        self._rederive_gradient_merge(target, scope, extra)
        if self._ckpt is not None:
            # the next run must not re-save the state just loaded
            self._ckpt.last = self._step
        if "rng" in extra:
            from ..core.generator import set_rng_state
            set_rng_state(extra["rng"])
        self.last_restored_extra = dict(extra)
        from ..observability.journal import emit as _jemit
        _jemit("restore", step=int(ckpt.step),
               executor_step=int(self._step),
               global_step=extra.get("global_step"))
        return ckpt.step

    def _convert_topology_shift(self, state, extra, target, on_mismatch):
        """Fingerprint mismatch triage: convert ZeRO layouts when the plans
        are recorded, otherwise warn (or raise under 'error')."""
        saved_plan = extra.get("zero_shard_plan")
        tgt_plan = getattr(target, "_zero_shard_plan", None)
        if tgt_plan is not None and not getattr(tgt_plan, "buckets", None):
            tgt_plan = None
        if saved_plan or tgt_plan is not None:
            from ..distributed.sharding import (reshard_state,
                                                unshard_state)
            src_dp = (saved_plan or {}).get("dp_degree", 1)
            tgt_dp = tgt_plan.dp_degree if tgt_plan is not None else 1
            try:
                converted = state
                if saved_plan:
                    converted = unshard_state(converted, saved_plan)
                if tgt_plan is not None:
                    converted = reshard_state(converted, tgt_plan)
            except (ValueError, KeyError) as e:
                if on_mismatch == "error":
                    from ..checkpoint import CheckpointError
                    raise CheckpointError(
                        "fingerprint mismatch is not a pure ZeRO-1 "
                        f"shard-count change (layout conversion failed: "
                        f"{e}) — refusing the chimera restore "
                        "(on_mismatch='error')") from e
                warnings.warn(
                    "restoring a checkpoint saved from a DIFFERENT "
                    f"program (fingerprint mismatch): ZeRO-1 layout "
                    f"conversion dp={src_dp} -> dp={tgt_dp} FAILED "
                    f"({e}); loading the unconverted state — resumed "
                    "training may diverge (pass on_mismatch='error' "
                    "to refuse)", RuntimeWarning, stacklevel=3)
                return state
            state = converted
            missing = [n for n in _persistable_names(target)
                       if n not in state]
            if missing:
                if on_mismatch == "error":
                    from ..checkpoint import CheckpointError
                    raise CheckpointError(
                        "fingerprint mismatch is not a pure ZeRO-1 "
                        "shard-count change: after layout conversion "
                        f"the checkpoint still lacks {missing[:8]}"
                        f"{'...' if len(missing) > 8 else ''} — "
                        "refusing the chimera restore "
                        "(on_mismatch='error')")
                warnings.warn(
                    "restoring a checkpoint saved from a DIFFERENT "
                    "program (fingerprint mismatch): converted the "
                    f"ZeRO-1 layout dp={src_dp} -> dp={tgt_dp}, but "
                    f"{len(missing)} target vars are still absent and "
                    "keep their fresh-init values — resumed training "
                    "may diverge (pass on_mismatch='error' to refuse)",
                    RuntimeWarning, stacklevel=3)
                return state
            warnings.warn(
                "restoring a checkpoint saved from a DIFFERENT program "
                "(fingerprint mismatch): automatically converted the "
                f"ZeRO-1 optimizer-state layout dp={src_dp} -> "
                f"dp={tgt_dp} (unshard_state -> reshard_state); "
                "training resumes on the re-bucketed state",
                RuntimeWarning, stacklevel=3)
            return state
        if on_mismatch == "error":
            from ..checkpoint import CheckpointError
            raise CheckpointError(
                "checkpoint program fingerprint does not match the "
                "target program and no recorded sharding plan makes the "
                "difference convertible; pass on_mismatch='warn' to "
                "force the (diverging) chimera restore")
        warnings.warn(
            "restoring a checkpoint saved from a DIFFERENT "
            "program (fingerprint mismatch): vars absent from "
            "the checkpoint keep their fresh-init values and "
            "orphan checkpoint vars are still written — resumed "
            "training may diverge from the original run "
            "(pass on_mismatch='error' to refuse chimera loads)",
            RuntimeWarning, stacklevel=3)
        return state

    def _rederive_elastic(self, target, scope, extra, world):
        """The elastic schedule position in the new world's denomination:
        K = logical_dp / `world` (default: this process's world)."""
        el_meta = getattr(target, "_elastic_meta", None) \
            if target is not None else None
        if el_meta is None or "elastic" not in extra:
            return
        from ..distributed.elastic import rederive_schedule, _world_now
        new_world = int(world) if world else _world_now()
        red = rederive_schedule(extra, new_world)
        if red is None:
            return
        self._step = red["executor_step"]
        self._elastic_steps = red["executor_step"]
        self._last_elastic_k = red["k_new"]
        self._last_elastic_world = new_world
        # a CompiledProgram re-anchors for its ACTUAL group on its first run
        self._elastic_rebase_global = red["global_step"]
        scope.set(el_meta["counter"], torch.full(
            (1,), red["counter_value"], dtype=torch.int32,
            device=self.device))
        if red["replayed_micro"]:
            for acc in el_meta["accs"]:
                v = scope.get(acc)
                if v is not None:
                    scope.set(acc, torch.zeros_like(v))
        if "dataset_position" in extra:
            # GLOBAL batches, the unit rebucket_feeds consumes
            extra["dataset_position"] = red["global_batches_consumed"]
        extra["global_step"] = red["global_step"]

    def _rederive_gradient_merge(self, target, scope, extra):
        """gradient_merge counter k_old -> k_new (a mid-window position
        rounds down to the last commit; that window replays)."""
        tgt_gm = getattr(target, "_gm_meta", None) \
            if target is not None else None
        saved_gm = extra.get("gradient_merge")
        if tgt_gm is None or not saved_gm:
            return
        k_old = max(1, int(saved_gm.get("k", 1)))
        k_new = max(1, int(tgt_gm.get("k", 1)))
        same_names = saved_gm.get("counter") == tgt_gm.get("counter")
        if k_old == k_new and same_names:
            return
        cnt = scope.get(saved_gm.get("counter")) \
            if saved_gm.get("counter") else None
        old_count = int(cnt.reshape(-1)[0]) if cnt is not None else 0
        commits, j = divmod(old_count, k_old)
        if j:
            warnings.warn(
                f"gradient_merge resume mid-window (micro {j}/{k_old}): "
                f"rounding down to commit {commits}; the partial window "
                "replays and its accumulators are reset", RuntimeWarning,
                stacklevel=3)
        scope.set(tgt_gm["counter"], torch.full(
            (1,), commits * k_new, dtype=torch.int32, device=self.device))
        for acc in tgt_gm.get("accs", []):
            v = scope.get(acc)
            if v is not None and (j or not same_names):
                scope.set(acc, torch.zeros_like(v))
        if "dataset_position" in extra:
            extra["dataset_position"] = commits * k_new

    def cache_stats(self) -> Dict[str, int]:
        """The step-graph cache of this executor: `hits`, `misses` and
        `traces` (captures; the number that must stop growing after the
        first `run_steps` call of a shape).  The same counts go to
        core/monitor.py as executor.graph_cache.*."""
        return dict(self._stats)

    def close(self):
        """Drop every captured step graph and free its memory pool."""
        self._graphs.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _record(self, kind):
        self._stats[kind] += 1
        stat_add("executor.graph_cache." + kind)

    def _graph_key(self, program, stacked, fetch_names, state_names,
                   key_extra):
        # the flags are part of the key: one read while the ops run
        # (FLAGS_fused_xent) picks kernels, and a capture bakes them in
        return (program.fingerprint(),
                tuple(sorted((n, tuple(v.shape[1:]), str(v.dtype))
                             for n, v in stacked.items())),
                tuple(fetch_names), tuple(state_names),
                tuple(sorted((n, repr(v)) for n, v in _flags._FLAGS.items())),
                tuple(key_extra))

    def _step_seeds(self, program, k, seed_of=None):
        """The seeds of K run() calls (each mapped by `seed_of`, a rank's
        seed rule, where given), uploaded once, copied per step."""
        seeds = [self._seed_for_step(program) + i for i in range(k)]
        if seed_of is not None:
            seeds = [seed_of(v) for v in seeds]
        return torch.tensor([[v] for v in seeds], dtype=torch.int64,
                            device=self.device)

    @staticmethod
    def _replay(entry, stacked=None, i=0, seed=None):
        """One replay of a captured step: the step's feeds and seed copied
        into its buffers first; the collectives it holds are counted
        (collective.COMM_STATS["replayed_by_op"])."""
        for n, buf in entry.feeds.items():
            buf.copy_(stacked[n][i])
        if seed is not None:
            entry.seed.copy_(seed)
        entry.graph.replay()
        _count_replayed(entry.comm)

    def _replay_steps(self, program, stacked, k, fetch_names, scope,
                      seed_of=None, finish=None, key_extra=(), seeds=None):
        """K replays of one captured step.  `seed_of` maps each step's
        seed to this rank's (a data-parallel rank's), or `seeds` gives
        the K seeds (an elastic window's); `finish(fetches)` runs inside
        the captured step on its fetches (a data-parallel rank's
        reduction over the ranks); `key_extra` joins the graph's key."""
        block = program.global_block()
        state_names = [n for n in _persistable_names(program)
                       if scope.get(n) is not None]
        key = self._graph_key(program, stacked, fetch_names, state_names,
                              key_extra)
        if seeds is None:
            seeds = self._step_seeds(program, k, seed_of)
        else:
            seeds = torch.tensor([[v] for v in seeds], dtype=torch.int64,
                                 device=self.device)
        with torch.cuda.device(self.device):
            entry = self._graphs.get(key)
            if entry is None:
                self._record("misses")
                entry = self._capture(block, stacked, seeds[0],
                                      fetch_names, state_names, scope,
                                      finish)
                self._record("traces")
                self._graphs[key] = entry
            else:
                self._record("hits")
            entry.bind_state(scope)
            steps = []
            for i in range(k):
                self._replay(entry, stacked, i, seeds[i])
                steps.append([f.clone() for f in entry.fetches])
        self._step += k
        return [torch.stack([s[j] for s in steps])
                for j in range(len(fetch_names))]

    def _replay_windows(self, split, state_names, stacked, k, fetch_names,
                        scope, seed_of=None, finish=None, key_extra=()):
        """The hoisted window (distributed/scan_window.py) as two captured
        steps over ONE set of state buffers: the body (`split.body`, one
        micro-step without the commit) replayed `split.k` times, then the
        tail (`split.tail`, the commit, no feeds or fetches) once, for
        each of the k / split.k windows.  The tail reads what the body
        wrote through the persistables only (the split's contract), so
        capturing both against the same buffers is the whole wiring."""
        key = self._graph_key(split.body, stacked, fetch_names, state_names,
                              key_extra + ("hoist", split.tail.fingerprint()))
        seeds = self._step_seeds(split.body, k, seed_of)
        with torch.cuda.device(self.device):
            pair = self._graphs.get(key)
            if pair is None:
                self._record("misses")
                body = self._capture(split.body.global_block(), stacked,
                                     seeds[0], fetch_names, state_names,
                                     scope, finish)
                # the scope holds the body's buffers now: the tail's
                # capture takes the same ones
                tail = self._capture(split.tail.global_block(), {},
                                     seeds[0], [], state_names, scope)
                self._record("traces")
                pair = self._graphs[key] = (body, tail)
            else:
                self._record("hits")
            body, tail = pair
            body.bind_state(scope)
            steps = []
            for i in range(k):
                self._replay(body, stacked, i, seeds[i])
                steps.append([f.clone() for f in body.fetches])
                if (i + 1) % split.k == 0:
                    self._replay(tail)
        self._step += k
        return [torch.stack([s[j] for s in steps])
                for j in range(len(fetch_names))]

    def _capture(self, block, stacked, seed, fetch_names, state_names,
                 scope, finish=None):
        """Capture one step of `block` over static buffers, the step seed
        read from a one-element buffer (`seed` is its first value).  A
        warm-up step runs first, eagerly on a side stream (as torch
        requires before capturing a backward): it builds and loads the
        hand kernels, sets their shared-memory attributes and lets
        autograd and cuBLAS make their lazy state (and NCCL its
        communicator, when `finish` or the step holds collectives).  Its
        results are dropped, so it changes no state."""
        state: Dict[str, torch.Tensor] = {}
        for n in state_names:
            t = scope.get(n)
            if t.device != self.device:
                t = t.to(self.device)
            if any(t is b for b in state.values()):
                t = t.clone()  # two names, one tensor: give each a buffer
            scope.set(n, t)
            state[n] = t
        feeds = {n: v[0].clone() for n, v in stacked.items()}
        seed_buf = seed.clone()
        plan = _release_plan(block.program, fetch_names)

        def step():
            env = dict(state)
            env.update(feeds)
            ctx = OpContext(seed=0, is_test=False, device=self.device,
                            seed_tensor=seed_buf)
            ctx.program = block.program
            with torch.no_grad():
                _run_ops(block.ops, plan, env, ctx)
                missing = [n for n in fetch_names if n not in env]
                if missing:
                    raise KeyError(
                        f"fetch targets {missing} were not produced")
                fetches = [env[n] for n in fetch_names]
                if finish is not None:
                    fetches = finish(fetches)
            return env, fetches

        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            env, fetches = step()
            del env, fetches
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = _comm_calls()
        try:
            with torch.cuda.graph(graph):
                env, fetches = step()
                bufs = list(state.values())
                written = {}
                for n, buf in state.items():
                    v = env[n]
                    if v is buf:
                        continue
                    # a value that is another persistable's buffer would
                    # be overwritten before it is read
                    written[n] = v.clone() if any(v is b for b in bufs) \
                        else v
                for n, v in written.items():
                    state[n].copy_(v)
        except RuntimeError as e:
            raise RuntimeError(
                f"CUDA graph capture of the step failed: {e}") from e
        entry = _StepGraph(graph, feeds, seed_buf, state, fetches)
        after = _comm_calls()
        entry.comm = {n: c - before.get(n, 0) for n, c in after.items()
                      if c != before.get(n, 0)}
        return entry

    def _coerce_feed(self, block, name, val):
        if isinstance(val, torch.Tensor):
            t = val
        else:  # ascontiguousarray alone would make a 0-d feed 1-d
            a = np.asarray(val)
            t = torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))
        try:
            want = block.var(name).dtype
        except KeyError:
            want = None
        if want is not None:
            t = t.to(torch_dtype(want))
        return t.to(self.device, non_blocking=False)

    def _seed_for_step(self, program: Program) -> int:
        return (int(program.random_seed) * 1000003 + self._step) % (2 ** 31)


def _check_nan_inf(program, fetch_names, fetched, scope, steps):
    """FLAGS_check_nan_inf after run_steps (the reference's post-scan
    check): non-finite values in the stacked fetches (naming the first
    step whose slice has one) or in the persistables, each named with the
    op that last wrote it."""
    bad = []
    for n, arr in zip(fetch_names, fetched):
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            step = None
            if steps > 1 and arr.ndim >= 1 and arr.shape[0] == steps:
                step = int(np.argmin(np.isfinite(
                    arr.reshape(steps, -1)).all(axis=1)))
            bad.append(("fetch", n, arr.dtype, step))
    for n in _persistable_names(program):
        v = scope.get(n)
        if v is None or not v.is_floating_point():
            continue
        if not bool(torch.isfinite(v).all()):
            bad.append(("var", n, str(v.dtype).replace("torch.", ""), None))
    if not bad:
        return
    producers = {}
    for b in program.blocks:
        for i, op in enumerate(b.ops):
            for out_name in op.output_names():
                if out_name:  # the last writer: the value the step kept
                    producers[out_name] = (b.idx, i, op)
    msgs = []
    for kind, n, dtype, step in bad:
        msg = f"{kind} {n!r} (dtype {dtype})"
        if step is not None:
            msg += f", first non-finite at micro-step {step}"
        hit = producers.get(n)
        if hit is not None:
            bi, oi, op = hit
            msg += (f", produced by op {op.type!r} (uid "
                    f"{op.attrs.get('op_uid')}, block {bi} op {oi})")
        msgs.append(msg)
    raise RuntimeError("FLAGS_check_nan_inf: non-finite values in "
                       + "; ".join(msgs))
