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
place: a failed NCCL capture raises.

Not ported yet: checkpoint hooks, per-step telemetry (later slices,
ROADMAP.md).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import flags as _flags
from ..core.dtype import torch_dtype
from ..core.monitor import stat_add
from ..core.place import Place, resolve_place
from ..core.program import Program, default_main_program
from ..ops.registry import get_op_info, OpContext

__all__ = ["Executor", "Scope", "global_scope", "scope_guard", "as_numpy"]


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


def _fetch_names(fetch_list) -> List[str]:
    return [f.name if hasattr(f, "name") else str(f)
            for f in (fetch_list or [])]


def _is_compiled(program) -> bool:
    """True for a CompiledProgram; False for a Program; raises for any
    other kind (pipeline and parameter-server trainer programs, which
    the JAX package's executor also dispatches, are not ported)."""
    from ..distributed.compiled_program import CompiledProgram
    if isinstance(program, CompiledProgram):
        return True
    if isinstance(program, Program):
        return False
    raise NotImplementedError(
        f"the executor takes a Program or a CompiledProgram, got "
        f"{type(program).__name__}: pipeline and parameter-server programs "
        "are not ported yet (ROADMAP.md Queue 1, Distribution)")


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

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        program = program if program is not None else default_main_program()
        if _is_compiled(program):
            return program._run(self, feed, fetch_list, scope, return_numpy)
        scope = scope or global_scope()
        fetched = self._run_program(program, feed or {},
                                    _fetch_names(fetch_list), scope,
                                    self._seed_for_step(program))
        self._step += 1
        if return_numpy:
            return [as_numpy(f) for f in fetched]
        return fetched

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
        if compiled is not None:
            fetched = compiled._run_steps(self, stacked, k, fetch_names,
                                          scope)
        elif self.device.type == "cuda":
            fetched = self._replay_steps(program, stacked, k, fetch_names,
                                         scope)
        else:
            steps = [self.run(program, {n: v[i] for n, v in stacked.items()},
                              fetch_names, scope, return_numpy=False)
                     for i in range(k)]
            fetched = [torch.stack([s[j] for s in steps])
                       for j in range(len(fetch_names))]
        arrays = as_numpy(fetched) if return_numpy or \
            _flags.flag("check_nan_inf", False) else None
        if _flags.flag("check_nan_inf", False):
            _check_nan_inf(program, fetch_names, arrays, scope, k)
        return arrays if return_numpy else fetched

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
                      seed_of=None, finish=None, key_extra=()):
        """K replays of one captured step.  `seed_of` maps each step's
        seed to this rank's (a data-parallel rank's); `finish(fetches)`
        runs inside the captured step on its fetches (a data-parallel
        rank's reduction over the ranks); `key_extra` joins the graph's
        key."""
        block = program.global_block()
        state_names = [n for n in _persistable_names(program)
                       if scope.get(n) is not None]
        key = self._graph_key(program, stacked, fetch_names, state_names,
                              key_extra)
        seeds = self._step_seeds(program, k, seed_of)
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
