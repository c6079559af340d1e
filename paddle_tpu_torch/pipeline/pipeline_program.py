"""Pipeline-parallel program splitting and the GPipe micro-batch schedule.

Counterpart of paddle_tpu/pipeline/pipeline_program.py (the reference's
pipeline stack: the program cut into per-device sections on the
`op_device` attr, PipelineTrainer with one scope per section and
micro-batch, SectionWorker's schedule of every forward, then every
backward, then the optimizer once).  One controller runs every stage: each
(stage, phase) slice of the block is a `_Phase` whose ops run through the
executor's op loop on the stage's `torch.device`, boundary tensors moving
there with `.to(device)`.  Where there are fewer devices than stages the
stages wrap (on one card every stage is cuda:0).  The JAX package jits
each phase and gets the overlap of stages from asynchronous dispatch; the
port dispatches eagerly, and CUDA's asynchronous launches give the same
overlap across devices.

The schedule: the fed mini-batch splits into M micro-batches along dim 0;
every forward runs (micro-batch by micro-batch, stages in order), then
every backward (stages in reverse), then the optimizer phase once over
the mean of the M micro-batch gradients, on the persistable state
overlaid with the last micro-batch's values.  Fetches with a leading dim
of the micro-batch size come back concatenated, float scalars averaged.
A micro-batch's values that neither the optimizer phase nor a fetch
reads are dropped after its backward.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import torch

from ..core.program import Block, OpDesc, OpRole, Program
from ..ops.registry import OpContext

__all__ = ["PipelineCompiledProgram", "assign_stages"]

_DEV_RE = re.compile(r"^(?:gpu|xla|tpu|cpu|npu|cuda)?:?(\d+)$")


def _stage_of_device(dev: Optional[str]) -> Optional[int]:
    if not dev:
        return None
    m = _DEV_RE.match(str(dev))
    return int(m.group(1)) if m else None


def assign_stages(block: Block) -> List[int]:
    """Stage index per op: an explicit op_device wins; otherwise the
    largest stage of its inputs' producers (ops across a cut land
    downstream, as the reference's section cut puts them).  A second,
    consumer-driven pass moves unanchored source ops (no device, no
    produced inputs: the loss cotangent's fill_constant seed, say) to the
    stage of their first consumer, so each phase's dataflow stays its
    own."""
    producer: Dict[str, int] = {}
    stages: List[int] = []
    unanchored: List[int] = []
    for i, op in enumerate(block.ops):
        s = _stage_of_device(op.attrs.get("op_device"))
        if s is None:
            ins = [producer.get(n) for n in op.input_names()]
            ins = [x for x in ins if x is not None]
            if ins:
                s = max(ins)
            else:
                s = 0
                unanchored.append(i)
        stages.append(s)
        for n in op.output_names():
            producer[n] = s

    if unanchored:
        consumer_stage: Dict[str, int] = {}
        for op, s in zip(block.ops, stages):
            for n in op.input_names():
                consumer_stage[n] = max(consumer_stage.get(n, 0), s)
        for i in unanchored:
            outs = block.ops[i].output_names()
            cs = [consumer_stage[n] for n in outs if n in consumer_stage]
            if cs:
                stages[i] = max(cs)
    return stages


def _to(v, device):
    """`v` on `device` (a SelectedRows moves its rows and values)."""
    from ..core.selected_rows import SelectedRows
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if isinstance(v, SelectedRows):
        return SelectedRows(v.rows.to(device), v.values.to(device),
                            v.height)
    return v


class _Phase:
    """One (stage, role) slice of the program: its ops in program order,
    the names it reads before writing, the names it writes, and its
    stage's device."""

    def __init__(self, ops: List[OpDesc], device):
        self.device = torch.device(device)
        self.ops = ops
        written: set = set()
        reads: List[str] = []
        for op in ops:
            for n in op.input_names():
                if n not in written and n not in reads:
                    reads.append(n)
            written.update(op.output_names())
        self.in_names = reads
        self.out_names = list(dict.fromkeys(
            n for op in ops for n in op.output_names()))

    def run(self, env: Dict[str, Any], seed: int) -> Dict[str, Any]:
        """Move this phase's inputs in `env` to its device, run its ops
        there, and leave their outputs in `env`."""
        if not self.ops:
            return env
        from ..static.executor import _run_op
        for n in self.in_names:
            if n in env:
                env[n] = _to(env[n], self.device)
        ctx = OpContext(seed=seed, is_test=False, device=self.device)
        with torch.no_grad():
            for op in self.ops:
                _run_op(op, env, ctx)
        return env


def _role_phase(op) -> str:
    role = op.attrs.get(OpRole.KEY, OpRole.Forward)
    if role & OpRole.Optimize or role == OpRole.LRSched:
        return "opt"
    if role & OpRole.Backward:
        return "bwd"
    return "fwd"


def mean_grads(pieces):
    """The mean of one gradient's micro-batch pieces (SelectedRows
    pieces: their rows concatenated, the values scaled by 1/M)."""
    from ..core.selected_rows import SelectedRows
    m = float(len(pieces))
    if isinstance(pieces[0], SelectedRows):
        return SelectedRows(torch.cat([p.rows for p in pieces]),
                            torch.cat([p.values for p in pieces]) / m,
                            pieces[0].height)
    return sum(pieces[1:], pieces[0]) / m


class PipelineCompiledProgram:
    """The runnable pipeline: hand it to exe.run like a CompiledProgram.

    Made by PipelineOptimizer.minimize.  `num_microbatches` (M) splits the
    fed mini-batch along dim 0; gradients accumulate over the M
    micro-batches, then the optimizer phase commits once.  `devices`
    (torch devices or names) place the stages; by default the
    executor's device holds every stage.
    """

    def __init__(self, program: Program, num_microbatches: int,
                 params_grads, devices=None):
        self._program = program
        self._M = max(1, int(num_microbatches))
        self._grad_names = [g.name for _, g in (params_grads or [])]
        self._devices = devices
        self._built_for = None

    # -- build ---------------------------------------------------------------
    def _build(self, default_device):
        devs = [torch.device(d) for d in (self._devices or
                                          [default_device])]
        key = tuple(str(d) for d in devs)
        if self._built_for == key:
            return
        block = self._program.global_block()
        stages = assign_stages(block)
        self._n_stages = max(stages) + 1 if stages else 1
        # fewer devices than stages: wrap
        self._stage_devices = [devs[i % len(devs)]
                               for i in range(self._n_stages)]
        self._phases: Dict[str, List[_Phase]] = {"fwd": [], "bwd": [],
                                                 "opt": []}
        for s in range(self._n_stages):
            for ph in ("fwd", "bwd", "opt"):
                ops = [op for op, st in zip(block.ops, stages)
                       if st == s and _role_phase(op) == ph
                       and op.type not in ("feed", "fetch")]
                self._phases[ph].append(_Phase(ops, self._stage_devices[s]))
        self._built_for = key

    # -- run -----------------------------------------------------------------
    def _run(self, executor, feed, fetch_list, scope, return_numpy):
        from ..static.executor import (_persistable_names, as_numpy,
                                       global_scope)
        self._build(executor.device)
        scope = scope or global_scope()
        feed = feed or {}
        fetch_names = [f.name if hasattr(f, "name") else str(f)
                       for f in (fetch_list or [])]
        M = self._M
        block = self._program.global_block()
        first = self._stage_devices[0]

        # the fed mini-batch cut into micro-batches along dim 0
        micro_feeds: List[Dict[str, Any]] = [dict() for _ in range(M)]
        micro_batch_size = None
        for name, val in feed.items():
            arr = executor._coerce_feed(block, name, val).to(first)
            if arr.shape[0] % M != 0:
                raise ValueError(
                    f"batch dim {arr.shape[0]} of feed {name!r} not "
                    f"divisible by num_microbatches={M}")
            mb = arr.shape[0] // M
            micro_batch_size = mb
            for m in range(M):
                micro_feeds[m][name] = arr[m * mb:(m + 1) * mb]

        state = {n: scope.get(n) for n in _persistable_names(self._program)
                 if scope.get(n) is not None}
        seed = executor._seed_for_step(self._program)
        executor._step += 1

        # GPipe: every micro-batch's forward, stages in order
        envs: List[Dict[str, Any]] = []
        for m in range(M):
            env = dict(state)
            env.update(micro_feeds[m])
            for s in range(self._n_stages):
                self._phases["fwd"][s].run(env, seed + m)
            envs.append(env)

        # every backward, micro-batches in order, stages in reverse; a
        # micro-batch other than the last keeps only its gradients and
        # fetches afterwards (the optimizer phase reads the last one's
        # values)
        keep = set(self._grad_names) | set(fetch_names)
        for m in range(M):
            for s in range(self._n_stages - 1, -1, -1):
                self._phases["bwd"][s].run(envs[m], seed + m)
            if m < M - 1:
                envs[m] = {n: v for n, v in envs[m].items() if n in keep}

        # the optimizer phase's environment: the persistable state
        # overlaid with the last micro-batch's values (state the forward
        # updated, such as batch-norm statistics), each parameter
        # gradient replaced by its micro-batch mean (a micro-batch loss
        # is a mean, so the mean of their gradients is the mini-batch's)
        opt_env = dict(state)
        opt_env.update(envs[-1])
        for g in self._grad_names:
            pieces = [_to(e[g], first) for e in envs if g in e]
            if pieces:
                opt_env[g] = mean_grads(pieces)

        # the optimizer phase: once a mini-batch
        for s in range(self._n_stages):
            self._phases["opt"][s].run(opt_env, seed)

        # commit the persistable state
        for n in state:
            if n in opt_env and opt_env[n] is not state[n]:
                scope.set(n, opt_env[n])

        # fetches: per-example tensors (leading dim the micro-batch size)
        # concatenated back to the mini-batch, float metrics averaged over
        # the micro-batches
        results = []
        for n in fetch_names:
            vals = [_to(e[n], first) for e in envs if n in e]
            if not vals and n in opt_env:
                vals = [opt_env[n]]
            if not vals:
                raise KeyError(f"fetch {n!r} not produced by the pipeline")
            v = vals[0]
            if len(vals) > 1:
                # mb == 1 is ambiguous with [1]-shaped scalar metrics (mean
                # makes [1]): take it as the metric case and average
                if (v.dim() >= 1 and micro_batch_size is not None
                        and micro_batch_size > 1
                        and v.shape[0] == micro_batch_size):
                    v = torch.cat(vals, dim=0)
                elif v.is_floating_point():
                    v = sum(vals[1:], vals[0]) / float(len(vals))
            results.append(as_numpy(v) if return_numpy else v)
        return results

    # introspection
    def stage_op_counts(self, device="cpu"):
        self._build(torch.device(device) if self._built_for is None
                    else self._stage_devices[0])
        return {ph: [len(p.ops) for p in phs]
                for ph, phs in self._phases.items()}
