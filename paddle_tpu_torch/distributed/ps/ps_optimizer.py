"""Parameter-server training: the transpiler, fleet's PS meta-optimizer
and the runtime-managed trainer program.

Counterpart of paddle_tpu/distributed/ps/ps_optimizer.py (the reference's
DistributeTranspiler, which splits a program into trainer, pserver and
startup programs, and its communicator modes Sync / Async / Geo).  The
trainer's forward and backward run on its executor's device; the PS
traffic is the host-side KV service (kv_server.py), reached either by
`PSCompiledProgram` around the step (the default) or by the graph ops a
`use_graph_ops` transpile appends to the program (send, fetch_barrier,
recv, distributed_lookup_table: ops/kernels/distributed_ops.py).  Modes:

  * sync:  push gradients (the server applies their mean once every
    trainer has pushed), then pull;
  * async: push gradients, applied at once (Hogwild), then pull;
  * geo:   train locally with the real optimizer; every k steps push the
    parameters' delta since the last sync and pull the merged value.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ...core.program import Program, OpRole
from ..fleet.meta_optimizers.meta_optimizer_base import MetaOptimizerBase

__all__ = ["ParameterServerOptimizer", "DistributeTranspiler",
           "DistributeTranspilerConfig", "PSCompiledProgram"]


class DistributeTranspilerConfig:
    """transpiler config parity (slice_var_up etc. accepted, unused)."""

    def __init__(self):
        self.slice_var_up = True
        self.split_method = None
        self.min_block_size = 8192
        self.sync_mode = True
        self.geo_sgd_mode = False
        self.geo_sgd_need_push_nums = 100
        # True → get_trainer_program returns a plain Program carrying
        # send/fetch_barrier/recv GRAPH OPS (reference transpiler shape,
        # distribute_transpiler.py:256); False → the runtime-managed
        # PSCompiledProgram push/pull path
        self.use_graph_ops = False
        # heter mode (heter_wrapper.h analog): ONLY the distributed
        # sparse tables go to the PS; dense params keep their LOCAL
        # optimizer ops (the device section trains them) — the program is
        # then split at boundary activations by
        # distributed/heter.split_heter_program
        self.heter_mode = False


def _strip_optimizer_ops(program: Program) -> Program:
    """Trainer side keeps fwd+bwd only (transpiler removes opt ops and
    replaces them with send/recv — here the runtime does push/pull)."""
    block = program.global_block()
    block.ops = [op for op in block.ops
                 if not (op.op_role & OpRole.Optimize
                         or op.op_role == OpRole.LRSched)]
    program._fingerprint_cache = None
    return program


def _strip_table_optimizer_ops(program: Program, tables) -> Program:
    """Heter mode: remove ONLY the optimizer ops updating distributed
    tables (the PS applies those server-side); dense optimizer ops stay
    with the device section."""
    block = program.global_block()
    block.ops = [op for op in block.ops
                 if not ((op.op_role & OpRole.Optimize)
                         and op.inputs.get("Param", [None])[0] in tables)]
    program._fingerprint_cache = None
    return program


def _host(t) -> np.ndarray:
    from ...static.executor import as_numpy
    return np.asarray(as_numpy(t))


class PSCompiledProgram:
    """Runnable PS trainer program (pass to exe.run).

    fwd+bwd runs on the executor's device; each step: push grads → pull
    params → scope.
    geo mode: full local program runs (with optimizer); every k steps the
    param delta is pushed and the merged value pulled.
    """

    def __init__(self, program: Program, params_grads, mode: str = "sync",
                 lr: float = 0.01, geo_k: int = 100, endpoints=None,
                 trainer_id: int = 0):
        self._program = program
        self._params = [p.name for p, _ in params_grads]
        self._grads = {p.name: g.name for p, g in params_grads}
        self._mode = mode
        self._lr = lr
        self._geo_k = geo_k
        self._endpoints = endpoints
        self._trainer_id = trainer_id
        self._client = None
        self._inited = False
        self._step = 0
        self._last_sync: Dict[str, np.ndarray] = {}

    def _get_client(self):
        if self._client is None:
            from .kv_server import KVClient
            from ..parallel_env import ParallelEnv
            import os
            eps = self._endpoints or [
                e for e in os.environ.get(
                    "PADDLE_PSERVERS_IP_PORT_LIST", "").split(",") if e]
            if not eps:
                raise RuntimeError("no pserver endpoints for PS training")
            self._client = KVClient(eps)
            self._client.wait_server_ready()
            # liveness registration: if this trainer dies, the servers
            # shrink sync fanins instead of stalling the others
            self._client.start_heartbeat(self._trainer_id)
        return self._client

    @staticmethod
    def _set(scope, name, val, device):
        """Write a pulled array into the scope, on `device`, in the dtype
        the scope held."""
        cur = scope.get(name)
        t = torch.from_numpy(np.ascontiguousarray(val))
        if isinstance(cur, torch.Tensor):
            t = t.to(cur.dtype)
        scope.set(name, t.to(device))

    def _init_params(self, scope, device):
        client = self._get_client()
        for p in self._params:
            v = scope.get(p)
            if v is not None:
                client.init_param(p, _host(v))  # first writer wins
        for p in self._params:
            val = client.pull(p)
            self._set(scope, p, val, device)
            self._last_sync[p] = val.copy()
        self._inited = True

    def _run(self, executor, feed, fetch_list, scope, return_numpy):
        from ...static.executor import global_scope
        scope = scope or global_scope()
        device = executor.device
        if not self._inited:
            self._init_params(scope, device)
        client = self._client
        fetch_list = list(fetch_list or [])

        if self._mode == "geo":
            # local step with the real optimizer; periodic delta sync
            res = executor.run(self._program, feed=feed,
                               fetch_list=fetch_list, scope=scope,
                               return_numpy=return_numpy)
            self._step += 1
            if self._step % self._geo_k == 0:
                for p in self._params:
                    cur = _host(scope.get(p))
                    client.push_delta(p, cur - self._last_sync[p])
                    merged = client.pull(p)
                    self._set(scope, p, merged, device)
                    self._last_sync[p] = merged.copy()
            return res

        # sync/async: fetch grads out of the fwd+bwd step
        grad_names = [self._grads[p] for p in self._params]
        all_res = executor.run(self._program, feed=feed,
                               fetch_list=fetch_list + grad_names,
                               scope=scope, return_numpy=False)
        user_res = all_res[: len(fetch_list)]
        if return_numpy:
            user_res = [_host(r) for r in user_res]
        grads = all_res[len(fetch_list):]
        lr = self._current_lr(scope)
        for p, g in zip(self._params, grads):
            client.push_grad(p, _host(g), lr, sync=(self._mode == "sync"))
        for p in self._params:
            self._set(scope, p, client.pull(p), device)
        self._step += 1
        return user_res

    def _current_lr(self, scope):
        for name in scope.keys():
            if name.startswith("learning_rate"):
                try:
                    return float(_host(scope.get(name)).reshape(()))
                except (TypeError, ValueError):
                    pass
        return self._lr


class DistributeTranspiler:
    """fluid.transpiler.DistributeTranspiler API parity."""

    def __init__(self, config: Optional[DistributeTranspilerConfig] = None):
        self.config = config or DistributeTranspilerConfig()
        self._trainer_program = None
        self._pserver_endpoint = None
        self._startup = None

    def transpile(self, trainer_id, program=None, pservers="", trainers=1,
                  startup_program=None, current_endpoint=""):
        from ...core.program import default_main_program, \
            default_startup_program
        self._program = program or default_main_program()
        self._startup = startup_program or default_startup_program()
        self._pservers = [e for e in pservers.split(",") if e]
        self._trainers = trainers
        self._trainer_id = trainer_id
        self._current_endpoint = current_endpoint
        if self.config.use_graph_ops and self.config.geo_sgd_mode:
            raise ValueError(
                "use_graph_ops does not support geo_sgd_mode (geo's "
                "every-k-steps delta push is runtime-managed; use the "
                "PSCompiledProgram path)")
        if self.config.use_graph_ops:
            # rewrite the startup program NOW (reference transpiler shape:
            # startup carries init send → barrier → recv so exe.run(startup)
            # works no matter when get_trainer_program() is called)
            pgs = getattr(self._program, "_ps_params_grads", None)
            if pgs is None:
                raise RuntimeError(
                    "transpile() requires a program minimized by an "
                    "optimizer (params_grads recorded)")
            self._rewrite_startup_with_graph_ops(pgs)

    def get_trainer_program(self, wait_port=True):
        pgs = getattr(self._program, "_ps_params_grads", None)
        if pgs is None:
            raise RuntimeError(
                "transpile() requires a program minimized by an optimizer "
                "(params_grads recorded)")
        if self.config.heter_mode and not self.config.use_graph_ops:
            raise ValueError(
                "heter_mode requires use_graph_ops=True — the runtime "
                "PSCompiledProgram path would silently train a non-heter "
                "dense-PS topology")
        if self.config.use_graph_ops and not self.config.geo_sgd_mode:
            return self._transpile_with_graph_ops(pgs)
        if self._distributed_tables(self._program):
            raise ValueError(
                "is_distributed embedding tables need the graph-op "
                "transpiler (DistributeTranspilerConfig.use_graph_ops = "
                "True); the runtime-managed PSCompiledProgram path would "
                "replicate and dense-sync the whole table")
        if self.config.geo_sgd_mode:
            mode = "geo"
            prog = self._program  # geo keeps local optimizer ops
        else:
            mode = "sync" if self.config.sync_mode else "async"
            prog = _strip_optimizer_ops(self._program.clone())
        return PSCompiledProgram(
            prog, pgs, mode=mode,
            geo_k=self.config.geo_sgd_need_push_nums,
            endpoints=self._pservers, trainer_id=self._trainer_id)

    _LOOKUP_TYPES = ("lookup_table", "lookup_table_v2", "embedding")

    def _sparse_opt_config(self, param_name):
        """Server-resident optimizer for a distributed table, read off the
        optimizer op that consumed its grad before stripping (pslib
        analog: the pserver runs lookup_sparse_table_fuse_{adam,sgd}, so
        Adam moment state lives ON the server,
        lookup_sparse_table_fuse_adam_op.cc:145)."""
        for op in self._program.global_block().ops:
            if not (op.op_role & OpRole.Optimize):
                continue
            if op.inputs.get("Param", [None])[0] != param_name:
                continue
            if op.type == "adam":
                return {"type": "adam",
                        "beta1": float(op.attrs.get("beta1", 0.9)),
                        "beta2": float(op.attrs.get("beta2", 0.999)),
                        "epsilon": float(op.attrs.get("epsilon", 1e-8))}
            if op.type in ("adamw", "lamb"):
                # adamw's decoupled decay / lamb's trust ratio have no
                # server-side implementation — silently training the
                # table under a DIFFERENT optimizer than configured is
                # worse than failing here
                raise ValueError(
                    f"distributed table {param_name!r} is optimized by "
                    f"{op.type!r}, but the server-resident sparse "
                    "optimizer supports sgd|adam — use Adam/SGD for the "
                    "table or drop is_distributed")
            return {"type": "sgd"}
        return {"type": "sgd"}

    def _distributed_tables(self, program) -> set:
        """Tables marked is_distributed on their lookup ops — these shard
        row-wise across pservers instead of replicating."""
        tables = set()
        for op in program.global_block().ops:
            if op.type in self._LOOKUP_TYPES and \
                    op.attrs.get("is_distributed"):
                if not op.attrs.get("is_sparse"):
                    raise ValueError(
                        "distributed embedding tables need "
                        "is_sparse=True (the SelectedRows gradient is "
                        "what gets pushed row-wise)")
                tables.add(op.inputs["W"][0])
        return tables

    def _transpile_with_graph_ops(self, params_grads) -> Program:
        """Reference transpiler shape (distribute_transpiler.py:256): the
        returned trainer Program itself carries `send` (grads out) →
        `fetch_barrier` → `recv` (params in) ops; exe.run of the program IS
        the PS step.  Startup gets a mode="init" send pushing initial
        params to the server (pserver-side startup analog).

        Distributed (row-sharded) embedding tables take the sparse path:
        their forward lookups become `distributed_lookup_table` (pull only
        the touched rows), their SelectedRows grads go out through a
        sparse `send` (server-side row SGD), and they are EXCLUDED from
        the dense send/recv round — the [V, D] table never crosses the
        wire whole (reference distributed_lookup_table_op.cc)."""
        # read the exact lr var off the optimizer ops before stripping them
        lr_var = next(
            (op.inputs["LearningRate"][0]
             for op in self._program.global_block().ops
             if (op.op_role & OpRole.Optimize) and
             op.inputs.get("LearningRate")), None)
        dist_tables = self._distributed_tables(self._program)
        if self.config.heter_mode:
            # dense params train locally in the device section; only the
            # table's optimizer moves server-side
            prog = _strip_table_optimizer_ops(self._program.clone(),
                                              dist_tables)
        else:
            prog = _strip_optimizer_ops(self._program.clone())
        block = prog.global_block()
        for op in block.ops:
            if op.type in self._LOOKUP_TYPES and \
                    op.inputs.get("W", [None])[0] in dist_tables:
                op.type = "distributed_lookup_table"
                op.attrs.update({
                    "table_name": op.inputs["W"][0],
                    "endpoints": list(self._pservers),
                    "trainer_id": self._trainer_id})
        param_names = [p.name for p, _ in params_grads
                       if p.name not in dist_tables]
        grad_names = [g.name for p, g in params_grads
                      if p.name not in dist_tables]
        sparse_pgs = [(p, g) for p, g in params_grads
                      if p.name in dist_tables]
        mode = "grad_sync" if self.config.sync_mode else "grad_async"
        if lr_var is not None and not block.has_var(lr_var):
            lr_var = None
        if lr_var is None:
            lr_var = next((v.name for v in block.vars.values()
                           if v.persistable and
                           v.name.startswith("learning_rate")), None)
        for p, g in sparse_pgs:
            send_ins = {"X": [g.name]}
            if lr_var:
                send_ins["LearningRate"] = [lr_var]
            dummy = block.create_var(shape=[1], dtype="float32")
            block.append_op(
                "send", send_ins, {"Dummy": [dummy.name]},
                {"send_varnames": [p.name],
                 "endpoints": list(self._pservers),
                 "mode": "sparse_grad", "trainer_id": self._trainer_id,
                 # sync mode: the SERVER accumulates every live trainer's
                 # rows and applies the average once (OP_PUSH_ROWS_SYNC)
                 # — averaging no longer trusts client-side grad_scale
                 "sync": bool(self.config.sync_mode),
                 OpRole.KEY: OpRole.RPC})
        if param_names and not self.config.heter_mode:
            self._append_ps_graph_ops(block, block, grad_names,
                                      param_names, mode, lr_var=lr_var)
        return prog

    def _append_ps_graph_ops(self, block, shape_block, x_names, param_names,
                             mode, lr_var=None):
        """Append the send → fetch_barrier → recv triple (one wire-attr
        construction shared by the per-step and startup rewrites)."""
        send_ins = {"X": x_names}
        if lr_var:
            send_ins["LearningRate"] = [lr_var]
        dummy = block.create_var(shape=[1], dtype="float32")
        block.append_op("send", send_ins, {"Dummy": [dummy.name]},
                        {"send_varnames": param_names,
                         "endpoints": list(self._pservers),
                         "mode": mode, "trainer_id": self._trainer_id,
                         OpRole.KEY: OpRole.RPC})
        block.append_op("fetch_barrier", {"X": [dummy.name]}, {},
                        {"endpoints": list(self._pservers),
                         OpRole.KEY: OpRole.RPC})
        block.append_op(
            "recv", {"Dummy": [dummy.name]}, {"Out": param_names},
            {"recv_varnames": param_names,
             "endpoints": list(self._pservers),
             "trainer_id": self._trainer_id,
             "shapes": [list(shape_block.var(n).shape)
                        for n in param_names],
             "dtypes": [shape_block.var(n).dtype for n in param_names],
             OpRole.KEY: OpRole.RPC})

    def _rewrite_startup_with_graph_ops(self, params_grads):
        """Startup push of locally-initialized params (first writer wins)
        followed by a pull of the winning values so every trainer starts
        identical (reference distribute_transpiler startup rewrite);
        guarded so repeated transpile() calls don't stack duplicate ops."""
        if getattr(self._startup, "_ps_startup_transpiled", False):
            return
        mb = self._program.global_block()
        dist_tables = self._distributed_tables(self._program)
        param_names = [p.name for p, _ in params_grads
                       if p.name not in dist_tables]
        sparse_names = [p.name for p, _ in params_grads
                        if p.name in dist_tables]
        sb = self._startup.global_block()
        for n in param_names + sparse_names:
            if not sb.has_var(n):
                sb.create_var(n, mb.var(n).shape, mb.var(n).dtype,
                              persistable=True)
        for n in sparse_names:
            # row-shard the locally initialized table across pservers
            # (first writer wins, like the dense init)
            dummy = sb.create_var(shape=[1], dtype="float32")
            sb.append_op(
                "send", {"X": [n]}, {"Dummy": [dummy.name]},
                {"send_varnames": [n], "endpoints": list(self._pservers),
                 "mode": "init_sparse", "trainer_id": self._trainer_id,
                 "sparse_opt": self._sparse_opt_config(n),
                 OpRole.KEY: OpRole.RPC})
        if param_names and not self.config.heter_mode:
            self._append_ps_graph_ops(sb, mb, param_names, param_names,
                                      "init")
        self._startup._ps_startup_transpiled = True

    def get_pserver_program(self, endpoint) -> Program:
        """A marker program whose execution serves the KV store
        (listen_and_serv semantics)."""
        p = Program()
        p.global_block().append_op(
            "listen_and_serv", {}, {},
            {"endpoint": endpoint, "Fanin": self._trainers,
             OpRole.KEY: OpRole.RPC})
        p._ps_server_config = {"endpoint": endpoint,
                               "num_trainers": self._trainers}
        return p

    def get_pserver_programs(self, endpoint):
        return self.get_pserver_program(endpoint), Program()

    def get_startup_program(self, endpoint=None, pserver_program=None,
                            startup_program=None):
        return startup_program or self._startup


class ParameterServerOptimizer(MetaOptimizerBase):
    """fleet PS meta-optimizer (incubate/fleet/parameter_server analog):
    minimize → record params_grads, strip opt ops (sync/async) or keep them
    (geo), produce a PSCompiledProgram as fleet.main_program."""

    def _can_apply(self):
        return not getattr(self.user_defined_strategy, "_is_collective",
                           False)

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        ops, params_grads = self.inner_opt.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        program = loss.block.program
        program._ps_params_grads = params_grads
        s = self.user_defined_strategy
        a_sync = bool(s.a_sync)
        k = s.a_sync_configs.get("k_steps", -1)
        if a_sync and k > 0:
            mode = "geo"
            prog = program  # local optimizer kept
        elif a_sync:
            mode = "async"
            prog = _strip_optimizer_ops(program.clone())
        else:
            mode = "sync"
            prog = _strip_optimizer_ops(program.clone())
        geo_k = max(1, k) if k > 0 else 100
        compiled = PSCompiledProgram(
            prog, params_grads, mode=mode, geo_k=geo_k,
            trainer_id=self.role_maker.worker_index()
            if self.role_maker else 0)
        program._compiled_for_fleet = compiled
        return ops, params_grads
