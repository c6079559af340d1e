"""Fleet: the distributed-training front end, collective mode.

Counterpart of paddle_tpu/distributed/fleet/base/fleet_base.py:
`fleet.init(role_maker, is_collective)` forms the process group
(`init_parallel_env`), the worker queries, and
`fleet.distributed_optimizer(opt, strategy).minimize(loss)`, which
chains the applicable meta-optimizers (StrategyCompiler) and leaves
`fleet.main_program` a CompiledProgram with data parallel
(GraphExecutionOptimizer).  The parameter-server runtime (init_worker,
init_server, run_server, stop_worker, a server role) and the pipeline
strategy are not ported (ROADMAP.md Queue 1, Distribution) and raise.
"""
from __future__ import annotations

import copy
from typing import Optional

from .distributed_strategy import DistributedStrategy
from .role_maker import PaddleCloudRoleMaker, RoleMakerBase
from .meta_optimizer_factory import MetaOptimizerFactory
from .strategy_compiler import StrategyCompiler
from .util_factory import UtilFactory

__all__ = ["Fleet", "fleet"]

_LATER = "ROADMAP.md Queue 1, Distribution"


def _no_ps(what):
    raise NotImplementedError(
        f"fleet.{what}: the parameter-server runtime is not ported yet "
        f"({_LATER})")


class Fleet:
    def __init__(self):
        self._role_maker: Optional[RoleMakerBase] = None
        self._is_collective = False
        self._user_defined_strategy: Optional[DistributedStrategy] = None
        self._user_defined_optimizer = None
        self._final_optimizer = None
        self._chosen_metas = []
        self._util = None
        self._origin_main_program = None
        self._origin_startup_program = None
        self._compiled_program = None

    def init(self, role_maker=None, is_collective=False, strategy=None):
        if role_maker is None:
            role_maker = PaddleCloudRoleMaker(is_collective=is_collective)
            self._is_collective = is_collective
        elif isinstance(role_maker, RoleMakerBase):
            self._is_collective = getattr(role_maker, "_is_collective",
                                          is_collective)
        else:
            raise TypeError("role_maker must be a RoleMakerBase")
        self._role_maker = role_maker
        self._user_defined_strategy = strategy or DistributedStrategy()
        self._util = UtilFactory()._create_util(
            {"role_maker": role_maker})
        if self._is_collective:
            from ...parallel import init_parallel_env
            init_parallel_env()
        return self

    def is_first_worker(self):
        return self._role_maker.is_first_worker()

    def worker_index(self):
        return self._role_maker.worker_index()

    def worker_num(self):
        return self._role_maker.worker_num()

    def is_worker(self):
        return self._role_maker.is_worker()

    def worker_endpoints(self, to_string=False):
        eps = self._role_maker.get_trainer_endpoints()
        return ",".join(eps) if to_string else eps

    def server_num(self):
        return self._role_maker.server_num()

    def server_index(self):
        return self._role_maker.server_index()

    def server_endpoints(self, to_string=False):
        eps = self._role_maker.get_pserver_endpoints()
        return ",".join(eps) if to_string else eps

    def is_server(self):
        return self._role_maker.is_server()

    @property
    def util(self):
        return self._util

    def barrier_worker(self):
        self._util.barrier("worker")

    def init_worker(self):
        _no_ps("init_worker")

    def init_server(self, *args, **kwargs):
        _no_ps("init_server")

    def run_server(self):
        _no_ps("run_server")

    def stop_worker(self):
        _no_ps("stop_worker")

    def distributed_optimizer(self, optimizer, strategy=None):
        self._user_defined_optimizer = optimizer
        if strategy is not None:
            self._user_defined_strategy = strategy
        return self

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        if self._user_defined_optimizer is None:
            raise RuntimeError("call fleet.distributed_optimizer first")
        strategy = copy.deepcopy(self._user_defined_strategy)
        if strategy.pipeline:
            raise NotImplementedError(
                f"DistributedStrategy.pipeline is not ported yet ({_LATER})")
        if not self._is_collective and self._role_maker and \
                self._role_maker.get_pserver_endpoints():
            _no_ps("minimize with server endpoints")
        candidates = MetaOptimizerFactory()._get_valid_meta_optimizers(
            self._user_defined_optimizer)
        compiler = StrategyCompiler()
        final_opt, chosen = compiler.generate_optimizer(
            loss, self._role_maker, self._user_defined_optimizer,
            strategy, candidates)
        self._final_optimizer = final_opt
        self._chosen_metas = chosen
        self._origin_main_program = loss.block.program
        from ....core.program import default_startup_program
        self._origin_startup_program = (startup_program
                                        or default_startup_program())
        result = final_opt.minimize(loss, startup_program, parameter_list,
                                    no_grad_set)
        self._compiled_program = getattr(
            self._origin_main_program, "_compiled_for_fleet", None)
        return result

    @property
    def main_program(self):
        """The program to hand exe.run: the CompiledProgram collective
        minimize made, else the minimized program."""
        return self._compiled_program or self._origin_main_program

    @property
    def startup_program(self):
        return self._origin_startup_program

    def applied_meta_list(self):
        return [type(m).__name__ for m in self._chosen_metas]

    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None,
                             export_for_deployment=True):
        from ....io.framework_io import save_inference_model
        return save_inference_model(
            dirname, feeded_var_names, target_vars, executor,
            main_program or self._origin_main_program)

    def save_persistables(self, executor, dirname, main_program=None):
        from ....io.framework_io import save_persistables
        return save_persistables(executor, dirname,
                                 main_program or self._origin_main_program)


fleet = Fleet()
