"""paddle.distributed.fleet, collective mode.

Counterpart of paddle_tpu/distributed/fleet/__init__.py:

    import paddle_tpu_torch.distributed.fleet as fleet
    fleet.init(is_collective=True)          # init_parallel_env
    strategy = fleet.DistributedStrategy()
    strategy.amp = True
    opt = fleet.distributed_optimizer(opt, strategy)
    opt.minimize(loss)
    exe.run(fleet.main_program, feed=global_batch, fetch_list=[loss])

`fleet.main_program` is a CompiledProgram with data parallel over the
process group (one process a rank).  The meta-optimizers: lars, lamb,
dgc, recompute, amp, fp16_allreduce, sharding (ZeRO stages 1-3),
gradient_merge, localsgd and adaptive_localsgd; strategy.tensor_parallel
sets the CompiledProgram's tensor_parallel_degree.  The pipeline and the
parameter server raise (ROADMAP.md Queue 1, Distribution).
"""
from .base.distributed_strategy import DistributedStrategy  # noqa: F401
from .base.role_maker import (  # noqa: F401
    Role, RoleMakerBase, PaddleCloudRoleMaker, UserDefinedRoleMaker,
)
from .base.fleet_base import Fleet, fleet as _fleet_singleton  # noqa: F401
from .base.util_factory import UtilBase  # noqa: F401
from . import meta_optimizers  # noqa: F401
from . import metrics  # noqa: F401

# the singleton's methods at module scope, as the reference's
# fleet/__init__.py has them
init = _fleet_singleton.init
distributed_optimizer = _fleet_singleton.distributed_optimizer
minimize = _fleet_singleton.minimize
is_first_worker = _fleet_singleton.is_first_worker
worker_index = _fleet_singleton.worker_index
worker_num = _fleet_singleton.worker_num
is_worker = _fleet_singleton.is_worker
worker_endpoints = _fleet_singleton.worker_endpoints
server_num = _fleet_singleton.server_num
server_index = _fleet_singleton.server_index
server_endpoints = _fleet_singleton.server_endpoints
is_server = _fleet_singleton.is_server
barrier_worker = _fleet_singleton.barrier_worker
init_worker = _fleet_singleton.init_worker
init_server = _fleet_singleton.init_server
run_server = _fleet_singleton.run_server
stop_worker = _fleet_singleton.stop_worker
save_inference_model = _fleet_singleton.save_inference_model
save_persistables = _fleet_singleton.save_persistables
applied_meta_list = _fleet_singleton.applied_meta_list


def __getattr__(name):
    # the singleton's properties (main_program, startup_program, util)
    if name in ("main_program", "startup_program", "util"):
        return getattr(_fleet_singleton, name)
    raise AttributeError(name)
