"""paddle_tpu_torch.distributed: data-parallel training.

Counterpart of paddle_tpu/distributed/: the collective API
(collective.py, its ops in ops/kernels/collective.py), the process group
of a launched rank (parallel.py: `init_parallel_env`, `DataParallel`;
parallel_env.py: the PADDLE_* contract), the launchers (spawn.py,
launch.py, launch_utils.py), `CompiledProgram.with_data_parallel`
(compiled_program.py: data parallel, ZeRO stages 1-3 and dp×tp tensor
parallelism), the ZeRO rewrite (sharding.py) with its rule engine
(partition_spec.py), the Megatron layers (tensor_parallel.py) and
fleet's collective mode with its meta-optimizers (fleet/).  The JAX package is one controller over a
mesh; the port runs one process a rank over torch.distributed: NCCL for
CUDA tensors where each rank has a device of its own, gloo otherwise.

Not ported yet (ROADMAP.md Queue 1, Distribution): tp decode
(serving), scan_window, ring attention, elastic training and
fleet_control, pipeline/ and the parameter-server tier.
"""
from .collective import (  # noqa: F401
    ReduceOp, broadcast, all_reduce, reduce, all_gather, scatter, barrier,
    all_to_all, alltoall, send, recv, new_group, get_group, wait, split,
)
from .parallel import (  # noqa: F401
    init_parallel_env, get_rank, get_world_size, prepare_context,
    DataParallel, ParallelEnv,
)
from .spawn import spawn  # noqa: F401
from .compiled_program import (  # noqa: F401
    CompiledProgram, BuildStrategy, ExecutionStrategy,
)
from .sharding import (  # noqa: F401
    shard_optimizer_states, ShardingPlan, unshard_state, reshard_state,
)
from .partition_spec import (  # noqa: F401
    match_partition_rules, zero_stage_rules, build_sharding_specs,
    tensor_parallel_rules, PartitionRule, REPLICATED, DP_SHARD,
    MP_COL, MP_ROW,
)
from . import fleet  # noqa: F401
