"""paddle_tpu_torch.distributed: data-parallel training.

Counterpart of paddle_tpu/distributed/: the collective API
(collective.py, its ops in ops/kernels/collective.py), the process group
of a launched rank (parallel.py: `init_parallel_env`, `DataParallel`;
parallel_env.py: the PADDLE_* contract), the launchers (spawn.py,
launch.py, launch_utils.py), `CompiledProgram.with_data_parallel`
(compiled_program.py: data parallel, ZeRO stages 1-3, dp×tp tensor
parallelism, dp×sp sequence parallelism, the hoisted gradient-merge
window of `run_steps`), the commit-tail split (scan_window.py), the ZeRO
rewrite (sharding.py) with its rule engine (partition_spec.py), the
Megatron layers (tensor_parallel.py) and fleet's collective mode with its
meta-optimizers (fleet/).  Ring attention lives in ops/attention.py,
tp-sharded decode in serving/tp_decode.py and expert parallelism in
incubate/moe.py.  The JAX package is one controller over a mesh; the
port runs one process a rank over torch.distributed: NCCL for CUDA
tensors where each rank has a device of its own, gloo otherwise.

Not ported yet (ROADMAP.md Queue 1, Distribution): elastic training and
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
from .scan_window import (  # noqa: F401
    WindowSplit, split_commit_tail, mark_scan_hoist,
    scan_window_wire_bytes,
)
from . import fleet  # noqa: F401
