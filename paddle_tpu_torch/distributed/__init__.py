"""paddle_tpu_torch.distributed: distributed training.

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
meta-optimizers (fleet/), elastic training (elastic.py: one logical
schedule on any world that divides it, with the launcher's `--elastic`
re-form), the multi-host fleet control plane (fleet_control.py, the
launcher's `--fleet_dir`), the host-side gloo rendezvous (gloo.py), the
parameter-server tier (ps/: the KV server, the transpiler, fleet's PS
runtime; the launcher's `--run_mode ps`), heterogeneous PS training
(heter.py) and the dataset path (dataset.py).  Ring attention lives in
ops/attention.py, tp-sharded decode in serving/tp_decode.py, expert
parallelism in incubate/moe.py and the pipeline in pipeline/.  The JAX
package is one controller over a mesh; the port runs one process a rank
over torch.distributed: NCCL for CUDA tensors where each rank has a
device of its own, gloo otherwise.
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
from .elastic import (  # noqa: F401
    elasticize, rebucket_feeds, rederive_schedule, reanchor_topology,
    elastic_meta, micro_steps_per_global,
)
from .fleet_control import (  # noqa: F401
    FleetController, FleetBarrier, FleetCommit, fleet_env, fleet_rank,
    fleet_world_size, newest_mutual_checkpoint_step,
)
from . import fleet_control  # noqa: F401
from . import gloo  # noqa: F401
from .dataset import (  # noqa: F401
    DatasetFactory, InMemoryDataset, QueueDataset, MultiSlotDataFeed,
)
from .heter import HeterSection, split_heter_program  # noqa: F401
