"""paddle_tpu_torch.distributed: data-parallel training.

Counterpart of paddle_tpu/distributed/: the collective API
(collective.py, its ops in ops/kernels/collective.py), the process group
of a launched rank (parallel.py: `init_parallel_env`, `DataParallel`;
parallel_env.py: the PADDLE_* contract), the launchers (spawn.py,
launch.py, launch_utils.py), `CompiledProgram.with_data_parallel`
(compiled_program.py) and fleet's collective mode with its
meta-optimizers (fleet/).  The JAX package is one controller over a
mesh; the port runs one process a rank over torch.distributed: NCCL for
CUDA tensors where each rank has a device of its own, gloo otherwise.

Not ported yet (ROADMAP.md Queue 1, Distribution): ZeRO (sharding.py,
partition_spec.py), tensor parallel, scan_window, ring attention,
elastic training and fleet_control, pipeline/ and the parameter-server
tier.
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
from . import fleet  # noqa: F401
