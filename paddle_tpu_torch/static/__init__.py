"""paddle_tpu_torch.static — Program construction, the BERT layer subset,
append_backward (with recompute), the optimizers with their regularizers,
gradient clips, gradient merge, EMA, ModelAverage, Lookahead and
Recompute, checkpoint selection, the analysis tier (the verifier, the
layout, memory and FLOPs walks, the planner), device_guard (the pipeline's stage
annotations), the eager executor and CompiledProgram (data parallel; the
`paddle.static` surface of the ported slices)."""
from ..core.program import (  # noqa: F401
    device_guard,
    Program, Block, OpDesc, VarDesc, OpRole, default_main_program,
    default_startup_program, program_guard, name_scope, unique_name,
)
from ..core.place import CPUPlace, CUDAPlace  # noqa: F401
from .executor import (  # noqa: F401
    Executor, Scope, global_scope, scope_guard, as_numpy,
)
from .initializer import (  # noqa: F401
    Constant, Uniform, Normal, Xavier, MSRA, ConstantInitializer,
    UniformInitializer, NormalInitializer, XavierInitializer,
)
from .param_attr import ParamAttr  # noqa: F401
from . import layers  # noqa: F401
from . import initializer  # noqa: F401
from . import nets  # noqa: F401
from .layers import data  # noqa: F401
from .backward import append_backward, gradients  # noqa: F401
from .memory_analysis import (  # noqa: F401
    estimate_peak_bytes, analyze_program, hbm_budget_bytes,
    select_layer_checkpoints,
)
from . import memory_analysis  # noqa: F401
from .flops_analysis import (  # noqa: F401
    analyze_flops, estimate_step_flops, peak_flops_per_chip,
)
from . import flops_analysis  # noqa: F401
from .verifier import (  # noqa: F401
    check_program, collective_sequence, collective_wire_bytes,
    collective_wire_bytes_by_axis, program_ring_degrees,
    VerifyReport, Diagnostic, ProgramVerificationError,
)
from . import verifier  # noqa: F401
from .layout_analysis import (  # noqa: F401
    propagate_shardings, ShardingLayout, LayoutSpec,
)
from . import layout_analysis  # noqa: F401
from .planner import (  # noqa: F401
    plan_program, apply_plan, Plan, ici_bytes_per_chip, page_budget,
    calibrate, Calibration, default_calibration,
)
from . import planner  # noqa: F401
from .recompute_rewrite import apply_recompute  # noqa: F401
from . import optimizer  # noqa: F401
from . import control_flow  # noqa: F401
from .optimizer import (  # noqa: F401
    Optimizer, SGD, SGDOptimizer, Momentum, MomentumOptimizer, Adam,
    AdamOptimizer, AdamW, Adamax, AdamaxOptimizer, Adagrad,
    AdagradOptimizer, Adadelta, AdadeltaOptimizer, RMSProp,
    RMSPropOptimizer, Ftrl, FtrlOptimizer, Lamb, LambOptimizer,
    LarsMomentum, LarsMomentumOptimizer, DecayedAdagrad,
    DecayedAdagradOptimizer, Dpsgd, DpsgdOptimizer, ProximalGD,
    ProximalGDOptimizer, ProximalAdagrad, ProximalAdagradOptimizer,
    ExponentialMovingAverage, ModelAverage, LookaheadOptimizer,
    RecomputeOptimizer, L1Decay, L2Decay, GradientClipByValue,
    GradientClipByNorm, GradientClipByGlobalNorm, gradient_merge,
)
from ..distributed.compiled_program import (  # noqa: F401
    CompiledProgram, BuildStrategy, ExecutionStrategy,
)
