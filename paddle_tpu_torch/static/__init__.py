"""paddle_tpu_torch.static — Program construction, the BERT layer subset,
append_backward (with recompute), the optimizers with their regularizers,
gradient clips, gradient merge, EMA, ModelAverage, Lookahead and
Recompute, checkpoint selection, device_guard (the pipeline's stage
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
from .memory_analysis import select_layer_checkpoints  # noqa: F401
from . import memory_analysis  # noqa: F401
from .recompute_rewrite import apply_recompute  # noqa: F401
from . import optimizer  # noqa: F401
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
