"""paddle_tpu_torch.static — Program construction, the BERT layer subset,
append_backward, the optimizers (SGD, Momentum, Adam, AdamW, Lamb) with
their regularizers, gradient clips and gradient merge, and the eager
executor (the `paddle.static` surface of the ported slices)."""
from ..core.program import (  # noqa: F401
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
from . import optimizer  # noqa: F401
from .optimizer import (  # noqa: F401
    Optimizer, SGD, SGDOptimizer, Momentum, MomentumOptimizer, Adam,
    AdamOptimizer, AdamW, Lamb, LambOptimizer, L1Decay, L2Decay,
    GradientClipByValue, GradientClipByNorm, GradientClipByGlobalNorm,
    gradient_merge,
)
