"""paddle_tpu_torch.amp — static-graph automatic mixed precision.

Counterpart of the static half of paddle_tpu/amp: `decorate(optimizer)`
rewrites the forward program with bf16 casts (`rewrite_program`) and
guards the optimizer step with check_finite_and_unscale (and, with
dynamic loss scaling, update_loss_scaling).  The dygraph half
(`auto_cast`, `GradScaler`) and the pure-low-precision O2 mode
(`cast_model_to_fp16`) are not ported yet (ROADMAP.md).
"""
from .fp16_lists import AutoMixedPrecisionLists, white_list, black_list, \
    gray_list  # noqa: F401
from .fp16_utils import rewrite_program  # noqa: F401
from .decorator import decorate, OptimizerWithMixedPrecision  # noqa: F401

__all__ = ["decorate", "OptimizerWithMixedPrecision",
           "AutoMixedPrecisionLists", "rewrite_program"]
