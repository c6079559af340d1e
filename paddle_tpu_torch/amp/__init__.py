"""paddle_tpu_torch.amp — automatic mixed precision, static and dygraph.

Counterpart of paddle_tpu/amp.  Static: `decorate(optimizer)` rewrites
the forward program with bf16 casts (`rewrite_program`) and guards the
optimizer step with check_finite_and_unscale (and, with dynamic loss
scaling, update_loss_scaling).  Dygraph: the `auto_cast` guard (O1 / O2,
custom lists, bf16 or fp16), applied by every port functional op, and
`GradScaler` (`AmpScaler`, its fluid spelling).  `cast_model_to_fp16` is the static pure low-precision
mode (O2).
"""
from .fp16_lists import AutoMixedPrecisionLists, white_list, black_list, \
    gray_list  # noqa: F401
from .fp16_utils import rewrite_program, cast_model_to_fp16  # noqa: F401
from .decorator import decorate, OptimizerWithMixedPrecision  # noqa: F401
from .auto_cast import auto_cast, amp_guard, GradScaler, AmpScaler  # noqa: F401

__all__ = ["auto_cast", "amp_guard", "GradScaler", "AmpScaler", "decorate",
           "OptimizerWithMixedPrecision", "AutoMixedPrecisionLists",
           "rewrite_program", "cast_model_to_fp16"]
