"""paddle.regularizer: L1Decay / L2Decay (counterpart of
paddle_tpu/regularizer.py)."""
from .static.optimizer import L1Decay, L2Decay  # noqa: F401

__all__ = ["L1Decay", "L2Decay"]
