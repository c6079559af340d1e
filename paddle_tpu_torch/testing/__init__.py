"""paddle_tpu_torch.testing — fault-injection and test harness utilities."""
from . import chaos  # noqa: F401

__all__ = ["chaos"]
