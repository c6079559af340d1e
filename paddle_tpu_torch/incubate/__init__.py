"""paddle_tpu_torch.incubate — the pre-stable tier.  Counterpart of
paddle_tpu/incubate/: the switch Mixture-of-Experts (moe.py).  The
auto-checkpoint and reader parts wait for ROADMAP.md Queue 1, The rest."""
from . import moe  # noqa: F401
