"""paddle_tpu_torch.incubate — the pre-stable tier.  Counterpart of
paddle_tpu/incubate/: the switch Mixture-of-Experts (moe.py) and the
auto-checkpoint tier (checkpoint/: CheckpointSaver, train_epoch_range).
The reader part waits for ROADMAP.md Queue 1, The rest."""
from . import checkpoint  # noqa: F401
from . import moe  # noqa: F401
