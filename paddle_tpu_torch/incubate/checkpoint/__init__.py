from .checkpoint_saver import CheckpointSaver, SerializableBase  # noqa: F401
from . import auto_checkpoint  # noqa: F401
