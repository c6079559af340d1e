"""paddle.vision for the port (counterpart of paddle_tpu/vision): the
models LeNet and ResNet (`models`).  `datasets` and `transforms` wait:
the datasets need downloads."""
from . import models  # noqa: F401
from .models import *  # noqa: F401,F403
