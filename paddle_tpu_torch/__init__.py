"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

A second package beside the JAX one (which stays the reference the port
is held against).  It imports torch and numpy, never jax and never
paddle_tpu.  Entry points run on the GPU (CUDAPlace(0)) unless the caller
asks for the CPU (CPUPlace(), Config.disable_gpu(),
dygraph.guard(CPUPlace())).

Ported so far: the `/predict` serving path of a static-graph BERT
encoder (Program IR, layers, op kernels, the eager executor, model
save/load, the inference passes, the Predictor and the HTTP
InferenceServer), the `bench.py` training step (backward, AMP, Adam,
`Executor.run_steps`) and BERT's pretraining recipe on it, the GPT
`/generate` path (the dygraph `Layer`, the `nn` subset, `models.gpt`, the
continuous-batching engine with its paged KV pool on the GPU), and
dygraph training through the 2.0 API (torch autograd as the tape,
`amp.auto_cast` / `GradScaler`, `optimizer`, the encoder layers,
`models.bert`, `hapi.Model.train_batch`), the training programs of the
BASELINE configs LeNet-5, ResNet-50 and Transformer-big
(`models.build_lenet` / `build_resnet50` / `build_transformer_big`, on
the conv2d, pool2d, batch_norm, relu, one_hot_v2 and label_smooth ops)
and `vision.models` (LeNet, ResNet) on the dygraph `nn` vision layers;
data, ZeRO, tensor, sequence, expert and elastic parallelism over
torch.distributed (`distributed`), with the checkpoint tier
(`checkpoint`, `observability`, `testing.chaos`); every Pallas kernel of the JAX package as a hand-written Hopper kernel
under csrc/.  ROADMAP.md lists what comes next.

The top-level names: `seed`, `to_tensor`, `matmul`, `grad`, `no_grad`,
`Model`, `CPUPlace`, `CUDAPlace` (and the subpackages `amp`, `nn`,
`optimizer`, `models`, `hapi`, `dygraph`, `static`, `vision`, ...).
"""
from .core.place import CPUPlace, CUDAPlace  # noqa: F401
from .core.generator import seed  # noqa: F401
from .dygraph.base import no_grad  # noqa: F401
from .dygraph.engine import grad  # noqa: F401
from .dygraph.tensor import to_tensor  # noqa: F401
from .tensor.linalg import matmul  # noqa: F401
from . import amp, nn, optimizer, vision  # noqa: F401
from .hapi.model import Model  # noqa: F401

__version__ = "0.1.0"
