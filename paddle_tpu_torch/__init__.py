"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

A second package beside the JAX one (which stays the reference the port
is held against).  It imports torch and numpy, never jax and never
paddle_tpu.  Entry points run on the GPU (CUDAPlace(0)) unless the caller
asks for the CPU (CPUPlace(), Config.disable_gpu()).

Ported so far: the `/predict` serving path of a static-graph BERT
encoder (Program IR, layers, op kernels, the eager executor, model
save/load, the inference passes, the Predictor and the HTTP
InferenceServer), the `bench.py` training step (backward, AMP, Adam,
`Executor.run_steps`), and the GPT `/generate` path (the dygraph
`Layer`, the `nn` subset, `models.gpt`, the continuous-batching engine
with its paged KV pool on the GPU); every Pallas kernel of the JAX
package as a hand-written Hopper kernel under csrc/.  ROADMAP.md lists
what comes next.
"""
from .core.place import CPUPlace, CUDAPlace  # noqa: F401

__version__ = "0.1.0"
