"""Kernel library: every module registers its ops on import.  Each file
mirrors the module of the same name under paddle_tpu/ops/kernels/ and
holds the subset of ops the ported slice runs."""
from . import (  # noqa: F401
    math,
    attention,
    elementwise,
    activation,
    manip,
    nn,
    random,
    loss,
    optimizers,
    amp,
    decode,
    reduce,
    control,
    tensor_array,
    op_gaps,
    quantize,
    stragglers,
    sparse_feature,
    collective,
    distributed_ops,
    vision,
    sequence,
)
