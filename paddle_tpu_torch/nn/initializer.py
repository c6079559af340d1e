"""paddle.nn.initializer — the 2.0 names (counterpart of
paddle_tpu/nn/initializer.py) over the classes of
paddle_tpu_torch/static/initializer.py: Constant, Uniform, Normal,
TruncatedNormal, Xavier / XavierNormal / XavierUniform, MSRA /
KaimingNormal / KaimingUniform, Bilinear, Assign /
NumpyArrayInitializer and set_global_initializer.  A dygraph layer runs
an initializer's op eagerly (dygraph.layers.materialize_initializer)."""
from ..static.initializer import (  # noqa: F401
    Bilinear,
    Constant, Uniform, Normal, TruncatedNormal, Xavier,
    XavierInitializer, MSRA, MSRAInitializer, NumpyArrayInitializer,
    Assign, set_global_initializer,
)

__all__ = ["Bilinear", "Constant", "Uniform", "Normal", "TruncatedNormal",
           "Xavier", "XavierInitializer", "XavierNormal", "XavierUniform",
           "MSRA", "MSRAInitializer", "KaimingNormal", "KaimingUniform",
           "NumpyArrayInitializer", "Assign", "set_global_initializer"]

XavierNormal = XavierInitializer


class XavierUniform(XavierInitializer):
    def __init__(self, fan_in=None, fan_out=None, name=None):
        super().__init__(uniform=True, fan_in=fan_in, fan_out=fan_out)


class KaimingNormal(MSRAInitializer):
    def __init__(self, fan_in=None, name=None):
        super().__init__(uniform=False, fan_in=fan_in)


class KaimingUniform(MSRAInitializer):
    def __init__(self, fan_in=None, name=None):
        super().__init__(uniform=True, fan_in=fan_in)
