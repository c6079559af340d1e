"""paddle_tpu_torch.slim — model compression: the quantization tier.

Counterpart of paddle_tpu/slim: the QAT transform pass, the freeze pass,
the weight-only int8 freeze of an inference program, and post-training
quantization, on the port's Program IR, Executor and Scope.
"""
from .quantization import (  # noqa: F401
    QuantizationTransformPass, QuantizationFreezePass,
    PostTrainingQuantization, QUANTIZABLE_OPS, freeze_weights_int8,
)

__all__ = ["QuantizationTransformPass", "QuantizationFreezePass",
           "PostTrainingQuantization", "QUANTIZABLE_OPS",
           "freeze_weights_int8"]
