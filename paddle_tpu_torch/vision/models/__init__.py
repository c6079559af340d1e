"""paddle.vision.models: LeNet (lenet.py) and the ResNet family
(resnet.py).  VGG and MobileNet wait for ROADMAP.md Queue 1, The rest."""
from .lenet import LeNet  # noqa: F401
from .resnet import (  # noqa: F401
    ResNet, BasicBlock, BottleneckBlock, resnet18, resnet34, resnet50,
    resnet101, resnet152,
)

__all__ = ["LeNet", "ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152"]
