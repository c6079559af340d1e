"""paddle.vision.models: LeNet (lenet.py), the ResNet family
(resnet.py), VGG (vgg.py) and MobileNet V1 / V2 (mobilenet.py)."""
from .lenet import LeNet  # noqa: F401
from .resnet import (  # noqa: F401
    ResNet, BasicBlock, BottleneckBlock, resnet18, resnet34, resnet50,
    resnet101, resnet152,
)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .mobilenet import (  # noqa: F401
    MobileNetV1, MobileNetV2, mobilenet_v1, mobilenet_v2,
)

__all__ = ["LeNet", "ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152", "VGG", "vgg11",
           "vgg13", "vgg16", "vgg19", "MobileNetV1", "MobileNetV2",
           "mobilenet_v1", "mobilenet_v2"]
