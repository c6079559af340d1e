"""The VGG family (counterpart of paddle_tpu/vision/models/vgg.py): vgg11 /
13 / 16 / 19, with or without batch norm; 3x3 convolutions (padding 1)
and 2x2 max pools, a 7x7 adaptive average pool (windows of in // 7, so
the input is at least 224 x 224 for a 7x7 map), then the 4096-wide
classifier with dropout 0.5.  No pretrained weights (no network)."""
from ... import nn

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

cfgs = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg, batch_norm=False):
    layers = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(kernel_size=2, stride=2))
        else:
            conv2d = nn.Conv2D(in_channels, v, kernel_size=3, padding=1)
            if batch_norm:
                layers += [conv2d, nn.BatchNorm2D(v), nn.ReLU()]
            else:
                layers += [conv2d, nn.ReLU()]
            in_channels = v
    return nn.Sequential(*layers)


class VGG(nn.Layer):
    def __init__(self, features, num_classes=1000):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        if num_classes > 0:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096),
                nn.ReLU(),
                nn.Dropout(),
                nn.Linear(4096, 4096),
                nn.ReLU(),
                nn.Dropout(),
                nn.Linear(4096, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            from ...tensor.manipulation import flatten
            x = self.avgpool(x)
            x = flatten(x, 1)
            x = self.classifier(x)
        return x


def _vgg(cfg, batch_norm=False, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights require network access; load a local "
            "checkpoint with set_state_dict instead")
    return VGG(make_layers(cfgs[cfg], batch_norm=batch_norm), **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, **kwargs)
