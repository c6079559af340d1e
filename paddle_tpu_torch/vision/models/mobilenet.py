"""MobileNet V1 / V2 at any `scale` (counterpart of
paddle_tpu/vision/models/mobilenet.py): the depthwise convolutions are
conv2d ops with groups = channels (cuDNN's grouped convolution), each
conv followed by BatchNorm2D and ReLU (V1) or ReLU6 (V2).  No pretrained
weights (no network)."""
from ... import nn

__all__ = ["MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2"]


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNRelu(nn.Sequential):
    def __init__(self, in_c, out_c, kernel=3, stride=1, groups=1,
                 relu6=False):
        padding = (kernel - 1) // 2
        super().__init__(
            nn.Conv2D(in_c, out_c, kernel, stride=stride, padding=padding,
                      groups=groups, bias_attr=False),
            nn.BatchNorm2D(out_c),
            nn.ReLU6() if relu6 else nn.ReLU())


class DepthwiseSeparable(nn.Sequential):
    def __init__(self, in_c, out_c, stride):
        super().__init__(
            ConvBNRelu(in_c, in_c, stride=stride, groups=in_c),
            ConvBNRelu(in_c, out_c, kernel=1))


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return int(ch * scale)

        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
              [(512, 1024, 2), (1024, 1024, 1)]
        layers = [ConvBNRelu(3, c(32), stride=2)]
        for in_c, out_c, s in cfg:
            layers.append(DepthwiseSeparable(c(in_c), c(out_c), s))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(c(1024), num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            from ...tensor.manipulation import flatten
            x = flatten(x, 1)
            x = self.fc(x)
        return x


class InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNRelu(inp, hidden, kernel=1, relu6=True))
        layers += [
            ConvBNRelu(hidden, hidden, stride=stride, groups=hidden,
                       relu6=True),
            nn.Conv2D(hidden, oup, 1, bias_attr=False),
            nn.BatchNorm2D(oup),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        input_channel = _make_divisible(32 * scale)
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        features = [ConvBNRelu(3, input_channel, stride=2, relu6=True)]
        for t, ch, n, s in cfg:
            out_channel = _make_divisible(ch * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, out_channel, s if i == 0 else 1, t))
                input_channel = out_channel
        self.last_channel = _make_divisible(1280 * max(1.0, scale))
        features.append(ConvBNRelu(input_channel, self.last_channel,
                                   kernel=1, relu6=True))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(self.last_channel, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            from ...tensor.manipulation import flatten
            x = flatten(x, 1)
            x = self.classifier(x)
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError("pretrained weights require network "
                                  "access; load a local checkpoint instead")
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError("pretrained weights require network "
                                  "access; load a local checkpoint instead")
    return MobileNetV2(scale=scale, **kwargs)
