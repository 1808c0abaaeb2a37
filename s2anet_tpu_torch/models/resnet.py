"""ResNet backbones, returning C3, C4, C5.

Counterpart of ``s2anet_tpu/models/resnet.py`` (``ResNetBackbone``,
``BasicBlock``, ``Bottleneck``). The JAX stem computes its 7x7/2 pad-3 conv
through a space-to-depth rewrite, a TPU layout trick for the same math; here
it is the plain conv. Max pool 3/2 pad 1.

In train mode every BatchNorm trains (``models/bn.py``): nothing frozen and
no ``norm_eval``, the settings of ``configs/dota_r50.yaml``. Convs compute
in the input's type (``models/conv.py``).

Module names follow the reference's torch key layout, which
``s2anet_tpu/models/torch_import.py::convert_reference_s2anet`` reads:
``backbone.0`` = (stem conv, bn), ``backbone.1`` = (maxpool, layer1),
``backbone.2..4`` = layer2..4, and per block ``conv{i}``/``bn{i}`` and
``downsample.{0,1}``.
"""

from __future__ import annotations

import torch
from torch import nn

from .bn import BatchNorm2d
from .conv import Conv2d

ARCH_SETTINGS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}


def _downsample(cin, cout, stride):
    return nn.Sequential(Conv2d(cin, cout, 1, stride, bias=False),
                         BatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (_downsample(cin, planes, stride)
                           if stride != 1 or cin != planes else None)

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + r)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out)
        self.downsample = (_downsample(cin, out, stride)
                           if stride != 1 or cin != out else None)

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return torch.relu(y + r)


def stage_channels(arch: str):
    """Channel counts of C3, C4, C5."""
    kind, _ = ARCH_SETTINGS[arch]
    exp = 1 if kind == "basic" else 4
    return [128 * exp, 256 * exp, 512 * exp]


class ResNet(nn.Module):
    """Stem + 4 stages; ``forward`` returns (C3, C4, C5)."""

    def __init__(self, arch: str = "resnet50"):
        super().__init__()
        kind, layer_cfg = ARCH_SETTINGS[arch]
        block = BasicBlock if kind == "basic" else Bottleneck
        stem = nn.Sequential(Conv2d(3, 64, 7, 2, 3, bias=False),
                             BatchNorm2d(64), nn.ReLU())
        stages = []
        cin, planes = 64, 64
        for s, n_blocks in enumerate(layer_cfg):
            blocks = []
            for i in range(n_blocks):
                stride = 1 if s == 0 or i > 0 else 2
                blocks.append(block(cin, planes, stride))
                cin = planes * block.expansion
            stages.append(nn.Sequential(*blocks))
            planes *= 2
        self.backbone = nn.Sequential(
            stem,
            nn.Sequential(nn.MaxPool2d(3, 2, 1), stages[0]),
            *stages[1:],
        )

    def forward(self, x):
        outs = []
        for i, layer in enumerate(self.backbone):
            x = layer(x)
            if i >= 2:
                outs.append(x)
        return tuple(outs)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """He-normal (fan_out) convs, identity BatchNorms."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu",
                                        generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
