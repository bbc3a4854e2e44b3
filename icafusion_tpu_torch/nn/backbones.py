"""The VGG16 and ResNet50 towers, NCHW.

Counterparts of the JAX package's nn/backbones.py (reference
models/common.py:109-181), used by the yolov5_VGG16_* and yolov5_ResNet50_*
configs. YAML args carry the input channels: VGGblock [num_convs, c1, c2],
ResNetlayer [c1, c2, stride, is_first, num_blocks]. Submodules carry the
flax names (``conv{i}``; ``conv1..3``, ``bn1..3``, ``shortcut_conv``,
``shortcut_bn``; ``stem_conv``, ``stem_bn``, ``blk{i}``), so
utils/convert.py maps them with no rule of their own.

Their 3x3 convs end in ReLU, and VGG's carry a bias: they are plain
``nn.Conv2d`` modules, never the port's ``Conv``, so none of them reaches
the fused conv3x3 + BN + SiLU kernel. BatchNorm has the YOLOv5 settings of
nn/layers.py (eps 1e-3, momentum 0.03), as in the JAX package.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from icafusion_tpu_torch.nn.layers import BN_EPS, BN_MOMENTUM, BatchNorm2d


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class VGGblock(nn.Module):
    """num_convs x (3x3 conv with bias + ReLU), then a 2x2/2 max pool
    (common.py:109-128)."""

    def __init__(self, num_convs: int, c1: int, c2: int):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"conv{i}", nn.Conv2d(c1 if i == 0 else c2, c2,
                                                  3, 1, 1, bias=True))

    def forward(self, x):
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return F.max_pool2d(x, 2, 2)


class ResNetblock(nn.Module):
    """Bottleneck block of expansion 4 (common.py:131-156): 1x1, 3x3 with
    the stride, 1x1 to 4 * c2, each with BatchNorm; a 1x1 conv + BatchNorm
    shortcut where the stride or the width changes."""

    expansion = 4

    def __init__(self, c1: int, c2: int, stride: int = 1):
        super().__init__()
        c3 = self.expansion * c2
        self.conv1 = nn.Conv2d(c1, c2, 1, bias=False)
        self.bn1 = _bn(c2)
        self.conv2 = nn.Conv2d(c2, c2, 3, stride, 1, bias=False)
        self.bn2 = _bn(c2)
        self.conv3 = nn.Conv2d(c2, c3, 1, bias=False)
        self.bn3 = _bn(c3)
        self.projects = stride != 1 or c1 != c3
        if self.projects:
            self.shortcut_conv = nn.Conv2d(c1, c3, 1, stride, bias=False)
            self.shortcut_bn = _bn(c3)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        sc = self.shortcut_bn(self.shortcut_conv(x)) if self.projects else x
        return F.relu(out + sc)


class ResNetlayer(nn.Module):
    """A ResNet stage (common.py:159-181). is_first: the 7x7/2 conv +
    BatchNorm + ReLU stem and a 3x3/2 max pool padded with -inf; else
    num_blocks bottlenecks, the first with the stride."""

    def __init__(self, c1: int, c2: int, stride: int = 1,
                 is_first: bool = False, num_blocks: int = 1):
        super().__init__()
        self.is_first = is_first
        self.num_blocks = num_blocks
        if is_first:
            self.stem_conv = nn.Conv2d(c1, c2, 7, 2, 3, bias=False)
            self.stem_bn = _bn(c2)
            return
        for i in range(num_blocks):
            self.add_module(f"blk{i}", ResNetblock(
                c1 if i == 0 else ResNetblock.expansion * c2, c2,
                stride if i == 0 else 1))

    def forward(self, x):
        if self.is_first:
            x = F.relu(self.stem_bn(self.stem_conv(x)))
            return F.max_pool2d(x, 3, 2, 1)
        for i in range(self.num_blocks):
            x = getattr(self, f"blk{i}")(x)
        return x
