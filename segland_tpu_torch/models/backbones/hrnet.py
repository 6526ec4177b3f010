"""HRNetV2 backbone (W18/W32/W48), NCHW PyTorch.

Port of segland_tpu/models/backbones/hrnet.py with upstream SegLand's module
names (networks/backbones/hrnet.py): two stride-2 3x3 stem convs
(``conv1``/``bn1``, ``conv2``/``bn2``), ``layer1`` of four Bottlenecks
64 -> 256, the transitions that add a branch a stage (``transition1.0``,
``transition1.1.0``, ``transition2.2.0``, ``transition3.3.0``; upstream keeps
None in the slots of the branches a transition leaves alone), and stages of
[1, 4, 3] HighResolution modules with [2, 3, 4] branches of four BasicBlocks
(``stageN.m.branches.b.k``) and a full SUM fuse lattice
(``stageN.m.fuse_layers.i.j``).  Returns the four branch outputs fine ->
coarse.

The JAX package runs the branch chains of 32 and 64 channels in a W-packed
layout (``ops/packed.py``), a device for the TPU's 128-lane vectors; the port
runs the plain chain it replaces, the same function.  Parameters stay fp32 and
are cast to the compute dtype at use; activations run channels-last;
BatchNorm follows ``module.training``; convolutions go through
:func:`conv2d`, so an open ``quant_interceptor`` takes them one by one.
"""

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.layers import batch_norm, conv2d
from ...ops.resize import resize_bilinear
from ..init import flax_defaults_
from .resnet import Bottleneck, _conv

_FILTERS = {
    "hr-w18": (18, 36, 72, 144),
    "hr-w32": (32, 64, 128, 256),
    "hr-w48": (48, 96, 192, 384),
}


class StemBottleneck(Bottleneck):
    """resnet's Bottleneck (upstream's keys) in ``layer1``.  The JAX package's
    int8 fused routes take only its ResNet's Bottleneck modules (its HRNet's
    are functions), so the port's leave these to the conv-by-conv path."""

    int8_fusable = False


class ConvBN(nn.Sequential):
    """Sequential(conv without bias, BatchNorm[, ReLU]) as upstream indexes
    it (``.0``, ``.1``); a 3x3 conv pads 1."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1, relu: bool = True):
        mods = [_conv(cin, cout, k, stride), nn.BatchNorm2d(cout, eps=1e-5)]
        super().__init__(*mods + ([nn.ReLU()] if relu else []))

    def forward(self, x):
        y = batch_norm(self[1], conv2d(self[0], x))
        return F.relu(y) if len(self) == 3 else y


class BasicBlock(nn.Module):
    def __init__(self, planes: int):
        super().__init__()
        self.conv1 = _conv(planes, planes, 3)
        self.bn1 = nn.BatchNorm2d(planes, eps=1e-5)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-5)

    def forward(self, x):
        out = F.relu(batch_norm(self.bn1, conv2d(self.conv1, x)))
        return F.relu(batch_norm(self.bn2, conv2d(self.conv2, out)) + x)


def _resize(x, hw):
    """align_corners=True bilinear resize of an NCHW map to ``hw``."""
    return resize_bilinear(x.permute(0, 2, 3, 1), hw, align_corners=True).permute(0, 3, 1, 2)


class HighResolutionModule(nn.Module):
    """Four BasicBlocks a branch, then the SUM fuse lattice (reference
    hrnet.py:124-271): output i sums every branch j at branch i's resolution,
    j > i through a 1x1 conv + BN resized to branch i's own shape (not a x2^k
    scale: the two differ where 32 does not divide the input), j < i through
    a chain of stride-2 3x3 conv + BN with a ReLU after every link but the
    last; a ReLU after each sum."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*(BasicBlock(c) for _ in range(4))) for c in channels)
        fuse = []
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:
                    row.append(ConvBN(channels[j], channels[i], 1, relu=False))
                elif j < i:
                    row.append(nn.Sequential(*(
                        ConvBN(channels[j], channels[i] if k == i - j - 1 else channels[j],
                               3, 2, relu=k < i - j - 1) for k in range(i - j))))
                else:
                    row.append(None)
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs):
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        out = []
        for i, row in enumerate(self.fuse_layers):
            y = None
            for j, layer in enumerate(row):
                t = ys[j] if layer is None else layer(ys[j])
                if j > i:
                    t = _resize(t, tuple(ys[i].shape[-2:]))
                y = t if y is None else y + t
            out.append(F.relu(y))
        return out


class HighResolutionNet(nn.Module):
    def __init__(self, filters: Sequence[int] = (32, 64, 128, 256),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        f = tuple(filters)
        self.filters = f
        self.conv1 = _conv(3, 64, 3, 2)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        self.conv2 = _conv(64, 64, 3, 2)
        self.bn2 = nn.BatchNorm2d(64, eps=1e-5)
        self.layer1 = nn.Sequential(*(StemBottleneck(64 if k == 0 else 256, 64,
                                                     has_downsample=k == 0) for k in range(4)))
        # transition1: branch 0 3x3 s1 (256 -> f0), branch 1 3x3 s2 (256 -> f1); the later
        # ones add a branch from the coarsest existing one (reference hrnet.py:478)
        self.transition1 = nn.ModuleList([ConvBN(256, f[0]), nn.Sequential(ConvBN(256, f[1],
                                                                                  stride=2))])
        self.stage2 = nn.Sequential(HighResolutionModule(f[:2]))
        self.transition2 = nn.ModuleList([None, None, nn.Sequential(ConvBN(f[1], f[2], stride=2))])
        self.stage3 = nn.Sequential(*(HighResolutionModule(f[:3]) for _ in range(4)))
        self.transition3 = nn.ModuleList([None, None, None,
                                          nn.Sequential(ConvBN(f[2], f[3], stride=2))])
        self.stage4 = nn.Sequential(*(HighResolutionModule(f) for _ in range(3)))

    def reset_parameters(self, generator=None):
        """The JAX package's init: flax's defaults (``models/init.py``); its
        HRNet has no explicit initializer."""
        flax_defaults_(self, generator)

    def forward(self, x):
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = F.relu(batch_norm(self.bn1, conv2d(self.conv1, x)))
        x = F.relu(batch_norm(self.bn2, conv2d(self.conv2, x)))
        x = self.layer1(x)
        xs = [t(x) for t in self.transition1]
        for transition, stage in ((None, self.stage2), (self.transition2, self.stage3),
                                  (self.transition3, self.stage4)):
            if transition is not None:
                xs = xs + [transition[len(xs)](xs[-1])]
            for module in stage:
                xs = module(xs)
        return xs  # fine -> coarse


def get_hrnet(name: str, dtype=torch.float32) -> HighResolutionNet:
    return HighResolutionNet(_FILTERS[name], dtype=dtype)
