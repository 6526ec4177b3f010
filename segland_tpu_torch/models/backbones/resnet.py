"""Dilated ResNet backbones (v1 7x7 stem, v2 deep 3-conv stem), NCHW PyTorch.

Port of segland_tpu/models/backbones/resnet.py with upstream SegLand's module
names (networks/backbones/resnet.py): ``conv1``/``bn1`` (``conv2``..``bn3``
with the deep stem), ``layerN.i.{conv1,bn1,conv2,bn2,conv3,bn3}`` and
``layerN.i.downsample.{0,1}``.  Output stride 8 or 16 by dilation, optional
multigrid on layer4, ``last_relu`` control on the last block of layers 3 and
4, and either the last feature map or the pyramid [x4, x3, x2, x1].

Parameters stay fp32 and are cast to the compute dtype at use; activations
run channels-last; BatchNorm follows ``module.training`` (running statistics
in eval mode, the batch's in train mode).
Convolutions go through :func:`conv2d`, so an open ``quant_interceptor``
(``quant/ptq.py``) takes them; a ``Bottleneck`` keeps ``stride``,
``dilation``, ``multi_grid``, ``has_downsample`` and ``last_relu`` as
attributes for that interceptor's fused route, which takes only blocks whose
``int8_fusable`` is set.
"""

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.pooling import max_pool_3x3_s2
from ...ops.layers import batch_norm, conv2d
from ..init import flax_defaults_


def _conv(cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=dilation * (k // 2),
                     dilation=dilation, bias=False)


class Bottleneck(nn.Module):
    # the int8 fused routes (quant/ptq.py) take it, as the JAX package's take its
    # ResNet's Bottleneck modules
    int8_fusable = True

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 multi_grid: int = 1, has_downsample: bool = False, last_relu: bool = True):
        super().__init__()
        self.planes = planes
        self.stride = stride
        self.dilation = dilation
        self.multi_grid = multi_grid
        self.has_downsample = has_downsample
        self.last_relu = last_relu
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = nn.BatchNorm2d(planes, eps=1e-5)
        self.conv2 = _conv(planes, planes, 3, stride, dilation * multi_grid)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-5)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = nn.BatchNorm2d(planes * 4, eps=1e-5)
        if has_downsample:
            self.downsample = nn.Sequential(_conv(inplanes, planes * 4, 1, stride),
                                            nn.BatchNorm2d(planes * 4, eps=1e-5))

    def forward(self, x):
        residual = x
        out = F.relu(batch_norm(self.bn1, conv2d(self.conv1, x)))
        out = F.relu(batch_norm(self.bn2, conv2d(self.conv2, out)))
        out = batch_norm(self.bn3, conv2d(self.conv3, out))
        if self.has_downsample:
            residual = batch_norm(self.downsample[1], conv2d(self.downsample[0], x))
        out = out + residual
        return F.relu(out) if self.last_relu else out


def _make_layer(planes: int, blocks: int, in_planes: int, stride: int = 1, dilation: int = 1,
                multi_grid: bool = False, last_relu: bool = True) -> nn.Sequential:
    grid = (1, 2, 4) if multi_grid else (1, 1, 1)
    has_ds = stride != 1 or in_planes != planes * 4
    mods = [Bottleneck(in_planes, planes, stride, dilation, grid[0], has_ds, True)]
    for i in range(1, blocks):
        use_relu = True if i != blocks - 1 else last_relu
        mods.append(Bottleneck(planes * 4, planes, 1, dilation, grid[i % len(grid)], False,
                               use_relu))
    return nn.Sequential(*mods)


class ResNet(nn.Module):
    """v1: 7x7 stem (reference resnet.py:80-136); ``deep_stem``: three 3x3
    convs (reference resnet.py:138-208)."""

    filters = (256, 512, 1024, 2048)
    deep_channels = 2048
    dsn_channels = 1024

    def __init__(self, layers: Sequence[int], dilated: bool = True, multi_grid: bool = False,
                 os: int = 8, relu_l3: bool = True, relu_l4: bool = True,
                 deep_stem: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.deep_stem = deep_stem
        if deep_stem:
            self.conv1 = _conv(3, 64, 3, 2)
            self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
            self.conv2 = _conv(64, 64, 3)
            self.bn2 = nn.BatchNorm2d(64, eps=1e-5)
            self.conv3 = _conv(64, 128, 3)
            self.bn3 = nn.BatchNorm2d(128, eps=1e-5)
            in_planes = 128
        else:
            self.conv1 = _conv(3, 64, 7, 2)
            self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
            in_planes = 64
        if dilated and os == 8:
            l3, l4 = dict(stride=1, dilation=2), dict(stride=1, dilation=4, multi_grid=multi_grid)
        elif dilated:
            l3, l4 = dict(stride=2, dilation=1), dict(stride=1, dilation=2, multi_grid=multi_grid)
        else:
            l3, l4 = dict(stride=2, dilation=1), dict(stride=2, dilation=1)
        self.layer1 = _make_layer(64, layers[0], in_planes)
        self.layer2 = _make_layer(128, layers[1], 256, stride=2)
        self.layer3 = _make_layer(256, layers[2], 512, last_relu=relu_l3, **l3)
        self.layer4 = _make_layer(512, layers[3], 1024, last_relu=relu_l4, **l4)

    def reset_parameters(self, generator=None):
        """The JAX package's init: lecun-normal conv weights, unit BatchNorm
        (``models/init.py``)."""
        flax_defaults_(self, generator)

    def _stem(self, x):
        x = F.relu(batch_norm(self.bn1, conv2d(self.conv1, x)))
        if self.deep_stem:
            x = F.relu(batch_norm(self.bn2, conv2d(self.conv2, x)))
            x = F.relu(batch_norm(self.bn3, conv2d(self.conv3, x)))
        return max_pool_3x3_s2(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)

    def forward(self, x, return_list: bool = False):
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x1 = self.layer1(self._stem(x))
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        x4 = self.layer4(x3)
        # pyramid ordering [x4, x3, x2, x1] matches reference resnet.py:186-201
        return [x4, x3, x2, x1] if return_list else x4


_LAYERS = {"resnet10": (1, 1, 1, 1), "resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
           "resnet50v2": (3, 4, 6, 3), "resnet101v2": (3, 4, 23, 3)}


def get_resnet(name: str, dtype=torch.float32, **kw) -> ResNet:
    """resnet50/101 (v1 stem), resnet50v2/101v2 (deep stem), and resnet10, a
    one-block-a-stage variant for narrow tests."""
    return ResNet(_LAYERS[name], deep_stem=name.endswith("v2"), dtype=dtype, **kw)


def resnet50(dtype=torch.float32, **kw):
    return get_resnet("resnet50", dtype, **kw)


def resnet101(dtype=torch.float32, **kw):
    return get_resnet("resnet101", dtype, **kw)


def resnet50v2(dtype=torch.float32, **kw):
    return get_resnet("resnet50v2", dtype, **kw)


def resnet101v2(dtype=torch.float32, **kw):
    return get_resnet("resnet101v2", dtype, **kw)
