"""Decoders, NCHW PyTorch.  Port of segland_tpu/models/decoders.py with
upstream SegLand's module names: the convnext_pop decoder (FPN-OCR), the
swin_pop decoder (UperNet+ over a PSP-v2 top), the pspnet_pop and pspnet
decoder (PSPModule), the pspplus_pop decoder (PSP+), the deeplab_pop decoder
(ASPP), the lsk_pop decoder (SimpleDecoder), the seghr_pop decoder (HRFPN)
and vggunet_pop's, which is none (``identity``: its U-Net is the decoder).
Pyramid decoders take fine -> coarse lists (x[0] the finest); PSPModule and
ASPP take the backbone's last map, PSP+ the pair [x4, x2].  BatchNorm follows
``module.training`` (``ops/layers.py:batch_norm``): running statistics in eval
mode, the batch's in train mode; so does PSPModuleV2's dropout."""

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pooling import adaptive_avg_pool
from ..ops.resize import resize_bilinear
from ..ops.layers import batch_norm, conv2d
from .backbones.convnext import layer_norm_nhwc
from .backbones.droppath import dropout
from .init import flax_defaults_


def _resize(x, hw):
    """align_corners=True bilinear resize of an NCHW map."""
    return resize_bilinear(x.permute(0, 2, 3, 1), hw, align_corners=True).permute(0, 3, 1, 2)


class ConvBNReLU(nn.Sequential):
    """Sequential(conv, bn, relu) as upstream indexes it (``.0``, ``.1``)."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = True):
        super().__init__(nn.Conv2d(cin, cout, k, padding=k // 2, bias=bias),
                         nn.BatchNorm2d(cout, eps=1e-5), nn.ReLU())

    def forward(self, x):
        return F.relu(batch_norm(self[1], conv2d(self[0], x)))


class _PSPStage(nn.Sequential):
    """Sequential(pool, conv, bn) of one pyramid size (``.1``, ``.2``)."""

    def __init__(self, cin: int, cout: int, size: int):
        super().__init__(nn.AdaptiveAvgPool2d(size), nn.Conv2d(cin, cout, 1, bias=False),
                         nn.BatchNorm2d(cout, eps=1e-5))
        self.size = size

    def forward(self, x):
        p = adaptive_avg_pool(x.permute(0, 2, 3, 1), self.size).permute(0, 3, 1, 2)
        return F.relu(batch_norm(self[2], conv2d(self[1], p)))


class PSPModuleV2(nn.Module):
    """swin/upernet-style PSP (reference networks/swin_pop.py:7-35): pooled
    priors through 1x1 conv + BN + ReLU, upsampled with align_corners=True,
    concatenated with the input, then a 1x1 bottleneck conv (no bias) + BN +
    ReLU + dropout at 0.1 in train mode.  The dropout is the JAX package's
    element-wise ``nn.Dropout`` (upstream drops whole channels,
    ``Dropout2d``), its mask drawn from the step's generator
    (``backbones/droppath.py``)."""

    DROP = 0.1

    def __init__(self, features: int, out_features: int = 512,
                 sizes: Sequence[int] = (1, 2, 3, 6)):
        super().__init__()
        self.stages = nn.ModuleList(_PSPStage(features, out_features, s) for s in sizes)
        self.bottleneck = ConvBNReLU(features + len(sizes) * out_features, out_features, 1,
                                     bias=False)

    def forward(self, feats):
        hw = tuple(feats.shape[-2:])
        priors = [_resize(stage(feats), hw) for stage in self.stages] + [feats]
        return dropout(self.bottleneck(torch.cat(priors, dim=1)), self.DROP, self.training)


class PSPModule(nn.Module):
    """pspnet_pop-style PSP (reference networks/pspnet_pop.py:8-35) over the
    backbone's last map: pooled priors through 1x1 conv + BN + ReLU, upsampled
    with align_corners=False, concatenated with the input; ``bottleneck`` is
    Sequential(3x3 conv no bias, BN, ReLU, 1x1 conv with bias)."""

    def __init__(self, in_channels: Sequence[int], out_features: int = 512,
                 sizes: Sequence[int] = (1, 2, 3, 6), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        features = in_channels[0]  # resnet filters run coarse -> fine
        self.stages = nn.ModuleList(_PSPStage(features, out_features, s) for s in sizes)
        self.bottleneck = nn.Sequential(
            nn.Conv2d(features + len(sizes) * out_features, out_features, 3, padding=1,
                      bias=False),
            nn.BatchNorm2d(out_features, eps=1e-5), nn.ReLU(),
            nn.Conv2d(out_features, out_features, 1))

    def reset_parameters(self, generator=None):
        flax_defaults_(self, generator)

    def forward(self, feats):
        feats = feats.to(self.dtype)
        hw = tuple(feats.shape[-2:])
        priors = [resize_bilinear(stage(feats).permute(0, 2, 3, 1), hw,
                                  align_corners=False).permute(0, 3, 1, 2)
                  for stage in self.stages] + [feats]
        b = self.bottleneck
        x = F.relu(batch_norm(b[1], conv2d(b[0], torch.cat(priors, dim=1))))
        return conv2d(b[3], x)


class PSPPlusDecoder(nn.Module):
    """The pspplus_pop decoder (reference networks/pspplus_pop.py:37-54), wired
    as the JAX package wires it (the reference's forward is broken as shipped:
    it indexes a tensor as a list; the JAX docstring says how the weights pin
    the wiring down).  ``psp`` (a PSPModule) on x4, upsampled with
    align_corners=True to x2's size; ``reduce`` (1x1 conv 512 -> 32, BN, ReLU)
    on x2; the two concatenated [low, high] into ``fc`` (3x3 conv, BN, ReLU,
    1x1 conv; both convs with bias)."""

    def __init__(self, in_channels: Sequence[int], out_features: int = 512,
                 reduced_feature: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.psp = PSPModule(in_channels[:1], out_features, dtype=dtype)
        self.reduce = nn.Sequential(nn.Conv2d(in_channels[2], reduced_feature, 1),
                                    nn.BatchNorm2d(reduced_feature, eps=1e-5), nn.ReLU())
        self.fc = nn.Sequential(
            nn.Conv2d(reduced_feature + out_features, out_features, 3, padding=1),
            nn.BatchNorm2d(out_features, eps=1e-5), nn.ReLU(),
            nn.Conv2d(out_features, out_features, 1))

    def reset_parameters(self, generator=None):
        flax_defaults_(self, generator)

    def forward(self, feats):
        x4, x2 = (f.to(self.dtype) for f in feats)
        low = F.relu(batch_norm(self.reduce[1], conv2d(self.reduce[0], x2)))
        high = _resize(self.psp(x4), tuple(low.shape[-2:]))
        x = F.relu(batch_norm(self.fc[1], conv2d(self.fc[0], torch.cat([low, high], dim=1))))
        return conv2d(self.fc[3], x)


class _ConvBN(nn.Module):
    """``conv`` (no bias) + ``bn`` + ReLU of the ASPP, under upstream's names.
    BatchNorm momentum 0.999 as upstream sets it (networks/deeplab_pop.py:27;
    flax's 0.001): in training the running statistics are nearly the last
    batch's."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=dilation * (k // 2), dilation=dilation,
                              bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5, momentum=0.999)

    def forward(self, x):
        return F.relu(batch_norm(self.bn, conv2d(self.conv, x)))


class _ImagePool(nn.Module):
    """Global average pool -> 1x1 conv + BN + ReLU (``conv.conv``, ``conv.bn``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = _ConvBN(cin, cout, 1)

    def forward(self, x):
        return self.conv(x.mean(dim=(2, 3), keepdim=True))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (reference networks/deeplab_pop.py:12-67)
    over the backbone's last map: a 1x1 branch, three 3x3 branches at rates
    6/12/18, the image pool broadcast over the map, concatenated into ``fc``."""

    def __init__(self, in_channels: Sequence[int], out_features: int = 256,
                 rates: Sequence[int] = (6, 12, 18), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        cin = in_channels[0]
        stages = {"c0": _ConvBN(cin, out_features, 1)}
        for i, r in enumerate(rates):
            stages[f"c{i + 1}"] = _ConvBN(cin, out_features, 3, r)
        stages["imagepool"] = _ImagePool(cin, out_features)
        self.stages = nn.ModuleDict(stages)
        self.fc = _ConvBN((len(rates) + 2) * out_features, out_features, 1)

    def reset_parameters(self, generator=None):
        flax_defaults_(self, generator)

    def forward(self, feats):
        feats = feats.to(self.dtype)
        branches = [stage(feats) for stage in self.stages.values()]
        branches[-1] = branches[-1].expand(-1, -1, *feats.shape[-2:])
        return self.fc(torch.cat(branches, dim=1))


class _Upsample2x(nn.Module):
    def forward(self, x):
        return _resize(x, (x.shape[-2] * 2, x.shape[-1] * 2))


def _scale_head(dim: int, n_ups: int) -> nn.Sequential:
    """log2 scale head: (conv3x3+BN+ReLU [+2x up align_True]) x max(1, n_ups)
    (reference swin_pop.py:121-140); the blocks sit at the even indices."""
    mods = []
    for _ in range(max(1, n_ups)):
        mods.append(ConvBNReLU(dim, dim, 3))
        if n_ups > 0:
            mods.append(_Upsample2x())
    return nn.Sequential(*mods)


def _n_ups(filters: Sequence[int]):
    """Each level's count of 2x upsamples back to level 0: log2 of its width
    over level 0's, at least 1 (0 for level 0's own width)."""
    return [0 if f == filters[0] else max(1, int(math.log2(f) - math.log2(filters[0])))
            for f in filters]


class UperNetPlusDecoder(nn.Module):
    """UperNet_Decoder_Plus (reference networks/swin_pop.py:104-173).

    Laterals (3x3 conv+BN+ReLU) on the three fine levels, PSP-v2 on the top;
    top-down sum with align_corners=True; per-level scale heads upsampling
    back to level-0 resolution; summed."""

    def __init__(self, in_channels: Sequence[int], out_features: int = 96,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        filters = tuple(in_channels)
        dim = out_features
        self.psp = PSPModuleV2(filters[-1], dim)
        self.lateral_convs = nn.ModuleList(ConvBNReLU(f, dim, 3) for f in filters[:-1])
        self.fpn_convs = nn.ModuleList(_scale_head(dim, n) for n in _n_ups(filters))

    def reset_parameters(self, generator=None):
        flax_defaults_(self, generator)

    def forward(self, feats):
        feats = [f.to(self.dtype) for f in feats]
        laterals = [conv(f) for conv, f in zip(self.lateral_convs, feats[:-1])]
        laterals.append(self.psp(feats[-1]))
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + _resize(laterals[i],
                                                        tuple(laterals[i - 1].shape[-2:]))
        target = tuple(feats[0].shape[-2:])
        out = None
        for head, lat in zip(self.fpn_convs, laterals):
            y = head(lat)
            if tuple(y.shape[-2:]) != target:
                y = _resize(y, target)
            out = y if out is None else out + y
        return out


class SimpleDecoder(nn.Module):
    """The lsk_pop decoder (reference networks/lsk_pop.py:104-165): every
    level's lateral (3x3 conv + BN + ReLU) gated by a global semantic
    embedding of the top level (mean-pooled, 1x1 conv without bias, sigmoid)
    as l * sem + l, a log2 scale head a level, summed at level 0's size
    (align_corners=True)."""

    def __init__(self, in_channels: Sequence[int], out_features: int = 192,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        filters = tuple(in_channels)
        dim = out_features
        self.semantic_embedding = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(filters[-1], dim, 1, bias=False), nn.Sigmoid())
        self.lateral_convs = nn.ModuleList(ConvBNReLU(f, dim, 3) for f in filters)
        self.fpn_convs = nn.ModuleList(_scale_head(dim, n) for n in _n_ups(filters))

    def reset_parameters(self, generator=None):
        flax_defaults_(self, generator)

    def forward(self, feats):
        feats = [f.to(self.dtype) for f in feats]
        sem = torch.sigmoid(conv2d(self.semantic_embedding[1],
                                   feats[-1].mean(dim=(2, 3), keepdim=True)))
        target = tuple(feats[0].shape[-2:])
        out = None
        for lateral, head, f in zip(self.lateral_convs, self.fpn_convs, feats):
            lat = lateral(f)
            y = head(lat * sem + lat)
            if tuple(y.shape[-2:]) != target:
                y = _resize(y, target)
            out = y if out is None else out + y
        return out


class FPNOCRDecoder(nn.Module):
    """FPN_Seg_OCR_Decoder (reference networks/convnext_pop.py:8-28):
    upsample levels 1..3 to level-0 size (align_corners=True), concat, 1x1
    conv (bias) + LayerNorm, no activation.

    Computed in the commuted form: the 1x1 conv and the bilinear upsample are
    both linear, so each level is convolved at its own resolution with its
    channel slice of the one ``conv`` weight, and only the out_features-wide
    results are upsampled and summed.  Same math, and the 1440-channel concat
    at 1/4 scale never exists."""

    def __init__(self, in_channels: Sequence[int], out_features: int = 192,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_channels = tuple(in_channels)
        self.dtype = dtype
        self.conv = nn.Conv2d(sum(in_channels), out_features, 1)
        self.norm = nn.LayerNorm(out_features, eps=1e-5)

    def reset_parameters(self, generator=None):
        flax_defaults_(self, generator)

    def forward(self, feats):
        dt = self.dtype
        target = tuple(feats[0].shape[-2:])
        out, off = None, 0
        for f in feats:
            c = f.shape[1]
            y = F.conv2d(f.to(dt), self.conv.weight[:, off:off + c].to(dt))
            if tuple(y.shape[-2:]) != target:
                y = resize_bilinear(y.permute(0, 2, 3, 1), target, align_corners=True)
                y = y.permute(0, 3, 1, 2)
            out = y if out is None else out + y
            off += c
        x = (out + self.conv.bias.to(dt)[:, None, None]).permute(0, 2, 3, 1)
        return layer_norm_nhwc(self.norm, x).permute(0, 3, 1, 2)


class HRFPNDecoder(nn.Module):
    """The seghr_pop decoder (reference networks/seghr_pop.py:8-24): the four
    HRNet branches concatenated at the finest one's size, branches 1-3
    resized there with align_corners=True.  No parameters."""

    def __init__(self, in_channels: Sequence[int] = (), out_features: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()

    def reset_parameters(self, generator=None):
        pass

    def forward(self, feats):
        target = tuple(feats[0].shape[-2:])
        return torch.cat([feats[0]] + [_resize(f, target) for f in feats[1:]], dim=1)


class IdentityDecoder(nn.Module):
    """vggunet_pop's: its trunk returns the features the head reads."""

    def __init__(self, in_channels: Sequence[int] = (), out_features: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()

    def reset_parameters(self, generator=None):
        pass

    def forward(self, feats):
        return feats


DECODERS = {"fpn_ocr": FPNOCRDecoder, "upernetplus": UperNetPlusDecoder, "psp": PSPModule,
            "pspplus": PSPPlusDecoder, "aspp": ASPP, "simple": SimpleDecoder,
            "hrfpn": HRFPNDecoder, "identity": IdentityDecoder}
