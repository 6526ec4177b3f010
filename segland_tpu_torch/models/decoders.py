"""Decoders, NCHW PyTorch.  Port of segland_tpu/models/decoders.py; only
the convnext_pop decoder is ported so far (the others are ROADMAP items
A6-A9)."""

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bilinear
from .backbones.convnext import layer_norm_nhwc


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


DECODERS = {"fpn_ocr": FPNOCRDecoder}
NOT_PORTED = {"psp": "A7", "pspplus": "A7", "aspp": "A7", "upernetplus": "A6",
              "simple": "A9", "hrfpn": "A8"}
