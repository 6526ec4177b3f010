"""LSKNet-T backbone, NCHW PyTorch.

Port of segland_tpu/models/backbones/lsknet.py in its plain formulation, with
upstream SegLand's module names (networks/backbones/lsknet.py): overlapping
patch embeds (``patch_embed{i}.proj``, 7x7/s4 then 3x3/s2, and
``patch_embed{i}.norm``, a BatchNorm), stages of blocks ``block{i}.{j}``
(BatchNorm ``norm1`` -> LSK attention ``attn`` -> layer-scale residual,
BatchNorm ``norm2`` -> conv-MLP ``mlp`` with a 3x3 depthwise -> layer-scale
residual) and a LayerNorm ``norm{i}`` (eps 1e-6) on each stage's output.  The
LSK block (``attn.spatial_gating_unit``): a 5x5 depthwise and a 7x7 depthwise
at dilation 3 in series, a 1x1 halving each, the channel mean and max of the
two through a 7x7 conv and a sigmoid, the halves gated and summed, a 1x1 back
to the width, and the block's input times that.  Returns the four stage
outputs fine -> coarse.

The JAX package packs the C < 128 stages along W (``ops/packed.py``) and
folds fc1 into the MLP's depthwise conv below 128 channels; both are TPU
layout devices, so the port runs the plain chain they replace, the same
function.  Training draws DropPath (0.1 over the depth by the linspace rule)
and the conv-MLP's element-wise dropout (0.1) from the step's generator
(``droppath.py``).  The MLP's GELU is tanh in bfloat16 and exact erf in
float32, as the JAX package picks it; the attention's GELU is exact in both.

The convs the JAX package holds as raw ``ConvParams`` (the attention's, the
gate's and the MLP's) are :class:`ParamConv` here: its int8 interceptor takes
only ``nn.Conv``, so they stay unquantized, and the port's interceptor, which
takes only ``nn.Conv2d`` itself, leaves these alike.
"""

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.layers import batch_norm, conv2d
from ..init import flax_defaults_
from .convnext import layer_norm_nhwc
from .droppath import DropPath, dropout, drop_path_rates


class ParamConv(nn.Conv2d):
    """A conv the JAX package applies from raw parameters (``ConvParams``):
    same weights and math as ``nn.Conv2d``, outside int8 quantization."""


def _pconv(cin: int, cout: int, k: int = 1, groups: int = 1, dilation: int = 1) -> ParamConv:
    return ParamConv(cin, cout, k, padding=dilation * (k // 2), dilation=dilation,
                     groups=groups)


class LSKblock(nn.Module):
    """The LSK spatial gate (reference lsknet.py ``LSKblock``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv0 = _pconv(dim, dim, 5, groups=dim)
        self.conv_spatial = _pconv(dim, dim, 7, groups=dim, dilation=3)
        self.conv1 = _pconv(dim, dim // 2)
        self.conv2 = _pconv(dim, dim // 2)
        self.conv_squeeze = _pconv(2, 2, 7)
        self.conv = _pconv(dim // 2, dim)

    def forward(self, x):
        a1 = conv2d(self.conv0, x)
        a2 = conv2d(self.conv_spatial, a1)
        attn1, attn2 = conv2d(self.conv1, a1), conv2d(self.conv2, a2)
        attn = torch.cat([attn1, attn2], dim=1)
        agg = torch.cat([attn.mean(dim=1, keepdim=True), attn.amax(dim=1, keepdim=True)], dim=1)
        sig = torch.sigmoid(conv2d(self.conv_squeeze, agg))
        attn = attn1 * sig[:, 0:1] + attn2 * sig[:, 1:2]
        return x * conv2d(self.conv, attn)


class Attention(nn.Module):
    """1x1 ``proj_1``, exact GELU, the LSK gate, 1x1 ``proj_2``, plus the input."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj_1 = _pconv(dim, dim)
        self.spatial_gating_unit = LSKblock(dim)
        self.proj_2 = _pconv(dim, dim)

    def forward(self, x):
        h = F.gelu(conv2d(self.proj_1, x))
        return conv2d(self.proj_2, self.spatial_gating_unit(h)) + x


class DWConv(nn.Module):
    """The MLP's 3x3 depthwise conv (upstream's ``dwconv.dwconv``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = _pconv(dim, dim, 3, groups=dim)

    def forward(self, x):
        return conv2d(self.dwconv, x)


class Mlp(nn.Module):
    """fc1, the depthwise 3x3, GELU, dropout, fc2, dropout."""

    def __init__(self, dim: int, hidden: int, drop: float):
        super().__init__()
        self.fc1 = _pconv(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = _pconv(hidden, dim)
        self.drop = drop

    def forward(self, x):
        h = self.dwconv(conv2d(self.fc1, x))
        h = F.gelu(h, approximate="tanh" if h.dtype == torch.bfloat16 else "none")
        h = dropout(h, self.drop, self.training)
        return dropout(conv2d(self.fc2, h), self.drop, self.training)


class Block(nn.Module):
    def __init__(self, dim: int, mlp_ratio: float, drop: float, drop_path: float):
        super().__init__()
        self.norm1 = nn.BatchNorm2d(dim, eps=1e-5)
        self.attn = Attention(dim)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.BatchNorm2d(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop)
        self.layer_scale_1 = nn.Parameter(torch.empty(dim))
        self.layer_scale_2 = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        h = self.attn(batch_norm(self.norm1, x))
        x = x + self.drop_path(self.layer_scale_1.to(h.dtype)[:, None, None] * h)
        h = self.mlp(batch_norm(self.norm2, x))
        return x + self.drop_path(self.layer_scale_2.to(h.dtype)[:, None, None] * h)


class OverlapPatchEmbed(nn.Module):
    """``proj`` (a k x k conv of stride s, padding k // 2) then ``norm`` (BatchNorm)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2)
        self.norm = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x):
        return batch_norm(self.norm, conv2d(self.proj, x))


class LSKNet(nn.Module):
    def __init__(self, embed_dims: Sequence[int] = (32, 64, 160, 256),
                 depths: Sequence[int] = (3, 3, 5, 2), mlp_ratios: Sequence[float] = (8, 8, 4, 4),
                 drop_rate: float = 0.1, drop_path_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.depths = tuple(depths)
        dpr = drop_path_rates(drop_path_rate, depths)
        cur, cin = 0, 3
        for i, (dim, depth) in enumerate(zip(embed_dims, depths)):
            k, s = (7, 4) if i == 0 else (3, 2)
            setattr(self, f"patch_embed{i + 1}", OverlapPatchEmbed(cin, dim, k, s))
            setattr(self, f"block{i + 1}", nn.ModuleList(
                Block(dim, mlp_ratios[i], drop_rate, dpr[cur + j]) for j in range(depth)))
            setattr(self, f"norm{i + 1}", nn.LayerNorm(dim, eps=1e-6))
            cur += depth
            cin = dim

    def reset_parameters(self, generator=None):
        """The JAX package's init: flax's defaults (``models/init.py``) and
        layer-scales at 1e-2."""
        flax_defaults_(self, generator)
        for name, p in self.named_parameters():
            if "layer_scale" in name:
                nn.init.constant_(p, 1e-2)

    def forward(self, x):
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        outs = []
        for i in range(len(self.depths)):
            x = getattr(self, f"patch_embed{i + 1}")(x)
            for blk in getattr(self, f"block{i + 1}"):
                x = blk(x)
            norm = getattr(self, f"norm{i + 1}")
            x = layer_norm_nhwc(norm, x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            outs.append(x)
        return outs  # fine -> coarse


def lsknet_tiny(dtype=torch.float32) -> LSKNet:
    return LSKNet(dtype=dtype)
