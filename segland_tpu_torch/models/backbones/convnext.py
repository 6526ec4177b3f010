"""ConvNeXt backbone (tiny), NCHW PyTorch.

Port of segland_tpu/models/backbones/convnext.py with upstream SegLand's
module names (networks/backbones/convnext.py): 4x4/s4 stem + LN, LN + 2x2/s2
downsample layers, blocks = 7x7 depthwise conv -> LN -> 4x MLP -> layer
scale -> + input; 4-level pyramid out, fine -> coarse.  DropPath is the
identity at eval and is omitted.

Parameters stay fp32 and are cast to the compute dtype at use, as flax
does.  Activations run channels-last, so the [..., C] rows the fused MLP
kernel takes are a view of the conv output, not a copy.
"""

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.fused_mlp import fused_ln_mlp
from ...ops.layers import conv2d, linear
from ..init import flax_defaults_


def layer_norm_nhwc(m: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, m.normalized_shape, m.weight.to(x.dtype), m.bias.to(x.dtype), m.eps)


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map (upstream's
    ``LayerNorm(data_format="channels_first")``)."""

    def forward(self, x):
        return layer_norm_nhwc(self, x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, fused_mlp: bool = False):
        super().__init__()
        self.fused_mlp = fused_mlp
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x):
        inp = x
        x = conv2d(self.dwconv, x).permute(0, 2, 3, 1)
        if self.fused_mlp:
            y = fused_ln_mlp(x.contiguous(), self.norm.weight, self.norm.bias,
                             self.pwconv1.weight.T, self.pwconv1.bias,
                             self.pwconv2.weight.T, self.pwconv2.bias,
                             res=inp.permute(0, 2, 3, 1).contiguous(),
                             ls=self.gamma, eps=1e-6)
            return y.permute(0, 3, 1, 2)
        dt = x.dtype
        x = layer_norm_nhwc(self.norm, x)
        x = linear(self.pwconv1, x)
        x = F.gelu(x)
        x = linear(self.pwconv2, x)
        # layer-scale cast to the compute dtype: a bare fp32 gamma would
        # promote every block output to fp32 in bf16 mode
        return inp + (self.gamma.to(dt) * x).permute(0, 3, 1, 2)


class ConvNeXt(nn.Module):
    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768), fused_mlp: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.downsample_layers = nn.ModuleList(
            [nn.Sequential(nn.Conv2d(3, dims[0], 4, stride=4), LayerNorm2d(dims[0], eps=1e-6))]
            + [nn.Sequential(LayerNorm2d(dims[i - 1], eps=1e-6),
                             nn.Conv2d(dims[i - 1], dims[i], 2, stride=2))
               for i in range(1, 4)])
        self.stages = nn.ModuleList(
            nn.Sequential(*[ConvNeXtBlock(dims[i], fused_mlp) for _ in range(depths[i])])
            for i in range(4))

    def reset_parameters(self, generator=None):
        """The JAX package's init: lecun-normal conv and linear weights, zero
        biases, unit norms (``models/init.py``), layer-scale 1e-6."""
        flax_defaults_(self, generator)
        for m in self.modules():
            if isinstance(m, ConvNeXtBlock):
                nn.init.constant_(m.gamma, 1e-6)

    def forward(self, x):
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        outs = []
        for i in range(4):
            ds = self.downsample_layers[i]
            if i == 0:
                x = ds[1](conv2d(ds[0], x))
            else:
                x = conv2d(ds[1], ds[0](x))
            x = self.stages[i](x)
            outs.append(x)
        return outs  # fine -> coarse


def convnext_tiny(dtype=torch.float32, fused_mlp: bool = False):
    return ConvNeXt(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768),
                    fused_mlp=fused_mlp, dtype=dtype)
