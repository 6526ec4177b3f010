"""Pooling with the JAX package's layout.  Port of segland_tpu/ops/pooling.py:
that module reproduces torch's AdaptiveAvgPool2d bins (start = floor(i*H/s),
end = ceil((i+1)*H/s)), so here the torch operator itself is the port."""

import torch
import torch.nn.functional as F


def adaptive_avg_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """x: [B,H,W,C] -> [B,out,out,C]."""
    return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), int(out_size)).permute(0, 2, 3, 1)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel_size=3, stride=2, padding=1) on [B,H,W,C], the ResNet
    stem pool (reference networks/backbones/resnet.py:90)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(2, 2) on [B,H,W,C], the VGG pool (an odd last row or column
    is dropped)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
