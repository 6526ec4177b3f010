"""Pooling with the JAX package's layout.  Port of segland_tpu/ops/pooling.py:
that module reproduces torch's AdaptiveAvgPool2d bins (start = floor(i*H/s),
end = ceil((i+1)*H/s)), so here the torch operator itself is the port.  Under
``torch.use_deterministic_algorithms`` a CUDA tensor that takes a gradient is
pooled as two products with the bins' averaging matrices: the operator's CUDA
backward adds with atomics and has no deterministic form."""

import numpy as np
import torch
import torch.nn.functional as F


def adaptive_avg_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """x: [B,H,W,C] -> [B,out,out,C]."""
    if x.is_cuda and x.requires_grad and torch.are_deterministic_algorithms_enabled():
        return pool_as_products(x, int(out_size))
    return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), int(out_size)).permute(0, 2, 3, 1)


def bin_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] fp32: row i averages bin i, [floor(i*n/s), ceil((i+1)*n/s))."""
    m = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        lo, hi = i * in_size // out_size, -(-(i + 1) * in_size // out_size)
        m[i, lo:hi] = 1.0 / (hi - lo)
    return m


def pool_as_products(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """``adaptive_avg_pool`` as two matmuls in fp32, whose backward is two
    matmuls too (deterministic on CUDA)."""
    ph, pw = (torch.from_numpy(bin_matrix(n, out_size)).to(x.device) for n in x.shape[-3:-1])
    y = torch.einsum("oh,...hwc->...owc", ph, x.float())
    return torch.einsum("pw,...owc->...opc", pw, y).to(x.dtype)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel_size=3, stride=2, padding=1) on [B,H,W,C], the ResNet
    stem pool (reference networks/backbones/resnet.py:90)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(2, 2) on [B,H,W,C], the VGG pool (an odd last row or column
    is dropped)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
