"""Bilinear resizing with torch semantics, on channels-last arrays.

Port of segland_tpu/ops/resize.py.  ``resize_bilinear`` takes the JAX
package's layout (resized axes -3 and -2) and runs ``F.interpolate`` on a
channels-first view, so a channels-last tensor is resized without a copy.
``linear_table`` builds the per-axis (lo, hi, w) tables the fused epilogue
kernel consumes, exactly as the JAX package builds them (float64 source
coordinates, fp32 weights).  Under ``torch.use_deterministic_algorithms`` a
CUDA tensor that takes a gradient is resized as two products with the
interpolation matrices (``resize_as_products``): ``F.interpolate``'s CUDA
backward adds with atomics and has no deterministic form.
"""

import numpy as np
import torch
import torch.nn.functional as F


def linear_table(in_size: int, out_size: int, align_corners: bool):
    """Source indices + lerp weights for 1-D linear interpolation (torch's
    area_pixel_compute_source_index).  Returns (lo int32, hi int32, w_hi fp32)."""
    if align_corners:
        if out_size == 1:
            src = np.zeros((1,), np.float64)
        else:
            src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    else:
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) - 0.5
        src = np.maximum(src, 0.0)
    lo = np.minimum(np.floor(src).astype(np.int32), in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    return lo, hi, (src - lo).astype(np.float32)


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of a [B,H,W,C] tensor to ``out_hw = (H', W')``."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if tuple(x.shape[-3:-1]) == (oh, ow):
        return x
    if x.is_cuda and x.requires_grad and torch.are_deterministic_algorithms_enabled():
        return resize_as_products(x, (oh, ow), align_corners)
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(oh, ow), mode="bilinear",
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 1)


def interpolation_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """[out_size, in_size] fp32: row i holds output i's two lerp weights."""
    lo, hi, w = linear_table(in_size, out_size, align_corners)
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, lo), 1.0 - w)
    np.add.at(m, (rows, hi), w)
    return m


def resize_as_products(x: torch.Tensor, out_hw, align_corners: bool) -> torch.Tensor:
    """``resize_bilinear`` as two matmuls in fp32, whose backward is two
    matmuls too (deterministic on CUDA)."""
    (oh, ow), (h, w) = out_hw, x.shape[-3:-1]
    ah, aw = (torch.from_numpy(interpolation_matrix(n, o, align_corners)).to(x.device)
              for n, o in ((h, oh), (w, ow)))
    y = torch.einsum("oh,...hwc->...owc", ah, x.float())
    return torch.einsum("pw,...owc->...opc", aw, y).to(x.dtype)
