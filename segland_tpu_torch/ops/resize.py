"""Bilinear resizing with torch semantics, on channels-last arrays.

Port of segland_tpu/ops/resize.py.  ``resize_bilinear`` takes the JAX
package's layout (resized axes -3 and -2) and runs ``F.interpolate`` on a
channels-first view, so a channels-last tensor is resized without a copy.
``linear_table`` builds the per-axis (lo, hi, w) tables the fused epilogue
kernel consumes, exactly as the JAX package builds them (float64 source
coordinates, fp32 weights).
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
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(oh, ow), mode="bilinear",
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 1)
