"""Eval epilogue: bilinear (align_corners=True) fp32 upsample + argmax.

Port of segland_tpu/ops/fused_epilogue.py.  ``upsample_argmax`` dispatches
on the device (see ``ops/__init__.py``): CUDA tensors go to the kernel K2
(``kernels/csrc/upsample_argmax.cu``), which never writes the upsampled
logits; CPU tensors to :func:`upsample_argmax_reference`.  Both take any
(h, w) -> (oh, ow) and break ties toward the first class.
"""

import functools

import torch

from . import use_kernel
from .resize import linear_table, resize_bilinear
from .. import kernels


def upsample_argmax_reference(logits, out_hw):
    """(B,h,w,K) logits -> (B,oh,ow) uint8: fp32 F.interpolate + argmax."""
    up = resize_bilinear(logits.float(), out_hw, align_corners=True)
    return up.argmax(-1).to(torch.uint8)


@functools.lru_cache(maxsize=16)
def _tables(in_size: int, out_size: int, device: torch.device):
    lo, hi, w = linear_table(in_size, out_size, align_corners=True)
    return tuple(torch.from_numpy(a).to(device) for a in (lo, hi, w))


def upsample_argmax(logits, out_hw):
    """argmax(resize_bilinear(logits fp32, out_hw, align_corners=True), -1).
    logits (B,h,w,K) -> (B,oh,ow) uint8."""
    if not use_kernel(logits):
        return upsample_argmax_reference(logits, out_hw)
    if logits.dim() != 4 or not logits.is_contiguous():
        raise ValueError("upsample_argmax takes contiguous (B,h,w,K) logits")
    b, h, w, k = logits.shape
    if not 1 <= k <= 255:
        raise ValueError(f"upsample_argmax writes uint8 classes; got K={k}")
    oh, ow = int(out_hw[0]), int(out_hw[1])
    lf = logits.float()
    dev = lf.device
    rlo, rhi, rw = _tables(h, oh, dev)
    clo, chi, cw = _tables(w, ow, dev)
    out = torch.empty((b, oh, ow), dtype=torch.uint8, device=dev)
    P = kernels.ptr
    err = kernels.library().segland_upsample_argmax(
        P(lf), P(rlo), P(rhi), P(rw), P(clo), P(chi), P(cw), P(out),
        b, h, w, k, oh, ow, dev.index, kernels.stream_of(lf))
    kernels.check(err, "upsample_argmax")
    upsample_argmax.launches += 1
    return out


upsample_argmax.launches = 0
