"""Eval epilogue: bilinear (align_corners=True) fp32 upsample + argmax.

Port of segland_tpu/ops/fused_epilogue.py.  ``upsample_argmax`` dispatches
on the device (see ``ops/__init__.py``): CUDA tensors go to the kernel K2
(``kernels/csrc/upsample_argmax.cu``), which never writes the upsampled
logits; CPU tensors to :func:`upsample_argmax_reference`.  Both take any
(h, w) -> (oh, ow) and break ties toward the first class.

K2 works in tiles of ``4 * txt`` output columns by ``ty * groups`` output
rows of one image (a block of ``txt * ty`` threads, 4 adjacent output pixels
of one row a thread), ``kc`` classes a pass: a persistent block stages a
tile's source patch (rows ``rlo[y0]..rhi[y1]``, columns ``clo[x0]..chi[x1]``)
in shared memory while it computes the pass before; then each warp row-lerps
its own rows of the tile once per patch column and class into its strip rows,
and each thread column-lerps its pixels from them.
:func:`upsample_plan` chooses ``txt``, ``ty``, ``groups`` and ``kc`` from the
largest patch of any tile, so that two patches and the strip fit the
kernel's shared-memory budget at every shape; the kernel computes the same
layout and checks the patch.
"""

import functools

import numpy as np
import torch

from . import forward_only, use_kernel
from .resize import linear_table, resize_bilinear
from .. import kernels

THREADS = 256        # kThreads of upsample_argmax.cu: the most threads a block
PIXELS = 4           # kPx: adjacent output pixels a thread
SMEM_BUDGET = 98304  # kSmemBudget: bytes of patches + strip a block (at least two a SM)
GROUPS = (4, 2, 1)   # row groups a tile, the most that fit first (one pass only)


def upsample_argmax_reference(logits, out_hw):
    """(B,h,w,K) logits -> (B,oh,ow) uint8: fp32 F.interpolate + argmax."""
    up = resize_bilinear(logits.float(), out_hw, align_corners=True)
    return up.argmax(-1).to(torch.uint8)


@functools.lru_cache(maxsize=16)
def _tables(in_size: int, out_size: int, device: torch.device):
    lo, hi, w = linear_table(in_size, out_size, align_corners=True)
    return tuple(torch.from_numpy(a).to(device) for a in (lo, hi, w))


def patch_spans(lo: np.ndarray, hi: np.ndarray, tile: int) -> np.ndarray:
    """Source rows (or columns) of each tile of ``tile`` outputs:
    hi[last output of the tile] - lo[first] + 1 (the tables are monotone)."""
    starts = np.arange(0, len(lo), tile)
    ends = np.minimum(starts + tile, len(lo)) - 1
    return hi[ends] - lo[starts] + 1


def plan_layout(txt: int, ty: int, groups: int, kc: int, prows: int, pcols: int) -> dict:
    """The shared-memory layout of a plan, as make_plan in upsample_argmax.cu
    computes it: floats a patch row and between strip columns, bytes of the two
    patch buffers (the next pass's is staged while this one's computes) and the
    strip (every row of a tile)."""
    ppitch = -(-(pcols * kc + 3) // 4) * 4  # + 3: a run may start mid-vector
    cs = -(-kc // 4) * 4
    if cs % 8 == 0:  # a quarter-warp's 16-byte column reads in distinct banks
        cs += 4
    return dict(ppitch=ppitch, cs=cs, smem=4 * (2 * prows * ppitch + ty * groups * pcols * cs))


@functools.lru_cache(maxsize=64)
def upsample_plan(h: int, w: int, k: int, oh: int, ow: int) -> dict:
    """K2's plan for (B, h, w, K) -> (B, oh, ow): the widest, then tallest row
    group (txt threads across, 4 pixels each, by ty rows; txt * ty a multiple
    of 32 up to 256) with the most row groups a tile (GROUPS) whose two patches
    and strip fit the budget with all K classes; else one group and the most
    classes a pass that fit, a multiple of 4.  Returns txt, ty, groups, kc,
    passes, the largest patch (prows, pcols) and plan_layout's fields.  Raises
    ValueError, with the arithmetic, where no tile fits (a source row of some
    4,000 columns that one tile's 4 output columns span)."""
    if not 1 <= k <= 255:
        raise ValueError(f"upsample_argmax writes uint8 classes; got K={k}")
    rlo, rhi, _ = linear_table(h, oh, True)
    clo, chi, _ = linear_table(w, ow, True)

    def plan(txt, ty, groups, kc, prows, pcols):
        return dict(txt=txt, ty=ty, groups=groups, kc=kc, passes=-(-k // kc), prows=prows,
                    pcols=pcols, **plan_layout(txt, ty, groups, kc, prows, pcols))

    for txt in (32, 16, 8, 4, 2, 1):
        pcols = int(patch_spans(clo, chi, PIXELS * txt).max())
        ty = THREADS // txt
        while txt * ty >= 32:
            for groups in GROUPS:
                prows = int(patch_spans(rlo, rhi, ty * groups).max())
                if plan_layout(txt, ty, groups, k, prows, pcols)["smem"] <= SMEM_BUDGET:
                    return plan(txt, ty, groups, k, prows, pcols)
            fits = [kc for kc in range(k - 1, 0, -1)
                    if plan_layout(txt, ty, 1, kc, prows, pcols)["smem"] <= SMEM_BUDGET]
            if fits:
                return plan(txt, ty, 1, fits[0] if fits[0] < 4 else fits[0] // 4 * 4, prows,
                            pcols)
            ty //= 2
    lay = plan_layout(1, 32, 1, 1, prows, pcols)
    raise ValueError(f"upsample_argmax ({h},{w},{k})->({oh},{ow}): even one class over "
                     f"{prows} x {pcols} source taps needs {lay['smem']:,} B > "
                     f"{SMEM_BUDGET:,}")


def upsample_argmax(logits, out_hw):
    """argmax(resize_bilinear(logits fp32, out_hw, align_corners=True), -1).
    logits (B,h,w,K) -> (B,oh,ow) uint8."""
    if not use_kernel(logits):
        return upsample_argmax_reference(logits, out_hw)
    forward_only("upsample_argmax", logits)
    if logits.dim() != 4 or not logits.is_contiguous():
        raise ValueError("upsample_argmax takes contiguous (B,h,w,K) logits")
    b, h, w, k = logits.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    plan = upsample_plan(h, w, k, oh, ow)
    lf = logits.float()
    if lf.data_ptr() % 16:  # the patch is read in 16-byte vectors
        lf = lf.clone()
    dev = lf.device
    rlo, rhi, rw = _tables(h, oh, dev)
    clo, chi, cw = _tables(w, ow, dev)
    out = torch.empty((b, oh, ow), dtype=torch.uint8, device=dev)
    P = kernels.ptr
    err = kernels.library().segland_upsample_argmax(
        P(lf), P(rlo), P(rhi), P(rw), P(clo), P(chi), P(cw), P(out),
        b, h, w, k, oh, ow, plan["txt"], plan["ty"], plan["groups"], plan["kc"], plan["prows"],
        plan["pcols"],
        dev.index, kernels.stream_of(lf))
    kernels.check(err, "upsample_argmax")
    upsample_argmax.launches += 1
    return out


upsample_argmax.launches = 0
