"""The attention-section variants probe's kernel: a parameterised copy of the
v1 Swin attention section with its knobs and ablation modes.  Port of
benchmarks/swin_attn_variants.py's ``section`` (body ``_kernel``), which is
itself a copy of segland_tpu/ops/pallas_attn.py's v1 section body.

A CUDA tensor goes to ``kernels/csrc/attn_section_variants.cu`` (K11, bf16:
section_win.cuh's body, a kernel a mode) or ``kernels/csrc/attn_section_f32.cu``
(fp32), or raises; a CPU tensor, or
any tensor inside ``ops.plain_versions()``, goes to the plain version
:func:`section_reference`.  It follows the JAX body's order of arithmetic
(T is x's dtype, bf16 or fp32):

    m, r = mask_tok[w % rows], regions[w % rows]       shipped rows
    y    = T((LN(x) * gamma + beta) * m)                fp32 stats, fast variance
           (ln: y = x * T(m))
    qkv  = T(T(y @ wqkv) + T(bqkv))                     fp32 accumulate
    per head:
      s    = q' . k + T(bias) + (-100 between shift regions)   fp32
             q' = q * scale in fp32 (score_f32) or T(T(q) * T(scale))
      p    = T(exp(s - max s) / sum)                    normalised before PV
             (nomax: no max; bf16sm: e = exp(bf16(s - max)),
              p = T(bf16(e) / bf16(sum e)), the sum over the unrounded e and
              the quotient in fp32, as XLA runs the JAX body with excess
              precision allowed; softmax: p = T(0.001 s), no exp, no sum)
      ctx  = T(p @ v)                                   (attn: ctx = q)
      acc += ctx @ wproj[the head's rows]               fp32, head by head
             (proj1: one product over the assembled context)
    out  = x + (T(acc) + T(bproj))                      (io: out = x + y)

The JAX wrapper pads the 49 tokens to 64 (bf16) or 56 (fp32) with a -1e9
key bias and region id -1; the plain version pads the same way.  Only the
``softmax`` ablation sees the pad keys: their scores, scaled by 1e-3, enter
the product with v.
"""

import collections

import torch

from . import forward_only, use_kernel
from .fused_attn import _check_clocks, _mask_rows
from .hg_attn import (MAX_ACC_REGS, SMEM_MAX, _PAD_BIAS, _mm, _windows, check_f32_width,
                      launch_f32, win_args, win_layout)
from .. import kernels

_N = 49
_HEAD_DIM = 32
ABLATIONS = ("none", "ln", "io", "attn", "softmax", "nomax", "bf16sm", "proj1")

# ---- K11's builds ------------------------------------------------------------------
# One build a width, every mode: section_win.cuh's body at W windows a pass (a 64-row
# tile of y each) and S ring slots of one [96, 64] bf16 weight tile; two sets of a
# head's q, k, v tiles and one head's bias in shared memory.  attn_section_variants.cu
# instantiates exactly these (a test reads them from there).
SectionBuild = collections.namedtuple("SectionBuild", "w s")
SECTION_BUILDS = {96: SectionBuild(2, 6), 192: SectionBuild(2, 6), 384: SectionBuild(1, 6)}


def section_layout(c: int, b: SectionBuild) -> dict:
    """Shared memory of a K11 build by buffer in bytes, the fp32 accumulator
    registers a consumer thread of the products (``acc``) and of the per-head
    projection, held across the heads (``head_acc``): the arithmetic of VarPlan
    in attn_section_variants.cu (mode io's kernel has none of it: no product,
    no shared memory).  The per-head projection takes C / 96 pieces of
    [96, 32] a head; by windows (W >= 2) a warpgroup takes every piece, by
    columns (W = 1) half of them, or half of the one piece's columns at C = 96."""
    lay = win_layout(c, b.w, b.s, 2, 1)
    npieces = c // 96
    if b.w >= 2:
        npc, nbp = npieces, 96
    else:
        npc, nbp = (1, 48) if c == 96 else (npieces // 2, 96)
    return dict(lay, head_acc=(b.w // 2 if b.w >= 2 else 1) * npc * nbp // 2)


def _fmt(layout):
    parts = " + ".join(f"{k} {v:,}" for k, v in layout.items()
                       if k not in ("smem", "acc", "head_acc") and v)
    return f"{parts} = {layout['smem']:,} B"


def check_section_build(c: int, num_heads: int, dtype, wblk: int, ablate: str = "none"):
    """The launcher's host-side checks, on the CPU too: heads of 32,
    ``wblk >= 1``, a known mode, a build for (C, dtype).  Returns the
    SectionBuild (bf16) or None (fp32); raises ValueError with the reason (for
    a width with no build, the arithmetic of its leanest layout: one window a
    pass, two ring slots)."""
    if c != num_heads * _HEAD_DIM:
        raise ValueError(f"heads of {_HEAD_DIM} only: C={c} with {num_heads} heads")
    if wblk < 1:
        raise ValueError(f"wblk must be >= 1, got {wblk}")
    if ablate not in ABLATIONS:
        raise ValueError(f"ablate={ablate!r} is not one of {ABLATIONS}")
    if dtype == torch.float32:
        check_f32_width(c)
        return None
    if dtype != torch.bfloat16:
        raise ValueError(f"the section is built for bfloat16 and float32, not {dtype}")
    b = SECTION_BUILDS.get(c)
    if b is None:
        lean = section_layout(c, SectionBuild(1, 2)) if c % 96 == 0 else None
        why = []
        if lean is None:
            why.append("the projection walks 96 columns a slot")
        else:
            if lean["smem"] > SMEM_MAX:
                why.append(f"one window a pass needs {_fmt(lean)} > {SMEM_MAX:,}")
            if lean["head_acc"] > MAX_ACC_REGS:
                why.append(f"the per-head projection's fp32 accumulator [64, {c}] takes "
                           f"{lean['head_acc']} registers a thread > {MAX_ACC_REGS}")
            if not why:
                why.append(f"built at C in {tuple(SECTION_BUILDS)} only")
        raise ValueError(f"no bfloat16 build for C={c}: " + "; ".join(why))
    return b


# ---- the plain version ----------------------------------------------------------------
def _tokens(x_win, mask_tok, regions, bias, num_heads):
    """x [NW, n8, C], the pad mask [NW, n8] in T, the region ids [NW, n8] (or
    None) and the bias [nh, n8, n8] in T: the JAX wrapper's padding, with
    window w taking table row w % rows."""
    nw = x_win.shape[0]
    mult = 16 if x_win.dtype == torch.bfloat16 else 8
    n8 = -(-_N // mult) * mult
    pad = n8 - _N
    x = torch.nn.functional.pad(x_win, (0, 0, 0, pad))
    win = torch.arange(nw, device=x.device)
    m = torch.nn.functional.pad(mask_tok.to(x_win.dtype)[win % mask_tok.shape[0]], (0, pad))
    r = None
    if regions is not None:
        r = torch.nn.functional.pad(regions.float()[win % regions.shape[0]], (0, pad),
                                    value=-1.0)
    b = torch.nn.functional.pad(bias.reshape(num_heads, _N, _N).float(), (0, pad, 0, pad))
    b[..., _N:] += _PAD_BIAS
    return x, m, r, b.to(x_win.dtype), n8


def section_reference(x_win, mask_tok, regions, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                      num_heads: int, eps: float = 1e-5, score_f32: bool = True,
                      ablate: str = "none"):
    """Plain PyTorch version of ``section``: x_win [NW, 49, C], mask_tok
    [rows, 49] and regions [rows, 49] (or None), window w taking row w % rows;
    bias [1, nh, 49, 49].  ``ablate`` one of ABLATIONS (the module docstring
    says what each computes)."""
    if ablate not in ABLATIONS:
        raise ValueError(f"ablate={ablate!r} is not one of {ABLATIONS}")
    cdt = x_win.dtype
    x, m, rid, b, n = _tokens(x_win, mask_tok, regions, bias, num_heads)
    nw, _, c = x.shape
    hd = c // num_heads
    if ablate == "ln":
        y = x * m[..., None]
    else:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
        y = (xf - mu) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
        y = (y * m.float()[..., None]).to(cdt)
    if ablate == "io":
        return (x + y)[:, :_N]
    qkv = _mm(y, wqkv).to(cdt) + bqkv.to(cdt)
    pen = None
    if rid is not None:
        pen = torch.where(rid[:, :, None] != rid[:, None, :], -100.0, 0.0)
    bias_f = b.float()
    scale = hd ** -0.5
    acc = torch.zeros(nw, n, c, dtype=torch.float32, device=x.device)
    ctxs = []
    for h in range(num_heads):
        q = qkv[..., h * hd:(h + 1) * hd]
        k = qkv[..., c + h * hd:c + (h + 1) * hd]
        v = qkv[..., 2 * c + h * hd:2 * c + (h + 1) * hd]
        if ablate == "attn":
            ctx = q
        else:
            if score_f32:
                q, k = q.float(), k.float()
            s = (q * torch.tensor(scale, dtype=q.dtype)).float() @ k.float().transpose(-1, -2)
            s = s + bias_f[h]
            if pen is not None:
                s = s + pen
            if ablate == "softmax":
                p = s * 0.001
            elif ablate == "nomax":
                p = torch.exp(s)
                p = p / p.sum(-1, keepdim=True)
            elif ablate == "bf16sm":
                # as XLA runs the JAX body (excess precision allowed): the sum over
                # the unrounded exponentials, the quotient of the rounded ones in fp32
                e = torch.exp((s - s.amax(-1, keepdim=True)).to(torch.bfloat16).float())
                p = (e.to(torch.bfloat16).float()
                     / e.sum(-1, keepdim=True).to(torch.bfloat16).float())
            else:
                p = torch.exp(s - s.amax(-1, keepdim=True))
                p = p / p.sum(-1, keepdim=True)
            ctx = _mm(p.to(cdt), v).to(cdt)
        if ablate == "proj1":
            ctxs.append(ctx)
        else:
            acc = acc + _mm(ctx, wproj[h * hd:(h + 1) * hd])
    if ablate == "proj1":
        acc = _mm(torch.cat(ctxs, -1), wproj)
    return (x + (acc.to(cdt) + bproj.to(cdt)))[:, :_N]


# ---- the kernels ----------------------------------------------------------------------
def _launch(x_win, mask_tok, regions, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads,
            eps, wblk, score_f32, ablate, clocks=None):
    """K11 on bf16 windows (attn_section_variants.cu), or the fp32 body on fp32."""
    forward_only("section", x_win, gamma, beta, wqkv, bqkv, wproj, bproj, bias)
    nw, c, dev = _windows("section", x_win)
    check_section_build(c, num_heads, x_win.dtype, wblk, ablate)
    m = _mask_rows("mask_tok", mask_tok, nw, dev)
    r = None if regions is None else _mask_rows("regions", regions, nw, dev)
    if x_win.dtype == torch.float32:
        return launch_f32("section", x_win, m, r, (0,) * 6, gamma, beta, wqkv, bqkv, wproj,
                          bproj, bias, num_heads, eps, wblk, 1, ablate, norm_first=True)
    # mode io (out = x + y) reads no weight, so none is prepared for it
    args = win_args("section", x_win, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads,
                    weights=ablate != "io")
    out = torch.empty_like(x_win)
    P, lib = kernels.ptr, kernels.library()
    head = (P(x_win), P(m), m.shape[0], P(r), 0 if r is None else r.shape[0],
            *(P(a) for a in args), P(out), nw, c, num_heads, wblk, eps, ABLATIONS.index(ablate),
            int(bool(score_f32)))
    if clocks is None:
        err = lib.segland_section_variants(*head, dev.index, kernels.stream_of(x_win))
    else:
        err = lib.segland_section_variants_clocks(*head, P(clocks), dev.index,
                                                  kernels.stream_of(x_win))
    kernels.check(err, "section")
    return out


def section(x_win, mask_tok, regions, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
            num_heads: int, eps: float = 1e-5, wblk: int = 32, score_f32: bool = True,
            ablate: str = "none"):
    """The variants probe's section (K11 on a bf16 CUDA tensor, the fp32 body
    on an fp32 one): x_win [NW, 49, C], mask_tok [rows, 49], regions [rows,
    49] or None (window w takes row w % rows), bias [1, nh, 49, 49], weights
    [in, out] (read K-major in bf16).  A thread block owns ``wblk`` windows;
    ``score_f32`` takes the scores in fp32, else q * scale is rounded to T
    first; ``ablate`` one of ABLATIONS."""
    if not use_kernel(x_win):
        return section_reference(x_win, mask_tok, regions, gamma, beta, wqkv, bqkv, wproj,
                                 bproj, bias, num_heads, eps, score_f32, ablate)
    out = _launch(x_win, mask_tok, regions, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                  num_heads, eps, wblk, score_f32, ablate)
    section.launches += 1
    return out


section.launches = 0


def section_clocks(clocks, x_win, mask_tok, regions, gamma, beta, wqkv, bqkv, wproj, bproj,
                   bias, num_heads: int, eps: float = 1e-5, wblk: int = 32,
                   score_f32: bool = True):
    """A measurement, not the served kernel: K11's bf16 body in mode none built
    to add its consumers' clock64() time by phase (setup, ring wait, wgmma,
    q/k/v epilogue, attention core, context copy, output epilogue) and their
    count into ``clocks``, a CUDA int64 tensor of 8.  Takes section's
    arguments; not counted in ``section.launches``."""
    _check_clocks(clocks, x_win, 8)
    return _launch(x_win, mask_tok, regions, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                   num_heads, eps, wblk, score_f32, "none", clocks)
