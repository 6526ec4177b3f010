"""Head-grouped Swin attention sections: the two kernels of the head-group
probe.  Port of benchmarks/swin_attn_hg.py's ``hg_section`` (masks shipped in
as ``[rows, 49]`` tables) and ``hg2_section`` (masks from the window index,
plus timing ablations), with their names.

A CUDA tensor goes to ``kernels/csrc/attn_section_hg.cu`` (K9, K10) or
raises; a CPU tensor, or any tensor inside ``ops.plain_versions()``, goes to
the plain versions :func:`hg_section_reference` and
:func:`hg2_section_reference`.  Both follow the JAX bodies' order of
arithmetic (T is x's dtype, bf16 or fp32):

    y    = T((LN(x) * gamma + beta) * mask)               fp32 stats, fast variance
    qkv  = T(y @ wqkv) + T(bqkv)                          fp32 accumulate, bias in T
    per group of hg heads, per head:
      s    = q' . k + T(bias) + (-100 between shift regions)   fp32
             q' = q * scale in fp32 (score_f32) or T(T(q) * T(scale))
      p    = exp(s - max(s));  l = sum(p)                 fp32, not normalised
      ctx  = T((T(p) @ v) / l)
      acc += ctx @ wproj[the group's rows]                fp32, group by group
    out  = x + (T(acc) + T(bproj))

The JAX wrappers pad the 49 tokens to 64 (bf16) or 56 (fp32) with a -1e9 key
bias; the plain versions pad the same way.  Only the ``softmax`` ablation
sees the pad keys (their -1e9 scores scaled by 1e-3 enter the sums).

``hg`` on the TPU packs the K and V of hg heads block-diagonally to fill its
128 lanes; on Hopper the kernels take hg heads a pass: one
``[rows, C] x [C, 96 hg]`` product makes q, k, v of the group, the group's
attention tiles run together, and the scores stay per head.
"""

import collections

import numpy as np
import torch

from . import use_kernel
from .fused_attn import _check_geom, _check_rows, _mask_rows, _mat, _vec
from .. import kernels

_WINDOW = 7
_N = _WINDOW * _WINDOW
_HEAD_DIM = 32
_PAD_BIAS = -1e9  # the key bias of a pad token
ABLATIONS = ("none", "ioraw", "io", "attn", "softmax")
# what the TPU probe's other ablation measured, and why the port has none
NO_BUILD = {"build": "no block-diagonal V is ever built on this card (hg heads a pass "
                     "keep per-head scores), so there is nothing to skip"}

# ---- the kernels' builds --------------------------------------------------------
# One build a (C, hg): W windows a pass through shared memory, PP warps sharing a row
# tile's columns in the qkv product, weight chunks of KC rows in a ring of S, the
# group's [hg, 49, 49] bias and the context in shared memory or read from L2 / kept
# in the output buffer.  attn_section_hg.cu instantiates exactly these (a test reads
# them from there).
HgBuild = collections.namedtuple("HgBuild", "w pp kc s bias_smem ctx_smem")
HG_BUILDS = {
    (96, 1): HgBuild(4, 2, 48, 3, True, True),
    (96, 3): HgBuild(1, 2, 48, 3, True, True),
    (192, 1): HgBuild(4, 2, 48, 3, True, False),
    (192, 2): HgBuild(2, 4, 16, 4, True, True),
    (192, 3): HgBuild(1, 2, 48, 3, True, True),
    (192, 6): HgBuild(1, 4, 16, 3, False, False),
    (384, 1): HgBuild(3, 2, 32, 3, True, False),
    (384, 2): HgBuild(2, 4, 16, 4, True, False),
    (384, 3): HgBuild(1, 2, 16, 4, True, True),
    (384, 4): HgBuild(1, 8, 16, 4, True, False),
    (768, 1): HgBuild(1, 2, 32, 3, True, True),
    (768, 2): HgBuild(1, 4, 48, 3, True, False),
    (768, 3): HgBuild(1, 2, 16, 4, True, False),
    (768, 4): HgBuild(1, 8, 16, 3, False, False),
}
# the JAX package's production head-group table (segland_tpu/ops/pallas_attn.py:_V2_HG)
V2_HG = {3: 3, 6: 6, 12: 4, 24: 4}
SMEM_MAX = 232448  # shared memory a block can have on sm_90
MAX_FRAGS = 18     # 16x16 fp32 accumulator tiles a warp (8 registers each)
_LQ, _LS, _WARPS = 48, 68, 8


def _al(n):
    return (n + 127) // 128 * 128


def hg_layout(c: int, hg: int, b: HgBuild) -> dict:
    """Shared memory of a build, by buffer in bytes, and its accumulator
    tiles a warp in the qkv product: the arithmetic of HgCfg in
    attn_section_hg.cu."""
    rows = b.w * _N
    rt = (rows + 15) // 16
    rq = (rows + 30) // 16 * 16  # the last window's row tiles reach 15 rows past it
    y = _al(rows * (c + 8) * 2)
    parts = dict(y=y, ctx=y if b.ctx_smem else 0, qkv=3 * hg * _al(rq * _LQ * 2),
                 strips=_WARPS * 16 * _LS * 4, ring=b.s * _al(b.kc * (96 * hg + 8) * 2),
                 bias=_al(hg * _N * _N * 2) if b.bias_smem else 0, tokens=2 * _al(rows * 4))
    frags = -(-rt * b.pp // _WARPS) * (6 * hg // b.pp)
    return dict(parts, smem=sum(parts.values()), frags=frags)


def _fmt(layout):
    parts = " + ".join(f"{k} {v:,}" for k, v in layout.items() if k not in ("smem", "frags") and v)
    return f"{parts} = {layout['smem']:,} B"


def check_hg_build(c: int, num_heads: int, hg: int, dtype, wblk: int, ablate: str = "none"):
    """The launchers' host-side checks, on the CPU too: heads of 32, ``hg``
    dividing ``num_heads``, a build for (C, hg), ``wblk >= 1``, bf16, a known
    ablation.  Returns the HgBuild; raises ValueError with the reason (for a
    pair with no build, the shared-memory and register arithmetic of its
    leanest layout)."""
    if c != num_heads * _HEAD_DIM:
        raise ValueError(f"heads of {_HEAD_DIM} only: C={c} with {num_heads} heads")
    if hg < 1 or num_heads % hg:
        raise ValueError(f"hg={hg} does not divide num_heads={num_heads}")
    if wblk < 1:
        raise ValueError(f"wblk must be >= 1, got {wblk}")
    check_ablate(ablate)
    if dtype != torch.bfloat16:
        raise ValueError(f"the head-grouped kernels are built for bfloat16 only, not {dtype} "
                         "(fp32 runs on the CPU through the plain versions)")
    b = HG_BUILDS.get((c, hg))
    if b is None:
        lean = hg_layout(c, hg, HgBuild(1, 8 if 6 * hg % 8 == 0 else 2, 16, 3, False, False))
        why = []
        if lean["smem"] > SMEM_MAX:
            why.append(f"one window a pass with the bias and the context out of shared "
                       f"memory needs {_fmt(lean)} > {SMEM_MAX:,}")
        if lean["frags"] > MAX_FRAGS:
            why.append(f"the [64, C] x [C, {96 * hg}] product needs {lean['frags']} 16x16 fp32 "
                       f"accumulator tiles a warp ({8 * lean['frags']} registers a thread) > "
                       f"{MAX_FRAGS}")
        raise ValueError(f"no build for C={c} hg={hg}: " + "; ".join(why))
    return b


# ---- plain versions -------------------------------------------------------------
def _mm(a, b):
    """a @ b over values of a's dtype, accumulated and returned in fp32."""
    return a.float() @ b.to(a.dtype).float()


def _hg_core(x, valid, rid, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads, eps, hg,
             score_f32, ablate, sums=None):
    """The JAX body over token-padded windows x [NW, n8, C]; valid [NW, n8]
    (0 on pad tokens), rid [NW, n8] or None, bias [nh, n8, n8] fp32 with the
    pad keys at -1e9.  ``sums``: a list that gets the per-head sums
    [NW, n8, hg] of each group."""
    check_ablate(ablate)
    if num_heads % hg:
        raise ValueError(f"hg={hg} does not divide num_heads={num_heads}")
    cdt = x.dtype
    if ablate == "ioraw":
        return x + x
    nw, n, c = x.shape
    hd = c // num_heads
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    y = (xf - mu) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    y = (y * valid[..., None]).to(cdt)
    if ablate == "io":
        return x + y
    qkv = _mm(y, wqkv).to(cdt) + bqkv.to(cdt)
    sdt = torch.float32 if score_f32 else cdt
    scale = torch.tensor(hd ** -0.5, dtype=sdt)
    bias_c = bias.to(cdt).float()
    pen = None
    if rid is not None:
        pen = torch.where(rid[:, :, None] != rid[:, None, :], -100.0, 0.0)[:, None]
    heads = lambda t: t.reshape(nw, n, -1, hd).transpose(1, 2)  # [NW, heads, n, hd]
    acc = torch.zeros(nw, n, c, dtype=torch.float32, device=x.device)
    for g0 in range(0, num_heads, hg):
        cols = slice(g0 * hd, (g0 + hg) * hd)
        q = qkv[..., cols].to(sdt) * scale
        if ablate == "attn":
            ctx = q.to(cdt)
        else:
            k = qkv[..., c:][..., cols].to(sdt)
            v = qkv[..., 2 * c:][..., cols]
            s = heads(q).float() @ heads(k).float().transpose(-1, -2) + bias_c[g0:g0 + hg]
            if pen is not None:
                s = s + pen
            p = s * 0.001 if ablate == "softmax" else torch.exp(s - s.amax(-1, keepdim=True))
            l = p.sum(-1, keepdim=True)
            if sums is not None:
                sums.append(l[..., 0].transpose(1, 2))
            ctx = ((p.to(cdt).float() @ heads(v).float()) / l).to(cdt)
            ctx = ctx.transpose(1, 2).reshape(nw, n, hg * hd)
        acc = acc + _mm(ctx, wproj[g0 * hd:(g0 + hg) * hd])
    return x + (acc.to(cdt) + bproj.to(cdt))


def _padded(x_win, bias, num_heads):
    """x [NW, 49, C] and bias [1, nh, 49, 49] padded to n8 tokens (a multiple
    of 16 in bf16, of 8 otherwise), as the JAX wrappers pad them: zero tokens,
    a -1e9 key bias on the pad keys."""
    m = 16 if x_win.dtype == torch.bfloat16 else 8
    n8 = -(-_N // m) * m
    x = torch.nn.functional.pad(x_win, (0, 0, 0, n8 - _N))
    b = torch.nn.functional.pad(bias.reshape(num_heads, _N, _N).float(),
                                (0, n8 - _N, 0, n8 - _N))
    b[..., _N:] += _PAD_BIAS
    return x, b, n8


def check_ablate(ablate):
    """Raise ValueError unless ``ablate`` is one of ABLATIONS, with the reason
    for the TPU probe's ablation that has no build here."""
    if ablate in NO_BUILD:
        raise ValueError(f"ablate={ablate!r}: {NO_BUILD[ablate]}")
    if ablate not in ABLATIONS:
        raise ValueError(f"ablate={ablate!r} is not one of {ABLATIONS}")


def hg_section_reference(x_win, mask_tok, regions, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                         num_heads: int, eps: float = 1e-5, hg: int = 1, score_f32: bool = True):
    """Plain PyTorch version of ``hg_section``: mask_tok [rows, 49] and regions
    [rows, 49] (or None), window w taking row ``w % rows``; bias [1, nh, 49, 49]."""
    nw = x_win.shape[0]
    x, b, n8 = _padded(x_win, bias, num_heads)
    win = torch.arange(nw, device=x.device)
    valid = mask_tok.to(x_win.dtype).float()[win % mask_tok.shape[0]]
    valid = torch.nn.functional.pad(valid, (0, n8 - _N))
    rid = None
    if regions is not None:
        rid = torch.nn.functional.pad(regions.float()[win % regions.shape[0]], (0, n8 - _N),
                                      value=-1.0)
    out = _hg_core(x, valid, rid, gamma, beta, wqkv, bqkv, wproj, bproj, b, num_heads, eps, hg,
                   score_f32, "none")
    return out[:, :_N]


def window_tables(n_windows: int, n_tokens: int, geom):
    """Valid flag and region id [n_windows, n_tokens] of every (window, token)
    from the window index, tokens past 49 included (they are pad tokens): the
    iota arithmetic of the JAX hg2 body, on the host."""
    h, w, hp, wp, ws, shift = geom
    win = np.arange(n_windows)[:, None]
    tok = np.arange(n_tokens)[None, :]
    wn = wp // ws
    grh = ((win // wn) % (hp // ws)) * ws + tok // ws  # rolled coordinates
    gwc = (win % wn) * ws + tok % ws
    oh = grh + shift
    oh = np.where(oh >= hp, oh - hp, oh)
    ow = gwc + shift
    ow = np.where(ow >= wp, ow - wp, ow)
    valid = ((tok < ws * ws) & (oh < h) & (ow < w)).astype(np.float32)
    rh = (grh >= hp - ws).astype(np.int64) + (grh >= hp - shift)
    rc = (gwc >= wp - ws).astype(np.int64) + (gwc >= wp - shift)
    return valid, (3 * rh + rc).astype(np.float32)


def hg2_section_reference(x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                          num_heads: int, eps: float = 1e-5, hg: int = 1,
                          score_f32: bool = True, ablate: str = "none", sums=None):
    """Plain PyTorch version of ``hg2_section``: geom = (h, w, hp, wp, ws, shift)
    gives the pad mask and, with a shift, the region ids.  ``ablate``: ioraw
    (x + x), io (x + y), attn (ctx = T(q * scale)), softmax (p = 0.001 s, no
    max, no exp) or none.  ``sums``: a list that gets the per-head softmax
    sums [NW, 49, nh]."""
    geom = tuple(int(v) for v in geom)
    x, b, n8 = _padded(x_win, bias, num_heads)
    valid, rid = window_tables(x_win.shape[0], n8, geom)
    dev = x.device
    parts = None if sums is None else []
    out = _hg_core(x, torch.from_numpy(valid).to(dev),
                   torch.from_numpy(rid).to(dev) if geom[5] > 0 else None, gamma, beta, wqkv,
                   bqkv, wproj, bproj, b, num_heads, eps, hg, score_f32, ablate, parts)
    if sums is not None:
        sums.append(torch.cat(parts, -1)[:, :_N])
    return out[:, :_N]


# ---- the kernels ------------------------------------------------------------------
def _launch(entry, x_win, mask, regions, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
            num_heads, eps, wblk, hg, score_f32, ablate):
    _check_rows(entry, x_win)
    nw, n, c = x_win.shape
    if n != _N:
        raise ValueError(f"{entry} takes 7x7 windows, got N={n}")
    check_hg_build(c, num_heads, hg, x_win.dtype, wblk, ablate)
    dev = x_win.device
    b = bias.float().to(torch.bfloat16).contiguous()  # rounded to T, as the JAX wrapper does
    if b.device != dev or tuple(b.shape) != (1, num_heads, _N, _N):
        raise ValueError(f"bias {tuple(bias.shape)} on {bias.device}; want "
                         f"[1, {num_heads}, 49, 49] on {dev}")
    args = (_vec(gamma, c, dev), _vec(beta, c, dev), _mat(entry, wqkv, (c, 3 * c), x_win),
            _vec(bqkv, 3 * c, dev), _mat(entry, wproj, (c, c), x_win), _vec(bproj, c, dev), b)
    out = torch.empty_like(x_win)
    P = kernels.ptr
    fn = getattr(kernels.library(), f"segland_{entry}")
    rows = lambda t: 0 if t is None else t.shape[0]
    err = fn(P(x_win), P(mask), rows(mask), P(regions), rows(regions), *(P(a) for a in args),
             P(out), nw, c, num_heads, hg, wblk, *geom, eps,
             ABLATIONS.index(ablate), int(bool(score_f32)), dev.index, kernels.stream_of(x_win))
    kernels.check(err, entry)
    return out


def hg_section(x_win, mask_tok, regions, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
               num_heads: int, eps: float = 1e-5, wblk: int = 32, hg: int = 1,
               score_f32: bool = True):
    """The head-grouped section with shipped masks (K9 on a CUDA tensor):
    x_win [NW, 49, C], mask_tok [rows, 49], regions [rows, 49] or None (window
    w takes row w % rows), bias [1, nh, 49, 49].  A thread block owns ``wblk``
    windows; ``hg`` heads a pass."""
    if not use_kernel(x_win):
        return hg_section_reference(x_win, mask_tok, regions, gamma, beta, wqkv, bqkv, wproj,
                                    bproj, bias, num_heads, eps, hg, score_f32)
    nw, dev = x_win.shape[0], x_win.device
    m = _mask_rows("mask_tok", mask_tok, nw, dev)
    r = None if regions is None else _mask_rows("regions", regions, nw, dev)
    out = _launch("hg_section", x_win, m, r, (0,) * 6, gamma, beta, wqkv, bqkv, wproj, bproj,
                  bias, num_heads, eps, wblk, hg, score_f32, "none")
    hg_section.launches += 1
    return out


hg_section.launches = 0


def hg2_section(x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads: int,
                eps: float = 1e-5, wblk: int = 32, hg: int = 1, score_f32: bool = True,
                ablate: str = "none"):
    """The head-grouped section with masks from the window index (K10 on a
    CUDA tensor): geom = (h, w, hp, wp, ws, shift), bias [1, nh, 49, 49],
    ``ablate`` one of ABLATIONS (timing builds with the outputs of
    :func:`hg2_section_reference`)."""
    if not use_kernel(x_win):
        return hg2_section_reference(x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                                     num_heads, eps, hg, score_f32, ablate)
    g = _check_geom(geom, x_win.shape[0])
    out = _launch("hg2_section", x_win, None, None, g, gamma, beta, wqkv, bqkv, wproj, bproj,
                  bias, num_heads, eps, wblk, hg, score_f32, ablate)
    hg2_section.launches += 1
    return out


hg2_section.launches = 0
