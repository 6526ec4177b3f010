"""Head-grouped Swin attention sections: the two kernels of the head-group
probe.  Port of benchmarks/swin_attn_hg.py's ``hg_section`` (masks shipped in
as ``[rows, 49]`` tables) and ``hg2_section`` (masks from the window index,
plus timing ablations), with their names.

A CUDA tensor goes to ``kernels/csrc/attn_section_hg_sm90.cu`` (K9, bf16),
``kernels/csrc/attn_section_hg2_sm90.cu`` (K10, bf16; both on the body of
``kernels/csrc/section_hg.cuh``) or ``kernels/csrc/attn_section_f32.cu``
(fp32), or raises; a CPU tensor, or
any tensor inside ``ops.plain_versions()``, goes to the plain versions
:func:`hg_section_reference` and :func:`hg2_section_reference`.  Both follow
the JAX bodies' order of arithmetic (T is x's dtype, bf16 or fp32):

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
128 lanes; on Hopper the kernels take hg heads a pass and keep the scores per
head: hg ``wgmma`` products back to back make q, k, v of the group, and the
group's attention tiles run together.
"""

import collections

import numpy as np
import torch

from . import use_kernel
from .fused_attn import (_check_clocks, _check_geom, _check_rows, _kmat, _mask_rows, _mat,
                         _vec)
from .. import kernels

_WINDOW = 7
_N = _WINDOW * _WINDOW
_HEAD_DIM = 32
_PAD_BIAS = -1e9  # the key bias of a pad token
ABLATIONS = ("none", "ioraw", "io", "attn", "softmax")
# what the TPU probe's other ablation measured, and why the port has none
NO_BUILD = {"build": "no block-diagonal V is ever built on this card (hg heads a pass "
                     "keep per-head scores), so there is nothing to skip"}

# the JAX package's production head-group table (segland_tpu/ops/pallas_attn.py:_V2_HG)
V2_HG = {3: 3, 6: 6, 12: 4, 24: 4}
SMEM_MAX = 232448  # shared memory a block can have on sm_90


def _al(n):
    return (n + 127) // 128 * 128


def _fmt(layout):
    parts = " + ".join(f"{k} {v:,}" for k, v in layout.items()
                       if k not in ("smem", "acc") and v)
    return f"{parts} = {layout['smem']:,} B"


# ---- K9's and K10's builds ----------------------------------------------------------
# One build a (C, hg) of section_hg.cuh's body: W windows a pass (1, 2 or 4, a
# 64-row tile of y each, rows 49-63 padding), S ring slots of one [96, 64] bf16
# weight tile; hg sets of a head's q, k, v tiles [64 W, 32] and hg heads' bias
# [49, 56] bf16 in shared memory.  attn_section_hg_sm90.cu instantiates exactly
# these (a test reads them from there).
HgSm90Build = collections.namedtuple("HgSm90Build", "w s")
HG_SM90_BUILDS = {
    (96, 1): HgSm90Build(4, 6), (96, 3): HgSm90Build(2, 6),
    (192, 1): HgSm90Build(2, 6), (192, 2): HgSm90Build(2, 6), (192, 6): HgSm90Build(1, 6),
    (384, 1): HgSm90Build(2, 6), (384, 2): HgSm90Build(2, 5), (384, 4): HgSm90Build(1, 6),
    (768, 1): HgSm90Build(1, 6), (768, 4): HgSm90Build(1, 4),
}
# K10's builds, on the same body: every (C, hg) of HG2_BUILDS in mode none; the modes io,
# attn and softmax (and the measurement build) at the pairs of HG2_MODE_BUILDS, hg = 1
# and the JAX package's default hg at each swin-s width.  attn_section_hg2_sm90.cu
# instantiates exactly these (a test reads them from there).
HG2_BUILDS = {
    (96, 1): HgSm90Build(4, 6), (96, 3): HgSm90Build(2, 6),
    (192, 1): HgSm90Build(2, 6), (192, 2): HgSm90Build(2, 6), (192, 3): HgSm90Build(2, 6),
    (192, 6): HgSm90Build(1, 6),
    (384, 1): HgSm90Build(2, 6), (384, 2): HgSm90Build(2, 5), (384, 3): HgSm90Build(1, 6),
    (384, 4): HgSm90Build(1, 6),
    (768, 1): HgSm90Build(1, 6), (768, 2): HgSm90Build(1, 6), (768, 3): HgSm90Build(1, 6),
    (768, 4): HgSm90Build(1, 4),
}
HG2_MODE_BUILDS = frozenset({(96, 1), (96, 3), (192, 1), (192, 6), (384, 1), (384, 4),
                             (768, 1), (768, 4)})
MAX_ACC_REGS = 96  # fp32 accumulator registers a thread of an 8-warp block (ptxas: <= 255)
_SLOT, _TILE_Q, _BIAS_HEAD = 96 * 128, 64 * 64, 49 * 56 * 2  # bytes: ring slot, q tile, bias


def win_layout(c: int, w: int, s: int, nq: int, nbias: int) -> dict:
    """Shared memory of section_win.cuh's WinPlan<C, W, S, NQ, NBIAS> by buffer in
    bytes, and the fp32 accumulator registers a consumer thread of its products
    (``acc``: m64 row tiles of 64 W rows, by rows over the two warpgroups from two
    tiles on, at 96 columns a wgmma, else by columns at 48)."""
    rows = 64 * w
    parts = dict(ring=s * _SLOT, y=-(-c // 64) * rows * 128, qkv=nq * 3 * w * _TILE_Q,
                 bias=_al(nbias * _BIAS_HEAD), tokens=rows * 4, barriers=2 * s * 8, align=1024)
    return dict(parts, smem=sum(parts.values()), acc=(w // 2) * 48 if w >= 2 else 24)


def hg_sm90_layout(c: int, hg: int, b: HgSm90Build) -> dict:
    """K9's build (C, hg): the arithmetic of HgPlan in attn_section_hg_sm90.cu."""
    return win_layout(c, b.w, b.s, hg, hg)


# ---- the fp32 body of K9, K10 and K11 -----------------------------------------------
# attn_section_f32.cu: exact FMA loops, one window a pass, its fp32 rows y [49, C], q, k, v
# [56, 33] (the 7 pad tokens of the JAX wrappers' fp32 layout included), scores [49, 57],
# 7 rows of context for the projection [7, C] and the token tables in shared memory.
F32_WIDTHS = (96, 192, 384, 768)


def f32_layout(c: int) -> dict:
    """Shared memory of the fp32 body at width C, by buffer in bytes: the
    arithmetic of f32_smem_floats in attn_section_f32.cu."""
    parts = dict(y=49 * c * 4, qkv=3 * 56 * 33 * 4, scores=49 * 57 * 4, rows=7 * c * 4,
                 tokens=2 * 56 * 4)
    return dict(parts, smem=sum(parts.values()))


def check_f32_width(c: int):
    """Raise ValueError unless the fp32 body is built at width C, with the
    arithmetic of a width that does not fit."""
    if c in F32_WIDTHS:
        return
    lay = f32_layout(c)
    parts = " + ".join(f"{k} {v:,}" for k, v in lay.items() if k != "smem")
    why = (f"one window needs {parts} = {lay['smem']:,} B > {SMEM_MAX:,}"
           if lay["smem"] > SMEM_MAX else f"built at C in {F32_WIDTHS} only")
    raise ValueError(f"no float32 build for C={c}: {why}")


# the fp32 body's modes; ``norm_first`` picks K11's order (normalise before PV, the
# softmax ablation undivided) over the head-grouped kernels' (divide after PV)
_F32_MODES = {"none": 0, "ioraw": 1, "io": 2, "ln": 3, "attn": 4, "attn_scaled": 5,
              "softmax": 6, "nomax": 7, "bf16sm": 8, "proj1": 0}


def launch_f32(entry, x_win, mask, regions, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
               num_heads, eps, wblk, hg, ablate, norm_first):
    """Launch the fp32 body on fp32 CUDA windows (checks done by the caller):
    mask and regions [rows, 49] fp32 tables (K9, K11) or None with geom (K10).
    The projection sums the heads of a group (hg), of a head (K11) or all of
    them (K11's proj1) before adding to the accumulator, as the JAX bodies do."""
    nw, _, c = x_win.shape
    dev = x_win.device
    b = bias.float().contiguous()
    if b.device != dev or tuple(b.shape) != (1, num_heads, _N, _N):
        raise ValueError(f"bias {tuple(bias.shape)} on {bias.device}; want "
                         f"[1, {num_heads}, 49, 49] on {dev}")
    mode = "attn_scaled" if ablate == "attn" and not norm_first else ablate
    group = c if ablate == "proj1" else hg * _HEAD_DIM
    args = (_vec(gamma, c, dev), _vec(beta, c, dev), _mat(entry, wqkv, (c, 3 * c), x_win),
            _vec(bqkv, 3 * c, dev), _mat(entry, wproj, (c, c), x_win), _vec(bproj, c, dev), b)
    out = torch.empty_like(x_win)
    P = kernels.ptr
    rows = lambda t: 0 if t is None else t.shape[0]
    err = kernels.library().segland_section_f32(
        P(x_win), P(mask), rows(mask), P(regions), rows(regions), *(P(a) for a in args), P(out),
        nw, c, num_heads, wblk, *geom, eps, _F32_MODES[mode], int(bool(norm_first)), group,
        dev.index, kernels.stream_of(x_win))
    kernels.check(err, f"{entry} (float32)")
    return out


def _check_hg_args(c, num_heads, hg, dtype, wblk):
    if c != num_heads * _HEAD_DIM:
        raise ValueError(f"heads of {_HEAD_DIM} only: C={c} with {num_heads} heads")
    if hg < 1 or num_heads % hg:
        raise ValueError(f"hg={hg} does not divide num_heads={num_heads}")
    if wblk < 1:
        raise ValueError(f"wblk must be >= 1, got {wblk}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the head-grouped kernels are built for bfloat16 and float32, "
                         f"not {dtype}")


def _no_build(entry, c, hg, builds):
    """ValueError for a pair with no build of section_win.cuh's body, with the
    shared-memory and register arithmetic of its leanest layout: one window a
    pass, two ring slots."""
    lean = hg_sm90_layout(c, hg, HgSm90Build(1, 2))
    fits = lean["smem"] <= SMEM_MAX and lean["acc"] <= MAX_ACC_REGS
    return ValueError(
        f"{entry} has no build for C={c} hg={hg}: one window a pass needs {_fmt(lean)} "
        f"({'<=' if lean['smem'] <= SMEM_MAX else '>'} {SMEM_MAX:,}) and {lean['acc']} "
        f"accumulator registers a thread (of {MAX_ACC_REGS})"
        + (f"; built at (C, hg) in {sorted(builds)} only" if fits else ""))


def check_hg_sm90_build(c: int, num_heads: int, hg: int, dtype, wblk: int):
    """K9's host-side checks, on the CPU too: heads of 32, ``hg`` dividing
    ``num_heads``, ``wblk >= 1``, a build for (C, hg) in bf16 or for C in fp32.
    Returns the HgSm90Build (bf16) or None (fp32); raises ValueError with the
    reason (for a pair with no build, the shared-memory and register arithmetic
    of its leanest layout: one window a pass, two ring slots)."""
    _check_hg_args(c, num_heads, hg, dtype, wblk)
    if dtype == torch.float32:
        check_f32_width(c)
        return None
    b = HG_SM90_BUILDS.get((c, hg))
    if b is None:
        raise _no_build("hg_section", c, hg, HG_SM90_BUILDS)
    return b


def check_hg_build(c: int, num_heads: int, hg: int, dtype, wblk: int, ablate: str = "none"):
    """K10's host-side checks, on the CPU too: heads of 32, ``hg`` dividing
    ``num_heads``, ``wblk >= 1``, a known ablation, a build for (C, hg) in bf16
    (for io, attn and softmax one of HG2_MODE_BUILDS) or for C in fp32.
    Returns the HgSm90Build (bf16) or None (fp32); raises ValueError with the
    reason (for a pair with no build, the shared-memory and register arithmetic
    of its leanest layout)."""
    _check_hg_args(c, num_heads, hg, dtype, wblk)
    check_ablate(ablate)
    if dtype == torch.float32:
        check_f32_width(c)
        return None
    b = HG2_BUILDS.get((c, hg))
    if b is None:
        raise _no_build("hg2_section", c, hg, HG2_BUILDS)
    if ablate not in ("none", "ioraw") and (c, hg) not in HG2_MODE_BUILDS:
        raise ValueError(f"hg2_section builds ablate={ablate!r} at (C, hg) in "
                         f"{sorted(HG2_MODE_BUILDS)} only (hg = 1 and the default hg), "
                         f"not C={c} hg={hg}")
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
def _windows(entry, x_win):
    _check_rows(entry, x_win)
    if x_win.shape[1] != _N:
        raise ValueError(f"{entry} takes 7x7 windows, got N={x_win.shape[1]}")
    return x_win.shape[0], x_win.shape[2], x_win.device


def _bias_bf16(bias, num_heads, dev):
    """The bias [1, nh, 49, 49] rounded to T, as the JAX wrappers do."""
    b = bias.float().to(torch.bfloat16)
    if b.device != dev or tuple(b.shape) != (1, num_heads, _N, _N):
        raise ValueError(f"bias {tuple(bias.shape)} on {bias.device}; want "
                         f"[1, {num_heads}, 49, 49] on {dev}")
    return b


def win_args(entry, x_win, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads,
             weights=True):
    """The arguments of section_win.cuh's kernels (K9, K11) after the tables: the
    vectors in fp32; the weights K-major in bf16 (nn.Linear's ``weight.T`` passes
    without a copy), or as they come for a kernel that reads none
    (``weights=False``); the bias in bf16 with its 49 columns padded to 56."""
    c, dev = x_win.shape[2], x_win.device
    for w, shape in ((wqkv, (c, 3 * c)), (wproj, (c, c))):
        if w.device != dev or tuple(w.shape) != shape:
            raise ValueError(f"weight {tuple(w.shape)} on {w.device}; want {shape} on {dev}")
    if weights:
        wqkv = _kmat(entry, wqkv, (c, 3 * c), x_win)
        wproj = _kmat(entry, wproj, (c, c), x_win)
    b = torch.nn.functional.pad(_bias_bf16(bias, num_heads, dev)[0], (0, 56 - _N)).contiguous()
    return (_vec(gamma, c, dev), _vec(beta, c, dev), wqkv, _vec(bqkv, 3 * c, dev), wproj,
            _vec(bproj, c, dev), b)


def _launch_hg2(x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads, eps, wblk,
                hg, score_f32, ablate, clocks=None):
    """K10 on bf16 windows (attn_section_hg2_sm90.cu), or the fp32 body on fp32."""
    nw, c, dev = _windows("hg2_section", x_win)
    check_hg_build(c, num_heads, hg, x_win.dtype, wblk, ablate)
    if x_win.dtype == torch.float32:
        return launch_f32("hg2_section", x_win, None, None, geom, gamma, beta, wqkv, bqkv, wproj,
                          bproj, bias, num_heads, eps, wblk, hg, ablate, norm_first=False)
    args = win_args("hg2_section", x_win, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                    num_heads, weights=ablate != "ioraw")
    out = torch.empty_like(x_win)
    P, lib = kernels.ptr, kernels.library()
    head = (P(x_win), *(P(a) for a in args), P(out), nw, c, num_heads, hg, wblk, *geom, eps,
            ABLATIONS.index(ablate), int(bool(score_f32)))
    if clocks is None:
        err = lib.segland_hg2_section(*head, dev.index, kernels.stream_of(x_win))
    else:
        err = lib.segland_hg2_section_clocks(*head, P(clocks), dev.index,
                                             kernels.stream_of(x_win))
    kernels.check(err, "hg2_section")
    return out


def _launch_hg(x_win, mask_tok, regions, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads,
               eps, wblk, hg, score_f32, clocks=None):
    """K9 on bf16 windows (attn_section_hg_sm90.cu), or the fp32 body on fp32."""
    nw, c, dev = _windows("hg_section", x_win)
    check_hg_sm90_build(c, num_heads, hg, x_win.dtype, wblk)
    m = _mask_rows("mask_tok", mask_tok, nw, dev)
    r = None if regions is None else _mask_rows("regions", regions, nw, dev)
    if x_win.dtype == torch.float32:
        return launch_f32("hg_section", x_win, m, r, (0,) * 6, gamma, beta, wqkv, bqkv, wproj,
                          bproj, bias, num_heads, eps, wblk, hg, "none", norm_first=False)
    args = win_args("hg_section", x_win, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads)
    out = torch.empty_like(x_win)
    P, lib = kernels.ptr, kernels.library()
    head = (P(x_win), P(m), m.shape[0], P(r), 0 if r is None else r.shape[0],
            *(P(a) for a in args), P(out), nw, c, num_heads, hg, wblk, eps, int(bool(score_f32)))
    if clocks is None:
        err = lib.segland_hg_section(*head, dev.index, kernels.stream_of(x_win))
    else:
        err = lib.segland_hg_section_clocks(*head, P(clocks), dev.index, kernels.stream_of(x_win))
    kernels.check(err, "hg_section")
    return out


def hg_section(x_win, mask_tok, regions, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
               num_heads: int, eps: float = 1e-5, wblk: int = 32, hg: int = 1,
               score_f32: bool = True):
    """The head-grouped section with shipped masks (K9 on a CUDA tensor):
    x_win [NW, 49, C], mask_tok [rows, 49], regions [rows, 49] or None (window
    w takes row w % rows), bias [1, nh, 49, 49], weights [in, out] (read K-major
    in bf16).  A thread block owns ``wblk`` windows; ``hg`` heads a pass."""
    if not use_kernel(x_win):
        return hg_section_reference(x_win, mask_tok, regions, gamma, beta, wqkv, bqkv, wproj,
                                    bproj, bias, num_heads, eps, hg, score_f32)
    out = _launch_hg(x_win, mask_tok, regions, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                     num_heads, eps, wblk, hg, score_f32)
    hg_section.launches += 1
    return out


def hg_section_clocks(clocks, x_win, mask_tok, regions, gamma, beta, wqkv, bqkv, wproj, bproj,
                      bias, num_heads: int, eps: float = 1e-5, wblk: int = 32, hg: int = 1,
                      score_f32: bool = True):
    """A measurement, not the served kernel: K9's bf16 body built to add its
    consumers' clock64() time by phase (setup, ring wait, wgmma, q/k/v
    epilogue, attention core, context copy, output epilogue) and their count
    into ``clocks``, a CUDA int64 tensor of 8.  Takes hg_section's arguments;
    not counted in ``hg_section.launches``."""
    _check_clocks(clocks, x_win, 8)
    return _launch_hg(x_win, mask_tok, regions, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                      num_heads, eps, wblk, hg, score_f32, clocks)


hg_section.launches = 0


def hg2_section(x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads: int,
                eps: float = 1e-5, wblk: int = 32, hg: int = 1, score_f32: bool = True,
                ablate: str = "none"):
    """The head-grouped section with masks from the window index (K10 on a
    CUDA tensor): geom = (h, w, hp, wp, ws, shift), bias [1, nh, 49, 49],
    weights [in, out] (read K-major in bf16), ``ablate`` one of ABLATIONS
    (timing builds with the outputs of :func:`hg2_section_reference`)."""
    if not use_kernel(x_win):
        return hg2_section_reference(x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                                     num_heads, eps, hg, score_f32, ablate)
    g = _check_geom(geom, x_win.shape[0])
    out = _launch_hg2(x_win, g, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads, eps, wblk,
                      hg, score_f32, ablate)
    hg2_section.launches += 1
    return out


def hg2_section_clocks(clocks, x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                       num_heads: int, eps: float = 1e-5, wblk: int = 32, hg: int = 1,
                       score_f32: bool = True):
    """A measurement, not the served kernel: K10's body in mode none built to
    add its consumers' clock64() time by phase (setup, ring wait, wgmma, q/k/v
    epilogue, attention core, context copy, output epilogue) and their count
    into ``clocks``, a CUDA int64 tensor of 8; (C, hg) one of HG2_MODE_BUILDS.
    Takes hg2_section's arguments; not counted in ``hg2_section.launches``."""
    _check_clocks(clocks, x_win, 8)
    if (x_win.shape[2], hg) not in HG2_MODE_BUILDS:
        raise ValueError(f"hg2_section's measurement builds are at (C, hg) in "
                         f"{sorted(HG2_MODE_BUILDS)} only")
    return _launch_hg2(x_win, _check_geom(geom, x_win.shape[0]), gamma, beta, wqkv, bqkv, wproj,
                       bproj, bias, num_heads, eps, wblk, hg, score_f32, "none", clocks)


hg2_section.launches = 0
