"""Swin window attention: the fused attention section and its core.

Port of segland_tpu/ops/pallas_attn.py, with its function names.  The ops
dispatch on the device (see ``ops/__init__.py``).  CUDA tensors go to the
kernels under ``kernels/csrc/``: :func:`attn_section` (``attn_section.cu``,
masks from ``geom``), :func:`attn_section_v1` (``attn_section_v1.cu``, masks
shipped in, ``group`` windows a super-window), :func:`swin_block`
(``swin_block.cu``, the section and the MLP in one launch) and
:func:`window_attention`.  CPU tensors go to the plain versions
:func:`attn_section_reference`, :func:`block_reference` and
:func:`window_attention_reference`.

Layouts (prepared by models/backbones/swin.py):
  x_win [NW, N, C]   raw window-partitioned tokens, NW = B * nW_img, N = ws*ws
  qkv   [NW, N, 3C]  pre-projected q | k | v, heads contiguous inside each
  bias  [nW_img or 1, nh, N, N]; window w uses bias[w % nW_img]

The attention section:
    y    = (LayerNorm(x) * gamma + beta) * mask_tok     (fp32 stats, fast variance)
    qkv  = y @ wqkv + bqkv
    s    = (q . k) * hd**-0.5 + bias + (-100 between different shift regions)
    ctx  = softmax(s) @ v                               (fp32 scores and softmax)
    out  = x + (ctx @ wproj + bproj)
A pad token (mask 0) is zeroed after the norm, still gets bqkv and takes part
as a key, as the reference backbone pads after norm1.
"""

import numpy as np
import torch

from . import use_kernel
from .fused_mlp import contiguous_as, ln_mlp_reference
from .. import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SECTION_CHANNELS = (96, 192, 384, 768)
_GROUPS = (1, 2, 4, 8)
_HEAD_DIM = 32
_WINDOW = 7


def window_attention_reference(qkv, bias, num_heads: int):
    """Plain PyTorch version of the attention core: scores and softmax in
    fp32, probabilities rounded to qkv's dtype before the product with v,
    which accumulates in fp32 and rounds once."""
    nw, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // num_heads
    q, k, v = (qkv[:, :, i * c:(i + 1) * c].reshape(nw, n, num_heads, hd).permute(0, 2, 1, 3)
               for i in range(3))
    attn = (q.float() @ k.float().transpose(-1, -2)) * (hd ** -0.5)
    nw_img = bias.shape[0]
    if nw_img == 1:
        attn = attn + bias.float()
    else:
        attn = (attn.reshape(nw // nw_img, nw_img, num_heads, n, n) + bias.float()[None])
        attn = attn.reshape(nw, num_heads, n, n)
    attn = torch.softmax(attn, dim=-1).to(qkv.dtype)
    out = attn @ v
    return out.permute(0, 2, 1, 3).reshape(nw, n, c)


def attn_section_reference(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                           num_heads: int, eps: float = 1e-5, regions=None):
    """Plain PyTorch version of the attention section, with the kernel's
    rounding points: LN in fp32, y rounded to x's dtype, every product
    accumulated in fp32 and rounded, each bias and the residual added in x's
    dtype.  mask_tok [nW_img or 1, N]; regions: optional [nW_img, N] ids."""
    cdt = x_win.dtype
    nw = x_win.shape[0]
    xf = x_win.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * gamma.float() + beta.float()
    m = mask_tok.float()
    if m.shape[0] == 1:
        y = y * m[0][None, :, None]
    else:
        y = (y.reshape(nw // m.shape[0], m.shape[0], *y.shape[1:])
             * m[None, :, :, None]).reshape(y.shape)
    y = y.to(cdt)
    qkv = (y @ wqkv.to(cdt)) + bqkv.to(cdt)
    full_bias = bias.float()
    if regions is not None:
        pen = torch.where(regions[:, :, None] != regions[:, None, :], -100.0, 0.0)
        full_bias = full_bias + pen[:, None].to(full_bias.dtype)
    ctx = window_attention_reference(qkv, full_bias, num_heads)
    out = (ctx @ wproj.to(cdt)) + bproj.to(cdt)
    return x_win + out


def block_reference(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias, gamma2,
                    beta2, w1, b1, w2, b2, num_heads: int, eps: float = 1e-5, regions=None):
    """Plain PyTorch version of the whole block: the attention section, whose
    output is rounded to x's dtype, then LN2 + MLP + residual over its
    [NW * N, C] rows (no layer-scale), pad tokens included."""
    a = attn_section_reference(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                               num_heads, eps, regions=regions)
    nw, n, c = a.shape
    out = ln_mlp_reference(a.reshape(nw * n, c), gamma2, beta2, w1, b1, w2, b2, eps=eps)
    return out.reshape(nw, n, c)


def window_masks(n_windows: int, geom):
    """Pad-token mask and shift-region ids [n_windows, ws*ws] from the window
    index alone: the arithmetic of the attention-section kernel, on the host.
    The batch is folded into the window index, so ``n_windows`` may be B *
    nW_img.  Region ids are 0 when ``shift`` is 0."""
    h, w, hp, wp, ws, shift = geom
    win = np.arange(n_windows)[:, None]
    tok = np.arange(ws * ws)[None, :]
    wn = wp // ws
    wr = (win // wn) % (hp // ws)
    wc = win % wn
    grh = wr * ws + tok // ws  # rolled coordinates
    gwc = wc * ws + tok % ws
    oh = grh + shift  # un-roll with wraparound
    oh = np.where(oh >= hp, oh - hp, oh)
    ow = gwc + shift
    ow = np.where(ow >= wp, ow - wp, ow)
    valid = ((oh < h) & (ow < w)).astype(np.float32)
    rid = np.zeros_like(grh)
    if shift > 0:
        rh = (grh >= hp - ws).astype(np.int64) + (grh >= hp - shift)
        rc = (gwc >= wp - ws).astype(np.int64) + (gwc >= wp - shift)
        rid = 3 * rh + rc
    return valid, rid.astype(np.float32)


def shipped_rows(table: np.ndarray, n_windows: int) -> np.ndarray:
    """Rows [n_windows, ws*ws] that the v1 kernel reads from a shipped mask or
    region table [rows, ws*ws]: window w takes row ``w % rows``.  The kernel's
    lookup, on the host."""
    return table[np.arange(n_windows) % table.shape[0]]


def _check_rows(name, t):
    if not t.is_cuda:
        raise ValueError(f"{name} launches a CUDA kernel; got a tensor on {t.device}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name} takes bfloat16 or float32, not {t.dtype}")
    if t.dim() != 3 or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} takes a contiguous, 16-byte aligned [NW, N, C] tensor")


def _bias_f32(bias, dev, num_heads, n):
    b = bias.float().contiguous()
    if b.device != dev or b.dim() != 4 or tuple(b.shape[1:]) != (num_heads, n, n):
        raise ValueError(f"bias {tuple(bias.shape)} on {bias.device}; want "
                         f"[*, {num_heads}, {n}, {n}] on {dev}")
    return b


def _vec(a, k, dev):
    a = a.reshape(-1).float().contiguous()
    if a.numel() != k or a.device != dev:
        raise ValueError(f"vector of {a.numel()} on {a.device}; want {k} on {dev}")
    return a


def _mat(name, a, shape, like):
    if a.device != like.device or tuple(a.shape) != shape:
        raise ValueError(f"weight {tuple(a.shape)} on {a.device}; want {shape} on {like.device}")
    a = contiguous_as(a, like.dtype)
    if a.data_ptr() % 16:
        raise ValueError(f"{name} takes 16-byte aligned weights")
    return a


def _section_args(name, x_win, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads):
    """Checks shared by the three section kernels; returns the section's
    vectors in fp32, its weights in x's dtype and the shared bias in fp32."""
    _check_rows(name, x_win)
    _, n, c = x_win.shape
    if n != _WINDOW * _WINDOW or c != num_heads * _HEAD_DIM:
        raise ValueError(f"{name} takes 7x7 windows and heads of 32; got N={n}, "
                         f"C={c}, heads={num_heads}")
    if x_win.dtype == torch.bfloat16 and c not in _SECTION_CHANNELS:
        raise ValueError(f"{name} has no bfloat16 build for C={c}")
    dev = x_win.device
    b = _bias_f32(bias, dev, num_heads, n)
    if b.shape[0] != 1:
        raise ValueError(f"{name} takes a shared bias [1, nh, N, N], got {tuple(bias.shape)}")
    return (_vec(gamma, c, dev), _vec(beta, c, dev), _mat(name, wqkv, (c, 3 * c), x_win),
            _vec(bqkv, 3 * c, dev), _mat(name, wproj, (c, c), x_win), _vec(bproj, c, dev), b)


def _check_geom(geom, nw):
    h, w, hp, wp, ws, shift = (int(v) for v in geom)
    if (ws != _WINDOW or hp % ws or wp % ws or not 0 <= shift < ws
            or nw % ((hp // ws) * (wp // ws))):
        raise ValueError(f"geom {geom} does not tile {nw} windows of {_WINDOW}x{_WINDOW}")
    return h, w, hp, wp, ws, shift


def attn_section(x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads: int,
                 eps: float = 1e-5):
    """Launch the attention-section kernel on CUDA windows x_win [NW, 49, C]
    (contiguous bf16 or fp32).  geom = (h, w, hp, wp, ws, shift) gives the pad
    mask and the shift regions; bias [1, nh, 49, 49] is the rel-pos bias.
    Weights are cast to x's dtype and vectors to fp32; what the kernel does
    not take raises."""
    g, be, wq, bq, wp_, bp, b = _section_args("attn_section", x_win, gamma, beta, wqkv, bqkv,
                                               wproj, bproj, bias, num_heads)
    nw, _, c = x_win.shape
    h, w, hp, wp, ws, shift = _check_geom(geom, nw)
    out = torch.empty_like(x_win)
    P = kernels.ptr
    err = kernels.library().segland_attn_section(
        _DTYPES[x_win.dtype], P(x_win), P(g), P(be), P(wq), P(bq), P(wp_), P(bp), P(b), P(out),
        nw, c, num_heads, h, w, hp, wp, ws, shift, eps, x_win.device.index,
        kernels.stream_of(x_win))
    kernels.check(err, "attn_section")
    attn_section.launches += 1
    return out


attn_section.launches = 0


def _mask_rows(name, t, nw, dev):
    """A [rows, 49] table (pad mask or region ids) in fp32, whose row for
    window w is ``w % rows``."""
    t = t.float().contiguous()
    if t.device != dev or t.dim() != 2 or t.shape[1] != _WINDOW * _WINDOW or nw % t.shape[0]:
        raise ValueError(f"{name} {tuple(t.shape)} on {t.device}; want [rows, 49] on {dev} "
                         f"with rows dividing {nw} windows")
    return t


def attn_section_v1(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                    num_heads: int, eps: float = 1e-5, regions=None, group: int = 1):
    """Launch the v1 attention-section kernel on CUDA windows x_win [NW, 49, C]
    (contiguous bf16 or fp32): the pad mask ``mask_tok`` [nW_img or 1, 49] and
    the region ids ``regions`` [nW_img, 49] (or None) are read from device
    memory, and ``group`` consecutive windows are attended as one super-window
    (NW need not divide by it).  Builds exist for group in 1, 2, 4, 8."""
    if group not in _GROUPS:
        raise ValueError(f"attn_section_v1 is built for group in {_GROUPS}, not {group}")
    g, be, wq, bq, wp_, bp, b = _section_args("attn_section_v1", x_win, gamma, beta, wqkv, bqkv,
                                               wproj, bproj, bias, num_heads)
    nw, n, c = x_win.shape
    dev = x_win.device
    m = _mask_rows("mask_tok", mask_tok, nw, dev)
    r = None if regions is None else _mask_rows("regions", regions, nw, dev)
    out = torch.empty_like(x_win)
    scratch = torch.empty((nw, n, 3 * c), dtype=x_win.dtype, device=dev)  # q, k, v, then ctx
    P = kernels.ptr
    err = kernels.library().segland_attn_section_v1(
        _DTYPES[x_win.dtype], P(x_win), P(m), m.shape[0], P(r), 0 if r is None else r.shape[0],
        P(g), P(be), P(wq), P(bq), P(wp_), P(bp), P(b), P(scratch), P(out), nw, c, num_heads,
        group, eps, dev.index, kernels.stream_of(x_win))
    kernels.check(err, "attn_section_v1")
    attn_section_v1.launches += 1
    return out


attn_section_v1.launches = 0


def swin_block(x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias, gamma2, beta2, w1, b1,
               w2, b2, num_heads: int, eps: float = 1e-5):
    """Launch the whole-block kernel on CUDA windows x_win [NW, 49, C]
    (contiguous bf16 or fp32): the attention section of :func:`attn_section`
    and LN2 + MLP + residual on its output, in one launch.  w1 [C, H],
    w2 [H, C]."""
    g, be, wq, bq, wp_, bp, b = _section_args("swin_block", x_win, gamma, beta, wqkv, bqkv,
                                               wproj, bproj, bias, num_heads)
    nw, _, c = x_win.shape
    dev = x_win.device
    if c not in _SECTION_CHANNELS:
        raise ValueError(f"swin_block has no build for C={c}")
    hidden = w1.shape[-1]
    if hidden % 64:
        raise ValueError(f"swin_block takes a hidden width that is a multiple of 64, not {hidden}")
    h, w, hp, wp, ws, shift = _check_geom(geom, nw)
    g2, be2 = _vec(gamma2, c, dev), _vec(beta2, c, dev)
    bb1, bb2 = _vec(b1, hidden, dev), _vec(b2, c, dev)
    ww1 = _mat("swin_block", w1, (c, hidden), x_win)
    ww2 = _mat("swin_block", w2, (hidden, c), x_win)
    out = torch.empty_like(x_win)
    P = kernels.ptr
    err = kernels.library().segland_swin_block(
        _DTYPES[x_win.dtype], P(x_win), P(g), P(be), P(wq), P(bq), P(wp_), P(bp), P(b), P(g2),
        P(be2), P(ww1), P(bb1), P(ww2), P(bb2), P(out), nw, c, num_heads, hidden, h, w, hp, wp,
        ws, shift, eps, dev.index, kernels.stream_of(x_win))
    kernels.check(err, "swin_block")
    swin_block.launches += 1
    return out


swin_block.launches = 0


def window_attention(qkv, bias, num_heads: int):
    """Launch the window-attention kernel on CUDA qkv [NW, 49, 3C] (contiguous
    bf16 or fp32); bias [nW_img or 1, nh, 49, 49] of any float dtype."""
    _check_rows("window_attention", qkv)
    nw, n, c3 = qkv.shape
    c = c3 // 3
    if n != _WINDOW * _WINDOW or c3 != 3 * c or c != num_heads * _HEAD_DIM:
        raise ValueError(f"window_attention takes 7x7 windows and heads of 32; got N={n}, "
                         f"3C={c3}, heads={num_heads}")
    b = _bias_f32(bias, qkv.device, num_heads, n)
    if nw % b.shape[0]:
        raise ValueError(f"{nw} windows do not divide into images of {b.shape[0]}")
    out = torch.empty((nw, n, c), dtype=qkv.dtype, device=qkv.device)
    P = kernels.ptr
    err = kernels.library().segland_window_attention(
        _DTYPES[qkv.dtype], P(qkv), P(b), P(out), nw, c, num_heads, b.shape[0],
        qkv.device.index, kernels.stream_of(qkv))
    kernels.check(err, "window_attention")
    window_attention.launches += 1
    return out


window_attention.launches = 0


def window_attention_fused(qkv, bias, num_heads: int):
    """qkv [NW, N, 3C], bias [nW_img or 1, nh, N, N] -> out [NW, N, C]
    (pre-projection)."""
    if use_kernel(qkv):
        return window_attention(qkv, bias, num_heads)
    return window_attention_reference(qkv, bias, num_heads)


def swin_attn_section_fused(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                            num_heads: int, eps: float = 1e-5, regions=None, group: int = 1,
                            geom=None):
    """Fused LN + qkv + window attention + proj + residual over partitioned
    windows; x_win [NW, N, C] -> [NW, N, C].

    With ``geom = (h, w, hp, wp, ws, shift)`` a CUDA tensor goes to the kernel
    that derives the pad mask and the shift regions from it; ``mask_tok`` and
    ``regions`` (which must agree with it) then feed the plain version only.
    Without ``geom`` it goes to the v1 kernel, which reads ``mask_tok`` and
    ``regions`` and attends ``group`` windows as one super-window.  ``group``
    changes nothing in the plain version: the other windows' keys have weight
    zero."""
    if geom is not None and group != 1:
        # ignoring it would make the knob a silent no-op
        raise ValueError("group != 1 is a knob of the v1 kernel; with geom set the "
                         "index-math kernel runs, which has no super-windows")
    if use_kernel(x_win):
        if geom is None:
            return attn_section_v1(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                                   num_heads, eps, regions=regions, group=group)
        return attn_section(x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                            num_heads, eps)
    return attn_section_reference(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj,
                                  bias, num_heads, eps, regions=regions)


def swin_block_fused(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias, gamma2,
                     beta2, w1, b1, w2, b2, num_heads: int, eps: float = 1e-5, regions=None,
                     geom=None):
    """A whole swin block (attention section, then LN2 + MLP + residual) over
    partitioned windows in one kernel; x_win [NW, N, C] -> [NW, N, C].

    The contract of :func:`swin_attn_section_fused` plus the MLP's parameters;
    ``geom`` is required.  The JAX function's ``hg`` is not taken here.  Its
    counterpart on this card, hg heads a pass, is the head-grouped section
    of ``ops/hg_attn.py`` (K10); on an H100 it pays at C >= 192 and costs at
    C = 96 (PERF.md), and no block or section route of a model runs it yet."""
    if geom is None:
        raise ValueError("swin_block_fused requires geom = (h, w, hp, wp, ws, shift)")
    if use_kernel(x_win):
        return swin_block(x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias, gamma2,
                          beta2, w1, b1, w2, b2, num_heads, eps)
    return block_reference(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                           gamma2, beta2, w1, b1, w2, b2, num_heads, eps, regions=regions)
