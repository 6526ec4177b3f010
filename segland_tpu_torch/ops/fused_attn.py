"""Swin window attention: the fused attention section and its core.

Port of segland_tpu/ops/pallas_attn.py, with its function names.  Both ops
dispatch on the device (see ``ops/__init__.py``): CUDA tensors go to the
kernels of ``kernels/csrc/attn_section.cu`` through :func:`attn_section` and
:func:`window_attention`, CPU tensors to the plain versions
:func:`attn_section_reference` and :func:`window_attention_reference`.

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
from .fused_mlp import contiguous_as
from .. import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SECTION_CHANNELS = (96, 192, 384, 768)
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


def attn_section(x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads: int,
                 eps: float = 1e-5):
    """Launch the attention-section kernel on CUDA windows x_win [NW, 49, C]
    (contiguous bf16 or fp32).  geom = (h, w, hp, wp, ws, shift) gives the pad
    mask and the shift regions; bias [1, nh, 49, 49] is the rel-pos bias.
    Weights are cast to x's dtype and vectors to fp32; what the kernel does
    not take raises."""
    _check_rows("attn_section", x_win)
    nw, n, c = x_win.shape
    h, w, hp, wp, ws, shift = (int(v) for v in geom)
    if ws != _WINDOW or n != ws * ws or c != num_heads * _HEAD_DIM:
        raise ValueError(f"attn_section takes 7x7 windows and heads of 32; got N={n}, "
                         f"C={c}, heads={num_heads}")
    if x_win.dtype == torch.bfloat16 and c not in _SECTION_CHANNELS:
        raise ValueError(f"attn_section has no bfloat16 build for C={c}")
    if hp % ws or wp % ws or not 0 <= shift < ws or nw % ((hp // ws) * (wp // ws)):
        raise ValueError(f"geom {geom} does not tile {nw} windows")
    cdt, dev = x_win.dtype, x_win.device

    def vec(a, k):
        a = a.reshape(-1).float().contiguous()
        if a.numel() != k or a.device != dev:
            raise ValueError(f"vector of {a.numel()} on {a.device}; want {k} on {dev}")
        return a

    def mat(a, shape):
        if a.device != dev or tuple(a.shape) != shape:
            raise ValueError(f"weight {tuple(a.shape)} on {a.device}; want {shape} on {dev}")
        a = contiguous_as(a, cdt)
        if a.data_ptr() % 16:
            raise ValueError("attn_section takes 16-byte aligned weights")
        return a

    b = _bias_f32(bias, dev, num_heads, n)
    if b.shape[0] != 1:
        raise ValueError(f"attn_section takes a shared bias [1, nh, N, N], got {tuple(bias.shape)}")
    g, be, bq, bp = vec(gamma, c), vec(beta, c), vec(bqkv, 3 * c), vec(bproj, c)
    wq, wp_ = mat(wqkv, (c, 3 * c)), mat(wproj, (c, c))
    out = torch.empty_like(x_win)
    P = kernels.ptr
    err = kernels.library().segland_attn_section(
        _DTYPES[cdt], P(x_win), P(g), P(be), P(wq), P(bq), P(wp_), P(bp), P(b), P(out),
        nw, c, num_heads, h, w, hp, wp, ws, shift, eps, dev.index, kernels.stream_of(x_win))
    kernels.check(err, "attn_section")
    attn_section.launches += 1
    return out


attn_section.launches = 0


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

    ``geom = (h, w, hp, wp, ws, shift)`` is required on CUDA: the kernel
    derives the pad mask and the shift regions from it, and ``mask_tok`` and
    ``regions`` (which must agree with it) feed the plain version only.  The
    JAX package's super-window grouping (``group != 1``, its v1 kernel) is not
    ported."""
    if group != 1:
        raise NotImplementedError(
            "attn_group != 1 (the v1 attention-section kernel) is not ported yet "
            "(ROADMAP item B5)")
    if use_kernel(x_win):
        if geom is None:
            raise NotImplementedError(
                "the attention section without geom (mask and region arrays shipped in) "
                "is the v1 kernel, not ported yet (ROADMAP item B5)")
        return attn_section(x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                            num_heads, eps)
    return attn_section_reference(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj,
                                  bias, num_heads, eps, regions=regions)
