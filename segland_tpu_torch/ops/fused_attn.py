"""Swin window attention: the fused attention section and its core.

Port of segland_tpu/ops/pallas_attn.py, with its function names.  The ops
dispatch on the device (see ``ops/__init__.py``).  CUDA tensors go to the
kernels under ``kernels/csrc/``: :func:`attn_section` (``attn_section.cu``,
masks from ``geom``), :func:`attn_section_v1` (``attn_section_v1.cu``, masks
shipped in, ``group`` windows a super-window), :func:`swin_block`
(``swin_block.cu``, the section and the MLP in one launch) and
:func:`window_attention` (``window_attention.cu``).  CPU tensors go to the plain versions
:func:`attn_section_reference`, :func:`block_reference` and
:func:`window_attention_reference`.

Where a gradient is asked for, the section and the block run inside
:class:`AttnSection` and :class:`SwinBlockFn`: the forward is the same
dispatch, and the backward recomputes the section through stock torch
(:func:`attn_section_torch`; the block then adds ``ln_mlp_reference``, K1's
backward recompute) and differentiates it, as the JAX package's custom VJPs
recompute an XLA formulation (pallas_attn.py:653-689, 881-920).  The window
attention core (K6) has no backward, as in the JAX package.

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

import collections

import numpy as np
import torch
import torch.nn.functional as F

from . import forward_only, use_kernel
from .fused_mlp import SMEM_MAX, contiguous_as, kmajor, ln_mlp_reference
from .. import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SECTION_CHANNELS = (96, 192, 384, 768)

# ---- the bf16 section kernel's builds (SEGLAND_SECTION_BUILDS in attn_section.cu) --------
# w windows a block, s ring slots of one [96, 64] bf16 weight tile each, rr: a producer
# warpgroup and setmaxnreg (240 registers a consumer thread), else a lone producer warp
# (168 a thread, ptxas' cap for 9 warps): whichever the build compiles without spills.
SectionBuild = collections.namedtuple("SectionBuild", "w s rr")
SECTION_BUILDS = {96: SectionBuild(4, 4, True), 192: SectionBuild(2, 6, False),
                  384: SectionBuild(2, 4, False), 768: SectionBuild(1, 6, False)}
# ---- the bf16 whole-block kernel's builds (SEGLAND_BLOCK_BUILDS in swin_block.cu) --------
# the section's w windows a block and s ring slots (a producer warpgroup always), then
# ln_mlp's rg warpgroups down the rows, cg across the output columns, np passes and hs
# hidden columns a warpgroup and chunk: SECTION_BUILDS' and MLP_BUILDS' at the same
# width, but at C = 96 a hidden chunk of 64, not 128 (the same k order, so the same
# result), and more ring slots where the shared memory has room.
BlockBuild = collections.namedtuple("BlockBuild", "w s rg cg np hs")
BLOCK_BUILDS = {96: BlockBuild(4, 5, 2, 1, 1, 64), 192: BlockBuild(2, 8, 2, 1, 1, 64),
                384: BlockBuild(2, 5, 1, 2, 1, 64), 768: BlockBuild(1, 7, 1, 2, 2, 64)}
# ---- the bf16 v1 kernel's builds (SEGLAND_V1_BUILDS in attn_section_v1.cu) ---------------
# w windows a block (the windows path takes group <= w, the scratch path the rest in
# chunks of w), s ring slots, a lone producer warp.  At C = 96 two windows, not
# SECTION_BUILDS' four: two row tiles a warpgroup beside the super-window walk spilled.
V1Build = collections.namedtuple("V1Build", "w s")
V1_BUILDS = {96: V1Build(2, 5), 192: V1Build(2, 5), 384: V1Build(2, 5), 768: V1Build(1, 5)}
_N = 49
_LQ, _STRIP = 48, 16 * 68 * 4  # q/k/v row stride (bf16), an attention strip (bytes)
_SLOT = 96 * 128  # a ring slot of the section kernels
_MAX_GROUP = 8


def _al128(n):
    return (n + 127) // 128 * 128


def _check_plan(name, c, parts):
    smem = sum(parts.values())
    if smem > SMEM_MAX:
        raise ValueError(f"{name} at C={c}: " + " + ".join(f"{k} {v:,}" for k, v in parts.items())
                         + f" = {smem:,} B > {SMEM_MAX:,}")
    return smem


def _section_layout(c, w, s, tok_bytes=1):
    """SecPlan<C, W, S, RR, TOK> of section_sm90.cuh: rows, row tiles and how the two
    consumer warpgroups split them, and shared memory by buffer."""
    rows = w * _N
    rt = -(-rows // 64)
    rs = -(-rows // 8) * 8
    split_rows = rt >= 2
    nb = 96 if split_rows else 48
    kt = -(-c // 64)
    rq = -(-rows // 16) * 16 + 16
    parts = dict(ring=s * _SLOT, y=kt * rs * 128, qkv=3 * _al128(rq * _LQ * 2),
                 strips=min(4 * w, 8) * _STRIP, bias=_al128(_N * _N * 4),
                 tokens=_al128(rows * tok_bytes), barriers=2 * s * 8, align=1024)
    return dict(w=w, s=s, c=c, rows=rows, row_tiles=rt, y_rows=rs,
                split="rows" if split_rows else "columns", n=nb, k_tiles=kt,
                slot_bytes=_SLOT, smem_parts=parts,
                acc_regs=(rt // 2 if split_rows else 1) * nb // 2,
                overrun=(rt * 64 - rs) * 128)


def section_plan(c: int) -> dict:
    """The bf16 section kernel's plan at width C: the arithmetic of SecPlan in
    section_sm90.cuh.  Windows a block, m64 row tiles and how the two consumer
    warpgroups split them, ring depth, shared memory by buffer and in all
    (bytes), and the accumulator registers a consumer thread holds.  Raises
    ValueError, with the arithmetic, for a width that has no build."""
    if c not in SECTION_BUILDS:
        raise ValueError(f"attn_section has no bfloat16 build for C={c}: built at C in "
                         f"{tuple(SECTION_BUILDS)} (heads of 32, the projection 96 columns "
                         f"a pass)")
    b = SECTION_BUILDS[c]
    plan = _section_layout(c, b.w, b.s)
    plan.update(rr=b.rr, slots_per_block=(c // 32 + c // 96) * plan["k_tiles"])
    plan["smem"] = _check_plan("attn_section", c, plan["smem_parts"])
    return plan


def block_plan(c: int, hidden: int = None) -> dict:
    """The bf16 whole-block kernel's plan at width C (and hidden width H): the
    arithmetic of BlockPlan in swin_block.cu.  The section's plan with a
    producer warpgroup, then ln_mlp's tiling over the block's row tiles: work
    items (row group, pass) a full block, the h tile over the dead q, k, v
    buffers, ring slots a block (the section's tiles, then the MLP's); shared
    memory by buffer and in all.  Raises
    ValueError, with the arithmetic, for a shape that has no build."""
    if c not in BLOCK_BUILDS:
        raise ValueError(f"swin_block has no bfloat16 build for C={c}: built at C in "
                         f"{tuple(BLOCK_BUILDS)}")
    b = BLOCK_BUILDS[c]
    plan = _section_layout(c, b.w, b.s)
    hc = b.cg * b.hs
    hidden = 4 * c if hidden is None else hidden
    if hidden <= 0 or hidden % hc:
        raise ValueError(f"swin_block at C={c} walks the hidden width in chunks of {b.cg} x "
                         f"{b.hs} = {hc} columns; H={hidden} is not a multiple of {hc}")
    if plan["row_tiles"] % b.rg:
        raise ValueError(f"swin_block at C={c}: {plan['row_tiles']} row tiles do not split "
                         f"into row groups of {b.rg}")
    cs = c // b.np // b.cg
    kt1, nt1, kt2, nt2 = -(-c // 64), b.hs // 64, hc // 64, -(-cs // 64)
    h_bytes = 0 if b.cg == 1 else b.rg * 2 * kt2 * 8192
    behind_y = sum(plan["smem_parts"][k] for k in ("qkv", "strips", "bias", "tokens"))
    if h_bytes > behind_y:
        raise ValueError(f"swin_block at C={c}: the h tile ({h_bytes:,} B) does not fit "
                         f"behind y ({behind_y:,} B)")
    items = plan["row_tiles"] // b.rg * b.np
    plan.update(b._asdict(), rr=True, hidden=hidden, hc=hc, cs=cs, chunks=hidden // hc,
                items=items, h_bytes=h_bytes,
                mlp_regs=nt1 * 32 + nt2 * 32 + (b.hs // 4 if b.cg == 1 else 0),
                slots_per_block=(c // 32 + c // 96) * plan["k_tiles"]
                + items * (hidden // hc) * (kt1 * b.cg * nt1 + kt2 * b.cg * nt2))
    plan["smem"] = _check_plan("swin_block", c, plan["smem_parts"])
    return plan


def v1_plan(c: int, group: int) -> dict:
    """The bf16 v1 kernel's plan at width C and ``group``: the arithmetic of
    V1Plan in attn_section_v1.cu.  The windows path (group <= the build's
    windows a block) owns whole super-windows with q, k and v in shared memory,
    the section's layout with fp32 region ids; the scratch path owns one
    super-window in chunks and keeps q, k and v in a [NW, 49, 3C] scratch
    tensor, its phase 2 over y.  Raises ValueError, with the arithmetic, for a
    width or group that has no build."""
    if c not in V1_BUILDS:
        raise ValueError(f"attn_section_v1 has no bfloat16 build for C={c}: built at C in "
                         f"{tuple(V1_BUILDS)}")
    if group not in _GROUPS:
        raise ValueError(f"attn_section_v1 is built for group in {_GROUPS}, not {group}")
    b = V1_BUILDS[c]
    plan = _section_layout(c, b.w, b.s, tok_bytes=4)
    plan.update(rr=False, group=group)
    if group <= b.w:
        plan.update(path="windows", scratch=False, windows_a_block=b.w)
    else:
        p = plan["smem_parts"]
        phase2 = (8 * _STRIP + _al128(_N * _N * 4) + 3 * _al128((_MAX_GROUP * _N + 16) * _LQ * 2)
                  + _al128(_MAX_GROUP * _N * 4))
        phase13 = p["y"] + plan["overrun"]
        plan.update(path="scratch", scratch=True, windows_a_block=group, chunks=-(-group // b.w),
                    smem_parts=dict(ring=p["ring"], phase2=phase2, phase13=phase13,
                                    barriers=p["barriers"], align=p["align"]))
        plan["smem"] = _check_plan("attn_section_v1", c, dict(
            ring=p["ring"], over_y=max(phase2, phase13), barriers=p["barriers"],
            align=p["align"]))
        return plan
    plan["smem"] = _check_plan("attn_section_v1", c, plan["smem_parts"])
    return plan


# ---- K6, window attention (window_attention.cu) -----------------------------------------
# bf16 qkv runs the ring body: a persistent grid walking (window, head) items through a
# cp.async ring, the core on mma.sync.
WINDOW_STAGES = 4  # kRingStages: items a ring-body block holds
_WINDOW_THREADS = 128
_SM_SMEM, _BLOCK_RESERVED, _SM_THREADS = 233472, 1024, 2048  # an sm_90 SM


def window_attention_plan(nw: int, c: int, nh: int, nw_img: int = 1,
                          bias_dtype=torch.bfloat16, sms: int = 132) -> dict:
    """K6's ring body as window_attention.cu launches it: ring stages, bytes a stage
    (q, k, v as 3 x 64 rows of 64 bytes, then the bias slice with 2 bytes of slack at
    each end, to 16), dynamic shared memory, blocks a SM (by shared memory: the card's
    occupancy query may say fewer, which chip_smoke.py checks), grid (a multiple of
    nh, at most one block an item), items and the most a block walks.  Raises
    ValueError for shapes the kernel refuses."""
    if nh * _HEAD_DIM != c or nw_img < 1 or nw % nw_img or nw * nh > 2 ** 31 - 1 or nw < 1:
        raise ValueError(f"window_attention: NW={nw}, C={c}, heads={nh}, nW_img={nw_img}: "
                         f"heads of 32, nW_img dividing NW, NW*heads < 2^31")
    esize = torch.finfo(bias_dtype).bits // 8
    stage = 3 * 64 * 64 + -(-(_N * _N * esize + 4) // 16) * 16
    smem = WINDOW_STAGES * stage
    if smem > SMEM_MAX:
        raise ValueError(f"window_attention ring: {WINDOW_STAGES} x {stage:,} B > {SMEM_MAX:,}")
    per_sm = min(_SM_SMEM // (smem + _BLOCK_RESERVED), _SM_THREADS // _WINDOW_THREADS)
    items = nw * nh
    grid = sms * per_sm
    if grid >= nh:
        grid -= grid % nh
    grid = min(grid, items)
    return dict(stages=WINDOW_STAGES, stage_bytes=stage,
                smem=smem, blocks_per_sm=per_sm, grid=grid, items=items,
                items_per_block=-(-items // grid), one_head_per_block=grid % nh == 0)


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


def attn_section_torch(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                       num_heads: int, eps: float = 1e-5, regions=None):
    """The section through stock torch in x's dtype, as the unfused swin block
    runs it: ``F.layer_norm`` and the pad mask, the qkv ``F.linear``, q k^T
    with the rel-pos bias and the shift penalty, softmax in fp32, P V, the
    projection ``F.linear`` and the residual.  The same function as
    :func:`attn_section_reference` with other rounding points (in bf16:
    gamma, beta and the scores rounded, torch's two-pass variance).  The
    backward of :class:`AttnSection` and :class:`SwinBlockFn` differentiates
    it; ``chip_smoke.py`` times it as ``torch_route_ms``."""
    dt = x_win.dtype
    nw, n, c = x_win.shape
    hd = c // num_heads
    y = F.layer_norm(x_win, (c,), gamma.to(dt), beta.to(dt), eps)
    m = mask_tok.to(dt)
    y = (y.reshape(nw // m.shape[0], m.shape[0], n, c) * m[None, :, :, None]).reshape(nw, n, c)
    q, k, v = F.linear(y, wqkv.t().to(dt), bqkv.to(dt)).reshape(
        nw, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    s = (q * hd ** -0.5) @ k.transpose(-1, -2)
    b = bias.to(dt)
    if regions is not None:
        pen = torch.where(regions[:, :, None] != regions[:, None, :], -100.0, 0.0)
        b = b + pen[:, None].to(dt)  # [nW_img, nh, N, N]
    s = (s.reshape(nw // b.shape[0], b.shape[0], num_heads, n, n) + b).reshape(nw, num_heads, n, n)
    p = torch.softmax(s.float(), dim=-1).to(dt)
    ctx = (p @ v).permute(0, 2, 1, 3).reshape(nw, n, c)
    return x_win + F.linear(ctx, wproj.t().to(dt), bproj.to(dt))


def _block_torch(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias, gamma2, beta2, w1,
                 b1, w2, b2, num_heads, eps, regions):
    """The whole block as :class:`SwinBlockFn`'s backward recomputes it: the
    stock-torch section, then K1's recompute (tanh-GELU in bf16, erf in fp32)
    over its [NW * N, C] rows."""
    a = attn_section_torch(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                           num_heads, eps, regions)
    nw, n, c = a.shape
    return ln_mlp_reference(a.reshape(nw * n, c), gamma2, beta2, w1, b1, w2, b2,
                            eps=eps).reshape(nw, n, c)


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


def _check_clocks(clocks, x_win, n):
    if x_win.dtype != torch.bfloat16 or clocks.dtype != torch.int64 or clocks.numel() < n \
            or clocks.device != x_win.device:
        raise ValueError(f"clocks: an int64 tensor of {n} on the device, bf16 windows only")


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
    return a if a.data_ptr() % 16 == 0 else a.clone()  # kernels read pairs


def _mat(name, a, shape, like):
    if a.device != like.device or tuple(a.shape) != shape:
        raise ValueError(f"weight {tuple(a.shape)} on {a.device}; want {shape} on {like.device}")
    a = contiguous_as(a, like.dtype)
    if a.data_ptr() % 16:
        raise ValueError(f"{name} takes 16-byte aligned weights")
    return a


def _kmat(name, a, shape, like):
    """A weight of ``shape`` (input-major) as the wgmma body reads it: K-major
    in x's dtype."""
    if a.device != like.device or tuple(a.shape) != shape:
        raise ValueError(f"weight {tuple(a.shape)} on {a.device}; want {shape} on {like.device}")
    return kmajor(a, like.dtype)


def _section_args(name, x_win, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads,
                  k_major=False):
    """Checks shared by the three section kernels; returns the section's
    vectors in fp32, its weights in x's dtype (K-major with ``k_major``) and
    the shared bias in fp32."""
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
    mat = _kmat if k_major else _mat
    return (_vec(gamma, c, dev), _vec(beta, c, dev), mat(name, wqkv, (c, 3 * c), x_win),
            _vec(bqkv, 3 * c, dev), mat(name, wproj, (c, c), x_win), _vec(bproj, c, dev), b)


def _check_geom(geom, nw):
    h, w, hp, wp, ws, shift = (int(v) for v in geom)
    if (ws != _WINDOW or hp % ws or wp % ws or not 0 <= shift < ws
            or nw % ((hp // ws) * (wp // ws))):
        raise ValueError(f"geom {geom} does not tile {nw} windows of {_WINDOW}x{_WINDOW}")
    return h, w, hp, wp, ws, shift


def _section_launch_args(x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads,
                         eps):
    """Checks the section kernel's inputs; returns its output buffer and the
    arguments that its C entries share (without dtype, device and stream)."""
    forward_only("attn_section", x_win, gamma, beta, wqkv, bqkv, wproj, bproj, bias)
    _check_rows("attn_section", x_win)
    bf16 = x_win.dtype == torch.bfloat16
    if bf16:
        section_plan(x_win.shape[-1])  # raises for a width the kernel has no build for
    # the bf16 (wgmma) body reads its weights K-major
    g, be, wq, bq, wp_, bp, b = _section_args("attn_section", x_win, gamma, beta, wqkv, bqkv,
                                               wproj, bproj, bias, num_heads, k_major=bf16)
    nw, _, c = x_win.shape
    h, w, hp, wp, ws, shift = _check_geom(geom, nw)
    out = torch.empty_like(x_win)
    P = kernels.ptr
    return out, (P(x_win), P(g), P(be), P(wq), P(bq), P(wp_), P(bp), P(b), P(out), nw, c,
                 num_heads, h, w, hp, wp, ws, shift, eps)


def attn_section(x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads: int,
                 eps: float = 1e-5):
    """Launch the attention-section kernel on CUDA windows x_win [NW, 49, C]
    (contiguous bf16 or fp32).  geom = (h, w, hp, wp, ws, shift) gives the pad
    mask and the shift regions; bias [1, nh, 49, 49] is the rel-pos bias.
    Weights are cast to x's dtype and vectors to fp32; what the kernel does
    not take raises."""
    out, args = _section_launch_args(x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                                     num_heads, eps)
    err = kernels.library().segland_attn_section(
        _DTYPES[x_win.dtype], *args, x_win.device.index, kernels.stream_of(x_win))
    kernels.check(err, "attn_section")
    attn_section.launches += 1
    return out


attn_section.launches = 0


def attn_section_clocks(clocks, x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                        num_heads: int, eps: float = 1e-5):
    """A measurement, not the served kernel: the section kernel's bf16 body
    built to add its consumers' clock64() time by phase (setup, ring wait,
    wgmma, q/k/v epilogue, attention core, context copy, output epilogue) and
    their count into ``clocks``, a CUDA int64 tensor of 8.  Takes
    attn_section's arguments; not counted in ``attn_section.launches``."""
    _check_clocks(clocks, x_win, 8)
    out, args = _section_launch_args(x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                                     num_heads, eps)
    err = kernels.library().segland_attn_section_clocks(
        *args, kernels.ptr(clocks), x_win.device.index, kernels.stream_of(x_win))
    kernels.check(err, "attn_section_clocks")
    return out


def _mask_rows(name, t, nw, dev):
    """A [rows, 49] table (pad mask or region ids) in fp32, whose row for
    window w is ``w % rows``."""
    t = t.float().contiguous()
    if t.device != dev or t.dim() != 2 or t.shape[1] != _WINDOW * _WINDOW or nw % t.shape[0]:
        raise ValueError(f"{name} {tuple(t.shape)} on {t.device}; want [rows, 49] on {dev} "
                         f"with rows dividing {nw} windows")
    return t


def _v1_launch_args(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads,
                    eps, regions, group):
    """Checks the v1 kernel's inputs; returns its output buffer and the
    arguments that its C entries share (without dtype, device and stream).
    The scratch tensor is allocated only for a path that reads it."""
    forward_only("attn_section_v1", x_win, gamma, beta, wqkv, bqkv, wproj, bproj, bias)
    if group not in _GROUPS:
        raise ValueError(f"attn_section_v1 is built for group in {_GROUPS}, not {group}")
    _check_rows("attn_section_v1", x_win)
    bf16 = x_win.dtype == torch.bfloat16
    plan = v1_plan(x_win.shape[-1], group) if bf16 else None  # raises without a build
    # the bf16 (wgmma) body reads its weights K-major
    g, be, wq, bq, wp_, bp, b = _section_args("attn_section_v1", x_win, gamma, beta, wqkv, bqkv,
                                               wproj, bproj, bias, num_heads, k_major=bf16)
    nw, n, c = x_win.shape
    dev = x_win.device
    m = _mask_rows("mask_tok", mask_tok, nw, dev)
    r = None if regions is None else _mask_rows("regions", regions, nw, dev)
    out = torch.empty_like(x_win)
    scratch = None  # q, k, v of the super-windows (fp32: then the context)
    if plan is None or plan["scratch"]:
        scratch = torch.empty((nw, n, 3 * c), dtype=x_win.dtype, device=dev)
    P = kernels.ptr
    return out, (P(x_win), P(m), m.shape[0], P(r), 0 if r is None else r.shape[0], P(g), P(be),
                 P(wq), P(bq), P(wp_), P(bp), P(b), P(scratch), P(out), nw, c, num_heads, group,
                 eps)


def attn_section_v1(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                    num_heads: int, eps: float = 1e-5, regions=None, group: int = 1):
    """Launch the v1 attention-section kernel on CUDA windows x_win [NW, 49, C]
    (contiguous bf16 or fp32): the pad mask ``mask_tok`` [nW_img or 1, 49] and
    the region ids ``regions`` [nW_img, 49] (or None) are read from device
    memory, and ``group`` consecutive windows are attended as one super-window
    (NW need not divide by it).  Builds exist for group in 1, 2, 4, 8."""
    out, args = _v1_launch_args(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                                num_heads, eps, regions, group)
    err = kernels.library().segland_attn_section_v1(
        _DTYPES[x_win.dtype], *args, x_win.device.index, kernels.stream_of(x_win))
    kernels.check(err, "attn_section_v1")
    attn_section_v1.launches += 1
    return out


attn_section_v1.launches = 0


def attn_section_v1_clocks(clocks, x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                           num_heads: int, eps: float = 1e-5, regions=None, group: int = 1):
    """A measurement, not the served kernel: the v1 kernel's bf16 body built to
    add its consumers' clock64() time by phase (setup, ring wait, wgmma, q/k/v
    epilogue, attention core with the super-window's key walk, context copy,
    output epilogue) and their count into ``clocks``, a CUDA int64 tensor of 8.
    Takes attn_section_v1's arguments; not counted in its ``launches``."""
    _check_clocks(clocks, x_win, 8)
    out, args = _v1_launch_args(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                                num_heads, eps, regions, group)
    err = kernels.library().segland_attn_section_v1_clocks(
        *args, kernels.ptr(clocks), x_win.device.index, kernels.stream_of(x_win))
    kernels.check(err, "attn_section_v1_clocks")
    return out


def _block_launch_args(x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias, gamma2, beta2,
                       w1, b1, w2, b2, num_heads, eps):
    """Checks the whole-block kernel's inputs; returns its output buffer and the
    arguments that its C entries share (without dtype, device and stream)."""
    forward_only("swin_block", x_win, gamma, beta, wqkv, bqkv, wproj, bproj, bias, gamma2, beta2,
                 w1, b1, w2, b2)
    _check_rows("swin_block", x_win)
    nw, _, c = x_win.shape
    bf16 = x_win.dtype == torch.bfloat16
    hidden = w1.shape[-1]
    if bf16:
        block_plan(c, hidden)  # raises for a shape the kernel has no build for
    elif c not in _SECTION_CHANNELS or hidden % 64:
        raise ValueError(f"swin_block has no float32 build for C={c}, H={hidden}")
    # the bf16 (wgmma) body reads every weight K-major
    g, be, wq, bq, wp_, bp, b = _section_args("swin_block", x_win, gamma, beta, wqkv, bqkv,
                                               wproj, bproj, bias, num_heads, k_major=bf16)
    dev = x_win.device
    h, w, hp, wp, ws, shift = _check_geom(geom, nw)
    g2, be2 = _vec(gamma2, c, dev), _vec(beta2, c, dev)
    bb1, bb2 = _vec(b1, hidden, dev), _vec(b2, c, dev)
    mat = _kmat if bf16 else _mat
    ww1 = mat("swin_block", w1, (c, hidden), x_win)
    ww2 = mat("swin_block", w2, (hidden, c), x_win)
    out = torch.empty_like(x_win)
    P = kernels.ptr
    return out, (P(x_win), P(g), P(be), P(wq), P(bq), P(wp_), P(bp), P(b), P(g2), P(be2),
                 P(ww1), P(bb1), P(ww2), P(bb2), P(out), nw, c, num_heads, hidden, h, w, hp, wp,
                 ws, shift, eps)


def swin_block(x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias, gamma2, beta2, w1, b1,
               w2, b2, num_heads: int, eps: float = 1e-5):
    """Launch the whole-block kernel on CUDA windows x_win [NW, 49, C]
    (contiguous bf16 or fp32): the attention section of :func:`attn_section`
    and LN2 + MLP + residual on its output, in one launch.  w1 [C, H],
    w2 [H, C] (bf16: read K-major, so nn.Linear's ``weight.T`` passes without
    a copy)."""
    out, args = _block_launch_args(x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                                   gamma2, beta2, w1, b1, w2, b2, num_heads, eps)
    err = kernels.library().segland_swin_block(
        _DTYPES[x_win.dtype], *args, x_win.device.index, kernels.stream_of(x_win))
    kernels.check(err, "swin_block")
    swin_block.launches += 1
    return out


swin_block.launches = 0


def swin_block_clocks(clocks, x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias, gamma2,
                      beta2, w1, b1, w2, b2, num_heads: int, eps: float = 1e-5):
    """A measurement, not the served kernel: the whole-block kernel's bf16 body
    built to add its consumers' clock64() time by phase (the section's seven,
    then LN2, the h epilogue and the MLP's output epilogue) and their count
    into ``clocks``, a CUDA int64 tensor of 11.  Takes swin_block's arguments;
    not counted in ``swin_block.launches``."""
    _check_clocks(clocks, x_win, 11)
    out, args = _block_launch_args(x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                                   gamma2, beta2, w1, b1, w2, b2, num_heads, eps)
    err = kernels.library().segland_swin_block_clocks(
        *args, kernels.ptr(clocks), x_win.device.index, kernels.stream_of(x_win))
    kernels.check(err, "swin_block_clocks")
    return out


def _window_bias(bias, qkv, num_heads, n):
    """The bias as K6 reads it: bf16 or fp32, contiguous [nW_img or 1, nh, N, N] on
    qkv's device, 4-byte aligned, nW_img dividing NW.  Raises ValueError otherwise.
    The fp32 body takes an fp32 bias: for fp32 qkv the bias is cast."""
    if bias.dtype not in _DTYPES:
        raise ValueError(f"window_attention takes a bfloat16 or float32 bias, not {bias.dtype}")
    if bias.device != qkv.device or bias.dim() != 4 or tuple(bias.shape[1:]) != (num_heads, n, n):
        raise ValueError(f"bias {tuple(bias.shape)} on {bias.device}; want "
                         f"[*, {num_heads}, {n}, {n}] on {qkv.device}")
    if not bias.is_contiguous() or bias.data_ptr() % 4:
        raise ValueError("window_attention takes a contiguous, 4-byte aligned bias")
    if qkv.shape[0] % bias.shape[0]:
        raise ValueError(f"{qkv.shape[0]} windows do not divide into images of {bias.shape[0]}")
    return bias.float() if qkv.dtype == torch.float32 else bias


def window_attention(qkv, bias, num_heads: int):
    """Launch the window-attention kernel K6 on CUDA qkv [NW, 49, 3C] (contiguous
    bf16 or fp32); bias [nW_img or 1, nh, 49, 49] in bf16 or fp32, read in its own
    dtype (see _window_bias).  bf16 qkv runs the ring body, fp32 qkv the fp32 body."""
    forward_only("window_attention", qkv, bias,
                 why="as in the JAX package, whose window_attention_fused has no VJP")
    _check_rows("window_attention", qkv)
    nw, n, c3 = qkv.shape
    c = c3 // 3
    if n != _WINDOW * _WINDOW or c3 != 3 * c or c != num_heads * _HEAD_DIM:
        raise ValueError(f"window_attention takes 7x7 windows and heads of 32; got N={n}, "
                         f"3C={c3}, heads={num_heads}")
    b = _window_bias(bias, qkv, num_heads, n)
    out = torch.empty((nw, n, c), dtype=qkv.dtype, device=qkv.device)
    P = kernels.ptr
    err = kernels.library().segland_window_attention(
        _DTYPES[qkv.dtype], P(qkv), _DTYPES[b.dtype], P(b), P(out), nw, c, num_heads,
        b.shape[0], qkv.device.index, kernels.stream_of(qkv))
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


def _section_dispatch(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads,
                      eps, regions, group, geom):
    if use_kernel(x_win):
        if geom is None:
            return attn_section_v1(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                                   num_heads, eps, regions=regions, group=group)
        return attn_section(x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                            num_heads, eps)
    return attn_section_reference(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj,
                                  bias, num_heads, eps, regions=regions)


def _block_dispatch(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias, gamma2, beta2,
                    w1, b1, w2, b2, num_heads, eps, regions, geom):
    if use_kernel(x_win):
        return swin_block(x_win, geom, gamma, beta, wqkv, bqkv, wproj, bproj, bias, gamma2,
                          beta2, w1, b1, w2, b2, num_heads, eps)
    return block_reference(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                           gamma2, beta2, w1, b1, w2, b2, num_heads, eps, regions=regions)


def _recompute_grads(ctx, n_diff, formulation, grad):
    """The backward of the two Functions: the saved differentiable inputs
    (the first ``n_diff`` saved tensors; then mask_tok and regions) through
    ``formulation`` under grad, differentiated against ``grad``."""
    saved = ctx.saved_tensors
    need = ctx.needs_input_grad[:n_diff]
    inputs = [a.detach().requires_grad_(r) for a, r in zip(saved[:n_diff], need)]
    mask_tok, regions = saved[n_diff:]
    with torch.enable_grad():
        out = formulation(inputs[0], mask_tok, *inputs[1:], ctx.num_heads, ctx.eps, regions)
    wrt = [a for a in inputs if a.requires_grad]
    found = iter(torch.autograd.grad(out, wrt, grad))
    return [next(found) if a.requires_grad else None for a in inputs]


class AttnSection(torch.autograd.Function):
    """K3 (``geom`` set) or K5 made differentiable as the JAX package's custom
    VJP makes B3 and B5 so: the forward is the dispatch (the kernel on CUDA,
    the plain version on the CPU), saving the inputs only; the backward
    recomputes :func:`attn_section_torch` from them and returns its gradients
    for x, gamma, beta, wqkv, bqkv, wproj, bproj and the rel-pos bias, whose
    gradient trains ``relative_position_bias_table``.  mask_tok and regions
    are constants.  A caller's ``weight.T`` view and bf16 cast of the gathered
    bias get their gradients through the view, the cast and the gather."""

    @staticmethod
    def forward(ctx, x_win, gamma, beta, wqkv, bqkv, wproj, bproj, bias, mask_tok, regions,
                num_heads, eps, group, geom):
        ctx.num_heads, ctx.eps = num_heads, eps
        ctx.save_for_backward(x_win, gamma, beta, wqkv, bqkv, wproj, bproj, bias, mask_tok,
                              regions)
        return _section_dispatch(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                                 num_heads, eps, regions, group, geom)

    @staticmethod
    def backward(ctx, grad):
        return (*_recompute_grads(ctx, 8, attn_section_torch, grad),) + (None,) * 6


class SwinBlockFn(torch.autograd.Function):
    """K4 made differentiable as the JAX package's custom VJP makes B4 so: the
    forward is the dispatch, saving the inputs only; the backward recomputes
    the stock-torch section and K1's recompute over it (``_block_torch``) and
    returns the gradients of all 14 differentiable inputs."""

    @staticmethod
    def forward(ctx, x_win, gamma, beta, wqkv, bqkv, wproj, bproj, bias, gamma2, beta2, w1, b1,
                w2, b2, mask_tok, regions, num_heads, eps, geom):
        ctx.num_heads, ctx.eps = num_heads, eps
        ctx.save_for_backward(x_win, gamma, beta, wqkv, bqkv, wproj, bproj, bias, gamma2, beta2,
                              w1, b1, w2, b2, mask_tok, regions)
        return _block_dispatch(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                               gamma2, beta2, w1, b1, w2, b2, num_heads, eps, regions, geom)

    @staticmethod
    def backward(ctx, grad):
        return (*_recompute_grads(ctx, 14, _block_torch, grad),) + (None,) * 5


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(a.requires_grad for a in tensors)


def swin_attn_section_fused(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                            num_heads: int, eps: float = 1e-5, regions=None, group: int = 1,
                            geom=None):
    """Fused LN + qkv + window attention + proj + residual over partitioned
    windows; x_win [NW, N, C] -> [NW, N, C].

    With ``geom = (h, w, hp, wp, ws, shift)`` a CUDA tensor goes to the kernel
    that derives the pad mask and the shift regions from it; ``mask_tok`` and
    ``regions`` (which must agree with it) then feed the plain version and
    the backward only.  Without ``geom`` it goes to the v1 kernel, which reads
    ``mask_tok`` and ``regions`` and attends ``group`` windows as one
    super-window.  ``group`` changes nothing in the plain version: the other
    windows' keys have weight zero.  With grad enabled and an input that
    requires it, through :class:`AttnSection`."""
    if geom is not None and group != 1:
        # ignoring it would make the knob a silent no-op
        raise ValueError("group != 1 is a knob of the v1 kernel; with geom set the "
                         "index-math kernel runs, which has no super-windows")
    args = (x_win, gamma, beta, wqkv, bqkv, wproj, bproj, bias)
    if _wants_grad(*args):
        return AttnSection.apply(*args, mask_tok, regions, num_heads, eps, group, geom)
    return _section_dispatch(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                             num_heads, eps, regions, group, geom)


def swin_block_fused(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias, gamma2,
                     beta2, w1, b1, w2, b2, num_heads: int, eps: float = 1e-5, regions=None,
                     geom=None):
    """A whole swin block (attention section, then LN2 + MLP + residual) over
    partitioned windows in one kernel; x_win [NW, N, C] -> [NW, N, C].

    The contract of :func:`swin_attn_section_fused` plus the MLP's parameters;
    ``geom`` is required.  With grad enabled and an input that requires it,
    through :class:`SwinBlockFn`.  The JAX function's ``hg`` is not taken
    here.  Its counterpart on this card, hg heads a pass, is the head-grouped
    section of ``ops/hg_attn.py`` (K9, K10); on an H100, measured on K9
    beside K3, it does not pay (PERF.md, ROADMAP A6), and no block or section
    route of a model runs it."""
    if geom is None:
        raise ValueError("swin_block_fused requires geom = (h, w, hp, wp, ws, shift)")
    args = (x_win, gamma, beta, wqkv, bqkv, wproj, bproj, bias, gamma2, beta2, w1, b1, w2, b2)
    if _wants_grad(*args):
        return SwinBlockFn.apply(*args, mask_tok, regions, num_heads, eps, geom)
    return _block_dispatch(x_win, mask_tok, gamma, beta, wqkv, bqkv, wproj, bproj, bias, gamma2,
                           beta2, w1, b1, w2, b2, num_heads, eps, regions, geom)
