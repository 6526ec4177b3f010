"""int8 ResNet bottleneck, fused: the whole eval-mode block, and its last
stage (conv3 + residual) alone.

Port of segland_tpu/ops/pallas_bottleneck.py.  ``fused_bottleneck_int8`` and
``conv3_residual_int8`` dispatch on the device (see ``ops/__init__.py``):
CUDA tensors go to the kernels K7 and K8 (``kernels/csrc/bottleneck_int8.cu``)
through :func:`bottleneck_int8` and :func:`conv3_residual`, CPU tensors to
:func:`bottleneck_int8_reference` and :func:`conv3_residual_reference`.

K8 is a persistent kernel over row tiles of 128 rows: a tile's h2q comes into
shared memory once and serves every column pass, w3's slices and the residual
stream in through two rings, and the output is written over the residual and
stored by TMA; :func:`conv3_plan` is its arithmetic.

K7 is two kernels behind one call: conv1 writes h1q (int8, [B,H,W,P]) into a
scratch tensor, conv23 reads it back by TMA, a box a tap, and runs conv2 and
conv3 on an 8 x 16 pixel tile.  :func:`conv1_reference` and
:func:`conv23_reference` are the plain versions of the two stages, and
:func:`bottleneck_plan` the tile arithmetic of both.

    xq  = clip(rint(x / s_x))                           x bf16 [B,H,W,C]
    h1q = clip(rint(relu(xq @ w1 * a1 + b1) / s_h1))    w1 int8 [C,P]
    h2q = clip(rint(relu(conv3x3_d(h1q, w2) * a2 + b2) / s_h2))   w2 int8 [3,3,P,P]
    out = relu?(h2q @ w3 * a3 + b3 + x) -> x.dtype      w3 int8 [P,C]

Stride 1, no downsample.  a*/b* are the folded dequant * BatchNorm affines
(a1 = s_x * s_w1 * bn1_scale, ...), fp32; the 3x3 zero-pads h1q; the residual
is x itself, not its dequantized int8.  Weights keep the JAX package's
layouts (input-major, HWIO).  Sums are exact int32; the fp32 steps run in
the order written, each rounded.
"""

import ctypes

import torch

from . import use_kernel
from .int8 import int8_conv2d, int_matmul, quantize_sym
from .. import kernels


def _scale(s, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(s, dtype=torch.float32, device=like.device)


def bottleneck_int8_reference(x, w1, w2, w3, a1, b1, a2, b2, a3, b3, s_x, s_h1, s_h2, *,
                              dilation: int = 1, last_relu: bool = True):
    """Plain PyTorch version: the JAX oracle's arithmetic step by step (it
    divides by the scales), with exact integer sums."""
    d = (dilation, dilation)
    xf = x.float()
    xq = quantize_sym(xf, _scale(s_x, x))
    acc1 = int8_conv2d(xq, w1.t()[None, None])
    h1 = torch.relu(acc1.float() * a1 + b1)
    h1q = quantize_sym(h1, _scale(s_h1, x))
    acc2 = int8_conv2d(h1q, w2.permute(0, 1, 3, 2), padding=d, dilation=d)
    h2 = torch.relu(acc2.float() * a2 + b2)
    h2q = quantize_sym(h2, _scale(s_h2, x))
    acc3 = int8_conv2d(h2q, w3.t()[None, None])
    o = acc3.float() * a3 + b3 + xf
    if last_relu:
        o = torch.relu(o)
    return o.to(x.dtype)


def conv1_reference(x, w1, a1, b1, s_x, s_h1):
    """Plain version of K7's first kernel: h1q int8 [B,H,W,P] =
    requant(relu(quant(x) @ w1 * a1 + b1)) over the image."""
    xq = quantize_sym(x.float(), _scale(s_x, x))
    h1 = torch.relu(int8_conv2d(xq, w1.t()[None, None]).float() * a1 + b1)
    return quantize_sym(h1, _scale(s_h1, x))


def conv23_reference(h1q, x, w2, w3, a2, b2, a3, b3, s_h2, *, dilation: int = 1,
                     last_relu: bool = True):
    """Plain version of K7's second kernel: conv2 over a given h1q int8
    [B,H,W,P], zero-padded, then conv3 and the residual x [B,H,W,C]."""
    d = (dilation, dilation)
    acc2 = int8_conv2d(h1q, w2.permute(0, 1, 3, 2), padding=d, dilation=d)
    h2q = quantize_sym(torch.relu(acc2.float() * a2 + b2), _scale(s_h2, x))
    o = int8_conv2d(h2q, w3.t()[None, None]).float() * a3 + b3 + x.float()
    if last_relu:
        o = torch.relu(o)
    return o.to(x.dtype)


def conv3_residual_reference(h2q, res, w3, a3, b3, *, last_relu: bool = True):
    """Plain PyTorch version of conv3 + BN3 + residual (+ ReLU): h2q int8
    [M,P], res [M,C], w3 int8 [P,C], a3/b3 fp32 [C] -> [M,C] in res.dtype."""
    o = int_matmul(h2q, w3).float() * a3 + b3 + res.float()
    if last_relu:
        o = torch.relu(o)
    return o.to(res.dtype)


def _vec(a, n: int, dev) -> torch.Tensor:
    a = torch.as_tensor(a).reshape(-1).float().contiguous()
    if a.numel() != n or a.device != dev:
        raise ValueError(f"vector of {a.numel()} on {a.device}; want {n} on {dev}")
    return a


def _weight(w, shape, dev) -> torch.Tensor:
    if w.dtype != torch.int8 or tuple(w.shape) != shape or w.device != dev:
        raise ValueError(f"weight {tuple(w.shape)} {w.dtype} on {w.device}; "
                         f"want int8 {shape} on {dev}")
    return w


def _check_widths(what: str, c: int, p: int):
    if c < 64 or c % 64 or p < 64 or p % 64:
        raise ValueError(f"{what} takes C and P that are multiples of 64, not C={c}, P={p}")


def _aligned(what: str, *tensors):
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what} takes 16-byte aligned tensors")


# ---- K7's plan (Conv1Plan and Conv23Plan in kernels/csrc/bottleneck_int8.cu) ----------
SMEM_MAX = 232448  # shared memory a block can have on sm_90
K7_WIDTHS = (64, 128, 256)  # the s8 wgmma widths K7 is built with (m64 nN k32)
K7_TILE = (8, 16)  # conv23's output tile, rows x columns: 128 pixels, 64 a warpgroup
K7_CHUNK = 64  # bytes of K (int8 channels) a ring slot holds
K7_SLOTS_MAX = 8
_K7_FIXED = 128 + 1024  # room for the mbarriers, and slack to align the tiles
K7_VEC = 256 * 8  # conv23: a pass's (a, b) columns, a warpgroup's


def bottleneck_plan(c: int, p: int, dilation: int) -> dict:
    """K7's plan at widths C, P: conv1's block rows, warpgroup columns, ring
    slots and shared memory, and conv23's tile, conv2 and conv3 columns a
    warpgroup and pass, ring slots and shared memory (bytes).  Raises
    ValueError, with the arithmetic, for widths the kernels do not take."""
    _check_widths("bottleneck_int8", c, p)
    if int(dilation) < 1:
        raise ValueError(f"bottleneck_int8 takes a dilation of 1 or more, not {dilation}")
    nw = min(p, 256)
    if nw not in K7_WIDTHS or p % nw:
        raise ValueError(f"bottleneck_int8 at P={p}: a warpgroup holds min(P, 256) = {nw} "
                         f"columns of conv1 and conv2, and its wgmma is built at widths "
                         f"{K7_WIDTHS} dividing P")
    cg = p // nw
    if cg > 2:
        raise ValueError(f"bottleneck_int8 at P={p}: conv1 keeps all P columns of its rows "
                         f"accumulating, {p} / {nw} = {cg} warpgroups of m64n{nw} int32, "
                         f"and a block has 2 consumer warpgroups")
    rows1 = 64 * (2 // cg)
    # a conv1 slot: the x rows as TMA brings them (bf16), their quantized rows, w1's slice;
    # beside the ring, (a1, b1) by column
    slot1 = rows1 * 2 * K7_CHUNK + rows1 * K7_CHUNK + p * K7_CHUNK
    s1 = min(K7_SLOTS_MAX, (SMEM_MAX - _K7_FIXED - 8 * p) // slot1)
    th, tw = K7_TILE
    nw3 = 128 if c % 128 == 0 else 64
    # a conv23 slot: a tap's h1q box and w2's slice, w3's slice, or 64 channels of residual
    slot2 = max(th * tw * K7_CHUNK + nw * K7_CHUNK, nw3 * K7_CHUNK, th * tw * 2 * K7_CHUNK)
    h2 = th * tw * p
    s2 = min(K7_SLOTS_MAX, (SMEM_MAX - _K7_FIXED - h2 - 2 * K7_VEC) // slot2)
    plan = dict(c=c, p=p, dilation=int(dilation),
                conv1=dict(rows=rows1, nw=nw, cg=cg, slots=s1, slot=slot1,
                           smem=s1 * slot1 + 8 * p + _K7_FIXED),
                conv23=dict(th=th, tw=tw, nw=nw, passes2=p // nw, nw3=nw3, passes3=c // nw3,
                            slots=s2, slot=slot2, h2=h2,
                            smem=s2 * slot2 + h2 + 2 * K7_VEC + _K7_FIXED))
    for stage, parts, least in (("conv1", f"{s1} slots x {slot1:,} + (a1, b1) {8 * p:,}", 2),
                                ("conv23", f"{s2} slots x {slot2:,} + h2q {h2:,} + "
                                           f"(a, b) 2 x {K7_VEC:,}", 2)):
        if plan[stage]["slots"] < least or plan[stage]["smem"] > SMEM_MAX:
            raise ValueError(f"bottleneck_int8 {stage} at C={c}, P={p}: {parts} + "
                             f"{_K7_FIXED:,} = {plan[stage]['smem']:,} B of shared memory, "
                             f"and its ring needs {least} slots within {SMEM_MAX:,}")
    return plan


def library_plan(c: int, p: int, dilation: int) -> dict:
    """The plan the built library gives (segland_bottleneck_int8_plan), in
    :func:`bottleneck_plan`'s terms, or None when it does not take the widths."""
    out = (ctypes.c_int * 10)()
    if not kernels.library().segland_bottleneck_int8_plan(c, p, int(dilation), out):
        return None
    rows, s1, slot1, smem1, th, tw, nw, nw3, s2, smem2 = list(out)
    return dict(conv1=dict(rows=rows, slots=s1, slot=slot1, smem=smem1),
                conv23=dict(th=th, tw=tw, nw=nw, nw3=nw3, slots=s2, smem=smem2))


def bottleneck_operands(x, w1, w2, w3, a1, b1, a2, b2, a3, b3, *, dilation: int = 1):
    """Checks K7's inputs and hands the weights over K-major: returns
    (w1t [P,C], w2t [9,P,P] as (tap, out, in), w3t [C,P], the six fp32
    vectors).  Anything the kernels do not take raises."""
    if not x.is_cuda:
        raise ValueError("bottleneck_int8 launches a CUDA kernel; got a tensor on "
                         + str(x.device))
    if x.dtype != torch.bfloat16:
        raise TypeError(f"bottleneck_int8 takes bfloat16, not {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("bottleneck_int8 takes a contiguous [B,H,W,C] tensor")
    c, p = x.shape[3], w1.shape[1]
    bottleneck_plan(c, p, dilation)  # raises on widths the kernels do not take
    dev = x.device
    w1t = _weight(w1, (c, p), dev).t().contiguous()
    w2t = _weight(w2, (3, 3, p, p), dev).permute(0, 1, 3, 2).reshape(9, p, p).contiguous()
    w3t = _weight(w3, (p, c), dev).t().contiguous()
    vecs = (_vec(a1, p, dev), _vec(b1, p, dev), _vec(a2, p, dev), _vec(b2, p, dev),
            _vec(a3, c, dev), _vec(b3, c, dev))
    _aligned("bottleneck_int8", x, w1t, w2t, w3t, *vecs)
    return w1t, w2t, w3t, vecs


def _clocks(clocks, n: int, like):
    """The measurement builds' clocks: a CUDA int64 tensor of n on like's device."""
    if clocks.dtype != torch.int64 or clocks.numel() < n or clocks.device != like.device:
        raise ValueError(f"clocks: an int64 tensor of {n} on {like.device}")
    return (kernels.ptr(clocks),)


def launch_conv1(x, w1t, a1, b1, s_x, s_h1, h1q, clocks=None):
    """K7's first kernel into h1q [B,H,W,P] (int8, contiguous, CUDA).  Counts
    nothing: :func:`bottleneck_int8` counts the block.  With ``clocks`` (an
    int64 tensor of 5) it launches the measurement build instead, which adds
    its consumers' clock64() time by phase (slot wait, quantize, wgmma,
    epilogue) and their count to ``clocks``."""
    bsz, h, w, c = x.shape
    p = w1t.shape[0]
    _aligned("bottleneck_int8", h1q)
    P = kernels.ptr
    lib = kernels.library()
    fn, extra = ((lib.segland_bottleneck_conv1, ()) if clocks is None else
                 (lib.segland_bottleneck_conv1_clocks, _clocks(clocks, 5, x)))
    err = fn(P(x), P(w1t), P(a1), P(b1), P(h1q), bsz * h * w, c, p, float(s_x), float(s_h1),
             *extra, x.device.index, kernels.stream_of(x))
    kernels.check(err, "bottleneck_int8 conv1")
    return h1q


def launch_conv23(h1q, x, w2t, w3t, a2, b2, a3, b3, s_h2, dilation, last_relu, out,
                  clocks=None):
    """K7's second kernel: conv2 and conv3 from h1q into out [B,H,W,C] (bf16,
    contiguous, CUDA).  Counts nothing: :func:`bottleneck_int8` counts the
    block.  With ``clocks`` (an int64 tensor of 7; C a multiple of 128) it
    launches the measurement build instead, which adds its consumers'
    clock64() time by phase (conv2 slot wait, wgmma, epilogue; the same of
    conv3) and their count to ``clocks``."""
    bsz, h, w, c = x.shape
    p = h1q.shape[3]
    _aligned("bottleneck_int8", out)
    P = kernels.ptr
    lib = kernels.library()
    fn, extra = ((lib.segland_bottleneck_conv23, ()) if clocks is None else
                 (lib.segland_bottleneck_conv23_clocks, _clocks(clocks, 7, x)))
    err = fn(P(h1q), P(x), P(w2t), P(w3t), P(a2), P(b2), P(a3), P(b3), P(out), bsz, h, w, c, p,
             int(dilation), int(bool(last_relu)), float(s_h2), *extra, x.device.index,
             kernels.stream_of(x))
    kernels.check(err, "bottleneck_int8 conv23")
    return out


def bottleneck_int8(x, w1, w2, w3, a1, b1, a2, b2, a3, b3, s_x, s_h1, s_h2, *,
                    dilation: int = 1, last_relu: bool = True):
    """Launch K7 on a CUDA x [B,H,W,C] (contiguous bfloat16): conv1 into an
    h1q scratch tensor, then conv23.  Any H and W; C a multiple of 64, P in
    64, 128, 256, 512 (see :func:`bottleneck_plan`); anything else raises."""
    w1t, w2t, w3t, (va1, vb1, va2, vb2, va3, vb3) = bottleneck_operands(
        x, w1, w2, w3, a1, b1, a2, b2, a3, b3, dilation=dilation)
    bsz, h, w, _ = x.shape
    h1q = torch.empty(bsz, h, w, w1t.shape[0], dtype=torch.int8, device=x.device)
    launch_conv1(x, w1t, va1, vb1, s_x, s_h1, h1q)
    out = launch_conv23(h1q, x, w2t, w3t, va2, vb2, va3, vb3, s_h2, dilation, last_relu,
                        torch.empty_like(x))
    bottleneck_int8.launches += 1
    return out


bottleneck_int8.launches = 0


# ---- K8's plan (Conv3Plan in kernels/csrc/bottleneck_int8.cu) ------------------------
K8_ROWS = 128  # a row tile, 64 rows a consumer warpgroup


def _k8_bars(kcmax: int) -> int:
    """Bytes of K8's barriers: W, R and h2q, full and empty."""
    return 8 * (2 * 8 + 2 * 8 + 2 * kcmax)


def conv3_plan(c: int, p: int) -> dict:
    """K8's plan at widths C, P: the row tile, columns a pass (NW3), the h2q
    chunks its build has room for (KCMAX: P <= 512 or <= 1024), the slots of
    its two rings (w3 slices, residual pieces) and the shared memory, in bytes.
    Raises ValueError, with the arithmetic, for widths it does not take."""
    _check_widths("conv3_residual", c, p)
    kc = p // K7_CHUNK
    if kc > 16:
        raise ValueError(f"conv3_residual at P={p}: a tile's h2q [{K8_ROWS}, P] stays in shared "
                         f"memory, {K8_ROWS * p:,} B, and its builds have room for P <= 1024")
    kcmax = 8 if kc <= 8 else 16
    nw3 = 128 if c % 128 == 0 else 64
    h2 = kcmax * K8_ROWS * K7_CHUNK
    wslot, rslot, vec = nw3 * K7_CHUNK, K8_ROWS * 2 * K7_CHUNK, nw3 * 8
    room = SMEM_MAX - 1024 - _k8_bars(kcmax) - h2 - 2 * vec
    sr = min(6, (room - 4 * wslot) // rslot)
    sw = min(8, (room - sr * rslot) // wslot)
    smem = h2 + sw * wslot + sr * rslot + 2 * vec + _k8_bars(kcmax) + 1024
    return dict(rows=K8_ROWS, nw3=nw3, passes=c // nw3, pieces=nw3 // 64, kc=kc, kcmax=kcmax,
                sw=sw, sr=sr, wslot=wslot, rslot=rslot, h2=h2, smem=smem)


def library_conv3_plan(c: int, p: int) -> dict:
    """The plan the built library gives (segland_conv3_residual_plan), in
    :func:`conv3_plan`'s terms, or None when it does not take the widths."""
    out = (ctypes.c_int * 6)()
    if not kernels.library().segland_conv3_residual_plan(c, p, out):
        return None
    return dict(zip(("rows", "nw3", "kcmax", "sw", "sr", "smem"), out))


def _conv3_operands(h2q, res, w3, a3, b3):
    if not res.is_cuda:
        raise ValueError("conv3_residual launches a CUDA kernel; got a tensor on "
                         + str(res.device))
    if res.dtype != torch.bfloat16 or h2q.dtype != torch.int8:
        raise TypeError(f"conv3_residual takes int8 h2q and bfloat16 res, not {h2q.dtype} "
                        f"and {res.dtype}")
    if h2q.dim() != 2 or res.dim() != 2 or not h2q.is_contiguous() or not res.is_contiguous():
        raise ValueError("conv3_residual takes contiguous [M,P] and [M,C] tensors")
    m, p = h2q.shape
    c = res.shape[1]
    dev = res.device
    if res.shape[0] != m or h2q.device != dev:
        raise ValueError(f"h2q {tuple(h2q.shape)} on {h2q.device} does not match res "
                         f"{tuple(res.shape)} on {dev}")
    conv3_plan(c, p)  # raises on widths the kernel does not take
    w3t = _weight(w3, (p, c), dev).t().contiguous()
    va3, vb3 = _vec(a3, c, dev), _vec(b3, c, dev)
    out = torch.empty_like(res)
    _aligned("conv3_residual", h2q, res, out, w3t, va3, vb3)
    return (h2q, res, w3t, va3, vb3, out), m, p, c


def _launch_conv3(entry, h2q, res, w3, a3, b3, last_relu, extra=()):
    args, m, p, c = _conv3_operands(h2q, res, w3, a3, b3)
    err = getattr(kernels.library(), entry)(
        *map(kernels.ptr, args), m, p, c, int(bool(last_relu)), *extra, res.device.index,
        kernels.stream_of(res))
    kernels.check(err, "conv3_residual")
    return args[-1]


def conv3_residual(h2q, res, w3, a3, b3, *, last_relu: bool = True):
    """Launch kernel K8: h2q int8 [M,P], res bfloat16 [M,C] (both contiguous,
    CUDA), w3 int8 [P,C].  Any M; C and P multiples of 64, P at most 1024."""
    out = _launch_conv3("segland_conv3_residual_int8", h2q, res, w3, a3, b3, last_relu)
    conv3_residual.launches += 1
    return out


def conv3_residual_clocks(clocks, h2q, res, w3, a3, b3, *, last_relu: bool = True):
    """A measurement, not the served kernel: K8 built to add its consumers'
    clock64() time by phase (slice wait, wgmma, residual wait, epilogue) and
    their count into ``clocks``, a CUDA int64 tensor of 5; C a multiple of 128,
    P at most 512.  Not counted in ``conv3_residual.launches``."""
    return _launch_conv3("segland_conv3_residual_int8_clocks", h2q, res, w3, a3, b3, last_relu,
                         _clocks(clocks, 5, res))


conv3_residual.launches = 0


def fused_bottleneck_int8(x, w1, w2, w3, a1, b1, a2, b2, a3, b3, s_x, s_h1, s_h2, *,
                          dilation: int = 1, last_relu: bool = True):
    """The whole block, x [B,H,W,C] -> [B,H,W,C]."""
    fn = bottleneck_int8 if use_kernel(x) else bottleneck_int8_reference
    return fn(x, w1, w2, w3, a1, b1, a2, b2, a3, b3, s_x, s_h1, s_h2,
              dilation=dilation, last_relu=last_relu)


def conv3_residual_int8(h2q, res, w3, a3, b3, *, last_relu: bool = True):
    """conv3 + BN3 + residual (+ ReLU) in one pass, [M,P] -> [M,C]."""
    fn = conv3_residual if use_kernel(res) else conv3_residual_reference
    return fn(h2q, res, w3, a3, b3, last_relu=last_relu)
