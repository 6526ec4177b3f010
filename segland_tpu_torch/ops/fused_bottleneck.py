"""int8 ResNet bottleneck, fused: the whole eval-mode block, and its last
stage (conv3 + residual) alone.

Port of segland_tpu/ops/pallas_bottleneck.py.  ``fused_bottleneck_int8`` and
``conv3_residual_int8`` dispatch on the device (see ``ops/__init__.py``):
CUDA tensors go to the kernels K7 and K8 (``kernels/csrc/bottleneck_int8.cu``)
through :func:`bottleneck_int8` and :func:`conv3_residual`, CPU tensors to
:func:`bottleneck_int8_reference` and :func:`conv3_residual_reference`.

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


def bottleneck_int8(x, w1, w2, w3, a1, b1, a2, b2, a3, b3, s_x, s_h1, s_h2, *,
                    dilation: int = 1, last_relu: bool = True):
    """Launch kernel K7 on a CUDA x [B,H,W,C] (contiguous bfloat16).  Any H
    and W; C and P multiples of 64; anything else raises.  The weights are
    handed over out-major ([P,C], [9,P,P] as (tap, out, in), [C,P])."""
    if not x.is_cuda:
        raise ValueError("bottleneck_int8 launches a CUDA kernel; got a tensor on "
                         + str(x.device))
    if x.dtype != torch.bfloat16:
        raise TypeError(f"bottleneck_int8 takes bfloat16, not {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("bottleneck_int8 takes a contiguous [B,H,W,C] tensor")
    bsz, h, w, c = x.shape
    p = w1.shape[1]
    d = int(dilation)
    _check_widths("bottleneck_int8", c, p)
    if d < 1:
        raise ValueError(f"dilation {dilation}")
    dev = x.device
    bottleneck_tile(c, p, d)  # raises when no tile fits a block's shared memory
    w1t = _weight(w1, (c, p), dev).t().contiguous()
    w2t = _weight(w2, (3, 3, p, p), dev).permute(0, 1, 3, 2).reshape(9, p, p).contiguous()
    w3t = _weight(w3, (p, c), dev).t().contiguous()
    va1, vb1, va2, vb2 = _vec(a1, p, dev), _vec(b1, p, dev), _vec(a2, p, dev), _vec(b2, p, dev)
    va3, vb3 = _vec(a3, c, dev), _vec(b3, c, dev)
    out = torch.empty_like(x)
    _aligned("bottleneck_int8", x, out, w1t, w2t, w3t, va1, vb1, va2, vb2, va3, vb3)
    P = kernels.ptr
    err = kernels.library().segland_bottleneck_int8(
        P(x), P(w1t), P(w2t), P(w3t), P(va1), P(vb1), P(va2), P(vb2), P(va3), P(vb3), P(out),
        bsz, h, w, c, p, d, int(bool(last_relu)), float(s_x), float(s_h1), float(s_h2),
        dev.index, kernels.stream_of(x))
    kernels.check(err, "bottleneck_int8")
    bottleneck_int8.launches += 1
    return out


bottleneck_int8.launches = 0


def bottleneck_tile(c: int, p: int, dilation: int):
    """(tile rows, tile columns, shared-memory bytes) K7 gives these widths."""
    th, tw, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if not kernels.library().segland_bottleneck_int8_tile(c, p, int(dilation), th, tw, smem):
        raise ValueError(f"no tile fits C={c}, P={p}, dilation={dilation}")
    return th.value, tw.value, smem.value


def conv3_residual(h2q, res, w3, a3, b3, *, last_relu: bool = True):
    """Launch kernel K8: h2q int8 [M,P], res bfloat16 [M,C] (both contiguous,
    CUDA), w3 int8 [P,C].  Any M; C and P multiples of 64."""
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
    _check_widths("conv3_residual", c, p)
    w3t = _weight(w3, (p, c), dev).t().contiguous()
    va3, vb3 = _vec(a3, c, dev), _vec(b3, c, dev)
    out = torch.empty_like(res)
    _aligned("conv3_residual", h2q, res, out, w3t, va3, vb3)
    P = kernels.ptr
    err = kernels.library().segland_conv3_residual_int8(
        P(h2q), P(res), P(w3t), P(va3), P(vb3), P(out), m, p, c, int(bool(last_relu)),
        dev.index, kernels.stream_of(res))
    kernels.check(err, "conv3_residual")
    conv3_residual.launches += 1
    return out


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
