"""Fused LayerNorm + MLP + layer-scale + residual over [..., C] rows.

Port of segland_tpu/ops/pallas_mlp.py.  ``fused_ln_mlp`` dispatches on the
device (see ``ops/__init__.py``): CUDA tensors go to the kernel K1
(``kernels/csrc/ln_mlp.cu``) through :func:`ln_mlp`, CPU tensors to
:func:`ln_mlp_reference`.

    y   = LayerNorm(x) * gamma + beta     (fp32 stats, fast variance)
    h   = gelu(y @ w1 + b1)               (tanh form in bf16, exact erf in fp32)
    o   = (h @ w2 + b2) * ls              (ls optional: ConvNeXt layer-scale)
    out = res + o                         (res defaults to x)

Weights are input-major as in the JAX package: w1 [C, H], w2 [H, C].
"""

import torch
import torch.nn.functional as F

from . import use_kernel
from .. import kernels


def ln_mlp_reference(x, gamma, beta, w1, b1, w2, b2, res=None, ls=None, eps=1e-5):
    """Plain PyTorch version, with the kernel's rounding points: stats and
    normalization in fp32, products in x.dtype with fp32 accumulate, each
    bias/scale/residual step rounded to x.dtype, GELU in fp32."""
    cdt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = (y * gamma.float() + beta.float()).to(cdt)
    h = (y @ w1.to(cdt)) + b1.to(cdt)
    approx = "tanh" if cdt == torch.bfloat16 else "none"
    h = F.gelu(h.float(), approximate=approx).to(cdt)
    o = (h @ w2.to(cdt)) + b2.to(cdt)
    if ls is not None:
        o = o * ls.to(cdt)
    return (x if res is None else res) + o


def contiguous_as(a: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``a`` in ``dtype`` and row-major, with at most one copy.  (``Tensor.to``
    returns ``a`` itself, strides and all, when the dtype already matches.)"""
    return a.to(dtype, memory_format=torch.contiguous_format).contiguous()


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CHANNELS = (96, 192, 384, 768)


def ln_mlp(x2, gamma, beta, w1, b1, w2, b2, res2=None, ls=None, eps=1e-5):
    """Launch kernel K1 on CUDA rows x2 [M, C] (contiguous bf16 or fp32).
    Weights are cast to x2's dtype and vectors to fp32, as the JAX wrapper
    does; anything else the kernel does not take raises."""
    if not x2.is_cuda:
        raise ValueError("ln_mlp launches a CUDA kernel; got a tensor on " + str(x2.device))
    if x2.dtype not in _DTYPES:
        raise TypeError(f"ln_mlp takes bfloat16 or float32, not {x2.dtype}")
    if x2.dim() != 2 or not x2.is_contiguous():
        raise ValueError("ln_mlp takes contiguous [M, C] rows")
    m, c = x2.shape
    hidden = w1.shape[-1]
    if c not in _CHANNELS or hidden % 64:
        raise ValueError(f"ln_mlp has no build for C={c}, H={hidden}")
    if tuple(w1.shape) != (c, hidden) or tuple(w2.shape) != (hidden, c):
        raise ValueError(f"weight shapes {tuple(w1.shape)}, {tuple(w2.shape)} "
                         f"do not match C={c}, H={hidden}")
    if res2 is not None and (res2.shape != x2.shape or res2.dtype != x2.dtype
                             or res2.device != x2.device or not res2.is_contiguous()):
        raise ValueError("res must be a contiguous tensor like x")
    cdt, dev = x2.dtype, x2.device

    def vec(a, n):
        a = a.reshape(-1).float().contiguous()
        if a.numel() != n or a.device != dev:
            raise ValueError(f"vector of {a.numel()} on {a.device}; want {n} on {dev}")
        return a

    def mat(a):
        if a.device != dev:
            raise ValueError(f"weight on {a.device}; want {dev}")
        return contiguous_as(a, cdt)

    g, b, bb1, bb2 = vec(gamma, c), vec(beta, c), vec(b1, hidden), vec(b2, c)
    l = None if ls is None else vec(ls, c)
    ww1, ww2 = mat(w1), mat(w2)
    out = torch.empty_like(x2)
    if any(t.data_ptr() % 16 for t in (x2, res2, ww1, ww2, out) if t is not None):
        raise ValueError("ln_mlp takes 16-byte aligned rows and weights")
    P = kernels.ptr
    err = kernels.library().segland_ln_mlp(
        _DTYPES[cdt], P(x2), P(res2), P(g), P(b), P(ww1), P(bb1), P(ww2), P(bb2),
        P(l), P(out), m, c, hidden, eps, dev.index, kernels.stream_of(x2))
    kernels.check(err, "ln_mlp")
    ln_mlp.launches += 1
    ln_mlp.rows += m
    return out


ln_mlp.launches = 0
ln_mlp.rows = 0  # M summed over those launches: more where pad tokens ride along


def fused_ln_mlp(x, gamma, beta, w1, b1, w2, b2, *, res=None, ls=None, eps=1e-5):
    """Fused LN+MLP(+layer-scale)+residual.  x: [..., C]; returns x's shape."""
    c = x.shape[-1]
    if use_kernel(x):
        if not x.is_contiguous() or (res is not None and not res.is_contiguous()):
            raise ValueError("fused_ln_mlp takes contiguous x and res on CUDA")
        out = ln_mlp(x.view(-1, c), gamma, beta, w1, b1, w2, b2,
                     None if res is None else res.view(-1, c), ls, eps)
    else:
        out = ln_mlp_reference(x.reshape(-1, c), gamma, beta, w1, b1, w2, b2,
                               None if res is None else res.reshape(-1, c), ls, eps)
    return out.view(x.shape)
