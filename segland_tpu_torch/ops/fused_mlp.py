"""Fused LayerNorm + MLP + layer-scale + residual over [..., C] rows.

Port of segland_tpu/ops/pallas_mlp.py.  ``fused_ln_mlp`` dispatches on the
device (see ``ops/__init__.py``): CUDA tensors go to the kernel K1
(``kernels/csrc/ln_mlp.cu``) through :func:`ln_mlp`, CPU tensors to
:func:`ln_mlp_reference`.  Where a gradient is asked for, the same dispatch
runs inside :class:`LnMlp`, whose backward recomputes the plain version and
differentiates it, as the JAX package's custom VJP does with its XLA
reference (pallas_mlp.py:195-218).

    y   = LayerNorm(x) * gamma + beta     (fp32 stats, fast variance)
    h   = gelu(y @ w1 + b1)               (tanh form in bf16, exact erf in fp32)
    o   = (h @ w2 + b2) * ls              (ls optional: ConvNeXt layer-scale)
    out = res + o                         (res defaults to x)

Weights are input-major as in the JAX package: w1 [C, H], w2 [H, C].  The
bf16 kernel reads them K-major (w1^T [H, C], w2^T [C, H]: nn.Linear's own
[out, in] layout); :func:`kmajor` hands it a caller's transposed view as it
is and copies anything else.
"""

import collections

import torch
import torch.nn.functional as F

from . import forward_only, use_kernel
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

# ---- the bf16 kernel's builds (SEGLAND_MLP_BUILDS in kernels/csrc/ln_mlp.cu) ----------
# rg consumer warpgroups down the rows and cg across the output columns (two in all),
# np passes over the output columns, hs hidden columns a warpgroup and chunk, s ring
# slots of one [64, 64] bf16 weight tile each.
MlpBuild = collections.namedtuple("MlpBuild", "rg cg np hs s")
MLP_BUILDS = {
    96: MlpBuild(2, 1, 1, 128, 12),
    192: MlpBuild(2, 1, 1, 64, 16),
    384: MlpBuild(1, 2, 1, 64, 16),
    768: MlpBuild(1, 2, 2, 64, 12),
}
SMEM_MAX = 232448  # shared memory a block can have on sm_90
CONSUMER_REGS = 240  # registers a consumer thread gets by setmaxnreg (sm90.cuh)
TILE_BYTES = 64 * 64 * 2  # a ring slot


def ln_mlp_plan(c: int, hidden: int) -> dict:
    """The bf16 kernel's plan at width C and hidden width H: the arithmetic of
    MlpPlan in ln_mlp.cu.  Tile sizes, ring depth, shared memory by buffer and
    in all (bytes), and the accumulator and fragment registers a consumer
    thread holds.  Raises ValueError, with the arithmetic, for a shape that has
    no build."""
    if c not in MLP_BUILDS:
        raise ValueError(f"ln_mlp has no bfloat16 build for C={c}: built at C in "
                         f"{tuple(MLP_BUILDS)} (two warpgroups of m64 wgmma hold at most "
                         f"2 x 192 output columns a pass)")
    b = MLP_BUILDS[c]
    hc = b.cg * b.hs  # hidden columns a chunk
    if hidden <= 0 or hidden % hc:
        raise ValueError(f"ln_mlp at C={c} walks the hidden width in chunks of {b.cg} x "
                         f"{b.hs} = {hc} columns; H={hidden} is not a multiple of {hc}")
    cs = c // b.np // b.cg  # output columns a warpgroup and pass
    kt1, nt1, kt2, nt2 = -(-c // 64), b.hs // 64, hc // 64, -(-cs // 64)
    parts = dict(ring=b.s * TILE_BYTES, y=b.rg * kt1 * TILE_BYTES,
                 h=0 if b.cg == 1 else b.rg * 2 * kt2 * TILE_BYTES,
                 barriers=2 * b.s * 8, align=1024)
    regs = dict(acc1=nt1 * 32, acc2=nt2 * 32, h_frags=b.hs // 4 if b.cg == 1 else 0)
    plan = dict(b._asdict(), c=c, hidden=hidden, rows=64 * b.rg, hc=hc, cs=cs,
                chunks=hidden // hc, tiles_per_chunk=kt1 * b.cg * nt1 + kt2 * b.cg * nt2,
                smem_parts=parts, smem=sum(parts.values()), regs=regs,
                acc_regs=sum(regs.values()))
    if plan["smem"] > SMEM_MAX:
        raise ValueError(f"ln_mlp at C={c}: " + " + ".join(f"{k} {v:,}" for k, v in parts.items())
                         + f" = {plan['smem']:,} B > {SMEM_MAX:,}")
    return plan


def kmajor(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w.T`` contiguous in ``dtype``: ``w.T`` itself when it already is (the
    models pass ``weight.T`` of an nn.Linear, whose [out, in] layout is the
    K-major one), else a copy."""
    t = w.t()
    if t.dtype == dtype and t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return contiguous_as(t, dtype)


def _launch_args(x2, gamma, beta, w1, b1, w2, b2, res2, ls, eps):
    """Checks K1's inputs; returns its output buffer and the arguments that
    its C entries share (without dtype, device and stream)."""
    forward_only("ln_mlp", x2, gamma, beta, w1, b1, w2, b2, res2, ls)
    if not x2.is_cuda:
        raise ValueError("ln_mlp launches a CUDA kernel; got a tensor on " + str(x2.device))
    if x2.dtype not in _DTYPES:
        raise TypeError(f"ln_mlp takes bfloat16 or float32, not {x2.dtype}")
    if x2.dim() != 2 or not x2.is_contiguous():
        raise ValueError("ln_mlp takes contiguous [M, C] rows")
    m, c = x2.shape
    hidden = w1.shape[-1]
    if x2.dtype == torch.bfloat16:
        ln_mlp_plan(c, hidden)  # raises for a shape the kernel has no build for
    elif c not in _CHANNELS or hidden % 64:
        raise ValueError(f"ln_mlp has no float32 build for C={c}, H={hidden}")
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
        return a if a.data_ptr() % 16 == 0 else a.clone()  # the kernel reads pairs

    def mat(a):
        if a.device != dev:
            raise ValueError(f"weight on {a.device}; want {dev}")
        # bf16: K-major, as the wgmma B descriptor reads it; fp32: input-major
        return kmajor(a, cdt) if cdt == torch.bfloat16 else contiguous_as(a, cdt)

    g, b, bb1, bb2 = vec(gamma, c), vec(beta, c), vec(b1, hidden), vec(b2, c)
    l = None if ls is None else vec(ls, c)
    ww1, ww2 = mat(w1), mat(w2)
    out = torch.empty_like(x2)
    if any(t.data_ptr() % 16 for t in (x2, res2, ww1, ww2, out) if t is not None):
        raise ValueError("ln_mlp takes 16-byte aligned rows and weights")
    P = kernels.ptr
    return out, (P(x2), P(res2), P(g), P(b), P(ww1), P(bb1), P(ww2), P(bb2), P(l), P(out), m,
                 c, hidden, eps)


def ln_mlp(x2, gamma, beta, w1, b1, w2, b2, res2=None, ls=None, eps=1e-5):
    """Launch kernel K1 on CUDA rows x2 [M, C] (contiguous bf16 or fp32).
    Weights are cast to x2's dtype and vectors to fp32, as the JAX wrapper
    does; anything else the kernel does not take raises."""
    out, args = _launch_args(x2, gamma, beta, w1, b1, w2, b2, res2, ls, eps)
    err = kernels.library().segland_ln_mlp(_DTYPES[x2.dtype], *args, x2.device.index,
                                           kernels.stream_of(x2))
    kernels.check(err, "ln_mlp")
    ln_mlp.launches += 1
    ln_mlp.rows += x2.shape[0]
    return out


ln_mlp.launches = 0
ln_mlp.rows = 0  # M summed over those launches: more where pad tokens ride along


def ln_mlp_clocks(clocks, x2, gamma, beta, w1, b1, w2, b2, res2=None, ls=None, eps=1e-5):
    """A measurement, not the served kernel: K1's bf16 body built to add its
    consumers' clock64() time by phase (LN, ring wait, wgmma, h epilogue,
    output epilogue) and their count into ``clocks``, a CUDA int64 tensor of
    6.  Takes ln_mlp's arguments; not counted in ``ln_mlp.launches``."""
    if x2.dtype != torch.bfloat16 or clocks.dtype != torch.int64 or clocks.numel() < 6 \
            or clocks.device != x2.device:
        raise ValueError("clocks: an int64 tensor of 6 on the device, bf16 rows only")
    out, args = _launch_args(x2, gamma, beta, w1, b1, w2, b2, res2, ls, eps)
    err = kernels.library().segland_ln_mlp_clocks(*args, kernels.ptr(clocks), x2.device.index,
                                                  kernels.stream_of(x2))
    kernels.check(err, "ln_mlp_clocks")
    return out


def _ln_mlp_rows(x2, gamma, beta, w1, b1, w2, b2, res2, ls, eps):
    """The dispatch on [M, C] rows: K1 on CUDA, the plain version on the CPU."""
    if use_kernel(x2):
        return ln_mlp(x2, gamma, beta, w1, b1, w2, b2, res2, ls, eps)
    return ln_mlp_reference(x2, gamma, beta, w1, b1, w2, b2, res2, ls, eps)


class LnMlp(torch.autograd.Function):
    """K1 made differentiable the way the JAX package makes B1 so: the
    forward is the dispatch (the kernel on CUDA), and the backward recomputes
    :func:`ln_mlp_reference` from the saved inputs and returns its gradients
    for x, gamma, beta, w1, b1, w2, b2, res and ls.  The recompute keeps the
    kernel's dtype rules (tanh-GELU in bf16, erf in fp32).  A caller's
    ``weight.T`` view gets its gradient through the transpose."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, w1, b1, w2, b2, res2, ls, eps):
        ctx.eps = eps
        ctx.save_for_backward(x2, gamma, beta, w1, b1, w2, b2, res2, ls)
        return _ln_mlp_rows(x2, gamma, beta, w1, b1, w2, b2, res2, ls, eps)

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[:9]
        inputs = [None if a is None else a.detach().requires_grad_(n)
                  for a, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = ln_mlp_reference(*inputs, eps=ctx.eps)
        wrt = [a for a in inputs if a is not None and a.requires_grad]
        found = iter(torch.autograd.grad(out, wrt, grad))
        return (*(next(found) if a is not None and a.requires_grad else None
                  for a in inputs), None)


def fused_ln_mlp(x, gamma, beta, w1, b1, w2, b2, *, res=None, ls=None, eps=1e-5):
    """Fused LN+MLP(+layer-scale)+residual.  x: [..., C]; returns x's shape.
    With grad enabled and an input that requires it, through :class:`LnMlp`."""
    c = x.shape[-1]
    if use_kernel(x) and (not x.is_contiguous() or (res is not None and not res.is_contiguous())):
        raise ValueError("fused_ln_mlp takes contiguous x and res on CUDA")
    args = (x.reshape(-1, c), gamma, beta, w1, b1, w2, b2,
            None if res is None else res.reshape(-1, c), ls)
    if torch.is_grad_enabled() and any(a is not None and a.requires_grad for a in args):
        out = LnMlp.apply(*args, eps)
    else:
        out = _ln_mlp_rows(*args, eps)
    return out.view(x.shape)
