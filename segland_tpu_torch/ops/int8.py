"""Exact int8 products outside any kernel: what the JAX package leaves to
XLA's ``preferred_element_type=int32`` convolutions and dots.

Every sum here is an int32 sum of int8 x int8 products, on the CPU and on
the card alike.  (A float32 convolution over integer-valued tensors is not:
127^2 * 9 * 512 exceeds 2^24.)  ``torch._int_mm`` does the products; a k x k
convolution is one product per tap over a shifted, strided view of the
zero-padded input, summed in int32.
"""

import torch
import torch.nn.functional as F


def round_clip(x: torch.Tensor) -> torch.Tensor:
    """clip(round(x), -127, 127), round half to even, still floating."""
    return torch.clamp(torch.round(x), -127.0, 127.0)


def quantize_sym(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 quantization of fp32 ``x``; ``scale`` is a tensor that
    broadcasts against it (a true division: by a Python number, torch
    multiplies with the reciprocal on CUDA)."""
    return round_clip(x / scale).to(torch.int8)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M,K] @ int8 [K,N] -> int32 [M,N], exact.

    On CUDA ``torch._int_mm`` wants M > 16, K and N multiples of 8 and is
    given a row-major ``a`` and a column-major ``b`` (cuBLASLt's int8 "TN"
    form); smaller or ragged operands are zero-padded and the result cut."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int_matmul takes int8 operands, not {a.dtype} and {b.dtype}")
    if a.device.type == "cpu":
        return torch._int_mm(a.contiguous(), b)
    m, k = a.shape
    n = b.shape[1]
    pm, pk, pn = max(17 - m, 0), (-k) % 8, (-n) % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    if b.stride(0) != 1 or b.stride(1) != b.shape[0]:
        b = b.t().contiguous().t()
    out = torch._int_mm(a.contiguous(), b)
    return out[:m, :n] if (pm or pn) else out


def int8_conv2d(xq: torch.Tensor, w_oi: torch.Tensor, stride=(1, 1), padding=(0, 0),
                dilation=(1, 1)) -> torch.Tensor:
    """Exact int8 convolution.  xq int8 [B,H,W,Cin]; w_oi int8
    [kh,kw,Cout,Cin] (each tap out-major, so its transpose is the
    column-major operand ``int_matmul`` wants) -> int32 [B,Ho,Wo,Cout]."""
    b, h, w, cin = xq.shape
    kh, kw, cout, _ = w_oi.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    xp = F.pad(xq, (0, 0, pw, pw, ph, ph)) if (ph or pw) else xq
    acc = None
    for i in range(kh):
        for j in range(kw):
            tap = xp[:, i * dh:i * dh + (ho - 1) * sh + 1:sh,
                     j * dw:j * dw + (wo - 1) * sw + 1:sw]
            t = int_matmul(tap.reshape(-1, cin), w_oi[i, j].t())
            acc = t if acc is None else acc.add_(t)
    return acc.view(b, ho, wo, cout)
