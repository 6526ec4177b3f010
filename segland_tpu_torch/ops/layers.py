"""``nn.Conv2d``, ``nn.Linear`` and ``nn.BatchNorm2d`` as the port's models
apply them: fp32 parameters cast to the input's dtype at use, as flax does;
BatchNorm on its running statistics in eval mode and, as flax's
``nn.BatchNorm(use_running_average=False)``, on the batch's in train mode.

``conv2d`` and ``linear`` first look for a ``forward`` set on the instance:
an open ``quant_interceptor`` (``quant/ptq.py``) puts its calibrating or quantized
path there, and ``module(x)`` would find the same one.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.nn.functional import all_reduce as all_reduce_autograd

from ..dist import stats_group

# cuDNN has no fast bfloat16 channels-last kernel for a 3x3 convolution whose
# dilation is large: on an H100 (torch 2.11, CUDA 12.8) [8,2048,128,128] -> 256
# takes 1.6 ms at dilation 6 and 2.4 s at dilation 12.  Above this dilation the
# convolution runs as nine shifted 1x1 products instead (9.9 ms there).
TAPS_ABOVE_DILATION = 6


def _conv_by_taps(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A stride-1, zero-padded 3x3 convolution as a sum over its taps, each a
    1x1 product over a shifted window of the padded input, summed in fp32.  A
    tap whose window lies wholly in the padding is skipped."""
    (dh, dw), (ph, pw) = m.dilation, m.padding
    h, w = x.shape[-2:]
    oh, ow = h + 2 * ph - 2 * dh, w + 2 * pw - 2 * dw
    weight = m.weight.to(x.dtype)
    xp = F.pad(x, (pw, pw, ph, ph))
    out = None
    for i in range(3):
        for j in range(3):
            top, left = i * dh, j * dw
            if top + oh <= ph or top >= ph + h or left + ow <= pw or left >= pw + w:
                continue
            y = F.conv2d(xp[:, :, top:top + oh, left:left + ow], weight[:, :, i:i + 1, j:j + 1])
            out = y.float() if out is None else out.add_(y)
    if out is None:
        out = x.new_zeros((x.shape[0], m.out_channels, oh, ow), dtype=torch.float32)
    if m.bias is not None:
        out = out + m.bias.float()[:, None, None]
    return out.to(x.dtype)


def conv2d_plain(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``m`` applied in x's dtype, whatever ``forward`` the instance carries."""
    if (m.kernel_size == (3, 3) and min(m.dilation) > TAPS_ABOVE_DILATION and m.groups == 1
            and m.stride == (1, 1) and not isinstance(m.padding, str)
            and m.padding_mode == "zeros" and x.dim() == 4):
        return _conv_by_taps(m, x)
    b = None if m.bias is None else m.bias.to(x.dtype)
    return F.conv2d(x, m.weight.to(x.dtype), b, m.stride, m.padding, m.dilation, m.groups)


def linear_plain(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, m.weight.to(x.dtype), None if m.bias is None else m.bias.to(x.dtype))


def batch_norm(m: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm of an NCHW map with fp32 parameters, output in x's dtype.

    Eval mode (``m.training`` False) normalises with the running statistics.
    Train mode follows flax: the batch's mean and *biased* variance over
    (B, H, W), taken in fp32 as E[x^2] - E[x]^2 (clamped at 0), normalise x,
    and the running statistics move by ``m.momentum`` (torch's convention:
    flax's momentum 0.9 is 0.1 here, ASPP's 0.001 is 0.999) towards them.
    ``F.batch_norm`` would put the unbiased variance into ``running_var``
    (and refuses a channel of one value), so the statistics are computed
    here.  ``num_batches_tracked`` is not advanced: the momentum is fixed.

    Under a process group (``dist.init_from_env``) the statistics are the
    global batch's, as GSPMD takes them over the JAX package's data mesh:
    each rank's per-channel sum, sum of squares and count are summed over the
    ranks by an autograd-aware all-reduce (its backward sums the gradients
    over the ranks), then the same E[x^2] - E[x]^2.  ``nn.SyncBatchNorm`` is
    not used: it refuses CPU tensors and writes the unbiased variance."""
    if not m.training:
        return F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias, False, 0.0,
                            m.eps)
    xf = x.float()
    group = stats_group()
    if group is None:
        mean = xf.mean((0, 2, 3))
        var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
    else:
        c = xf.shape[1]
        count = torch.full((1,), float(xf.numel() // c), device=xf.device)
        sums = all_reduce_autograd(torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), count]),
                                   group=group)
        mean = sums[:c] / sums[2 * c]
        var = (sums[c:2 * c] / sums[2 * c] - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        m.running_mean.lerp_(mean, m.momentum)
        m.running_var.lerp_(var, m.momentum)
    scale = torch.rsqrt(var + m.eps) * m.weight
    y = (xf - mean[:, None, None]) * scale[:, None, None] + m.bias[:, None, None]
    return y.to(x.dtype)


def conv2d(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``m`` applied in x's dtype; a ``forward`` set on the instance takes the call."""
    taken = m.__dict__.get("forward")
    return conv2d_plain(m, x) if taken is None else taken(x)


def linear(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``m`` applied in x's dtype; a ``forward`` set on the instance takes the call."""
    taken = m.__dict__.get("forward")
    return linear_plain(m, x) if taken is None else taken(x)
