"""Segmentation losses as fp32 functions returning loss dicts.  Port of
segland_tpu/losses.py (reference loss/criterion.py): CELoss (optionally +
0.4 * aux) and OrthLoss (CE + 10 * mean |upper triangle| of the prototype
cosine matrix).  Logits are [B, h, w, K], the JAX package's layout, and are
bilinearly upsampled to the label size with align_corners=True before the
CE (loss/criterion.py:18,51).  Under a process group the CE is the global
batch's mean (``cross_entropy``); the orth term is replicated and stays as
it is.
"""

import torch

from .dist import all_reduce_sum, stats_group, world
from .ops.resize import resize_bilinear

ORTH_WEIGHT = 10.0  # reference loss/criterion.py:35
AUX_WEIGHT = 0.4    # reference loss/criterion.py:23


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = 255) -> torch.Tensor:
    """Mean CE over the pixels whose label is in [0, K) and not ignored.
    logits [B, H, W, K], labels [B, H, W] int.  Other labels count as
    ignored, as in the JAX package; ``F.cross_entropy`` would assert on them."""
    logits = logits.float()
    labels = labels.long()
    valid = (labels != ignore_index) & (labels >= 0) & (labels < logits.shape[-1])
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    nll = -torch.log_softmax(logits, -1).gather(-1, safe[..., None])[..., 0]
    total = torch.where(valid, nll, torch.zeros_like(nll)).sum()
    group = stats_group()
    if group is None:
        return total / valid.sum().clamp_min(1)
    # Under a process group the mean is the global batch's: the sum over every rank's
    # pixels over their global count (segland_tpu/losses.py:32-33 under GSPMD).  DDP
    # averages the ranks' gradients, so each rank differentiates its own sum over the
    # global count times the world size; the value returned is the global mean.
    sums = all_reduce_sum(torch.stack([total.detach().double(), valid.sum().double()]),
                          group=group)
    count = sums[1].clamp_min(1)
    scaled = total / count.float() * world()
    return scaled + ((sums[0] / count).float() - scaled).detach()


def _upsampled_ce(logits, labels, ignore_index):
    up = resize_bilinear(logits.float(), labels.shape[-2:], align_corners=True)
    return cross_entropy(up, labels, ignore_index)


def orth_penalty(proto_sim: torch.Tensor) -> torch.Tensor:
    """Mean |sim| over the strict upper triangle (reference criterion.py:37-43),
    for square [K, K] and rectangular [K1, K2] (fine-tune) matrices."""
    mask = torch.ones_like(proto_sim, dtype=torch.bool).triu(1)
    return (proto_sim.abs() * mask).sum() / mask.sum().clamp_min(1)


def ce_loss(logits, labels, aux_logits=None, ignore_index: int = 255):
    """CELoss: {'total_loss'[, 'main_loss', 'aux_loss']}."""
    main = _upsampled_ce(logits, labels, ignore_index)
    if aux_logits is None:
        return {"total_loss": main}
    aux = _upsampled_ce(aux_logits, labels, ignore_index)
    return {"total_loss": main + AUX_WEIGHT * aux, "main_loss": main, "aux_loss": aux}


def orth_loss(logits, labels, proto_sim, aux_logits=None, ignore_index: int = 255):
    """OrthLoss: CE + 10 * orth (+ 0.4 * aux), the reference's loss-dict keys."""
    seg = _upsampled_ce(logits, labels, ignore_index)
    orth = orth_penalty(proto_sim)
    if aux_logits is None:
        return {"total_loss": seg + ORTH_WEIGHT * orth, "seg_loss": seg, "orth_loss": orth}
    aux = _upsampled_ce(aux_logits, labels, ignore_index)
    return {"total_loss": seg + ORTH_WEIGHT * orth + AUX_WEIGHT * aux, "seg_loss": seg,
            "aux_loss": aux, "orth_loss": orth}


def get_loss(model_name: str):
    """POP heads use OrthLoss, plain heads CELoss (reference loss/__init__.py:3-8
    selects by substring)."""
    return orth_loss if "pop" in model_name else ce_loss
