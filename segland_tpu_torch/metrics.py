"""Confusion matrix on the device and mIoU from it.  Port of
segland_tpu/metrics.py (reference utils/pyt_utils.py:182-200; mIoU split
into base/novel/total as in eval_base.py:193-199)."""

import numpy as np
import torch


def confusion_matrix(gt: torch.Tensor, pred: torch.Tensor, num_classes: int,
                     ignore_index: int = 255) -> torch.Tensor:
    """[K, K] int64 counts over non-ignored pixels; rows = gt, cols = pred.
    Pixels whose gt is out of range are dropped, as jnp.bincount's
    ``length`` drops them."""
    gt = gt.reshape(-1).long()
    idx = torch.where(gt != ignore_index, gt * num_classes + pred.reshape(-1).long(),
                      num_classes * num_classes)
    counts = torch.bincount(idx, minlength=num_classes * num_classes + 1)
    return counts[: num_classes * num_classes].reshape(num_classes, num_classes)


def miou_from_cmatrix(cm, n_base: int):
    """(base_miou, novel_miou, total_miou, per_class_iou).  base = classes
    [0..n_base] incl. background, novel = the rest; NaN classes are left out
    through nanmean."""
    cm = np.asarray(cm, dtype=np.float64)
    pos = cm.sum(1)
    res = cm.sum(0)
    tp = np.diag(cm)
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = tp / (pos + res - tp)
    base = np.nanmean(iou[: n_base + 1])
    novel = np.nanmean(iou[n_base + 1:]) if len(iou) > n_base + 1 else float("nan")
    total = np.nanmean(iou)
    return base, novel, total, iou
