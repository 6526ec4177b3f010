"""Confusion matrix and intersection/union on the device, mIoU from the
matrix.  Port of segland_tpu/metrics.py (reference utils/pyt_utils.py:182-200
and :278-305; mIoU split into base/novel/total as in eval_base.py:193-199)."""

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


def intersection_and_union(pred: torch.Tensor, gt: torch.Tensor, num_classes: int,
                           ignore_index: int = 255):
    """Per-class (intersection, union, target) int64 counts [K] (reference
    utils/pyt_utils.py:293-305): the prediction is masked to ignore where the
    ground truth is.  As jnp.bincount counts them, values past K - 1 are
    dropped and negative ones land in class 0."""
    gt = gt.reshape(-1).long()
    pred = pred.reshape(-1).long()
    valid = gt != ignore_index
    pred = torch.where(valid, pred, ignore_index)

    def hist(v):
        v = v.clamp(0, num_classes)
        return torch.bincount(v, minlength=num_classes + 1)[:num_classes]

    area_inter = hist(torch.where((pred == gt) & valid, pred, num_classes))
    area_pred = hist(torch.where(valid, pred, num_classes))
    area_gt = hist(torch.where(valid, gt, num_classes))
    return area_inter, area_pred + area_gt - area_inter, area_gt


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
