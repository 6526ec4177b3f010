"""Ensemble serving: every member runs on the same batch, the
members' logits are summed on the device, and only the uint8 argmax leaves
it.  Port of segland_tpu/evallib/ensemble.py.

The reference fuses its contest ensemble through per-model ``.mat`` maps
averaged on the host (eval_base.py:190-191 + fusemat.py:26-53).  Here the
members run one after another on one stream, so no member's fp32 logits are
fetched.  Numerics follow fusemat: the mean of the members' upsampled maps,
then the argmax (the mean's 1/N cannot change the argmax).
"""

import time
from typing import Optional, Sequence

import torch

from ..metrics import confusion_matrix, miou_from_cmatrix
from ..ops import plain_versions
from ..ops.fused_epilogue import upsample_argmax
from ..ops.resize import resize_bilinear
from .infer import IMAGENET_MEAN, IMAGENET_STD, Staging


class EnsembleEvaluator(Staging):
    """Members: a sequence of models (nn.Module), moved to ``device`` and put
    in eval mode; they run on the same normalized batch and their logits are
    bilinear-upsampled (align_corners=True, the eval protocol) to the output
    size, summed and argmaxed.  ``plain_kernels=True`` runs every kernel's
    plain version, as in ``Evaluator``.  Under a process group each rank runs
    its share of each batch and ``run`` sums the confusion matrices over the
    ranks, as ``Evaluator`` does."""

    def __init__(self, members: Sequence[torch.nn.Module], device, num_classes: int = 12,
                 n_base: int = 7, ignore_label: int = 255, normalize_on_device: bool = False,
                 mean=IMAGENET_MEAN, std=IMAGENET_STD, plain_kernels: bool = False):
        super().__init__(device, num_classes, n_base, ignore_label, normalize_on_device, mean,
                         std, plain_kernels)
        self.members = [m.to(self.device).eval() for m in members]

    def _group_sums(self, img):
        """{native (h, w): fp32 sum of the members' NHWC logits at it}.  Bilinear
        upsampling is linear, so a group's sum is upsampled once."""
        x = self._pre(img)
        by_res = {}
        for model in self.members:
            logits = model(x).permute(0, 2, 3, 1).float()
            res = tuple(logits.shape[1:3])
            by_res[res] = logits if res not in by_res else by_res[res] + logits
        return by_res

    def _upsampled_sum(self, by_res, out_hw):
        acc = None
        for summed in by_res.values():
            up = resize_bilinear(summed, out_hw, align_corners=True)
            acc = up if acc is None else acc + up
        return acc

    def _device_batch(self, images, batch_pad):
        host, b = images if isinstance(images, tuple) else self._stage(images, batch_pad)
        return host.to(self.device, non_blocking=True), b

    @torch.inference_mode()
    def predict_batch(self, images, out_hw, batch_pad: Optional[int] = None):
        """images [B,H,W,3] (or a staged (host tensor, true batch) pair) ->
        pred [B,oh,ow] uint8 on the device.  With one native resolution that
        is not the output's, the summed map goes through upsample_argmax (K2
        on CUDA): the upsampled fp32 map never exists."""
        img, b = self._device_batch(images, batch_pad)
        out_hw = (int(out_hw[0]), int(out_hw[1]))
        with plain_versions(self.plain_kernels):
            by_res = self._group_sums(img)
            (res, summed), *more = by_res.items()
            if not more and res != out_hw:
                pred = upsample_argmax(summed.contiguous(), out_hw)
            else:
                pred = self._upsampled_sum(by_res, out_hw).argmax(-1).to(torch.uint8)
        return pred[:b]

    @torch.inference_mode()
    def summed_logits(self, images, out_hw, batch_pad: Optional[int] = None):
        """The [B,oh,ow,K] fp32 sum of the members' upsampled logits that
        predict_batch argmaxes, on the device."""
        img, b = self._device_batch(images, batch_pad)
        with plain_versions(self.plain_kernels):
            return self._upsampled_sum(self._group_sums(img), out_hw)[:b]

    @torch.inference_mode()
    def run(self, loader, logger=None):
        """mIoU epoch over labelled tiles: the confusion matrix is built on the
        device.  Returns (cmatrix, (base, novel, total, iou), tiles/sec)."""
        cm_dev = torch.zeros((self.num_classes, self.num_classes), dtype=torch.int64,
                             device=self.device)
        n_tiles = 0
        t0 = time.perf_counter()
        batches = self._prefetch((self._stage(images), self._stage_labels(labels, False), ids)
                                 for images, labels, ids in loader)
        for staged, labels, ids in batches:
            if labels is None:
                raise ValueError(f"ensemble run scores labelled tiles; {ids[0]} has no label")
            gt = labels.to(self.device, non_blocking=True)
            pred = self.predict_batch(staged, gt.shape[-2:])
            cm_dev += confusion_matrix(gt, pred, self.num_classes, self.ignore_label)
            n_tiles += len(ids)
        cm, n_tiles, dt = self._across_ranks(cm_dev, n_tiles, t0)
        base, novel, total, iou = miou_from_cmatrix(cm, self.n_base)
        if logger:
            logger.info(f"ensemble eval: {n_tiles} tiles in {dt:.1f}s "
                        f"({n_tiles / max(dt, 1e-9):.1f} tiles/s)")
        return cm, (base, novel, total, iou), n_tiles / max(dt, 1e-9)
