"""Whole-tile batched inference, confusion matrix on the device, export.

Port of segland_tpu/evallib/infer.py.  Batches arrive as [B,H,W,3] arrays
(uint8 with ``normalize_on_device``, else normalized float32); logits are
upsampled to label size with align_corners=True and argmaxed on the device
(eval_base.py:168).  The mIoU path runs the fused epilogue (kernel K2 on
CUDA) and only uint8 class maps ever exist.

Without labels ``run`` hands each batch's GTiff and .mat writes to a pool of
``export_workers`` threads, as the JAX ``Evaluator`` does, so that the next
batch's forward does not wait for the disk; the device-to-host copies stay
on the loop's thread.

Under a process group each rank runs its share of each global batch (the
``Loader``'s process shards, as the JAX mesh shards a batch), writes the
exports of its own tiles, and the confusion matrices and tile counts are
summed over the ranks at the end of ``run``, so every rank reports the same
mIoU.  int8 calibration takes each global batch whole
(``quant.calibrate_across_ranks``), as the JAX package calibrates on the
mesh's global batch.
"""

import collections
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from .. import dist
from ..metrics import confusion_matrix, miou_from_cmatrix
from ..ops import plain_versions
from ..ops.fused_epilogue import upsample_argmax
from ..ops.resize import resize_bilinear

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Staging:
    """What ``Evaluator`` and ``EnsembleEvaluator`` share: the device,
    the class counts, normalization on the device, and host batches staged
    in pinned memory by a thread ahead of the consumer."""

    def __init__(self, device, num_classes: int = 12, n_base: int = 7,
                 ignore_label: int = 255, normalize_on_device: bool = False,
                 mean=IMAGENET_MEAN, std=IMAGENET_STD, plain_kernels: bool = False):
        self.device = torch.device(device)
        self.num_classes = num_classes
        self.n_base = n_base
        self.ignore_label = ignore_label
        self.normalize_on_device = normalize_on_device
        self._mean = torch.tensor(mean, dtype=torch.float32, device=self.device)
        self._std = torch.tensor(std, dtype=torch.float32, device=self.device)
        self.plain_kernels = plain_kernels

    def _across_ranks(self, cm_dev, n_tiles: int, t0: float, error=None):
        """(confusion matrix summed over the ranks as float64 numpy, tiles over
        the ranks, seconds): the ranks wait for each other here.  ``error``, an
        export error of this rank, is raised after the all-reduce, and every
        other rank raises too, so that none is left waiting in a collective."""
        n = torch.tensor([n_tiles, error is not None], dtype=torch.int64, device=self.device)
        dist.all_reduce_sum(cm_dev, group=dist.stats_group())
        dist.all_reduce_sum(n, group=dist.stats_group())
        if error is not None:
            raise error
        if int(n[1]):
            raise RuntimeError(f"the exports of {int(n[1])} of {dist.world()} ranks failed")
        cm = cm_dev.cpu().numpy().astype(np.float64)
        return cm, int(n[0]), time.perf_counter() - t0

    def _pre(self, img):
        """[B,H,W,3] on the device -> normalized NCHW fp32 (channels-last)."""
        if self.normalize_on_device:
            # BGR->RGB flip, /255, -mean, /std (dataset/base_dataset.py:29-34)
            img = img.flip(-1).float() / 255.0
            img = (img - self._mean) / self._std
        return img.permute(0, 3, 1, 2)

    def _host(self, a: np.ndarray) -> torch.Tensor:
        """A host copy of ``a`` the device can read asynchronously (pinned on
        CUDA); a copy, because loaders may reuse their buffers."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if self.device.type == "cuda" else t.clone()

    def _stage(self, images, batch_pad: Optional[int] = None):
        """Zero-pad a host batch to ``batch_pad`` and pin it.  Returns
        (host tensor, true batch)."""
        images = images if isinstance(images, np.ndarray) else np.stack(images, 0)
        b = images.shape[0]
        pad = (-b) % (batch_pad or b)
        if pad:
            images = np.concatenate(
                [images, np.zeros((pad,) + images.shape[1:], images.dtype)], 0)
        return self._host(images), b

    def _stage_labels(self, labels, square_pad_eval: bool):
        """Host labels -> pinned [B,H,W] (uint8 where the classes fit), or
        None for an unlabeled batch.  square_pad_eval ignore-pads them to
        (longside, longside)."""
        if (labels[0] if isinstance(labels, list) else labels) is None:
            return None
        labels = np.stack(labels, 0) if isinstance(labels, list) else np.asarray(labels)
        if square_pad_eval:
            lh, lw = labels.shape[-2:]
            side = max(lh, lw)
            labels = np.pad(labels, ((0, 0), (0, side - lh), (0, side - lw)),
                            constant_values=self.ignore_label)
        if self.num_classes <= 255 and self.ignore_label == 255:
            labels = labels.astype(np.uint8)  # 4x less h2d than int32
        return self._host(labels)

    @staticmethod
    def _prefetch(batches, depth: int = 2):
        """Run the ``batches`` iterator on a thread, ``depth`` items ahead of
        the consumer.  An error in it is raised here, in the consumer."""
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        done = object()
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for item in batches:
                    if not put(item):
                        return
                put(done)
            except BaseException as e:  # handed to the consumer, which raises it
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()


class Evaluator(Staging):
    """``plain_kernels=True`` runs every kernel's plain PyTorch version, even
    on CUDA: it exists to hold the kernels against their plain versions, and
    no CLI sets it.

    ``int8=True`` is the PTQ serving mode (``quant/ptq.py``): the first
    ``calib_batches`` calls of ``predict_batch`` also run a calibration
    forward (a running abs-max, so the scales always cover the current
    batch), and every prediction takes the int8 conv/linear path.  ``quant``,
    activation scales calibrated beforehand ({module name: act_amax}), skips
    that warm-up.  Under a process group (one rank included) a calibration
    forward is one of the global batch, and every rank makes it: ``run``
    makes it with an empty share for the global batches that leave this rank
    none, so that each rank calibrates on ``min(calib_batches, len(loader))``
    global batches."""

    def __init__(self, model, device, num_classes: int = 12, n_base: int = 7,
                 ignore_label: int = 255, normalize_on_device: bool = False,
                 mean=IMAGENET_MEAN, std=IMAGENET_STD, plain_kernels: bool = False,
                 int8: bool = False, calib_batches: int = 4, quant_cfg=None, quant=None):
        super().__init__(device, num_classes, n_base, ignore_label, normalize_on_device, mean,
                         std, plain_kernels)
        self.model = model.to(self.device).eval()
        self.int8 = int8
        if int8:
            from ..quant import DEFAULT_CONFIG, ActScales, quantized_apply

            self._quant_cfg = quant_cfg or DEFAULT_CONFIG
            self._quant = ActScales()
            if quant:
                self._quant.update({k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
                                    for k, v in quant.items()})
                calib_batches = 0
            elif calib_batches < 1:
                raise ValueError("int8=True needs calib_batches >= 1 or pre-calibrated "
                                 "scales in quant")
            self._q_apply = quantized_apply(self.model, self._quant_cfg)
        self.calib_batches = calib_batches
        self._calib_seen = 0

    def _forward(self, x):
        """NCHW logits of a normalized batch, by the int8 path when asked."""
        if not self.int8:
            return self.model(x)
        if self._calib_seen < self.calib_batches:
            self._calibrate(x)
        return self._q_apply(self._quant, x)

    def _calibrate(self, x):
        """One calibration forward; over ranks, of the global batch whose share
        of this rank is ``x`` (None: empty)."""
        from ..quant import calibrate_across_ranks, quant_interceptor

        if dist.is_initialized():
            calibrate_across_ranks(self.model, x, self._quant, self._quant_cfg,
                                   dist.stats_group())
        else:
            with quant_interceptor(self.model, "calibrate", self._quant_cfg, self._quant):
                self.model(x)
        self._calib_seen += 1

    def _postprocess(self, logits, out_h, out_w, want_logits=True):
        """(B,h,w,K) logits -> (upsampled fp32 logits or None, uint8 preds)."""
        if not want_logits:
            return None, upsample_argmax(logits, (out_h, out_w))
        up = resize_bilinear(logits.float(), (out_h, out_w), align_corners=True)
        return up, up.argmax(-1).to(torch.uint8)

    @torch.inference_mode()
    def predict_batch(self, images, out_hw, batch_pad: Optional[int] = None,
                      want_logits: bool = True):
        """images [B,H,W,3] -> (logits [B,oh,ow,K] fp32 or None, pred [B,oh,ow]
        uint8), both on the device.  A ragged batch is zero-padded to
        ``batch_pad`` and the padded rows are sliced off the outputs."""
        host, b = images if isinstance(images, tuple) else self._stage(images, batch_pad)
        img = host.to(self.device, non_blocking=True)
        with plain_versions(self.plain_kernels):
            logits = self._forward(self._pre(img)).permute(0, 2, 3, 1)
            logits, pred = self._postprocess(logits.contiguous(), int(out_hw[0]),
                                             int(out_hw[1]), want_logits)
        if img.shape[0] != b:
            logits = logits[:b] if logits is not None else None
            pred = pred[:b]
        return logits, pred

    @torch.inference_mode()
    def run(self, loader, save_path: Optional[str] = None,
            prob_path: Optional[str] = None, data_root: Optional[str] = None,
            colormap=None, square_pad_eval: bool = False, logger=None,
            export_workers: int = 4):
        """Full eval epoch.  Returns (cmatrix, (base, novel, total, iou),
        tiles/sec).

        With GT: accumulate the confusion matrix on the device.  Without GT:
        write colormapped GTiff predictions and, with ``prob_path``, per-tile
        .mat maps of the upsampled logits (reference eval_base.py:160-191), on
        a pool of ``export_workers`` threads.  The loop waits for the oldest
        batch's writes once ``2 * export_workers`` batches are pending, which
        bounds the host memory they hold; a write error is raised before
        ``run`` returns (at once in one process; over ranks after the
        confusion matrices' all-reduce, on every rank).

        square_pad_eval: eval_ft protocol -- upsample logits to (longside,
        longside) and ignore-pad the GT (eval_ft.py:168-178).
        """
        cm_dev = torch.zeros((self.num_classes, self.num_classes), dtype=torch.int64,
                             device=self.device)
        n_tiles = 0
        t0 = time.perf_counter()
        # the global batches this run calibrates on, each rank on every one of them
        calib_due = (min(self.calib_batches, self._calib_seen + len(loader))
                     if self.int8 and dist.is_initialized() else 0)
        pending = collections.deque()
        error = None

        def settle(keep):
            nonlocal error
            while len(pending) > keep:
                try:
                    pending.popleft().result()
                except Exception as e:
                    if dist.world() == 1:
                        raise
                    error = error or e  # raised on every rank after the all-reduce

        # decode and pin on the host, off the thread that feeds the device
        batches = self._prefetch(
            (self._stage(images), self._stage_labels(labels, square_pad_eval), ids)
            for images, labels, ids in loader)
        pool = ThreadPoolExecutor(export_workers, thread_name_prefix="segland-export")
        try:
            for staged, labels, ids in batches:
                if labels is not None:
                    gt = labels.to(self.device, non_blocking=True)
                    _, pred = self.predict_batch(staged, gt.shape[-2:], want_logits=False)
                    cm_dev += confusion_matrix(gt, pred, self.num_classes, self.ignore_label)
                else:
                    lh, lw = staged[0].shape[1:3]
                    logits, pred = self.predict_batch(staged, (lh, lw),
                                                      want_logits=prob_path is not None)
                    pred_np = pred.cpu().numpy() if save_path else None
                    logits_np = logits.cpu().numpy() if prob_path else None
                    if error is None:
                        pending.append(pool.submit(self._export, ids, pred_np, logits_np,
                                                   save_path, prob_path, data_root, colormap))
                        settle(2 * export_workers)
                n_tiles += len(ids)
            while self._calib_seen < calib_due:  # this rank's shares of them were empty
                self._calibrate(None)
            settle(0)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
        cm, n_tiles, dt = self._across_ranks(cm_dev, n_tiles, t0, error)
        base, novel, total, iou = miou_from_cmatrix(cm, self.n_base)
        if logger:
            logger.info(f"eval: {n_tiles} tiles in {dt:.1f}s "
                        f"({n_tiles / max(dt, 1e-9):.1f} tiles/s)")
        return cm, (base, novel, total, iou), n_tiles / max(dt, 1e-9)

    @staticmethod
    def _export(ids, pred_np, logits_np, save_path, prob_path, data_root, colormap):
        """One batch's files, on an export thread."""
        from ..data.tileio import OEM_COLORMAP, write_pred_tiff, write_prob_mat

        for i, tid in enumerate(ids):
            if save_path:
                src = os.path.join(data_root, "images", f"{tid}.tif") if data_root else None
                write_pred_tiff(os.path.join(save_path, f"{tid}.tif"), pred_np[i],
                                colormap or OEM_COLORMAP, src)
            if prob_path:
                # NCHW layout for fusemat byte-compat (eval_base.py:190)
                write_prob_mat(os.path.join(prob_path, f"{tid}.mat"),
                               np.transpose(logits_np[i], (2, 0, 1))[None])
