"""OpenEarthMap datasets, host-side (reference dataset/oem.py).  Own copy of
segland_tpu/data/oem.py: ``OEMTrainDataset`` (its host path) and
``OEMValDataset``.

Returns NHWC images.  Class split: base {1..7}, novel {8..11}, 0 = background
(reference oem.py:32-34).
"""

import os
import os.path as osp
import random as _random

import numpy as np

from . import augment as A
from .tileio import read_image, read_label

NUM_CLASSES = 11
BASE_CLASSES = tuple(range(1, 8))
NOVEL_CLASSES = tuple(range(8, NUM_CLASSES + 1))


class OEMTrainDataset:
    """Base-training dataset (reference GFSSegTrain, oem.py:12-76).

    Pipeline: crop -> pad -> flip -> rot90 -> normalize(0.5, 0.5, 0.5).  The
    list is ``train.txt`` beside ``list_path``, as upstream reads it.  With
    ``device_augment`` an item is the raw uint8 tile and its label, which the
    train step augments on the device (``ops/device_aug.py``): every tile is
    brought to ``device_tile_size`` so that a batch stacks to one shape (a
    smaller tile padded, image 0 and label ignore; a larger one raises)."""

    num_classes = NUM_CLASSES

    def __init__(self, root: str, list_path: str, crop_size=(512, 512),
                 ignore_label: int = 255, seed: int = 123, device_augment: bool = False,
                 device_tile_size=(1024, 1024)):
        self.root = root
        self.crop_size = tuple(crop_size)
        self.ignore_label = ignore_label
        self.device_augment = device_augment
        self.device_tile_size = tuple(device_tile_size)
        train_list = os.path.join(os.path.dirname(list_path), "train.txt")
        if not os.path.exists(train_list):
            raise FileNotFoundError(train_list)
        with open(train_list) as f:
            self.data_list = f.read().splitlines()
        self.set_seed(seed)

    def set_seed(self, seed: int):
        """Per-epoch reseed (reference train_base.py:236-237)."""
        self.rng = _random.Random(seed)
        self.nprng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.data_list)

    def __getitem__(self, index: int):
        tid = self.data_list[index]
        image = read_image(osp.join(self.root, "images", f"{tid}.tif"))
        label = read_label(osp.join(self.root, "labels", f"{tid}.tif")).astype(np.int32)
        if self.device_augment:
            return self._raw_tile(tid, image, label)
        image, label = A.crop_train(self.nprng, image, label, self.crop_size, self.ignore_label)
        image, label = A.pad(self.crop_size, image, label, self.ignore_label)
        image, label = A.random_flip(self.rng, image, label)
        image, label = A.fixed_random_rotate(self.rng, image, label)
        image = A.normalize(image, A.OEM_TRAIN_MEAN, A.OEM_TRAIN_STD)
        return np.ascontiguousarray(image), np.ascontiguousarray(label), tid

    def _raw_tile(self, tid, image, label):
        """The tile at ``device_tile_size`` (segland_tpu/data/oem.py:62-75)."""
        (h, w), (th, tw) = label.shape, self.device_tile_size
        if h > th or w > tw:
            raise ValueError(f"tile {tid} is {(h, w)}, larger than device_tile_size {(th, tw)}: "
                             "--device-augment needs a uniform raw tile shape; raise "
                             "device_tile_size or use the host augmentations")
        if h < th or w < tw:
            image = np.pad(image, ((0, th - h), (0, tw - w), (0, 0)))
            label = np.pad(label, ((0, th - h), (0, tw - w)), constant_values=self.ignore_label)
        return (np.ascontiguousarray(image.astype(np.uint8)), np.ascontiguousarray(label), tid)


class OEMValDataset:
    """Validation / test dataset (reference GFSSegVal, oem.py:78-149).

    Remaps raw labels to contiguous eval ids: base -> 1..7 (list order),
    novel -> 8..11, everything else 0.  Keeps ImageNet normalization (the
    reference does NOT override mean/std here — a deliberate asymmetry with
    the train set that must be preserved for mIoU parity).
    """

    num_classes = NUM_CLASSES

    def __init__(self, root: str, list_path: str, base_size=(1024, 1024),
                 resize_label: bool = False, use_novel: bool = True,
                 use_base: bool = True, ignore_label: int = 255,
                 device_normalize: bool = False, stats: str = "imagenet"):
        self.root = root
        self.mean, self.std = A.STATS[stats]
        self.base_size = tuple(base_size)
        self.resize_label = resize_label
        self.use_novel = use_novel
        self.use_base = use_base
        self.ignore_label = ignore_label
        # device_normalize: return raw uint8 tiles; the consumer does the
        # BGR-flip/scale/normalize on the device (4x less host->device
        # traffic, no host float math).  The numpy normalize stays for
        # reference-exact parity tests.
        self.device_normalize = device_normalize
        with open(list_path) as f:
            self.ids = f.read().splitlines()
        # ring of reused batch buffers for the native fast path (first-touch
        # page faults on fresh >128MB host allocations can be slow — see
        # native._out_buffer). 4 slots cover Loader prefetch=2 + consumer +
        # in-flight write.
        self._bufs = {}
        self._buf_slot = 0

    def __len__(self):
        return len(self.ids)

    def remap(self, label: np.ndarray) -> np.ndarray:
        new_label = label.copy()
        base_list = list(BASE_CLASSES)
        novel_list = list(NOVEL_CLASSES)
        for c in np.unique(label).tolist():
            if c in base_list:
                new_label[label == c] = (base_list.index(c) + 1) if self.use_base else 0
            elif c in novel_list:
                if self.use_novel:
                    off = len(base_list) + 1 if self.use_base else 1
                    new_label[label == c] = novel_list.index(c) + off
                else:
                    new_label[label == c] = 0
        return new_label

    def _normalize(self, image):
        if self.device_normalize:
            return image  # raw uint8 HWC; normalization fused on device
        return A.normalize(image, self.mean, self.std)

    def __getitem__(self, index: int):
        tid = self.ids[index]
        image = read_image(osp.join(self.root, "images", f"{tid}.tif"))
        label_path = osp.join(self.root, "labels", f"{tid}.tif")
        if os.path.exists(label_path):
            label = self.remap(read_label(label_path).astype(np.int32))
            if self.resize_label:
                image, label = A.resize_to_base(image, label, self.base_size)
                image = self._normalize(image)
                image, label = A.pad(self.base_size, image, label, self.ignore_label)
            else:
                image = self._normalize(image)
            return np.ascontiguousarray(image), np.ascontiguousarray(label), tid
        image = self._normalize(image)
        return np.ascontiguousarray(image), None, tid

    def _buffer(self, shape, dtype):
        self._buf_slot = (self._buf_slot + 1) % 4
        key = (shape, np.dtype(dtype).str, self._buf_slot)
        buf = self._bufs.get(key)
        if buf is None:
            buf = self._bufs[key] = np.empty(shape, dtype)
        return buf

    def get_batch(self, indices):
        """Batched fast path (used by Loader when present): one native
        OpenMP decode call for the whole batch's images — GIL-free, fused
        with normalization unless device_normalize.  Returns a collated
        (images, labels, ids) tuple, or None to make the Loader fall back
        to the per-item path (native lib missing, odd-sized tiles,
        resize_label protocol, or a batch mixing labeled/unlabeled ids)."""
        from .. import native

        if self.resize_label or native.get_lib() is None:
            return None
        h, w = self.base_size
        tids = [self.ids[i] for i in indices]
        img_paths = [osp.join(self.root, "images", f"{t}.tif") for t in tids]
        lab_paths = [osp.join(self.root, "labels", f"{t}.tif") for t in tids]
        have = [os.path.exists(p) for p in lab_paths]
        if any(have) != all(have):
            return None
        n = len(indices)
        if self.device_normalize:
            images = native.decode_batch(
                img_paths, h, w, 3, out=self._buffer((n, h, w, 3), np.uint8))
        else:
            images = native.decode_normalize_batch(
                img_paths, h, w, self.mean, self.std,
                out=self._buffer((n, h, w, 3), np.float32))
        if images is None:
            return None
        if not all(have):
            return images, [None] * n, tids
        labels = np.stack(
            [self.remap(read_label(p).astype(np.int32)) for p in lab_paths], 0)
        return images, labels, tids
