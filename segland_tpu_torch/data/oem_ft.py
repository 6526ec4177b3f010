"""Episodic OEM fine-tune dataset (reference dataset/oem_ft.py).  Own copy
of segland_tpu/data/oem_ft.py (numpy only).

Each item is a PAIR: a random novel-support sample (background relabeled to
ignore, oem_ft.py:197) and a base-class sample, independently augmented.
Per-class base id lists are scanned from label tiles and cached as
``train_base_class<c>.txt`` next to the list file (oem_ft.py:33-57);
``update_base_list()`` resamples ``shot`` base images per class each epoch
(oem_ft.py:72-124, called from ft_pop.py:271-272).
"""

import os
import os.path as osp
import random as _random
from collections import defaultdict

import numpy as np

from . import augment as A
from .oem import BASE_CLASSES, NOVEL_CLASSES, NUM_CLASSES
from .tileio import read_image, read_label


class OEMFtTrainDataset:
    num_classes = NUM_CLASSES

    def __init__(self, root: str, list_path: str, shot: int = 5, seed: int = 123,
                 crop_size=(512, 512), ignore_label: int = 255, mode: str = "train",
                 use_base: bool = True, filter: bool = False,
                 stats: str = "imagenet"):
        if mode not in ("train", "val_supp"):
            raise ValueError(f"mode {mode!r}: 'train' or 'val_supp'")
        self.root = root
        self.mean, self.std = A.STATS[stats]
        self.shot = shot
        self.mode = mode
        self.crop_size = tuple(crop_size)
        self.ignore_label = ignore_label
        self.use_base = use_base
        self.rng = _random.Random(seed)
        self.nprng = np.random.RandomState(seed)
        # --filter-novel (reference oem_ft.py:32-35,276-281): base-support
        # candidates are restricted to images containing NO novel classes,
        # and the whole list DIRECTORY gets a "_filter" suffix — the
        # per-class caches AND the all_<shot>shot support list are read from
        # <list_dir>_filter (upstream expects that dir to be user-prepared;
        # we additionally create it when writing fresh caches, and fall back
        # to the unfiltered shot list if the filtered dir lacks one)
        self.filter = bool(filter) and mode == "train"

        list_dir = os.path.dirname(list_path)
        if self.filter:
            list_dir = list_dir + "_filter"
        self.list_dir = list_dir
        first = os.path.join(list_dir, f"train_base_class{BASE_CLASSES[0]}.txt")
        if os.path.exists(first):
            self.base_cls_to_ids = defaultdict(list)
            for cls in BASE_CLASSES:
                with open(os.path.join(list_dir, f"train_base_class{cls}.txt")) as f:
                    self.base_cls_to_ids[cls] = f.read().splitlines()
        else:
            with open(list_path) as f:
                self.ids = f.read().splitlines()
            self.base_cls_to_ids, self.novel_cls_to_ids = self._filter_and_map_ids()
            os.makedirs(list_dir, exist_ok=True)
            for cls in BASE_CLASSES:
                with open(os.path.join(list_dir, f"train_base_class{cls}.txt"), "w") as f:
                    f.writelines(i + "\n" for i in self.base_cls_to_ids[cls])

        shot_list = os.path.join(list_dir, f"all_{shot}shot_seed{seed}.txt")
        if self.filter and not os.path.exists(shot_list):
            shot_list = os.path.join(os.path.dirname(list_path),
                                     f"all_{shot}shot_seed{seed}.txt")

        with open(shot_list) as f:
            self.novel_id_list = f.read().splitlines()
        if use_base:
            self.base_id_list = self._sample_base_list()
        else:
            self.base_id_list = []

    def set_seed(self, seed: int):
        self.rng = _random.Random(seed)
        self.nprng = np.random.RandomState(seed)

    def _label_classes(self, tid):
        label = read_label(osp.join(self.root, "labels", f"{tid}.tif"))
        cls = np.unique(label).tolist()
        if 0 in cls:
            cls.remove(0)
        return set(cls)

    def _filter_and_map_ids(self):
        """Scan label tiles, map class -> containing image ids
        (reference oem_ft.py:262-300).  With self.filter (--filter-novel),
        a base class only counts images whose classes are a SUBSET of the
        base set — i.e. novel-free tiles (oem_ft.py:276-281)."""
        base_map, novel_map = defaultdict(list), defaultdict(list)
        for tid in self.ids:
            classes = self._label_classes(tid)
            if not self.filter or classes.issubset(set(BASE_CLASSES)):
                for cls in classes & set(BASE_CLASSES):
                    base_map[cls].append(tid)
            for cls in classes & set(NOVEL_CLASSES):
                novel_map[cls].append(tid)
        return base_map, novel_map

    def _sample_base_list(self):
        """Sample ``shot`` images per base class, repeat-extended when scarce
        (reference oem_ft.py:126-181). Also counts base images containing
        novel classes (checksum-style log of the reference)."""
        base_id_list = []
        base_with_novel = 0
        for cls in BASE_CLASSES:
            chosen = self.base_cls_to_ids[cls]
            n = len(chosen)
            if n == 0:
                continue
            if n < self.shot:
                picks = list(chosen) + [chosen[self.rng.randint(1, n) - 1]
                                        for _ in range(self.shot - n)]
            else:
                picks = [chosen[i] for i in self.rng.choices(range(n), k=self.shot)]
            for tid in picks:
                base_id_list.append(tid)
                if not self._label_classes(tid).issubset(set(BASE_CLASSES)):
                    base_with_novel += 1
        self._base_with_novel = base_with_novel
        return base_id_list

    def update_base_list(self):
        """Per-epoch base-support resampling (reference ft_pop.py:271-272)."""
        self.base_id_list = self._sample_base_list()

    def __len__(self):
        if self.mode == "val_supp":
            n = len(NOVEL_CLASSES)
            return n + len(BASE_CLASSES) if self.use_base else n
        return len(self.base_id_list)

    def _load_pair(self, tid):
        image = read_image(osp.join(self.root, "images", f"{tid}.tif"))
        label = read_label(osp.join(self.root, "labels", f"{tid}.tif")).astype(np.int32)
        return image, label

    def _augment(self, image, label):
        image, label = A.crop_train(self.nprng, image, label, self.crop_size, self.ignore_label)
        image, label = A.pad(self.crop_size, image, label, self.ignore_label)
        image, label = A.random_flip(self.rng, image, label)
        image, label = A.fixed_random_rotate(self.rng, image, label)
        # ImageNet stats by default: oem_ft does NOT override mean/std
        # (unlike oem train); ``stats="train"`` opts out of the asymmetry
        image = A.normalize(image, self.mean, self.std)
        return np.ascontiguousarray(image), np.ascontiguousarray(label)

    def __getitem__(self, index: int):
        if self.mode == "val_supp":
            return self._get_val_support(index)
        tid_b = self.base_id_list[index]
        tid = self.rng.choice(self.novel_id_list)
        image, label = self._load_pair(tid)
        label = np.where(label == 0, self.ignore_label, label).astype(np.int32)
        image_b, label_b = self._load_pair(tid_b)
        image, label = self._augment(image, label)
        image_b, label_b = self._augment(image_b, label_b)
        return image, label, image_b, label_b, tid

    def _get_val_support(self, index: int):
        """Per-class binarized support sets (reference oem_ft.py:222-260)."""
        if self.use_base:
            if index < len(BASE_CLASSES):
                cls_id_list, cls_idx = self.base_id_list, index
                target_cls = BASE_CLASSES[index]
            else:
                cls_idx = index - len(BASE_CLASSES)
                cls_id_list = self.novel_id_list
                target_cls = NOVEL_CLASSES[cls_idx]
        else:
            cls_id_list, cls_idx = self.novel_id_list, index
            target_cls = NOVEL_CLASSES[index]
        images, labels, ids = [], [], []
        for k in range(self.shot):
            tid = cls_id_list[cls_idx * self.shot + k]
            image, label = self._load_pair(tid)
            new_label = label.copy()
            new_label[(label != target_cls) & (label != self.ignore_label)] = 0
            new_label[label == target_cls] = 1
            # +-10-degree rotate with retry-until-target-present, then flip
            # (reference oem_ft.py:251-252; val_supp uses ImageNet padding)
            image, new_label = A.random_rotate(
                self.rng, image, new_label, ignore_label=self.ignore_label)
            image, new_label = A.random_flip(self.rng, image, new_label)
            image = A.normalize(image, self.mean, self.std)
            images.append(np.ascontiguousarray(image))
            labels.append(np.ascontiguousarray(new_label))
            ids.append(tid)
        return images, labels, ids, target_cls
