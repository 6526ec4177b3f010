"""Training augmentation on the device.  Port of segland_tpu/ops/device_aug.py.

With ``--device-augment`` the host decodes only: the batch crosses to the
device as uint8 tiles and the train step runs the reference's chain
(dataset/oem.py:69-74: crop -> pad -> flip -> k*90 rotate -> normalize) on
it, in plain torch (no kernel: the JAX package has no Pallas kernel here).

- The crop's retry while the label crop is all ignore (reference
  base_dataset.py:150-169) is bounded, as in the JAX package: an integral
  image of (label != ignore) prices each of ``retries`` candidate windows at
  four gathers and the first valid one wins (candidate 0 when none is).
  ``aug_fallback`` counts the samples whose candidates were all ignore
  although the tile has labelled pixels.
- The draws (offsets, flip, k) come from a CPU generator the step seeds from
  (seed, step) apart from its dropout stream (``aug_seed``; the JAX step folds
  1 into its step key), so ``--device-augment`` leaves the DropPath and
  dropout masks as they were.  They are drawn for the global batch and each
  rank takes its rows, so they do not depend on the process count.
- For a fixed draw the output is bitwise equal to the host pipeline
  (``data/augment.py``) in float32: the same ops in the same order.
"""

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..data.augment import IGNORE_LABEL, OEM_TRAIN_MEAN, OEM_TRAIN_STD


def aug_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s augmentation draws in a run seeded ``seed``,
    a stream apart from ``droppath.step_seed``'s."""
    return int(np.random.SeedSequence((seed, step, 1)).generate_state(1, np.uint64)[0])


def pad_to_crop(images, labels, crop_hw, ignore_label: int = IGNORE_LABEL):
    """Bottom/right pad where the crop exceeds the tile (image 0, label
    ignore: reference base_dataset.py:88-104); the margins are then 0."""
    ch, cw = crop_hw
    h, w = labels.shape[-2:]
    ph, pw = max(ch - h, 0), max(cw - w, 0)
    if ph or pw:
        images = F.pad(images, (0, 0, 0, pw, 0, ph))
        labels = F.pad(labels, (0, pw, 0, ph), value=ignore_label)
    return images, labels


def draw(generator: torch.Generator, n: int, tile_hw, crop_hw, retries: int = 8):
    """(offsets [n, retries, 2], flip [n] bool, k [n]) on the CPU: offsets
    uniform over the margins of a (padded) ``tile_hw`` tile, flip with p 0.5,
    k uniform in {0, 1, 2, 3}."""
    (h, w), (ch, cw) = tile_hw, crop_hw
    oy = torch.randint(0, h - ch + 1, (n, retries), generator=generator)
    ox = torch.randint(0, w - cw + 1, (n, retries), generator=generator)
    flip = torch.rand(n, generator=generator) < 0.5
    k = torch.randint(0, 4, (n,), generator=generator)
    return torch.stack([oy, ox], -1), flip, k


def valid_integral(labels, ignore_label: int = IGNORE_LABEL):
    """[B, H+1, W+1] zero-padded integral images of (label != ignore)."""
    ii = (labels != ignore_label).to(torch.int32).cumsum(1).cumsum(2)
    return F.pad(ii, (1, 0, 1, 0))


def window_counts(ii, offs, crop_hw):
    """[B, R] non-ignore pixel counts of the R windows at ``offs`` [B, R, 2]."""
    ch, cw = crop_hw
    b = torch.arange(ii.shape[0], device=ii.device)[:, None]
    oy, ox = offs[..., 0], offs[..., 1]
    return ii[b, oy + ch, ox + cw] - ii[b, oy, ox + cw] - ii[b, oy + ch, ox] + ii[b, oy, ox]


def apply_draw(images, labels, crop_hw, oy, ox, flip, k, mean=OEM_TRAIN_MEAN,
               std=OEM_TRAIN_STD):
    """The chain for one draw a sample: crop at (oy, ox) [B] (device), then a
    horizontal flip where ``flip`` and a k*90 degree rotation (host lists),
    then BGR->RGB, /255, -mean, /std in float32.  Returns (images [B,ch,cw,3]
    float32, labels [B,ch,cw] int32)."""
    ch, cw = crop_hw
    dev = images.device
    b = torch.arange(images.shape[0], device=dev)[:, None, None]
    rows = (oy[:, None] + torch.arange(ch, device=dev))[:, :, None]
    cols = (ox[:, None] + torch.arange(cw, device=dev))[:, None, :]
    img, lab = images[b, rows, cols], labels[b, rows, cols].to(torch.int32)
    out_i, out_l = [], []
    for i in range(img.shape[0]):
        x, y = img[i], lab[i]
        if flip[i]:
            x, y = x.flip(1), y.flip(1)
        out_i.append(torch.rot90(x, int(k[i]), (0, 1)))
        out_l.append(torch.rot90(y, int(k[i]), (0, 1)))
    x = torch.stack(out_i).float().flip(-1)
    # a tensor divisor: CUDA multiplies by the reciprocal of a Python scalar, which
    # rounds otherwise than numpy's division
    x = x / torch.tensor(255.0, device=dev)
    x = x - torch.tensor(mean, dtype=torch.float32, device=dev)
    x = x / torch.tensor(std, dtype=torch.float32, device=dev)
    return x, torch.stack(out_l)


def augment_forced(images, labels, crop_hw, offs, flip, k, ignore_label: int = IGNORE_LABEL,
                   mean=OEM_TRAIN_MEAN, std=OEM_TRAIN_STD):
    """The chain for a given draw (offs [B, 2] on the host), for tests and
    the card's check against the host pipeline."""
    images, labels = pad_to_crop(images, labels, crop_hw, ignore_label)
    offs = torch.as_tensor(offs, device=images.device).reshape(-1, 2)
    return apply_draw(images, labels, crop_hw, offs[:, 0], offs[:, 1], list(flip), list(k),
                      mean, std)


def base_train_augment(generator: torch.Generator, images, labels, crop_size: Sequence[int],
                       shard=(0, 1), ignore_label: int = IGNORE_LABEL,
                       mean: Sequence[float] = OEM_TRAIN_MEAN,
                       std: Sequence[float] = OEM_TRAIN_STD, retries: int = 8):
    """images [B,H,W,3] uint8, labels [B,H,W] integer, on the device ->
    (images [B,ch,cw,3] float32 normalized, labels [B,ch,cw] int32, the
    count of this batch's crop fallbacks, a 0-dim float32 tensor).

    ``shard`` (index, count): the batch is share ``index`` of ``count`` equal
    shares of a global batch; the draws are the global batch's rows of it."""
    ch, cw = int(crop_size[0]), int(crop_size[1])
    if ch != cw:
        raise ValueError(f"k*90 rotation needs a square crop, got {(ch, cw)} (the host "
                         "pipeline could not collate a non-square rotated batch either)")
    images, labels = pad_to_crop(images, labels, (ch, cw), ignore_label)
    n = images.shape[0]
    index, count = shard
    offs, flip, k = draw(generator, n * count, labels.shape[-2:], (ch, cw), retries)
    rows = slice(index * n, (index + 1) * n)
    offs, flip, k = offs[rows].to(images.device), flip[rows].tolist(), k[rows].tolist()
    ii = valid_integral(labels, ignore_label)
    valid = window_counts(ii, offs, (ch, cw)) > 0
    pick = valid.to(torch.int32).argmax(1, keepdim=True)  # the first valid, 0 if none
    oy, ox = offs[..., 0].gather(1, pick)[:, 0], offs[..., 1].gather(1, pick)[:, 0]
    fallback = (~valid.any(1)) & (ii[:, -1, -1] > 0)
    x, y = apply_draw(images, labels, (ch, cw), oy, ox, flip, k, mean, std)
    return x, y, fallback.sum().to(torch.float32)
