"""Host-side numpy transforms, matching reference dataset/base_dataset.py.
Own copy of segland_tpu/data/augment.py: the train pipeline (crop, retried
while the label crop is all ignore -> pad -> random horizontal flip -> k*90
degree rotate -> normalize; reference dataset/oem.py:69-74), the fine-tune
support set's small-angle rotation and the eval side.  Resizes use PIL
(imported at the call) in place of cv2: both implement the standard
half-pixel bilinear, so results agree to rounding.

Randomness: the train functions take a python ``random.Random`` or a numpy
``RandomState``, as the reference uses both (crop offsets from np.random,
flips and rotations from random.random; base_dataset.py:106-155).
"""

import random as _random
from typing import Sequence

import numpy as np

IGNORE_LABEL = 255
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
OEM_TRAIN_MEAN = (0.5, 0.5, 0.5)  # reference dataset/oem.py:26-27
OEM_TRAIN_STD = (0.5, 0.5, 0.5)

# Named normalization-stat sets: the reference trains base models with
# 0.5-stats but normalizes val/ft with ImageNet stats (dataset/oem.py:26-27
# vs base_dataset.py defaults), a deliberate asymmetry preserved by default.
# ``--norm-stats train`` lets a consistent-stats run opt out.
STATS = {
    "imagenet": (IMAGENET_MEAN, IMAGENET_STD),
    "train": (OEM_TRAIN_MEAN, OEM_TRAIN_STD),
}


def normalize(image: np.ndarray, mean: Sequence[float], std: Sequence[float]) -> np.ndarray:
    """BGR->RGB channel flip, /255, -mean, /std (base_dataset.py:29-34)."""
    image = image.astype(np.float32)[:, :, ::-1]
    image = image / 255.0
    image = image - np.asarray(mean, np.float32)
    image = image / np.asarray(std, np.float32)
    return image


def pad(output_size, image, label=None, ignore_label: int = IGNORE_LABEL):
    """Bottom/right zero-pad image, ignore-pad label (base_dataset.py:88-104)."""
    pad_h = max(output_size[0] - image.shape[0], 0)
    pad_w = max(output_size[1] - image.shape[1], 0)
    if pad_h > 0 or pad_w > 0:
        image = np.pad(image, ((0, pad_h), (0, pad_w), (0, 0)), constant_values=0.0)
        if label is not None:
            label = np.pad(label, ((0, pad_h), (0, pad_w)), constant_values=ignore_label)
    return (image, label) if label is not None else image


def random_flip(rng: _random.Random, image, label, p: float = 0.5):
    if rng.random() < p:
        image = np.flip(image, axis=1)
        label = np.flip(label, axis=1)
    return image, label


def fixed_random_rotate(rng: _random.Random, image, label):
    """k*90-degree rotate, k uniform in {0,1,2,3} (base_dataset.py:134-138)."""
    k = int(rng.random() // 0.25)
    return np.rot90(image, k, (0, 1)), np.rot90(label, k, (0, 1))


def _warp_rotate(arr: np.ndarray, angle_deg: float, cval, nearest: bool) -> np.ndarray:
    """cv2.warpAffine(getRotationMatrix2D((w/2, h/2), angle, 1)) semantics:
    integer pixel-center coordinates, the reference's half-pixel-off center
    (w/2, h/2), BORDER_CONSTANT, INTER_LINEAR or INTER_NEAREST."""
    h, w = arr.shape[:2]
    theta = np.deg2rad(angle_deg)
    a, b = np.cos(theta), np.sin(theta)
    cx, cy = w / 2.0, h / 2.0
    # dst->src map (warpAffine inverts the src->dst rotation internally)
    xs_d, ys_d = np.meshgrid(np.arange(w, dtype=np.float64),
                             np.arange(h, dtype=np.float64))
    xs = a * (xs_d - cx) - b * (ys_d - cy) + cx
    ys = b * (xs_d - cx) + a * (ys_d - cy) + cy
    if nearest:
        xi = np.floor(xs + 0.5).astype(np.int64)
        yi = np.floor(ys + 0.5).astype(np.int64)
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        out = np.full(arr.shape, cval, arr.dtype)
        out[inside] = arr[yi[inside], xi[inside]]
        return out
    x0 = np.floor(xs).astype(np.int64)
    y0 = np.floor(ys).astype(np.int64)
    fx = (xs - x0).astype(np.float32)
    fy = (ys - y0).astype(np.float32)
    src = arr.astype(np.float32)
    if src.ndim == 2:
        src = src[:, :, None]
    cval_arr = np.broadcast_to(np.asarray(cval, np.float32), (src.shape[2],))

    def tap(yy, xx):
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        vals = src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(inside[..., None], vals, cval_arr)

    fx, fy = fx[..., None], fy[..., None]
    out = ((1 - fy) * ((1 - fx) * tap(y0, x0) + fx * tap(y0, x0 + 1))
           + fy * ((1 - fx) * tap(y0 + 1, x0) + fx * tap(y0 + 1, x0 + 1)))
    if arr.ndim == 2:
        out = out[..., 0]
    if np.issubdtype(arr.dtype, np.integer):
        info = np.iinfo(arr.dtype)
        out = np.clip(np.rint(out), info.min, info.max)
    return out.astype(arr.dtype)


def random_rotate(rng: _random.Random, image, label, p: float = 0.5,
                  rotate_range=(-10.0, 10.0), padding=None,
                  ignore_label: int = IGNORE_LABEL):
    """Small-angle rotation, re-drawn until class 1 survives
    (base_dataset.py:117-132): up to 5 angle draws; accepted only if the
    rotated label still holds a class-1 pixel (the binarized target class of
    the oem_ft val_supp path, oem_ft.py:251), else the original pair is kept.
    Image border = mean*255 (self.padding, base_dataset.py:15), label border
    = ignore."""
    if padding is None:
        padding = [v * 255.0 for v in IMAGENET_MEAN]
    if rng.random() < p:
        rotate_cnt = 0
        while rotate_cnt < 5:
            angle = rotate_range[0] + (rotate_range[1] - rotate_range[0]) * rng.random()
            # the reference normalizes BGR->RGB *after* rotation, so the cv2
            # borderValue list applies to the raw channels; the padding is
            # symmetric for OEM (mean 0.5 or near-equal ImageNet)
            cval = padding if image.ndim == 3 else np.asarray(padding).ravel()[0]
            image_tmp = _warp_rotate(image, angle, cval, nearest=False)
            label_tmp = _warp_rotate(label, angle, ignore_label, nearest=True)
            if np.sum(label_tmp == 1) > 0:
                break
            rotate_cnt += 1
        if rotate_cnt < 5:
            image, label = image_tmp, label_tmp
    return image, label


def crop_train(nprng: np.random.RandomState, image, label, crop_size,
               ignore_label: int = IGNORE_LABEL):
    """Random crop, re-drawn while the label crop is entirely ignore
    (base_dataset.py:140-169)."""
    img_h, img_w = label.shape
    crop_h, crop_w = crop_size
    margin_h = max(img_h - crop_h, 0)
    margin_w = max(img_w - crop_w, 0)
    while True:
        h_off = nprng.randint(0, margin_h + 1)
        w_off = nprng.randint(0, margin_w + 1)
        label_c = label[h_off: h_off + crop_h, w_off: w_off + crop_w]
        uniq = np.unique(label_c).tolist()
        if not (len(uniq) == 1 and ignore_label in uniq):
            break
    return image[h_off: h_off + crop_h, w_off: w_off + crop_w], label_c


def crop_val(image, label, crop_size):
    """Center crop (base_dataset.py:170-174)."""
    img_h, img_w = label.shape
    crop_h, crop_w = crop_size
    h_off = int(round(max(img_h - crop_h, 0) / 2.0))
    w_off = int(round(max(img_w - crop_w, 0) / 2.0))
    return (
        image[h_off : h_off + crop_h, w_off : w_off + crop_w],
        label[h_off : h_off + crop_h, w_off : w_off + crop_w],
    )


def _pil_resize(arr: np.ndarray, dsize_wh, bilinear: bool) -> np.ndarray:
    from PIL import Image

    resample = Image.BILINEAR if bilinear else Image.NEAREST
    if arr.ndim == 3:
        return np.stack(
            [np.asarray(Image.fromarray(arr[..., c]).resize(dsize_wh, resample))
             for c in range(arr.shape[2])], axis=-1)
    return np.asarray(Image.fromarray(arr).resize(dsize_wh, resample))


def resize_to_base(image, label=None, base_size=(1024, 1024)):
    """Aspect-preserving resize to fit base_size (base_dataset.py:52-63):
    linear for image, nearest for label."""
    output_size = base_size
    scale = min(max(output_size) / max(image.shape[:2]), min(output_size) / min(image.shape[:2]))
    new_w = int(image.shape[1] * scale + 0.5)
    new_h = int(image.shape[0] * scale + 0.5)
    if (new_h, new_w) == image.shape[:2]:  # a resize to its own size is a copy (PIL, cv2)
        return (image, label) if label is not None else image
    image = _pil_resize(image, (new_w, new_h), bilinear=True)
    if label is not None:
        label = _pil_resize(label, (new_w, new_h), bilinear=False)
        return image, label
    return image
