"""The port's train data path against the JAX package's, bit for bit: the
train-side augmentations on the same draws, and ``OEMTrainDataset`` +
``Loader`` over two epochs (per-epoch reseed and shuffle) on GeoTIFF tiles
written with the port's own TIFF writer, which PIL and both packages' readers
read back exactly."""

import random

import numpy as np
import pytest
from PIL import Image

from segland_tpu.data import augment as JA
from segland_tpu.data import Loader as JLoader, OEMTrainDataset as JTrain
from segland_tpu_torch.data import DATASETS, Loader, OEMTrainDataset
from segland_tpu_torch.data import augment as A
from segland_tpu_torch.data.geotiff import write_tiff
from segland_tpu_torch.data.tileio import read_image, read_label


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Six 40x40 tiles; half of each label ignored, so crops retry."""
    root = tmp_path_factory.mktemp("oem_train")
    for d in ("images", "labels", "list"):
        (root / d).mkdir()
    rng = np.random.RandomState(11)
    ids = [f"tile_{i}" for i in range(6)]
    for tid in ids:
        lab = rng.randint(0, 8, (40, 40)).astype(np.uint8)
        lab[:, :24] = 255
        write_tiff(str(root / "images" / f"{tid}.tif"),
                   rng.randint(0, 256, (40, 40, 3)).astype(np.uint8))
        write_tiff(str(root / "labels" / f"{tid}.tif"), lab)
    (root / "list" / "train.txt").write_text("\n".join(ids) + "\n")
    return root


def test_tiff_writer_round_trips(tmp_path):
    rng = np.random.RandomState(0)
    for arr in (rng.randint(0, 256, (17, 29, 3)), rng.randint(0, 256, (17, 29))):
        arr = arr.astype(np.uint8)
        path = str(tmp_path / f"a{arr.ndim}.tif")
        write_tiff(path, arr)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
        got = read_image(path) if arr.ndim == 3 else read_label(path)
        np.testing.assert_array_equal(got, arr)
    with pytest.raises(ValueError):
        write_tiff(str(tmp_path / "b.tif"), np.zeros((4, 4, 2), np.uint8))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augmentations_match_on_the_same_draws(seed):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (30, 26, 3)).astype(np.uint8)
    lab = rng.randint(0, 8, (30, 26)).astype(np.int32)
    lab[:20] = 255
    a = A.crop_train(np.random.RandomState(seed), img, lab, (16, 16))
    b = JA.crop_train(np.random.RandomState(seed), img, lab, (16, 16))
    for fn in ("random_flip", "fixed_random_rotate"):
        a = getattr(A, fn)(random.Random(seed), *a)
        b = getattr(JA, fn)(random.Random(seed), *b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert (a[1] != 255).any()


def test_dataset_and_loader_give_the_jax_samples(root):
    lst = str(root / "list" / "train.txt")
    ours = OEMTrainDataset(str(root), lst, crop_size=(24, 24), seed=5)
    theirs = JTrain(str(root), lst, crop_size=(24, 24), seed=5)
    lo = Loader(ours, 2, shuffle=True, drop_last=True, seed=5)
    lj = JLoader(theirs, 2, shuffle=True, drop_last=True, seed=5)
    for epoch in range(2):
        for ds in (ours, theirs):
            ds.set_seed(5 + epoch)
        lo.set_epoch(epoch)
        lj.set_epoch(epoch)
        got, want = list(lo), list(lj)
        assert len(got) == len(want) == 3
        for (gi, gm, gid), (wi, wm, wid) in zip(got, want):
            assert gid == wid
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gm, wm)
            assert gi.dtype == np.float32 and gi.shape == (2, 24, 24, 3)


def test_registry_and_device_augment(tmp_path):
    """device_augment: the raw uint8 tile and its label, brought to
    device_tile_size (image 0, label ignore; segland_tpu/data/oem.py:62-75),
    and a larger tile raises."""
    assert set(DATASETS) == {"oem", "oem_ft"}
    for d in ("images", "labels", "list"):
        (tmp_path / d).mkdir()
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (20, 24, 3)).astype(np.uint8)
    lab = rng.randint(0, 8, (20, 24)).astype(np.uint8)
    write_tiff(str(tmp_path / "images" / "a.tif"), img)
    write_tiff(str(tmp_path / "labels" / "a.tif"), lab)
    (tmp_path / "list" / "train.txt").write_text("a\n")
    ds = OEMTrainDataset(str(tmp_path), str(tmp_path / "list" / "train.txt"),
                         crop_size=(16, 16), device_augment=True, device_tile_size=(24, 32))
    got_img, got_lab, tid = ds[0]
    assert tid == "a" and got_img.dtype == np.uint8 and got_img.shape == (24, 32, 3)
    np.testing.assert_array_equal(got_img[:20, :24], img)
    assert not got_img[20:].any() and not got_img[:, 24:].any()
    np.testing.assert_array_equal(got_lab[:20, :24], lab)
    assert (got_lab[20:] == 255).all() and (got_lab[:, 24:] == 255).all()
    want = JTrain(str(tmp_path), str(tmp_path / "list" / "train.txt"), crop_size=(16, 16),
                  device_augment=True, device_tile_size=(24, 32))[0]
    for g, w in zip((got_img, got_lab, tid), want):
        np.testing.assert_array_equal(g, w)
    ds.device_tile_size = (16, 16)
    with pytest.raises(ValueError, match="larger than device_tile_size"):
        ds[0]
