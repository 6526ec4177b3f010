"""The port's fine-tune data path against the JAX package's, bit for bit, on
the same GeoTIFF tiles and seeds: ``gen_fs_list`` writes the same support
list; ``OEMFtTrainDataset`` gives the same (novel, base) pairs over two
epochs of ``Loader`` shuffles, per-epoch reseeds and ``update_base_list``
resamples, with and without ``filter`` (its own list in ``<list dir>_filter``,
or the fallback to the unfiltered support list), writes the same per-class
caches, and gives the same ``val_supp`` support sets; ``random_rotate``
equals the JAX one on the same draws.  The two packages' datasets get list
directories of their own, since each writes its caches beside its list."""

import random
import shutil

import numpy as np
import pytest

from segland_tpu.cli import gen_fs_list as j_gen_fs_list
from segland_tpu.data import Loader as JLoader, OEMFtTrainDataset as JFt
from segland_tpu.data import augment as JA
from segland_tpu_torch.cli import gen_fs_list
from segland_tpu_torch.data import DATASETS, Loader, OEMFtTrainDataset, OEMValDataset
from segland_tpu_torch.data import augment as A
from segland_tpu_torch.data.geotiff import write_tiff

SHOT, SEED = 2, 7


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    """Ten 40x40 tiles of 10x10 blocks: base classes everywhere, novel classes
    8..11 in tiles 0-5 only, background blocks, an ignored band in tiles 0-5
    (tiles 6-9 hold base classes and background only: what --filter-novel
    keeps, since an ignored pixel counts as a class that is not base)."""
    root = tmp_path_factory.mktemp("oem_ft")
    for d in ("images", "labels"):
        (root / d).mkdir()
    rng = np.random.RandomState(5)
    ids = [f"tile_{i}" for i in range(10)]
    for i, tid in enumerate(ids):
        blocks = rng.randint(0, 8, (4, 4))
        if i < 6:
            blocks[rng.randint(4), rng.randint(4)] = 8 + i % 4
            blocks[rng.randint(4), rng.randint(4)] = 8 + (i + 1) % 4
        lab = blocks.repeat(10, 0).repeat(10, 1).astype(np.uint8)
        if i < 6:
            lab[:, :3] = 255
        write_tiff(str(root / "images" / f"{tid}.tif"),
                   rng.randint(0, 256, (40, 40, 3)).astype(np.uint8))
        write_tiff(str(root / "labels" / f"{tid}.tif"), lab)
    return root, ids


def _lists(root, ids, tmp_path, filtered_shot_list=False):
    """A list directory for each package, each with train.txt and the support
    list from that package's gen_fs_list (and, with ``filtered_shot_list``, a
    ``<dir>_filter`` holding its own support list)."""
    out = {}
    for side, gen in (("port", gen_fs_list), ("jax", j_gen_fs_list)):
        d = tmp_path / side
        d.mkdir()
        (d / "train.txt").write_text("\n".join(ids) + "\n")
        gen.main(["--data-dir", str(root), "--train-list", str(d / "train.txt"),
                  "--shot", str(SHOT), "--seed", str(SEED)])
        if filtered_shot_list:
            (tmp_path / f"{side}_filter").mkdir()
            shutil.copy(d / f"all_{SHOT}shot_seed{SEED}.txt", tmp_path / f"{side}_filter")
            # another order, so that reading the wrong file would show
            lines = (d / f"all_{SHOT}shot_seed{SEED}.txt").read_text().splitlines()
            (tmp_path / f"{side}_filter" / f"all_{SHOT}shot_seed{SEED}.txt").write_text(
                "\n".join(lines[::-1]) + "\n")
        out[side] = str(d / "train.txt")
    return out


@pytest.mark.parametrize("shot,seed", [(2, 7), (3, 123), (7, 1)])
def test_gen_fs_list_writes_the_jax_file(tiles, tmp_path, shot, seed):
    """shot 7 > the 6 tiles of a class: the list is repeat-extended."""
    root, ids = tiles
    files = []
    for side, gen in (("port", gen_fs_list), ("jax", j_gen_fs_list)):
        d = tmp_path / side
        d.mkdir()
        (d / "train.txt").write_text("\n".join(ids) + "\n")
        gen.main(["--data-dir", str(root), "--train-list", str(d / "train.txt"),
                  "--shot", str(shot), "--seed", str(seed)])
        files.append((d / f"all_{shot}shot_seed{seed}.txt").read_text())
    assert files[0] == files[1] and len(files[0].splitlines()) == 4 * shot


@pytest.mark.parametrize("filt", ["off", "fallback", "own list"])
def test_train_pairs_match_jax(tiles, tmp_path, filt):
    root, ids = tiles
    lists = _lists(root, ids, tmp_path, filtered_shot_list=filt == "own list")
    kw = dict(shot=SHOT, seed=SEED, crop_size=(24, 24), filter=filt != "off")
    ours = OEMFtTrainDataset(str(root), lists["port"], **kw)
    theirs = JFt(str(root), lists["jax"], **kw)
    assert ours.novel_id_list == theirs.novel_id_list
    if filt == "own list":
        assert ours.novel_id_list != (tmp_path / "port" / f"all_{SHOT}shot_seed{SEED}.txt"
                                      ).read_text().splitlines()
    suffix = "_filter" if filt != "off" else ""
    for c in range(1, 8):
        name = f"train_base_class{c}.txt"
        cache = (tmp_path / f"port{suffix}" / name).read_text()
        assert cache == (tmp_path / f"jax{suffix}" / name).read_text()
        if filt != "off":  # novel-free tiles only
            assert set(cache.split()) <= {f"tile_{i}" for i in range(6, 10)}
    lo = Loader(ours, 2, shuffle=True, drop_last=True, seed=SEED)
    lj = JLoader(theirs, 2, shuffle=True, drop_last=True, seed=SEED)
    for epoch in range(2):
        for ds in (ours, theirs):
            ds.set_seed(SEED + epoch)
        lo.set_epoch(epoch)
        lj.set_epoch(epoch)
        got, want = list(lo), list(lj)
        assert len(got) == len(want) == len(ours) // 2 > 0
        for g, w in zip(got, want):
            assert len(g) == len(w) == 5
            for a, b in zip(g, w):
                if isinstance(a, np.ndarray):
                    assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            assert not (g[1] == 0).any()  # the novel side's background is ignored
        ours.update_base_list()
        theirs.update_base_list()
        assert ours.base_id_list == theirs.base_id_list


def test_val_supp_sets_match_jax(tiles, tmp_path):
    root, ids = tiles
    lists = _lists(root, ids, tmp_path)
    kw = dict(shot=SHOT, seed=SEED, crop_size=(24, 24), mode="val_supp")
    ours = OEMFtTrainDataset(str(root), lists["port"], **kw)
    theirs = JFt(str(root), lists["jax"], **kw)
    assert len(ours) == len(theirs) == 11
    for i in range(len(ours)):
        (gi, gl, gid, gc), (wi, wl, wid, wc) = ours[i], theirs[i]
        assert gid == wid and gc == wc and len(gi) == SHOT
        for a, b in zip(gi + gl, wi + wl):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert all(set(np.unique(lab)) <= {0, 1, 255} for lab in gl)


@pytest.mark.parametrize("case", ["class 1 everywhere", "no class 1", "p = 0", "a block of 1",
                                  "a corner of 1"])
@pytest.mark.parametrize("seed", [0, 3])
def test_random_rotate_matches_jax(case, seed):
    """The cases of tests/test_data.py's rotate tests and two partial labels
    (a central block survives the rotation, a corner may not): the same image,
    label and draws consumed."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (16, 20, 3)).astype(np.uint8)
    lab = {"class 1 everywhere": np.ones((16, 20), np.uint8),
           "no class 1": np.zeros((16, 20), np.uint8)}.get(case, rng.randint(0, 3, (16, 20)))
    lab = lab.astype(np.uint8)
    if case == "a block of 1":
        lab[6:10, 8:12] = 1
    if case == "a corner of 1":
        lab[lab == 1] = 0
        lab[0, 0] = 1
    p = 0.0 if case == "p = 0" else 1.0
    ra, rb = random.Random(seed), random.Random(seed)
    got = A.random_rotate(ra, img, lab, p=p)
    want = JA.random_rotate(rb, img, lab, p=p)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ra.random() == rb.random()


def test_registry_and_modes():
    assert DATASETS["oem_ft"] == (OEMFtTrainDataset, OEMValDataset)
    with pytest.raises(ValueError, match="val_supp"):
        OEMFtTrainDataset("/nonexistent", "/nonexistent/train.txt", mode="test")
