"""The port's fusion and contest tools against the JAX package's on the CPU:
fuse_prob_maps / fuse_prob_dirs (.mat maps summed in float64, divided by the
number of directories, argmax of the float32 mean), resize_preds_to_png,
colorize_labels, and the CLIs fuse, trans, translabel, gen_new_samples and
get_list.  Bar: the same files, byte for byte, and the same lists; labels the
importer writes read back equal (the two packages write them differently
without rasterio)."""

import os

import numpy as np
import pytest

from segland_tpu_torch.data.geotiff import write_tiff
from segland_tpu_torch.data.tileio import OEM_COLORMAP, write_pred_tiff, write_prob_mat

K, H, W = 8, 24, 20


@pytest.fixture(scope="module")
def prob_dirs(tmp_path_factory):
    """Three models' .mat maps of 4 tiles (NCHW fp32, as eval_base exports
    them); tile c is missing from the third model, and tile d's maps tie
    exactly at some pixels."""
    root = tmp_path_factory.mktemp("probs")
    rng = np.random.RandomState(0)
    dirs = []
    for m in range(3):
        d = root / f"model{m}" / "prob"
        d.mkdir(parents=True)
        for tid in ("a", "b", "c", "d"):
            if tid == "c" and m == 2:
                continue
            p = rng.randn(1, K, H, W).astype(np.float32)
            if tid == "d":
                p[:, 3] = p[:, 5]
            write_prob_mat(str(d / f"{tid}.mat"), p)
        dirs.append(str(d))
    return dirs


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


def test_fuse_prob_maps_is_the_argmax_of_the_float32_mean(prob_dirs):
    import scipy.io

    from segland_tpu_torch.evallib.fuse import fuse_prob_maps

    got = fuse_prob_maps(prob_dirs, "cpu")
    assert sorted(got) == ["a.mat", "b.mat", "c.mat", "d.mat"]
    for f, idx in got.items():
        maps = [scipy.io.loadmat(os.path.join(d, f))["outputs"][0] for d in prob_dirs
                if os.path.exists(os.path.join(d, f))]
        total = np.sum(np.stack(maps).astype(np.float64), 0)
        want = (total / len(prob_dirs)).astype(np.float32).argmax(0)
        assert idx.dtype == np.uint8 and idx.shape == (H, W)
        np.testing.assert_array_equal(idx, want)


@pytest.mark.parametrize("size", [(64, 64), (20, 24)])
def test_fuse_prob_dirs_matches_jax(prob_dirs, tmp_path, size):
    from segland_tpu.evallib.fuse import fuse_prob_dirs as j_fuse
    from segland_tpu_torch.evallib.fuse import fuse_prob_dirs

    want = j_fuse(prob_dirs, str(tmp_path / "jax"), out_size=size)
    got = fuse_prob_dirs(prob_dirs, str(tmp_path / "port"), out_size=size, device="cpu")
    assert got == want == ["a.mat", "b.mat", "c.mat", "d.mat"]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_fuse_cli_matches_jax(prob_dirs, tmp_path):
    from PIL import Image

    from segland_tpu.cli.fuse import main as j_main
    from segland_tpu_torch.cli.fuse import main

    j_main(["--inputs", *prob_dirs, "--output", str(tmp_path / "jax"), "--size", "48"])
    main(["--inputs", *prob_dirs, "--output", str(tmp_path / "port"), "--size", "48",
          "--device", "cpu"])
    files = _files(tmp_path / "port")
    assert sorted(files) == ["a.png", "b.png", "c.png", "d.png"]
    assert files == _files(tmp_path / "jax")
    img = Image.open(tmp_path / "port" / "a.png")
    assert img.mode == "P" and img.size == (48, 48)


@pytest.fixture(scope="module")
def pred_dir(tmp_path_factory):
    """Colormapped GTiff predictions as eval_base writes them, and a stray file."""
    d = tmp_path_factory.mktemp("preds")
    rng = np.random.RandomState(1)
    for i in range(3):
        write_pred_tiff(str(d / f"p{i}.tif"), rng.randint(0, 12, (H, W)).astype(np.uint8),
                        OEM_COLORMAP)
    (d / "notes.txt").write_text("not a tile\n")
    return d


@pytest.mark.parametrize("size", [(1024, 1024), (30, 17)])
def test_resize_preds_to_png_matches_jax(pred_dir, tmp_path, size):
    from segland_tpu.evallib.fuse import resize_preds_to_png as j_resize
    from segland_tpu_torch.evallib.fuse import resize_preds_to_png

    want = j_resize(str(pred_dir), str(tmp_path / "jax"), size)
    got = resize_preds_to_png(str(pred_dir), str(tmp_path / "port"), size)
    assert got == want == ["p0.png", "p1.png", "p2.png"]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_trans_cli_matches_jax(pred_dir, tmp_path):
    from PIL import Image

    from segland_tpu.cli.trans import main as j_main
    from segland_tpu_torch.cli.trans import main

    j_main(["--input", str(pred_dir), "--output", str(tmp_path / "jax"), "--size", "40"])
    main(["--input", str(pred_dir), "--output", str(tmp_path / "port"), "--size", "40"])
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    img = Image.open(tmp_path / "port" / "p1.png")
    assert img.mode == "P" and img.size == (40, 40)


@pytest.fixture(scope="module")
def label_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("labels")
    rng = np.random.RandomState(2)
    for i in range(3):
        write_tiff(str(d / f"t{i}.tif"), rng.randint(0, 12, (H, W)).astype(np.uint8))
    return d


def test_colorize_labels_matches_jax(label_dir, tmp_path):
    from PIL import Image

    from segland_tpu.evallib.fuse import colorize_labels as j_colorize
    from segland_tpu_torch.data.tileio import read_label
    from segland_tpu_torch.evallib.fuse import colorize_labels

    j_colorize(str(label_dir), str(tmp_path / "jax"))
    colorize_labels(str(label_dir), str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "port")) == ["t0.tif", "t1.tif", "t2.tif"]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    img = Image.open(tmp_path / "port" / "t0.tif")
    assert img.mode == "P" and img.getpalette()[3:6] == list(OEM_COLORMAP[1])
    np.testing.assert_array_equal(read_label(str(tmp_path / "port" / "t0.tif")),
                                  read_label(str(label_dir / "t0.tif")))


def test_translabel_cli_matches_jax(label_dir, tmp_path):
    from segland_tpu.cli.translabel import main as j_main
    from segland_tpu_torch.cli.translabel import main

    j_main(["--input", str(label_dir), "--output", str(tmp_path / "jax")])
    main(["--input", str(label_dir), "--output", str(tmp_path / "port")])
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


@pytest.fixture(scope="module")
def cutmix_root(tmp_path_factory):
    """Two classes' cut-mix samples: sentinel 30 in the masks, one mask whose
    image is missing, and two masks whose stems collide."""
    root = tmp_path_factory.mktemp("cutmix")
    rng = np.random.RandomState(3)
    for cls, stems in (("Parking space", ("tile0", "tile1", "tile2")),
                       ("Sports field", ("tile0", "tile3"))):
        (root / cls / f"{cls}_image").mkdir(parents=True)
        (root / cls / f"{cls}_mask").mkdir(parents=True)
        for stem in stems:
            mask = rng.randint(0, 8, (H, W)).astype(np.uint8)
            mask[2:6, 3:9] = 30
            write_tiff(str(root / cls / f"{cls}_mask" / f"{stem}_a.tif"), mask)
            if stem != "tile2":
                write_tiff(str(root / cls / f"{cls}_image" / f"{stem}.tif"),
                           rng.randint(0, 256, (H, W, 3)).astype(np.uint8))
    return root


def test_gen_new_samples_matches_jax(cutmix_root, tmp_path):
    from segland_tpu.cli.gen_new_samples import main as j_main
    from segland_tpu.data.tileio import read_label as j_read_label
    from segland_tpu_torch.cli.gen_new_samples import main
    from segland_tpu_torch.data.tileio import read_label

    argv = ["--cutmix-root", str(cutmix_root), "--class-names", "Parking space",
            "Sports field", "Building type 2", "--indexes", "9", "10", "11"]
    j_main(argv + ["--output-root", str(tmp_path / "jax")])
    names = main(argv + ["--output-root", str(tmp_path / "port")])
    lst = (tmp_path / "port" / "train.txt").read_text()
    assert lst == (tmp_path / "jax" / "train.txt").read_text()
    assert names == lst.split() == ["tile0_new", "tile1_new", "tile2_new", "tile0_newa",
                                    "tile3_new"]
    assert _files(tmp_path / "port" / "image") == _files(tmp_path / "jax" / "image")
    for x in names:
        got = read_label(str(tmp_path / "port" / "label" / f"{x}.tif"))
        want = j_read_label(str(tmp_path / "jax" / "label" / f"{x}.tif"))
        np.testing.assert_array_equal(got, want)
        assert 30 not in got and (got[2:6, 3:9] == (10 if x in ("tile0_newa", "tile3_new")
                                                    else 9)).all()


@pytest.mark.parametrize("seed,ratio", [("0", "0.8"), ("5", "0.5")])
def test_get_list_matches_jax(label_dir, tmp_path, seed, ratio):
    from segland_tpu.cli.get_list import main as j_main
    from segland_tpu_torch.cli.get_list import main

    for tag, fn in (("jax", j_main), ("port", main)):
        fn(["--input", str(label_dir), "--train-out", str(tmp_path / f"{tag}_tr.txt"),
            "--test-out", str(tmp_path / f"{tag}_te.txt"), "--seed", seed, "--ratio", ratio])
    for part in ("tr", "te"):
        assert ((tmp_path / f"port_{part}.txt").read_text()
                == (tmp_path / f"jax_{part}.txt").read_text())
    lines = ((tmp_path / "port_tr.txt").read_text() + (tmp_path / "port_te.txt").read_text())
    assert sorted(lines.split()) == ["t0.tif", "t1.tif", "t2.tif"]
