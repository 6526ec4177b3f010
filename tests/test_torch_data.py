"""The port's own copies of the host data modules (segland_tpu_torch/data,
native, utils) give the same arrays and files as segland_tpu's on the same
tiles: readers, the val dataset (host and device normalize, label remap,
resize_label), the batched native decode through the Loader, and the GTiff
and .mat writers (byte for byte)."""

import numpy as np
import pytest
from PIL import Image

import segland_tpu.data as JD
import segland_tpu.data.augment as JA
import segland_tpu.data.tileio as JT
import segland_tpu_torch.data as PD
import segland_tpu_torch.data.augment as PA
import segland_tpu_torch.data.tileio as PT
from segland_tpu_torch.utils import get_logger


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("oem_data")
    for d in ("images", "labels"):
        (root / d).mkdir()
    rng = np.random.RandomState(11)
    for i in range(5):
        Image.fromarray(rng.randint(0, 255, (48, 64, 3), np.uint8)).save(
            root / "images" / f"t{i}.tif")
        if i < 4:
            Image.fromarray(rng.randint(0, 13, (48, 64)).astype(np.uint8)).save(
                root / "labels" / f"t{i}.tif")
    (root / "val.txt").write_text("t0\nt1\nt2\nt3\n")
    (root / "test.txt").write_text("t4\n")
    return root


def test_readers_match(root):
    for name in ("t0", "t4"):
        path = str(root / "images" / f"{name}.tif")
        np.testing.assert_array_equal(PT.read_image(path), JT.read_image(path))
    path = str(root / "labels" / "t1.tif")
    np.testing.assert_array_equal(PT.read_label(path), JT.read_label(path))
    assert PT.OEM_COLORMAP == JT.OEM_COLORMAP and PT.OEM_COLORMAP_FT == JT.OEM_COLORMAP_FT
    assert PA.STATS == JA.STATS


@pytest.mark.parametrize("kw", [{}, {"device_normalize": True}, {"stats": "train"},
                                {"resize_label": True, "base_size": (32, 32)},
                                {"use_novel": False}],
                         ids=["host", "device_normalize", "train_stats", "resize_label",
                              "no_novel"])
def test_val_dataset_matches(root, kw):
    kw = {"base_size": (48, 64), **kw}
    ds_p = PD.OEMValDataset(str(root), str(root / "val.txt"), **kw)
    ds_j = JD.OEMValDataset(str(root), str(root / "val.txt"), **kw)
    assert len(ds_p) == len(ds_j) == 4
    for i in range(4):
        (img_p, lab_p, id_p), (img_j, lab_j, id_j) = ds_p[i], ds_j[i]
        assert id_p == id_j and img_p.dtype == img_j.dtype
        np.testing.assert_array_equal(img_p, img_j)
        np.testing.assert_array_equal(lab_p, lab_j)


@pytest.mark.parametrize("lst,device_normalize", [("val.txt", False), ("val.txt", True),
                                                  ("test.txt", True)])
def test_loader_batches_match(root, lst, device_normalize):
    kw = dict(base_size=(48, 64), device_normalize=device_normalize)
    batches = [list(L(D(str(root), str(root / lst), **kw), 3, num_workers=2))
               for L, D in ((PD.Loader, PD.OEMValDataset), (JD.Loader, JD.OEMValDataset))]
    assert len(batches[0]) == len(batches[1]) == (2 if lst == "val.txt" else 1)
    for (img_p, lab_p, ids_p), (img_j, lab_j, ids_j) in zip(*batches):
        assert ids_p == ids_j
        np.testing.assert_array_equal(img_p, img_j)
        if lab_j[0] is None:
            assert lab_p[0] is None
        else:
            np.testing.assert_array_equal(lab_p, lab_j)


def test_writers_match_byte_for_byte(root, tmp_path):
    pred = np.random.RandomState(12).randint(0, 12, (48, 64)).astype(np.uint8)
    src = str(root / "images" / "t0.tif")
    PT.write_pred_tiff(str(tmp_path / "p.tif"), pred, PT.OEM_COLORMAP_FT, src)
    JT.write_pred_tiff(str(tmp_path / "j.tif"), pred, JT.OEM_COLORMAP_FT, src)
    assert (tmp_path / "p.tif").read_bytes() == (tmp_path / "j.tif").read_bytes()
    np.testing.assert_array_equal(PT.read_label(str(tmp_path / "p.tif")), pred)
    probs = np.random.RandomState(13).randn(1, 8, 6, 5).astype(np.float32)
    PT.write_prob_mat(str(tmp_path / "p.mat"), probs)
    np.testing.assert_array_equal(JT.read_prob_mat(str(tmp_path / "p.mat")), probs)
    np.testing.assert_array_equal(PT.read_prob_mat(str(tmp_path / "p.mat")), probs)


def test_native_decoder_builds_from_the_ports_source(root):
    from segland_tpu_torch import native

    lib = native.get_lib()
    if lib is None:
        pytest.skip("no C++ compiler or zlib here: the readers fall back to PIL")
    arr = native.decode(str(root / "images" / "t2.tif"))
    np.testing.assert_array_equal(arr, np.asarray(Image.open(root / "images" / "t2.tif")))
    assert "segland_tpu_torch" in native._cache_dir()


def test_logger_is_a_singleton():
    assert get_logger("segland_port_test") is get_logger("segland_port_test")
