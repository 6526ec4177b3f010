"""The port's eval_base and eval_ft CLIs on tiny 64x64 GeoTIFF tiles: one
upstream-keyed .pth evaluated by both packages' CLIs gives the same
cmatrix_<seed>.npy (up to pixels whose top-2 logits lie within 1e-3), for
convnext_pop and for swin_pop / swin-t, and unlabeled tiles export a GTiff
and an NCHW .mat per tile (no .mat from eval_ft).  deeplab_pop and pspnet_pop
over resnet50, with --int8 and --int8 --fused: tests/test_torch_cli_resnet.py."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from torch_helpers import near_tie_pixels, one_torch_thread
from segland_tpu_torch.models import build_model
from segland_tpu_torch.models.backbones.convnext import ConvNeXtBlock

pytestmark = pytest.mark.usefixtures("one_torch_thread")

COMMON = ["--model", "convnext_pop", "--backbone", "convnext-t", "--num-workers", "0",
          "--base-size", "64,64", "--eval-batch", "2"]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("oem_port")
    for d in ("images", "labels", "list"):
        (root / d).mkdir()
    rng = np.random.RandomState(7)
    ids = [f"tile_{i}" for i in range(3)]
    for tid in ids:
        Image.fromarray(rng.randint(0, 255, (64, 64, 3), np.uint8)).save(root / "images" / f"{tid}.tif")
        Image.fromarray(rng.randint(1, 8, (64, 64)).astype(np.uint8)).save(root / "labels" / f"{tid}.tif")
    for tid in ("test_0", "test_1"):
        Image.fromarray(rng.randint(0, 255, (64, 64, 3), np.uint8)).save(root / "images" / f"{tid}.tif")
    (root / "list" / "val.txt").write_text("\n".join(ids) + "\n")
    (root / "list" / "test.txt").write_text("test_0\ntest_1\n")
    return root


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    g = torch.Generator().manual_seed(3)
    model = build_model("convnext_pop", "convnext-t", n_base=7, generator=g)
    with torch.no_grad():
        for blk in model.modules():
            if isinstance(blk, ConvNeXtBlock):
                blk.gamma.uniform_(0.1, 0.5, generator=g)
    path = str(tmp_path_factory.mktemp("ckpt") / "convnext_pop.pth")
    torch.save(model.state_dict(), path)
    return path, model


def _args(root, lst, pth, out):
    return ["--data-dir", str(root), "--val-list", str(root / "list" / lst),
            "--restore-from", pth, "--save-path", out] + COMMON


def test_cmatrix_matches_the_jax_cli(data_root, pth, tmp_path):
    from segland_tpu.cli.eval_base import main as j_main
    from segland_tpu.data import OEMValDataset
    from segland_tpu_torch.cli.eval_base import main
    from segland_tpu_torch.evallib import Evaluator

    path, model = pth
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    base, novel, total, tps = main(_args(data_root, "val.txt", path, out_t) + ["--device", "cpu"])[123]
    j_main(_args(data_root, "val.txt", path, out_j))
    cm_t = np.load(os.path.join(out_t, "cmatrix_123.npy"))
    cm_j = np.load(os.path.join(out_j, "cmatrix_123.npy"))
    assert cm_t.sum() == 3 * 64 * 64 and 0.0 <= base <= 1.0 and tps > 0
    ds = OEMValDataset(str(data_root), str(data_root / "list" / "val.txt"), base_size=(64, 64))
    imgs = np.stack([ds[i][0] for i in range(len(ds))])
    logits, _ = Evaluator(model, "cpu").predict_batch(imgs, (64, 64))
    ties = int(near_tie_pixels(logits.numpy()).sum())
    assert np.abs(cm_t - cm_j).sum() <= 2 * ties


def test_unlabeled_tiles_export_tiff_and_mat(data_root, pth, tmp_path):
    from segland_tpu.data.tileio import read_prob_mat
    from segland_tpu_torch.cli.eval_base import main

    out = str(tmp_path / "pred")
    main(_args(data_root, "test.txt", pth[0], out) + ["--device", "cpu", "--device-normalize"])
    for tid in ("test_0", "test_1"):
        assert os.path.exists(os.path.join(out, f"{tid}.tif"))
        assert read_prob_mat(os.path.join(out, "prob", f"{tid}.mat")).shape == (1, 8, 64, 64)


def _swin_pth(tmp_path_factory, is_ft):
    """A swin_pop checkpoint whose logits spread: the 0.02-scale rel-pos tables
    drawn at 1, and the POP classifiers at 2 / sqrt(fan-in), as chip_smoke.py
    draws them (the init's classifiers leave the logits within ~0.005 of each
    other, so the argmax is rounding).  The draw of seed 5 gives the
    fine-tuned model's novel classes 5,153 of the 12,288 validation pixels."""
    import torch.nn as nn

    g = torch.Generator().manual_seed(5)
    model = build_model("swin_pop", "swin-t", n_base=7, n_novel=4 if is_ft else 0, is_ft=is_ft,
                        generator=g)
    with torch.no_grad():
        for m in model.backbone.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, m.in_features ** -0.5, generator=g)
        for name, p in model.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.normal_(0.0, 1.0, generator=g)
        heads = [model.classifier] + ([model.classifier_n] if is_ft else [])
        for conv in (m for h in heads for m in h if isinstance(m, nn.Conv2d)):
            conv.weight.normal_(0.0, 2.0 * conv.in_channels ** -0.5, generator=g)
    path = str(tmp_path_factory.mktemp("ckpt") / f"swin_pop_{int(is_ft)}.pth")
    torch.save({"state_dict": model.state_dict()}, path)
    return path, model


SWIN = ["--model", "swin_pop", "--backbone", "swin-t", "--num-workers", "0",
        "--base-size", "64,64", "--eval-batch", "2", "--device-normalize"]


@pytest.mark.parametrize("cli,fused", [("eval_base", "--fused"), ("eval_ft", "--no-fused"),
                                       ("eval_ft", "--fused")])
def test_swin_cmatrix_matches_the_jax_cli(data_root, tmp_path_factory, tmp_path, cli, fused):
    import importlib

    from segland_tpu_torch.evallib import Evaluator

    is_ft = cli == "eval_ft"
    path, model = _swin_pth(tmp_path_factory, is_ft)
    args = ["--data-dir", str(data_root), "--val-list", str(data_root / "list" / "val.txt"),
            "--restore-from", path, fused] + SWIN
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    main = importlib.import_module(f"segland_tpu_torch.cli.{cli}").main
    j_main = importlib.import_module(f"segland_tpu.cli.{cli}").main
    base, novel, total, tps = main(args + ["--save-path", out_t, "--device", "cpu"])[123]
    j_main(args + ["--save-path", out_j])
    cm_t = np.load(os.path.join(out_t, "cmatrix_123.npy"))
    cm_j = np.load(os.path.join(out_j, "cmatrix_123.npy"))
    assert cm_t.sum() == 3 * 64 * 64 and 0.0 <= total <= 1.0 and tps > 0
    assert (cm_t[:, 8:].sum() > 0) == is_ft  # novel classes predicted only by the ft head
    imgs = np.stack([np.asarray(Image.open(data_root / "images" / f"tile_{i}.tif"))
                     for i in range(3)])
    ev = Evaluator(model, "cpu", normalize_on_device=True)
    ties = int(near_tie_pixels(ev.predict_batch(imgs, (64, 64))[0].numpy()).sum())
    assert np.abs(cm_t - cm_j).sum() <= 2 * ties


@pytest.mark.parametrize("env,value", [("SEGLAND_SWIN_V3_STAGES", "all"),
                                       ("SEGLAND_SWIN_WR", "1")])
def test_swin_route_switches_give_the_plain_cmatrix(data_root, tmp_path_factory, tmp_path,
                                                    monkeypatch, env, value):
    """eval_base --fused under the JAX package's route switches (the whole-block
    kernel in every stage; window-resident stages) gives the confusion matrix of
    the --no-fused run up to near-ties, and the switch reaches the blocks."""
    from segland_tpu_torch.cli.eval_base import main
    from segland_tpu_torch.evallib import Evaluator
    from segland_tpu_torch.models.backbones import swin

    path, model = _swin_pth(tmp_path_factory, False)
    args = ["--data-dir", str(data_root), "--val-list", str(data_root / "list" / "val.txt"),
            "--restore-from", path, "--device", "cpu"] + SWIN
    calls = {"block": 0, "section": 0, "resident": 0}
    for owner, name, key in ((swin, "swin_block_fused", "block"),
                             (swin, "swin_attn_section_fused", "section"),
                             (swin.SwinBlock, "_win_resident", "resident")):
        def counted(*a, _fn=getattr(owner, name), _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(owner, name, counted)
    out_p, out_r = str(tmp_path / "plain"), str(tmp_path / "route")
    main(args + ["--no-fused", "--save-path", out_p])
    assert calls == {"block": 0, "section": 0, "resident": 0}
    monkeypatch.setenv(env, value)
    main(args + ["--fused", "--save-path", out_r])
    n = 12 * 2  # swin-t has 12 blocks; 3 tiles in batches of 2
    assert calls == ({"block": n, "section": 0, "resident": 0} if env.endswith("STAGES")
                     else {"block": 0, "section": n, "resident": n})
    cm_p = np.load(os.path.join(out_p, "cmatrix_123.npy"))
    cm_r = np.load(os.path.join(out_r, "cmatrix_123.npy"))
    assert cm_r.sum() == cm_p.sum() == 3 * 64 * 64
    imgs = np.stack([np.asarray(Image.open(data_root / "images" / f"tile_{i}.tif"))
                     for i in range(3)])
    ev = Evaluator(model, "cpu", normalize_on_device=True)
    ties = int(near_tie_pixels(ev.predict_batch(imgs, (64, 64))[0].numpy()).sum())
    assert np.abs(cm_r - cm_p).sum() <= 2 * ties


def test_swin_eval_ft_exports_tiff_without_mat(data_root, tmp_path_factory, tmp_path):
    from segland_tpu_torch.cli.eval_ft import main
    from segland_tpu_torch.data.tileio import OEM_COLORMAP_FT, read_image

    path, _ = _swin_pth(tmp_path_factory, True)
    out = str(tmp_path / "pred")
    main(["--data-dir", str(data_root), "--val-list", str(data_root / "list" / "test.txt"),
          "--restore-from", path, "--save-path", out, "--device", "cpu"] + SWIN)
    for tid in ("test_0", "test_1"):
        assert read_image(os.path.join(out, f"{tid}.tif")).shape[:2] == (64, 64)
    assert not os.path.exists(os.path.join(out, "prob"))
    assert OEM_COLORMAP_FT[8] == (255, 0, 255)


@pytest.mark.parametrize("model", ["convnext_pop", "swin_pop", "deeplab_pop"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_default_covers_bfloat16_only(model, dtype):
    """The per-model --fused default was measured in bf16 and applies there
    only; an explicit --fused / --no-fused wins in either dtype."""
    from segland_tpu_torch.cli.common import EVAL_FUSED_DEFAULTS, resolve_fused
    from segland_tpu_torch.cli.eval_base import get_parser

    base = ["--data-dir", "x", "--model", model, "--dtype", dtype]
    parse = get_parser().parse_args
    assert resolve_fused(parse(base)) is (dtype == "bfloat16" and EVAL_FUSED_DEFAULTS[model])
    assert resolve_fused(parse(base + ["--fused"])) is True
    assert resolve_fused(parse(base + ["--no-fused"])) is False


@pytest.mark.parametrize("extra", [["--model", "lsk_pop"], ["--model", "pspplus_pop"],
                                   ["--model", "pspnet"]])
def test_unported_paths_raise(data_root, tmp_path, extra):
    """Named when these keys raised (ROADMAP A7, A9); now each evaluates: the
    model at a narrow size from its seeded init (lsk-t is narrow at full
    width; the ResNet ones at resnet10), every labelled pixel counted and the
    unlabeled tiles exported."""
    from segland_tpu_torch.cli.eval_base import main

    narrow = ["--backbone", "lsk-t" if extra[1] == "lsk_pop" else "resnet10"]
    args = ["--data-dir", str(data_root), "--val-list", str(data_root / "list" / "val.txt"),
            "--save-path", str(tmp_path)] + COMMON + ["--device", "cpu"] + extra + narrow
    base, _, total, tps = main(args)[123]
    cm = np.load(tmp_path / "cmatrix_123.npy")
    assert cm.shape == (12, 12) and cm.sum() == 3 * 64 * 64
    assert 0.0 <= base <= 1.0 and 0.0 <= total <= 1.0 and tps > 0
    main(["--data-dir", str(data_root), "--val-list", str(data_root / "list" / "test.txt"),
          "--save-path", str(tmp_path / "test")] + COMMON + ["--device", "cpu"] + extra + narrow)
    assert sorted(os.listdir(tmp_path / "test" / "prob")) == ["test_0.mat", "test_1.mat"]


def test_eval_ft_two_seeds_load_their_own_checkpoints(data_root, tmp_path_factory, tmp_path):
    """Under --is-ft each seed loads <stem>_<seed>.pth when it exists (reference
    eval_ft.py:154: restore_from[:-4]+'_<seed>.pth'), else the given file.
    Seed 456's file has zeroed novel prototypes (as tests/test_e2e.py's mirror
    of this test), so its confusion matrix must differ from seed 123's; without
    seeded files both seeds score the given file."""
    from segland_tpu_torch.cli.eval_ft import main

    path, model = _swin_pth(tmp_path_factory, True)
    seeded, alone = tmp_path / "seeded", tmp_path / "alone"
    seeded.mkdir()
    alone.mkdir()
    sd = model.state_dict()
    for d in (seeded, alone):
        torch.save(sd, d / "best.pth")
    torch.save(sd, seeded / "best_123.pth")
    torch.save({**sd, "novel_emb": torch.zeros_like(sd["novel_emb"])}, seeded / "best_456.pth")
    cms = {}
    for d in (seeded, alone):
        out = str(tmp_path / f"out_{d.name}")
        res = main(["--data-dir", str(data_root), "--val-list", str(data_root / "list" / "val.txt"),
                    "--restore-from", str(d / "best.pth"), "--save-path", out, "--device", "cpu",
                    "--random-seed", "123,456"] + SWIN)
        assert set(res) == {123, 456}
        cms[d.name] = [np.load(os.path.join(out, f"cmatrix_{s}.npy")) for s in (123, 456)]
    assert not np.array_equal(*cms["seeded"])
    assert np.array_equal(*cms["alone"]) and np.array_equal(cms["alone"][0], cms["seeded"][0])


# ---- the export pool (Evaluator.run's export_workers) ------------------------
EXPORT_IDS = [f"x{i}" for i in range(5)]  # 3 batches of 2: the last one short


@pytest.fixture(scope="module")
def export_tiles(tmp_path_factory):
    """5 unlabeled 32^2 tiles, a narrow model (one strided conv: stride-4
    logits, 8 classes) and the port's loader over them."""
    from segland_tpu_torch.data.geotiff import write_tiff

    root = tmp_path_factory.mktemp("exports")
    (root / "images").mkdir()
    rng = np.random.RandomState(11)
    for tid in EXPORT_IDS:
        write_tiff(str(root / "images" / f"{tid}.tif"),
                   rng.randint(0, 256, (32, 32, 3)).astype(np.uint8))
    (root / "list.txt").write_text("\n".join(EXPORT_IDS) + "\n")
    model = torch.nn.Conv2d(3, 8, 3, stride=4, padding=1)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(rng.randn(8, 3, 3, 3).astype(np.float32)))
    return root, model.eval()


def _export_run(root, model, out, workers):
    from segland_tpu_torch.data import Loader, OEMValDataset
    from segland_tpu_torch.evallib import Evaluator

    os.makedirs(os.path.join(out, "prob"))
    ds = OEMValDataset(str(root), str(root / "list.txt"), base_size=(32, 32))
    Evaluator(model, "cpu", num_classes=8).run(
        Loader(ds, 2, num_workers=0), save_path=out, prob_path=os.path.join(out, "prob"),
        data_root=str(root), export_workers=workers)
    return ds


def _mat_bytes(path):
    """A .mat file's bytes but for the date in its header text (scipy writes
    the time of the call there)."""
    data = open(path, "rb").read()
    return data[:116].split(b", Created on:")[0] + data[116:]


def test_export_pool_writes_the_same_bytes_at_1_and_4_workers(export_tiles, tmp_path):
    """Every GTiff and .mat file is byte-equal at export_workers 1 and 4 (at 1
    the loop waits for the oldest batch once 2 are pending), and equal to the
    JAX package's write_pred_tiff / write_prob_mat of the same arrays."""
    from segland_tpu.data.tileio import OEM_COLORMAP, write_pred_tiff, write_prob_mat
    from segland_tpu_torch.data import Loader
    from segland_tpu_torch.evallib import Evaluator

    root, model = export_tiles
    outs = {w: str(tmp_path / f"w{w}") for w in (1, 4)}
    for w, out in outs.items():
        ds = _export_run(root, model, out, w)
    jax_out = tmp_path / "jax"
    (jax_out / "prob").mkdir(parents=True)
    ev = Evaluator(model, "cpu", num_classes=8)
    for images, _, ids in Loader(ds, 2, num_workers=0):  # the run's batches
        logits, pred = ev.predict_batch(images, (32, 32))
        for i, tid in enumerate(ids):
            write_pred_tiff(str(jax_out / f"{tid}.tif"), pred[i].numpy(), OEM_COLORMAP,
                            str(root / "images" / f"{tid}.tif"))
            write_prob_mat(str(jax_out / "prob" / f"{tid}.mat"),
                           np.transpose(logits[i].numpy(), (2, 0, 1))[None])
    for tid in EXPORT_IDS:
        tifs = [open(os.path.join(p, f"{tid}.tif"), "rb").read()
                for p in (outs[1], outs[4], str(jax_out))]
        mats = [_mat_bytes(os.path.join(p, "prob", f"{tid}.mat"))
                for p in (outs[1], outs[4], str(jax_out))]
        assert tifs[0] == tifs[1] == tifs[2], tid
        assert mats[0] == mats[1] == mats[2], tid
    assert len(set(open(os.path.join(outs[4], f"{t}.tif"), "rb").read()
                   for t in EXPORT_IDS)) == len(EXPORT_IDS)  # five maps, not one


@pytest.mark.parametrize("workers", [1, 4])
def test_an_export_error_reaches_the_caller_and_no_thread_stays(export_tiles, tmp_path,
                                                                monkeypatch, workers):
    """A .mat write that raises on the second tile makes run raise that error,
    and no export thread is alive afterwards."""
    import threading

    from segland_tpu_torch.data import tileio

    root, model = export_tiles
    plain = tileio.write_prob_mat

    def second_fails(path, probs):
        if os.path.basename(path) == f"{EXPORT_IDS[1]}.mat":
            raise OSError(f"no room for {os.path.basename(path)}")
        plain(path, probs)

    monkeypatch.setattr(tileio, "write_prob_mat", second_fails)
    with pytest.raises(OSError, match="no room for x1.mat"):
        _export_run(root, model, str(tmp_path / "out"), workers)
    assert [t.name for t in threading.enumerate() if t.name.startswith("segland-export")] == []
