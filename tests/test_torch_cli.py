"""The port's eval_base and eval_ft CLIs on tiny 64x64 GeoTIFF tiles: one
upstream-keyed .pth evaluated by both packages' CLIs gives the same
cmatrix_<seed>.npy (up to pixels whose top-2 logits lie within 1e-3), for
convnext_pop and for swin_pop / swin-t, and unlabeled tiles export a GTiff
and an NCHW .mat per tile (no .mat from eval_ft).  deeplab_pop and pspnet_pop
over resnet50 run with --int8 and --int8 --fused (on the CPU the fused route
runs the block kernel's plain version, 12 of 16 bottlenecks a forward)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from torch_helpers import near_tie_pixels
from segland_tpu_torch.models import build_model
from segland_tpu_torch.models.backbones.convnext import ConvNeXtBlock

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
    import torch.nn as nn

    g = torch.Generator().manual_seed(4)
    model = build_model("swin_pop", "swin-t", n_base=7, n_novel=4 if is_ft else 0, is_ft=is_ft,
                        generator=g)
    with torch.no_grad():  # upstream's 0.02-scale init gives near-constant logits
        for m in model.backbone.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, m.in_features ** -0.5, generator=g)
        for name, p in model.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.normal_(0.0, 1.0, generator=g)
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


def _resnet_pth(tmp_path_factory, name, is_ft=False):
    model = build_model(name, "resnet50", n_base=7, n_novel=4 if is_ft else 0, is_ft=is_ft,
                        generator=torch.Generator().manual_seed(5))
    path = str(tmp_path_factory.mktemp("ckpt") / f"{name}_{int(is_ft)}.pth")
    torch.save(model.state_dict(), path)
    return path, model


RESNET = ["--backbone", "resnet50", "--num-workers", "0", "--base-size", "64,64",
          "--eval-batch", "2", "--device-normalize"]


@pytest.mark.parametrize("name", ["deeplab_pop", "pspnet_pop"])
def test_resnet_cmatrix_matches_the_jax_cli(data_root, tmp_path_factory, tmp_path, name):
    from segland_tpu.cli.eval_base import main as j_main
    from segland_tpu_torch.cli.eval_base import main
    from segland_tpu_torch.evallib import Evaluator

    path, model = _resnet_pth(tmp_path_factory, name)
    args = ["--data-dir", str(data_root), "--val-list", str(data_root / "list" / "val.txt"),
            "--restore-from", path, "--model", name] + RESNET
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    main(args + ["--save-path", out_t, "--device", "cpu"])
    j_main(args + ["--save-path", out_j])
    cm_t = np.load(os.path.join(out_t, "cmatrix_123.npy"))
    cm_j = np.load(os.path.join(out_j, "cmatrix_123.npy"))
    imgs = np.stack([np.asarray(Image.open(data_root / "images" / f"tile_{i}.tif"))
                     for i in range(3)])
    ev = Evaluator(model, "cpu", normalize_on_device=True)
    ties = int(near_tie_pixels(ev.predict_batch(imgs, (64, 64))[0].numpy()).sum())
    assert cm_t.sum() == 3 * 64 * 64 and np.abs(cm_t - cm_j).sum() <= 2 * ties


@pytest.mark.parametrize("name,flags,blocks", [
    ("deeplab_pop", ["--int8"], 0),
    ("deeplab_pop", ["--int8", "--fused", "--dtype", "bfloat16"], 12),
    ("pspnet_pop", ["--int8", "--fused", "--dtype", "bfloat16", "--calib-percentile", "99.9"], 12),
    ("pspnet_pop", ["--int8", "--fused"], 0),  # the fused block takes bfloat16 only
])
def test_int8_cli_gives_a_cmatrix_and_counts_fused_blocks(data_root, tmp_path_factory, tmp_path,
                                                          monkeypatch, name, flags, blocks):
    """--int8 quantizes conv by conv; with --fused and bfloat16 the 12 of
    resnet50's 16 bottlenecks with stride 1 and no downsample go through the
    fused block op at every int8 forward (its plain version on the CPU), the
    calibration forwards apart.  The confusion matrix stays near the fp32 one."""
    from segland_tpu_torch.cli.eval_base import main
    from segland_tpu_torch.ops import fused_bottleneck as FB
    from segland_tpu_torch.quant import ptq

    path, _ = _resnet_pth(tmp_path_factory, name)
    calls, layers = [], []
    monkeypatch.setattr(FB, "bottleneck_int8_reference",
                        lambda x, *a, _fn=FB.bottleneck_int8_reference, **kw:
                        calls.append((x.shape[-1], kw["dilation"])) or _fn(x, *a, **kw))
    monkeypatch.setattr(ptq.quant_interceptor, "_layer",
                        lambda self, n, m, x, _fn=ptq.quant_interceptor._layer:
                        layers.append((self.mode, n)) or _fn(self, n, m, x))
    args = ["--data-dir", str(data_root), "--val-list", str(data_root / "list" / "val.txt"),
            "--restore-from", path, "--model", name, "--device", "cpu"] + RESNET
    out_q, out_f = str(tmp_path / "int8"), str(tmp_path / "fp32")
    res = main(args + flags + ["--save-path", out_q, "--calib-batches", "1"])[123]
    n_calib, n_int8 = len(layers), 0
    main(args + ["--save-path", out_f])
    assert len(layers) == n_calib  # the unquantized run intercepts nothing
    cm_q = np.load(os.path.join(out_q, "cmatrix_123.npy"))
    cm_f = np.load(os.path.join(out_f, "cmatrix_123.npy"))
    assert cm_q.sum() == cm_f.sum() == 3 * 64 * 64 and 0.0 <= res[2] <= 1.0
    assert np.abs(cm_q - cm_f).sum() <= 2 * 0.15 * cm_f.sum()
    # 3 tiles in batches of 2: two int8 forwards, one calibration forward
    assert len(calls) == 2 * blocks
    if blocks:
        per_forward = sorted(calls[:blocks])
        assert per_forward == sorted([(256, 1)] * 2 + [(512, 1)] * 3 + [(1024, 2)] * 5
                                     + [(2048, 4)] * 2)
    n_int8 = sum(1 for mode, _ in layers if mode == "int8")
    n_cal = sum(1 for mode, _ in layers if mode == "calibrate")
    convs = n_cal  # every quantizable layer is seen once by the one calibration forward
    assert n_int8 == 2 * (convs - 3 * blocks)  # a fused block takes its three convs along


def test_pspnet_pop_eval_ft_int8(data_root, tmp_path_factory, tmp_path):
    from segland_tpu_torch.cli.eval_ft import main

    path, _ = _resnet_pth(tmp_path_factory, "pspnet_pop", is_ft=True)
    args = ["--data-dir", str(data_root), "--val-list", str(data_root / "list" / "val.txt"),
            "--restore-from", path, "--model", "pspnet_pop", "--device", "cpu"] + RESNET
    out_q, out_f = str(tmp_path / "int8"), str(tmp_path / "fp32")
    main(args + ["--int8", "--calib-batches", "2", "--save-path", out_q])
    main(args + ["--save-path", out_f])
    cm_q = np.load(os.path.join(out_q, "cmatrix_123.npy"))
    cm_f = np.load(os.path.join(out_f, "cmatrix_123.npy"))
    assert cm_q.shape == (12, 12) and cm_q.sum() == cm_f.sum() == 3 * 64 * 64
    assert np.abs(cm_q - cm_f).sum() <= 2 * 0.15 * cm_f.sum()


def test_fused_defaults_are_off_for_the_resnet_models():
    from segland_tpu_torch.cli.common import EVAL_FUSED_DEFAULTS
    from segland_tpu_torch.cli.eval_base import get_parser

    assert EVAL_FUSED_DEFAULTS["deeplab_pop"] is False and EVAL_FUSED_DEFAULTS["pspnet_pop"] is False
    args = get_parser().parse_args(["--data-dir", "x"])
    assert args.int8 is False and args.fused is None and args.device == "cuda"
    assert args.calib_batches == 4 and args.calib_percentile is None


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


@pytest.mark.parametrize("extra", [["--model", "seghr_pop"], ["--model", "pspplus_pop"],
                                   ["--model", "pspnet"]])
def test_unported_paths_raise(data_root, pth, tmp_path, extra):
    from segland_tpu_torch.cli.eval_base import main

    with pytest.raises(NotImplementedError):
        main(_args(data_root, "val.txt", pth[0], str(tmp_path)) + ["--device", "cpu"] + extra)


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
