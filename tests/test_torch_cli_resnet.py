"""The port's eval_base and eval_ft CLIs on deeplab_pop and pspnet_pop over
resnet50 on tiny 64x64 GeoTIFF tiles (split from tests/test_torch_cli.py):
one upstream-keyed .pth evaluated by both packages' CLIs gives the same
cmatrix_<seed>.npy (up to pixels whose top-2 logits lie within 1e-3), and
--int8 and --int8 --fused run (on the CPU the fused route runs the block
kernel's plain version, 12 of 16 bottlenecks a forward)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from torch_helpers import near_tie_pixels, one_torch_thread
from segland_tpu_torch.models import build_model

pytestmark = pytest.mark.usefixtures("one_torch_thread")


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
def resnet_pth(tmp_path_factory):
    """(name, is_ft=False) -> (.pth of ``name`` / resnet50 drawn from seed 5,
    the model): each drawn once a module (a resnet50 PSP head draws 12M
    truncated normals)."""
    cache = {}

    def get(name, is_ft=False):
        if (name, is_ft) not in cache:
            model = build_model(name, "resnet50", n_base=7, n_novel=4 if is_ft else 0,
                                is_ft=is_ft, generator=torch.Generator().manual_seed(5))
            path = str(tmp_path_factory.mktemp("ckpt") / f"{name}_{int(is_ft)}.pth")
            torch.save(model.state_dict(), path)
            cache[name, is_ft] = path, model
        return cache[name, is_ft]

    return get


RESNET = ["--backbone", "resnet50", "--num-workers", "0", "--base-size", "64,64",
          "--eval-batch", "2", "--device-normalize"]


@pytest.mark.parametrize("name", ["deeplab_pop", "pspnet_pop"])
def test_resnet_cmatrix_matches_the_jax_cli(data_root, resnet_pth, tmp_path, name):
    from segland_tpu.cli.eval_base import main as j_main
    from segland_tpu_torch.cli.eval_base import main
    from segland_tpu_torch.evallib import Evaluator

    path, model = resnet_pth(name)
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
def test_int8_cli_gives_a_cmatrix_and_counts_fused_blocks(data_root, resnet_pth, tmp_path,
                                                          monkeypatch, name, flags, blocks):
    """--int8 quantizes conv by conv; with --fused and bfloat16 the 12 of
    resnet50's 16 bottlenecks with stride 1 and no downsample go through the
    fused block op at every int8 forward (its plain version on the CPU), the
    calibration forwards apart.  The confusion matrix stays near the fp32 one."""
    from segland_tpu_torch.cli.eval_base import main
    from segland_tpu_torch.ops import fused_bottleneck as FB
    from segland_tpu_torch.quant import ptq

    path, _ = resnet_pth(name)
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


def test_pspnet_pop_eval_ft_int8(data_root, resnet_pth, tmp_path):
    from segland_tpu_torch.cli.eval_ft import main

    path, _ = resnet_pth("pspnet_pop", is_ft=True)
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
