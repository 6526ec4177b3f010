"""The port's few-shot pipeline learns, end to end, on the synthetic colour
task of tests/synthtask.py, through its own entry points on the CPU:
``train_base`` trains ``pspnet_pop`` / ``resnet10`` on the base classes (for
BASE_EPOCHS, see there), then
``ft_pop`` fine-tunes it from ``best.pth`` on 5-shot episodes of novel
classes that base training never saw.  The port's mirror of
tests/test_fewshot_learns.py, at the same settings and bars: the base model
reaches base mIoU >= 0.60 on the base-only tiles; before the fine-tune the
novel mIoU is about 0 (at most 0.25), after it at least 0.30 and at least
0.25 above where it started, while the base mIoU stays at or above 0.40 on
the mixed tiles."""

import os

import numpy as np
import pytest
import torch

from synthtask import build_task

pytestmark = pytest.mark.slow

# Twice the JAX test's 150 epochs.  The 0.60 bar sits inside the spread of 150-epoch runs: the
# JAX CLI reached 0.57-0.61 there; the port 0.50 from upstream's init (which it drew before),
# 0.62 from the JAX CLI's own draw and 0.5675 from its own draw of the JAX package's init
# (models/init.py, which it draws now; CPU runs).
BASE_EPOCHS = 300
# consistent normalisation, as tests/test_fewshot_learns.py explains
COMMON = ["--model", "pspnet_pop", "--backbone", "resnet10", "--device", "cpu",
          "--num-workers", "0", "--norm-stats", "train"]


@pytest.fixture(scope="module")
def task_root(tmp_path_factory):
    return build_task(tmp_path_factory.mktemp("oem_learnable_port"))


@pytest.fixture(scope="module")
def trained_base(task_root, tmp_path_factory):
    from segland_tpu_torch.cli import train_base

    snap = tmp_path_factory.mktemp("snap_base_port")
    best = train_base.main(
        ["--data-dir", str(task_root), "--train-list", str(task_root / "list" / "train.txt"),
         "--val-list", str(task_root / "list" / "val_base.txt"), "--snapshot-dir", str(snap),
         "--input-size", "32,32", "--base-size", "64,64", "--batch-size", "4",
         "--num-epoch", str(BASE_EPOCHS), "--learning-rate", "1e-3", "--val-start", "0",
         "--val-frequency", "25", "--snapshot-frequency", str(BASE_EPOCHS),
         "--print-frequency", "100"]
        + COMMON)
    return snap, best


@pytest.fixture(scope="module")
def tuned(task_root, trained_base, tmp_path_factory):
    from segland_tpu_torch.cli import ft_pop

    snap, _ = trained_base
    ft_snap = tmp_path_factory.mktemp("snap_ft_port")
    results = ft_pop.main(
        ["--data-dir", str(task_root), "--train-list", str(task_root / "list" / "train.txt"),
         "--val-list", str(task_root / "list" / "val.txt"), "--snapshot-dir", str(ft_snap),
         "--restore-from", str(snap / "best.pth"), "--input-size", "32,32",
         "--base-size", "64,64", "--batch-size", "2", "--num-epoch", "30",
         "--learning-rate", "1e-3", "--fix-lr", "--shot", "5", "--update-base",
         "--val-frequency", "3", "--random-seed", "123", "--print-frequency", "100"] + COMMON)
    return ft_snap, results[123]


def _novel_miou_before_ft(task_root, snap):
    """The fine-tune model as ft_pop starts it (base weights, a fresh novel_emb,
    classifier_n a copy of classifier), scored by ft_pop's validate_ft."""
    from segland_tpu_torch.ckpt import load_pth
    from segland_tpu_torch.cli.ft_pop import validate_ft
    from segland_tpu_torch.data import Loader, OEMValDataset
    from segland_tpu_torch.models import build_model
    from segland_tpu_torch.train import init_cls_n, make_eval_step

    model = build_model("pspnet_pop", "resnet10", n_base=7, n_novel=4, is_ft=True,
                        generator=torch.Generator().manual_seed(123))
    load_pth(model, str(snap / "best.pth"))
    init_cls_n(model)
    valset = OEMValDataset(str(task_root), str(task_root / "list" / "val.txt"),
                           base_size=(64, 64), resize_label=True, stats="train")
    _, novel, _ = validate_ft(make_eval_step(model, 12), Loader(valset, 2),
                              torch.device("cpu"), 12, 7)
    return novel


def test_base_training_learns(trained_base):
    _, best = trained_base
    assert best >= 0.60, f"base training failed to learn the colour task: {best}"


def test_fewshot_learns_novel_classes(task_root, trained_base, tuned):
    snap, _ = trained_base
    ft_snap, best = tuned
    before = _novel_miou_before_ft(task_root, snap)
    print(f"novel mIoU before the fine-tune {before:.4f}, after {best['novel']:.4f}; "
          f"base {best['base']:.4f}")
    assert before <= 0.25, f"pre-ft novel mIoU {before:.4f}: the task probes no learning"
    assert os.path.exists(ft_snap / "best_123.pth")
    assert best["novel"] >= 0.30, f"novel mIoU {best['novel']:.4f} (from {before:.4f})"
    assert best["novel"] - before >= 0.25
    assert best["base"] >= 0.40, f"the fine-tune forgot the base classes: {best['base']:.4f}"
    assert np.isfinite(best["total"])
