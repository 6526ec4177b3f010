"""Accuracy gate of the port's int8 path on a TRAINED model: pspnet_pop /
resnet10 is trained on the learnable colour task (tests/synthtask.py) by the
JAX package's train_base CLI, its best checkpoint is carried into the port,
and the port's Evaluator scores the base validation tiles in fp32 and in int8
(two calibration batches).

The gate (slow, 150 epochs, as tests/test_fewshot_learns.py trains it):
|d mIoU| <= 0.002 and >= 99% of the pixels the same class.  Beside it a small
case that tier-1 runs: 40 epochs, where the model has only begun to fit
(val mIoU about 0.3; after 20 it still predicts three classes only), held to
|d mIoU| <= 0.005 and >= 98%: a half-trained model has more pixels near a tie.
In both, the port's fp32 mIoU equals the JAX Evaluator's on the same
checkpoint.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from synthtask import build_task
from torch_helpers import load_port

COMMON = ["--model", "pspnet_pop", "--backbone", "resnet10", "--num-workers", "0",
          "--norm-stats", "train"]


@pytest.fixture(scope="module")
def task_root(tmp_path_factory):
    return build_task(tmp_path_factory.mktemp("oem_int8_gate"))


def _train(task_root, snap, epochs):
    from segland_tpu.cli.train_base import main

    return main(["--data-dir", str(task_root),
                 "--train-list", str(task_root / "list" / "train.txt"),
                 "--val-list", str(task_root / "list" / "val_base.txt"),
                 "--snapshot-dir", snap, "--input-size", "32,32", "--batch-size", "4",
                 "--num-epoch", str(epochs), "--learning-rate", "1e-3", "--val-start", "0",
                 "--val-frequency", "10", "--snapshot-frequency", str(epochs)] + COMMON)


def _gate(task_root, snap, d_miou, agreement):
    from segland_tpu.ckpt import load_params
    from segland_tpu.data import Loader as JLoader, OEMValDataset as JValDataset
    from segland_tpu.evallib import Evaluator as JEvaluator
    from segland_tpu.models import build_model as j_build
    from segland_tpu_torch.data import Loader, OEMValDataset
    from segland_tpu_torch.evallib import Evaluator
    from segland_tpu_torch.models import build_model

    jm = j_build("pspnet_pop", "resnet10", n_base=7)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)
    v = jax.tree_util.tree_map(np.asarray, load_params(
        os.path.join(snap, "best.ckpt"), jax.tree_util.tree_map(np.asarray, v)))
    port = load_port(build_model("pspnet_pop", "resnet10", n_base=7), v)
    val = str(task_root / "list" / "val_base.txt")

    def run(**kw):
        ev = Evaluator(port, "cpu", num_classes=8, n_base=7, **kw)
        ds = OEMValDataset(str(task_root), val, base_size=(64, 64), stats="train")
        _, (base, _, total, _), _ = ev.run(Loader(ds, 2, shuffle=False, num_workers=0))
        preds = [ev.predict_batch(np.asarray(img, np.float32), (64, 64), want_logits=False)[1]
                 for img, _, _ in Loader(ds, 2, shuffle=False, num_workers=0)]
        return base, total, np.concatenate([p.numpy() for p in preds])

    b_f, t_f, pred_f = run()
    b_q, t_q, pred_q = run(int8=True, calib_batches=2)
    jds = JValDataset(str(task_root), val, base_size=(64, 64), stats="train")
    _, (jb, _, jt, _), _ = JEvaluator(jm, v, num_classes=8, n_base=7,
                                      fused_epilogue=False).run(JLoader(jds, 2, shuffle=False))
    agree = float(np.mean(pred_f == pred_q))
    print(f"int8 gate: total mIoU fp32 {t_f:.4f} (JAX {jt:.4f}) int8 {t_q:.4f} "
          f"(d={abs(t_f - t_q):.5f}), agreement {agree:.5f}")
    assert abs(t_f - jt) < 1e-9 and abs(b_f - jb) < 1e-9
    assert len(np.unique(pred_f)) >= 4, "degenerate model: the gate would compare constants"
    assert agree >= agreement, f"int8 argmax agreement {agree:.4f}"
    assert abs(t_f - t_q) <= d_miou and abs(b_f - b_q) <= d_miou, (t_f, t_q, b_f, b_q)


def test_int8_gate_small_case(task_root, tmp_path_factory):
    snap = str(tmp_path_factory.mktemp("snap_small"))
    best = _train(task_root, snap, 40)
    assert best >= 0.15, f"training degenerate (val mIoU {best})"
    _gate(task_root, snap, d_miou=0.005, agreement=0.98)


@pytest.mark.slow
def test_int8_accuracy_gate_on_trained_model(task_root, tmp_path_factory):
    snap = str(tmp_path_factory.mktemp("snap_full"))
    best = _train(task_root, snap, 150)
    assert best >= 0.40, f"base training degenerate (val mIoU {best})"
    _gate(task_root, snap, d_miou=0.002, agreement=0.99)
