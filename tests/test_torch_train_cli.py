"""``python -m segland_tpu_torch.cli.train_base`` end to end on the CPU
(``--device cpu``) on tiny GeoTIFF tiles: ``convnext_pop`` with ``--fused``
(K1's autograd Function) for 3 epochs, snapshots every epoch, validation
every epoch, ``best.pth`` and ``--metrics``; a resumed run from
``epoch_2.pth`` ends on the same weights as the straight run (exactly: the
CPU ops are deterministic); the port's ``eval_base`` runs ``best.pth``; the
JAX package's ``load_torch_checkpoint`` reads it with nothing missing, and its
forward equals the port's within the repo's 5e-4 bar; ``seghr_pop`` / ``hr-w18``
trains and its ``best.pth`` loads into the JAX package; ``pspplus_pop``, the
plain ``pspnet`` (the CE step), ``lsk_pop`` and ``vggunet_pop`` train;
``--device-augment`` trains.  Then what does not train raises."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import one_torch_thread, t
from segland_tpu_torch.cli import train_base
from segland_tpu_torch.data.geotiff import write_tiff

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Four 48x48 tiles whose labels follow the image (so the loss can fall),
    with an ignored band; two train (one step an epoch), two validate."""
    root = tmp_path_factory.mktemp("oem_cli")
    for d in ("images", "labels", "list"):
        (root / d).mkdir()
    rng = np.random.RandomState(4)
    ids = [f"tile_{i}" for i in range(4)]
    for tid in ids:
        img = rng.randint(0, 256, (48, 48, 3)).astype(np.uint8)
        lab = (img[..., 0] // 32).astype(np.uint8)
        lab[:3] = 255
        write_tiff(str(root / "images" / f"{tid}.tif"), img)
        write_tiff(str(root / "labels" / f"{tid}.tif"), lab)
    (root / "list" / "train.txt").write_text("\n".join(ids[:2]) + "\n")
    (root / "list" / "val.txt").write_text("\n".join(ids[2:]) + "\n")
    return root


def _args(root, snap, *extra):
    return ["--data-dir", str(root), "--train-list", str(root / "list" / "train.txt"),
            "--val-list", str(root / "list" / "val.txt"), "--model", "convnext_pop",
            "--device", "cpu", "--fused", "--input-size", "32,32", "--base-size", "48,48",
            "--batch-size", "2", "--num-epoch", "3", "--snapshot-frequency", "1",
            "--val-start", "0", "--val-frequency", "1", "--print-frequency", "1",
            "--num-workers", "0", "--snapshot-dir", str(snap), *extra]


@pytest.fixture(scope="module")
def trained(root, tmp_path_factory):
    snap = tmp_path_factory.mktemp("snap")
    best = train_base.main(_args(root, snap, "--metrics"))
    return snap, best


def test_snapshots_best_and_metrics(trained):
    snap, best = trained
    for name in ("epoch_1.pth", "epoch_2.pth", "epoch_3.pth", "best.pth", "metrics.jsonl"):
        assert (snap / name).exists(), name
    rows = [json.loads(line) for line in (snap / "metrics.jsonl").read_text().splitlines()]
    tags = {r["tag"] for r in rows}
    assert {"train/total_loss", "train/seg_loss", "train/orth_loss", "train/lr",
            "train/grad_norm", "train/nonfinite_skipped", "val/mIoU"} <= tags
    assert all(np.isfinite(r["value"]) for r in rows)
    assert sum(r["tag"] == "train/total_loss" for r in rows) == 3  # a step an epoch
    assert [r["step"] for r in rows if r["tag"] == "val/mIoU"] == [1, 2, 3]
    assert 0.0 <= best <= 1.0
    blob = torch.load(snap / "epoch_2.pth", weights_only=False)
    assert set(blob) == {"state_dict", "optimizer", "epoch"} and blob["epoch"] == 2
    assert blob["optimizer"]["count"] == 2


def test_resume_reaches_the_same_weights(root, trained, tmp_path):
    snap, _ = trained
    train_base.main(_args(root, tmp_path, "--resume-from", str(snap / "epoch_2.pth")))
    want = torch.load(snap / "epoch_3.pth", weights_only=False)
    got = torch.load(tmp_path / "epoch_3.pth", weights_only=False)
    assert not (tmp_path / "epoch_2.pth").exists()
    assert got["epoch"] == 3 and got["optimizer"]["count"] == want["optimizer"]["count"] == 3
    for k, v in want["state_dict"].items():
        torch.testing.assert_close(got["state_dict"][k], v, rtol=0, atol=0, msg=k)


def test_best_pth_runs_in_eval_base_and_loads_into_jax(root, trained, tmp_path):
    from segland_tpu.ckpt.torch_convert import arch_for, load_torch_checkpoint
    from segland_tpu.models import build_model as j_build
    from segland_tpu_torch.cli import eval_base
    from segland_tpu_torch.models import build_model

    snap, _ = trained
    best = str(snap / "best.pth")
    res = eval_base.main(["--data-dir", str(root), "--val-list", str(root / "list" / "val.txt"),
                          "--model", "convnext_pop", "--restore-from", best, "--device", "cpu",
                          "--base-size", "48,48", "--num-workers", "0",
                          "--save-path", str(tmp_path / "eval")])
    assert 0.0 <= res[123][2] <= 1.0
    jm = j_build("convnext_pop", n_base=7)
    img = np.random.RandomState(0).randn(1, 32, 32, 3).astype(np.float32)
    template = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(img)))
    variables, info = load_torch_checkpoint(best, template,
                                            arch=arch_for("convnext_pop", "convnext-t"))
    assert info["missing"] == [] and info["unexpected"] == [] and info["loaded"] > 0
    want = np.asarray(jm.apply(variables, jnp.asarray(img)))
    model = build_model("convnext_pop", n_base=7)
    model.load_state_dict(torch.load(best, weights_only=False))
    with torch.no_grad():
        got = model(t(img).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


def test_seghr_trains_and_its_best_pth_loads_into_jax(root, tmp_path):
    """seghr_pop at hr-w18 (the reference's base-training model, HRNet at its
    narrowest) for 2 epochs with --no-packed-train, which builds HRNet's plain
    form: finite losses, snapshots, best.pth through eval_base and into the
    JAX package's load_torch_checkpoint (arch "hrnet") with nothing missing or
    unexpected.  --packed-train asks for the JAX package's W-packed layout,
    which the port does not carry, and raises."""
    from segland_tpu.ckpt.torch_convert import arch_for, load_torch_checkpoint
    from segland_tpu.models import build_model as j_build
    from segland_tpu_torch.cli import eval_base
    from torch_helpers import random_variables

    hr = ["--model", "seghr_pop", "--backbone", "hr-w18", "--no-fused", "--num-epoch", "2"]
    snap = tmp_path / "snap"
    best = train_base.main(_args(root, snap, "--metrics", *hr, "--no-packed-train"))
    assert 0.0 <= best <= 1.0
    rows = [json.loads(line) for line in (snap / "metrics.jsonl").read_text().splitlines()]
    assert sum(r["tag"] == "train/total_loss" for r in rows) == 2
    assert all(np.isfinite(r["value"]) for r in rows)
    for name in ("epoch_1.pth", "epoch_2.pth", "best.pth"):
        assert (snap / name).exists(), name
    res = eval_base.main(["--data-dir", str(root), "--val-list", str(root / "list" / "val.txt"),
                          "--model", "seghr_pop", "--backbone", "hr-w18",
                          "--restore-from", str(snap / "best.pth"), "--device", "cpu",
                          "--base-size", "48,48", "--num-workers", "0",
                          "--save-path", str(tmp_path / "eval")])
    assert 0.0 <= res[123][2] <= 1.0
    template = jax.tree_util.tree_map(np.zeros_like, random_variables(
        j_build("seghr_pop", "hr-w18", n_base=7), jnp.zeros((1, 32, 32, 3))))
    _, info = load_torch_checkpoint(str(snap / "best.pth"), template,
                                    arch=arch_for("seghr_pop", "hr-w18"))
    assert info["missing"] == [] and info["unexpected"] == [] and info["loaded"] > 1000
    with pytest.raises(ValueError, match="W-packed"):
        train_base.main(_args(root, tmp_path / "packed", *hr, "--packed-train"))


@pytest.mark.parametrize("name,backbone", [("pspplus_pop", "resnet10"), ("pspnet", "resnet10"),
                                           ("lsk_pop", "lsk-t"), ("vggunet_pop", "vgg16bn-unet")])
def test_the_last_registry_models_train(root, tmp_path, name, backbone):
    """The keys that raised before (ROADMAP A7, A9) train for 2 epochs: the POP
    ones on the orth loss, the plain pspnet on the CE loss with its aux head
    (the JAX CLI's pick by name); finite losses, snapshots, best.pth through
    eval_base.  --packed-train asks for the JAX package's W-packed layout of
    lsk-t and vgg16bn-unet and raises."""
    from segland_tpu_torch.cli import eval_base

    model = ["--model", name, "--backbone", backbone, "--no-fused", "--num-epoch", "2"]
    snap = tmp_path / "snap"
    best = train_base.main(_args(root, snap, "--metrics", *model))
    assert 0.0 <= best <= 1.0
    rows = [json.loads(line) for line in (snap / "metrics.jsonl").read_text().splitlines()]
    tags = {r["tag"] for r in rows}
    want = ({"train/main_loss", "train/aux_loss"} if name == "pspnet"
            else {"train/seg_loss", "train/orth_loss"})
    assert want | {"train/total_loss"} <= tags and not (tags & {"train/seg_loss",
                                                                  "train/main_loss"}) - want
    assert sum(r["tag"] == "train/total_loss" for r in rows) == 2
    assert all(np.isfinite(r["value"]) for r in rows)
    for f in ("epoch_1.pth", "epoch_2.pth", "best.pth"):
        assert (snap / f).exists(), f
    res = eval_base.main(["--data-dir", str(root), "--val-list", str(root / "list" / "val.txt"),
                          "--model", name, "--backbone", backbone,
                          "--restore-from", str(snap / "best.pth"), "--device", "cpu",
                          "--base-size", "48,48", "--num-workers", "0",
                          "--save-path", str(tmp_path / "eval")])
    assert 0.0 <= res[123][2] <= 1.0
    if name in ("lsk_pop", "vggunet_pop"):
        with pytest.raises(ValueError, match="W-packed"):
            train_base.main(_args(root, tmp_path / "packed", *model, "--packed-train"))


@pytest.mark.parametrize("extra,item", [
    (["--device-augment", "--dataset", "oem_ft"], "raw-tile"),
    (["--dataset", "oem_ft"], "A5"),
])
def test_what_does_not_train_yet_raises(root, tmp_path, extra, item):
    args = _args(root, tmp_path)
    with pytest.raises(ValueError, match=item):
        train_base.main(args + extra)


@pytest.mark.parametrize("flag", [["--fp16"], ["--momentum", "0.9"], ["--filter-novel"],
                                  ["--save-pred-every", "5"], ["--profile-dir", "p"],
                                  ["--ckpt-format", "msgpack"]])
def test_jax_flags_the_port_does_not_read_are_refused(root, tmp_path, flag, capsys):
    """A flag of the JAX package's train_base that nothing here would read
    stops the parse instead of being ignored."""
    with pytest.raises(SystemExit):
        train_base.main(_args(root, tmp_path) + flag)
    assert "unrecognized arguments: " + flag[0] in capsys.readouterr().err


def test_more_than_one_process_raises(root, tmp_path, monkeypatch):
    """WORLD_SIZE without the rest of the launcher's environment raises, naming
    what is missing, instead of waiting for a rendezvous (a whole launch over
    two processes: tests/test_torch_dist.py)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="RANK must be set"):
        train_base.main(_args(root, tmp_path))


def test_device_augment_trains(root, tmp_path):
    """--device-augment: the raw 48^2 tiles, brought to --base-size, are
    augmented inside the step; the loss dicts carry aug_fallback."""
    snap = tmp_path / "aug"
    args = _args(root, snap, "--device-augment", "--metrics")
    args[args.index("--num-epoch") + 1] = "1"
    best = train_base.main(args)
    rows = [json.loads(line) for line in (snap / "metrics.jsonl").read_text().splitlines()]
    assert [r["value"] for r in rows if r["tag"] == "train/aug_fallback"] == [0.0]
    assert all(np.isfinite(r["value"]) for r in rows) and 0.0 <= best <= 1.0


def test_the_default_device_is_the_card(root, tmp_path):
    """No fallback: without --device cpu the run asks for CUDA and fails here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default would train on it")
    args = [a for a in _args(root, tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises((AssertionError, RuntimeError)):
        train_base.main(args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_train_default_of_fused(dtype):
    """Off for every model (the kernels' train routes are slower than the
    stock-torch blocks on the card, PERF.md); --fused and --no-fused win."""
    from segland_tpu_torch.cli.common import TRAIN_FUSED_DEFAULTS, resolve_fused

    parse = lambda extra: train_base.get_parser().parse_args(
        ["--data-dir", "x", "--model", "convnext_pop", "--dtype", dtype] + extra)
    assert TRAIN_FUSED_DEFAULTS == {"convnext_pop": False, "swin_pop": False,
                                    "seghr_pop": False}
    assert resolve_fused(parse([]), "train") is False
    assert resolve_fused(parse(["--fused"]), "train") is True
    assert resolve_fused(parse(["--no-fused"]), "train") is False
