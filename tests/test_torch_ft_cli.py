"""``python -m segland_tpu_torch.cli.ft_pop`` end to end on the CPU
(``--device cpu``) on tiny GeoTIFF tiles, ``pspnet_pop`` / ``resnet10`` from
a base ``.pth``, two seeds (support lists from the port's ``gen_fs_list``):
``best_<seed>.pth`` per seed with the frozen tensors (backbone, decoder,
classifier, base_emb, BatchNorm statistics) bit-equal to the base model's and
the novel head moved; its ``validate_ft`` numbers equal the JAX
``validate_ft``'s on the same weights (read by the JAX package's
``load_torch_checkpoint``, nothing missing) and tiles; the port's ``eval_ft``
loads each seed's file; ``seghr_pop`` / ``hr-w18`` fine-tunes for an epoch.  Then
what the CLI refuses."""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segland_tpu_torch.ckpt import save_params
from segland_tpu_torch.cli import ft_pop, gen_fs_list
from segland_tpu_torch.data.geotiff import write_tiff
from segland_tpu_torch.models import build_model
from segland_tpu_torch.train import ft_trainable
from torch_helpers import one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SEEDS = (123, 234)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Ten 48x48 tiles of 16x16 blocks of one class each, the image a block's
    colour plus noise; novel classes in half the tiles; an ignored band.
    Eight train, two validate; a support list a seed; a base model's .pth."""
    root = tmp_path_factory.mktemp("oem_ft_cli")
    for d in ("images", "labels", "list"):
        (root / d).mkdir()
    rng = np.random.RandomState(8)
    palette = rng.randint(0, 256, (12, 3))
    ids = [f"tile_{i}" for i in range(10)]
    for i, tid in enumerate(ids):
        blocks = rng.randint(0, 8 if i % 2 else 12, (3, 3))
        lab = blocks.repeat(16, 0).repeat(16, 1)
        img = np.clip(palette[lab] + rng.randn(48, 48, 3) * 10, 0, 255).astype(np.uint8)
        lab = lab.astype(np.uint8)
        lab[:2] = 255
        write_tiff(str(root / "images" / f"{tid}.tif"), img)
        write_tiff(str(root / "labels" / f"{tid}.tif"), lab)
    (root / "list" / "train.txt").write_text("\n".join(ids[:8]) + "\n")
    (root / "list" / "val.txt").write_text("\n".join(ids[8:]) + "\n")
    for seed in SEEDS:
        gen_fs_list.main(["--data-dir", str(root), "--train-list", str(root / "list" / "train.txt"),
                          "--shot", "2", "--seed", str(seed)])
    save_params(str(root / "base.pth"), build_model(
        "pspnet_pop", "resnet10", n_base=7, generator=torch.Generator().manual_seed(0)))
    return root


def _args(root, snap, *extra):
    return ["--data-dir", str(root), "--train-list", str(root / "list" / "train.txt"),
            "--val-list", str(root / "list" / "val.txt"), "--model", "pspnet_pop",
            "--backbone", "resnet10", "--device", "cpu", "--restore-from",
            str(root / "base.pth"), "--input-size", "32,32", "--base-size", "48,48",
            "--batch-size", "2", "--num-epoch", "2", "--shot", "2", "--update-base",
            "--fix-lr", "--learning-rate", "1e-2", "--val-frequency", "1",
            "--print-frequency", "1", "--num-workers", "0", "--snapshot-dir", str(snap), *extra]


@pytest.fixture(scope="module")
def tuned(root, tmp_path_factory):
    snap = tmp_path_factory.mktemp("snap_ft")
    results = ft_pop.main(_args(root, snap, "--random-seed", ",".join(map(str, SEEDS)),
                                "--metrics"))
    return snap, results


def test_best_per_seed_keeps_the_frozen_tensors(root, tuned):
    snap, results = tuned
    base = torch.load(root / "base.pth", weights_only=False)
    for seed in SEEDS:
        assert set(results[seed]) == {"total", "base", "novel", "epoch"}
        assert results[seed]["base"] > 0 and results[seed]["epoch"] in (1, 2)
        best = torch.load(snap / f"best_{seed}.pth", weights_only=False)
        assert set(best) == set(base) | {"novel_emb", "classifier_n.0.weight",
                                         "classifier_n.2.weight", "classifier_n.4.weight"}
        for k, v in base.items():
            assert torch.equal(best[k], v), k
        fresh = build_model("pspnet_pop", "resnet10", n_base=7, n_novel=4, is_ft=True,
                            generator=torch.Generator().manual_seed(seed)).state_dict()
        for k in best:
            if ft_trainable(k):
                init = (base[k.replace("classifier_n", "classifier")] if "classifier" in k
                        else fresh[k])
                assert not torch.equal(best[k], init), k
    rows = [json.loads(line) for line in (snap / "metrics.jsonl").read_text().splitlines()]
    tags = {r["tag"] for r in rows}
    for seed in SEEDS:
        assert {f"seed{seed}/train/total_loss", f"seed{seed}/train/nonfinite_skipped",
                f"seed{seed}/val/base_mIoU", f"seed{seed}/val/novel_mIoU"} <= tags
    assert all(np.isfinite(r["value"]) for r in rows)
    assert sum(r["tag"] == f"seed{SEEDS[0]}/train/total_loss" for r in rows) == 14  # 7 a epoch


def test_validate_ft_matches_jax_on_the_best_weights(root, tuned):
    """The best checkpoint, read by both packages, scored by both
    validate_ft on the same tiles: the port's (base, novel, total) equal the
    JAX package's and the numbers the run reported for its best epoch."""
    from segland_tpu.ckpt.torch_convert import arch_for, load_torch_checkpoint
    from segland_tpu.cli.ft_pop import validate_ft as j_validate_ft
    from segland_tpu.data import Loader as JLoader, OEMValDataset as JVal
    from segland_tpu.models import build_model as j_build
    from segland_tpu.train.base import make_eval_step as j_eval_step
    from segland_tpu_torch.data import Loader, OEMValDataset
    from segland_tpu_torch.train import make_eval_step

    snap, results = tuned
    path = str(snap / f"best_{SEEDS[0]}.pth")
    jm = j_build("pspnet_pop", backbone="resnet10", n_base=7, n_novel=4, is_ft=True)
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False),
                            jnp.zeros((1, 48, 48, 3)))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables, info = load_torch_checkpoint(path, template, is_restore=True,
                                            arch=arch_for("pspnet_pop", "resnet10"))
    assert info["missing"] == [] and info["unexpected"] == [] and info["loaded"] > 0
    kw = dict(base_size=(48, 48), resize_label=True, use_novel=True, use_base=True)
    lst = str(root / "list" / "val.txt")
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    want = j_validate_ft(state, jax.jit(j_eval_step(jm, 12)),
                         JLoader(JVal(str(root), lst, **kw), 1), 12, 7)
    model = build_model("pspnet_pop", "resnet10", n_base=7, n_novel=4, is_ft=True)
    model.load_state_dict(torch.load(path, weights_only=False))
    got = ft_pop.validate_ft(make_eval_step(model, 12),
                             Loader(OEMValDataset(str(root), lst, **kw), 1), torch.device("cpu"),
                             12, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    best = results[SEEDS[0]]
    np.testing.assert_allclose(got, (best["base"], best["novel"], best["total"]), rtol=0,
                               atol=1e-12)


def test_eval_ft_loads_each_seeds_best(root, tuned, tmp_path, monkeypatch):
    from segland_tpu_torch.cli import eval_base, eval_ft

    snap, _ = tuned
    loaded = []
    load = eval_base.load_pth

    def recording(model, path, **kw):
        loaded.append((path, load(model, path, **kw)))
        return loaded[-1][1]

    monkeypatch.setattr(eval_base, "load_pth", recording)
    res = eval_ft.main(["--data-dir", str(root), "--val-list", str(root / "list" / "val.txt"),
                        "--model", "pspnet_pop", "--backbone", "resnet10", "--device", "cpu",
                        "--restore-from", str(snap / "best.pth"), "--base-size", "48,48",
                        "--random-seed", ",".join(map(str, SEEDS)), "--num-workers", "0",
                        "--save-path", str(tmp_path / "eval")])
    assert [p for p, _ in loaded] == [str(snap / f"best_{s}.pth") for s in SEEDS]
    assert all(missing == [] and unexpected == [] for _, (_, missing, unexpected) in loaded)
    for seed in SEEDS:
        assert 0.0 <= res[seed][2] <= 1.0


def test_seghr_fine_tunes_one_epoch(root, tmp_path):
    """seghr_pop / hr-w18 from a base .pth for one epoch (--no-packed-train):
    best_123.pth keeps every frozen tensor of the base bit for bit, and its
    novel head moved from where it started."""
    base_path = tmp_path / "seghr_base.pth"
    save_params(str(base_path), build_model("seghr_pop", "hr-w18", n_base=7,
                                            generator=torch.Generator().manual_seed(0)))
    snap = tmp_path / "snap"
    res = ft_pop.main(_args(root, snap) + ["--model", "seghr_pop", "--backbone", "hr-w18",
                                           "--restore-from", str(base_path), "--num-epoch", "1",
                                           "--no-packed-train"])
    assert set(res) == {123} and res[123]["epoch"] == 1
    base = torch.load(base_path, weights_only=False)
    best = torch.load(snap / "best_123.pth", weights_only=False)
    assert set(best) == set(base) | {"novel_emb", "classifier_n.0.weight",
                                     "classifier_n.2.weight", "classifier_n.4.weight"}
    for k, v in base.items():
        assert torch.equal(best[k], v), k
    fresh = build_model("seghr_pop", "hr-w18", n_base=7, n_novel=4, is_ft=True,
                        generator=torch.Generator().manual_seed(123)).state_dict()
    for k in best:
        if ft_trainable(k):
            init = base[k.replace("classifier_n", "classifier")] if "classifier" in k else fresh[k]
            assert not torch.equal(best[k], init), k


def test_restore_refuses_a_ckpt_and_a_shape_mismatch(root, tmp_path):
    with pytest.raises(NotImplementedError, match=".ckpt"):
        ft_pop.main(_args(root, tmp_path) + ["--restore-from", str(tmp_path / "best.ckpt")])
    other = tmp_path / "six.pth"
    save_params(str(other), build_model("pspnet_pop", "resnet10", n_base=6))
    with pytest.raises(RuntimeError, match="size mismatch"):
        ft_pop.main(_args(root, tmp_path) + ["--restore-from", str(other)])


def test_more_than_one_process_raises(root, tmp_path, monkeypatch):
    """WORLD_SIZE without the rest of the launcher's environment raises, naming
    what is missing (a whole launch over two processes: tests/test_torch_dist.py)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="RANK must be set"):
        ft_pop.main(_args(root, tmp_path))


def test_the_default_device_is_the_card(root, tmp_path):
    """No fallback: without --device cpu the run asks for CUDA and fails here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default would fine-tune on it")
    args = [a for a in _args(root, tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises((AssertionError, RuntimeError)):
        ft_pop.main(args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_ft_default_of_fused(dtype):
    """FT_FUSED_DEFAULTS applies under --dtype bfloat16 only; --fused and
    --no-fused win; --momentum and --filter-novel parse here (train_base
    refuses them)."""
    from segland_tpu_torch.cli.common import FT_FUSED_DEFAULTS, resolve_fused

    for model in ("swin_pop", "convnext_pop", "pspnet_pop"):
        parse = lambda extra: ft_pop.get_parser().parse_args(
            ["--data-dir", "x", "--model", model, "--dtype", dtype, "--momentum", "0.8",
             "--filter-novel"] + extra)
        want = dtype == "bfloat16" and FT_FUSED_DEFAULTS.get(model, False)
        assert resolve_fused(parse([]), "ft") is want
        assert resolve_fused(parse(["--fused"]), "ft") is True
        assert resolve_fused(parse(["--no-fused"]), "ft") is False
        assert parse([]).momentum == 0.8 and parse([]).filter_novel
