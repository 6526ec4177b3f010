"""Ensemble serving and scene prediction of the port against the JAX package
on the CPU: EnsembleEvaluator (one native resolution, which takes the fused
upsample + argmax's plain version, and two), the ensemble_eval CLI over .pth
members, _tile_starts, predict_scene, predict_scene_device and the predict
CLI.  Weights are drawn with numpy (torch_helpers.random_variables) and
carried across by load_port.  Bars: summed upsampled logits 5e-4 absolute;
class maps equal except where the top-2 logits lie within 1e-3; confusion
matrices equal."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft_helpers import narrow_backbones
from torch_helpers import load_port, near_tie_pixels, one_torch_thread, random_variables
from segland_tpu.models import build_model as j_build
from segland_tpu.ops.resize import resize_bilinear as j_resize
from segland_tpu_torch.ckpt import save_params
from segland_tpu_torch.data.geotiff import write_tiff
from segland_tpu_torch.evallib import EnsembleEvaluator
from segland_tpu_torch.models import build_model
from segland_tpu_torch.ops.resize import resize_bilinear

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HW = 32
# (model, backbone, seed): two pspnet_pop members logits at stride 8, convnext_pop at stride 4
MEMBERS = (("pspnet_pop", "resnet10", 0), ("pspnet_pop", "resnet10", 1),
           ("convnext_pop", "convnext-t", 2))


@pytest.fixture(scope="module")
def narrow():
    """convnext-t narrow in both packages while the module's tests run."""
    mp = pytest.MonkeyPatch()
    narrow_backbones(mp)
    yield
    mp.undo()


def _member(name, backbone, seed, n_base=7, port=None):
    """(JAX module, its variables drawn from ``seed``, the port model with the
    same weights).  The port model is built on the meta device, so that no
    init is drawn before load_port fills it (resnet10's PSP head alone draws
    12M weights), or copied from ``port``, a model of the same architecture."""
    jm = j_build(name, backbone=backbone, n_base=n_base)
    v = random_variables(jm, jnp.zeros((1, HW, HW, 3)), seed=seed)
    if port is None:
        with torch.device("meta"):
            port = build_model(name, backbone, n_base=n_base, device="meta")
        port = port.to_empty(device="cpu")
    else:
        port = copy.deepcopy(port)
    return jm, v, load_port(port, v)


@pytest.fixture(scope="module")
def members(narrow):
    """[(JAX module, variables, port model)] with the same weights."""
    out = []
    for name, backbone, seed in MEMBERS:
        same = [m for (n, _, _), m in zip(MEMBERS, out) if n == name]
        out.append(_member(name, backbone, seed, port=same[0][2] if same else None))
    return out


@pytest.fixture(scope="module")
def batch_ups(members):
    """A batch, and each member's fp32 logits on it upsampled on the JAX side
    (fusemat's maps before the sum)."""
    img = np.random.RandomState(3).rand(2, HW, HW, 3).astype(np.float32)

    def f(vs, x):
        return [j_resize(jm.apply(v, x, train=False).astype(jnp.float32), (HW, HW),
                         align_corners=True) for (jm, _, _), v in zip(members, vs)]

    return img, [np.asarray(u) for u in jax.jit(f)([v for _, v, _ in members], img)]


@pytest.mark.parametrize("n_members,groups", [(2, 1), (3, 2)])
def test_ensemble_evaluator_matches_jax(members, batch_ups, monkeypatch, n_members, groups):
    """Two pspnet members share one native resolution: the sum takes
    upsample_argmax (K2's plain version here) once; with the convnext member
    there are two groups, each resized, summed and argmaxed."""
    from segland_tpu.evallib import EnsembleEvaluator as JEnsemble
    from segland_tpu_torch.evallib import ensemble as ens_mod

    sel = members[:n_members]
    img, ups = batch_ups
    want_sum = sum(ups[1:n_members], ups[0])
    want = np.asarray(JEnsemble([(jm, v) for jm, v, _ in sel], num_classes=8,
                                n_base=7).predict_batch(img, (HW, HW)))

    calls = []
    fused = ens_mod.upsample_argmax
    monkeypatch.setattr(ens_mod, "upsample_argmax",
                        lambda x, hw: calls.append(tuple(x.shape)) or fused(x, hw))
    ens = EnsembleEvaluator([m for _, _, m in sel], "cpu", num_classes=8, n_base=7)
    got_sum = ens.summed_logits(img, (HW, HW)).numpy()
    got = ens.predict_batch(img, (HW, HW)).numpy()
    assert calls == ([(2, HW // 8, HW // 8, 8)] if groups == 1 else [])
    assert got_sum.shape == (2, HW, HW, 8) and got.dtype == np.uint8
    np.testing.assert_allclose(got_sum, want_sum, rtol=0, atol=5e-4)
    differ = got != want
    assert not (differ & ~near_tie_pixels(want_sum)).any(), int(differ.sum())
    # a ragged batch padded and sliced back gives the same map
    np.testing.assert_array_equal(ens.predict_batch(img, (HW, HW), batch_pad=4).numpy(), got)


def _tiles(root, n_labelled=3, n_unlabelled=0, seed=0, classes=8):
    for d in ("images", "labels"):
        (root / d).mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    ids = [f"t{i}" for i in range(n_labelled + n_unlabelled)]
    for i, tid in enumerate(ids):
        write_tiff(str(root / "images" / f"{tid}.tif"),
                   rng.randint(0, 256, (HW, HW, 3)).astype(np.uint8))
        if i < n_labelled:
            write_tiff(str(root / "labels" / f"{tid}.tif"),
                       rng.randint(0, classes, (HW, HW)).astype(np.uint8))
    lst = root / "val.txt"
    lst.write_text("\n".join(ids) + "\n")
    return lst


def _save(d, name, model):
    path = str(d / f"{name}.pth")
    save_params(path, model)
    return f"convnext_pop:convnext-t:{path}"


@pytest.fixture(scope="module")
def pth_members(narrow, tmp_path_factory):
    """Two narrow convnext_pop members as upstream-keyed .pth member specs (cheap
    to build again in the CLIs, unlike resnet10's PSP head)."""
    d = tmp_path_factory.mktemp("members")
    return [_save(d, f"m{seed}", _member("convnext_pop", "convnext-t", seed)[2])
            for seed in (5, 6)]


def test_ensemble_eval_cli_matches_jax_cli(pth_members, tmp_path):
    from segland_tpu.cli.ensemble_eval import main as j_main
    from segland_tpu_torch.cli.ensemble_eval import main

    lst = _tiles(tmp_path / "data")
    common = ["--data-dir", str(tmp_path / "data"), "--val-list", str(lst), "--members",
              ",".join(pth_members), "--base-size", f"{HW},{HW}", "--num-classes", "8",
              "--num-workers", "0", "--eval-batch", "2"]
    want = j_main(common + ["--save-path", str(tmp_path / "jax")])
    got = main(common + ["--save-path", str(tmp_path / "port"), "--device", "cpu"])
    cm = np.load(tmp_path / "port" / "cmatrix_ensemble.npy")
    np.testing.assert_array_equal(cm, np.load(tmp_path / "jax" / "cmatrix_ensemble.npy"))
    assert cm.sum() == 3 * HW * HW
    assert got["total"] == pytest.approx(want["total"], abs=1e-12)


def test_ensemble_eval_cli_takes_base_classes(narrow, tmp_path):
    """A member with 5 base classes: the JAX CLI, whose n_base is 7 whatever
    --base-classes says, cannot load it; the port's takes --base-classes, its
    confusion matrix is the JAX EnsembleEvaluator's over the same tree, and
    unlabelled tiles export class maps."""
    from segland_tpu.cli.ensemble_eval import main as j_main
    from segland_tpu.data import Loader as JLoader, OEMValDataset as JVal
    from segland_tpu.evallib import EnsembleEvaluator as JEnsemble
    from segland_tpu_torch.cli.ensemble_eval import main
    from segland_tpu_torch.data.tileio import read_label

    lst = _tiles(tmp_path / "data", n_labelled=2, n_unlabelled=1, classes=6)
    jm, v, port = _member("convnext_pop", "convnext-t", 4, n_base=5)
    spec = _save(tmp_path, "n5", port)
    common = ["--data-dir", str(tmp_path / "data"), "--members", spec, "--base-size",
              f"{HW},{HW}", "--num-classes", "6", "--base-classes", "5", "--num-workers", "0",
              "--eval-batch", "2"]
    labelled = tmp_path / "labelled.txt"
    labelled.write_text("t0\nt1\n")
    with pytest.raises(ValueError, match="shape mismatch"):
        j_main(common + ["--val-list", str(labelled), "--save-path", str(tmp_path / "jax")])
    main(common + ["--val-list", str(labelled), "--save-path", str(tmp_path / "port"),
                   "--device", "cpu"])
    loader = JLoader(JVal(str(tmp_path / "data"), str(labelled), base_size=(HW, HW)), 2)
    want, _, _ = JEnsemble([(jm, v)], num_classes=6, n_base=5).run(loader)
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "cmatrix_ensemble.npy"), want)

    unlabelled = tmp_path / "unlabelled.txt"
    unlabelled.write_text("t2\n")
    out = main(common + ["--val-list", str(unlabelled), "--save-path", str(tmp_path / "export"),
                         "--device", "cpu"])
    assert out == {"written": 1}
    pred = read_label(str(tmp_path / "export" / "t2.tif"))
    assert pred.shape == (HW, HW) and pred.max() < 6


@pytest.mark.parametrize("spec", ["pspnet_pop:resnet10", "pspnet_pop:resnet10:m.pth:float16",
                                  "a:b:c:bfloat16:x"])
def test_member_spec_rejects_bad_specs(spec):
    from segland_tpu_torch.cli.ensemble_eval import parse_member

    with pytest.raises(ValueError):
        parse_member(spec)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_member_spec_dtypes(dtype):
    from segland_tpu_torch.cli.ensemble_eval import parse_member

    assert parse_member(f"swin_pop:swin-s:w.pth:{dtype}") == ("swin_pop", "swin-s", "w.pth",
                                                               dtype)
    assert parse_member("swin_pop:swin-s:w.pth")[3] == "float32"


@pytest.mark.parametrize("size,tile,stride", [(1024, 1024, 896), (2048, 1024, 896),
                                              (500, 1024, 896), (4096, 1024, 896),
                                              (150, 64, 48), (200, 64, 48), (64, 64, 48)])
def test_tile_starts_match_jax(size, tile, stride):
    from segland_tpu.evallib.tiled import _tile_starts as j_starts
    from segland_tpu_torch.evallib.tiled import _tile_starts

    assert _tile_starts(size, tile, stride) == j_starts(size, tile, stride)


TILE, OVERLAP = 64, 16


@pytest.fixture(scope="module")
def scene_model(members):
    """The convnext member, and a tile forward of each package: logits
    upsampled to the tile (align_corners=True)."""
    jm, v, port = members[2]
    j_fwd = jax.jit(lambda x: j_resize(jm.apply(v, x, train=False).astype(jnp.float32),
                                       (TILE, TILE), align_corners=True))

    @torch.inference_mode()
    def p_fwd(x):
        lg = port(torch.as_tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float()
        return resize_bilinear(lg, (TILE, TILE), align_corners=True)

    return j_fwd, p_fwd


def test_predict_scene_matches_jax(scene_model):
    from segland_tpu.evallib.tiled import predict_scene as j_predict_scene
    from segland_tpu_torch.evallib.tiled import predict_scene

    j_fwd, p_fwd = scene_model
    scene = np.random.RandomState(5).rand(150, 200, 3).astype(np.float32)
    want_lg, want = j_predict_scene(lambda t: j_fwd(jnp.asarray(t)), scene, 8, tile=TILE,
                                    overlap=OVERLAP, batch=4)
    got_lg, got = predict_scene(lambda t: p_fwd(t).numpy(), scene, 8, tile=TILE,
                                overlap=OVERLAP, batch=4)
    assert got_lg.shape == (150, 200, 8) and got.shape == (150, 200)
    np.testing.assert_allclose(got_lg, want_lg, rtol=0, atol=5e-4)
    assert not ((got != want) & ~near_tie_pixels(want_lg)).any()


@pytest.mark.parametrize("hw,batch", [((150, 200), 4), ((150, 200), 5), ((30, 40), 3)])
def test_predict_scene_device_matches_host(scene_model, hw, batch):
    """12 tiles in batches of 4, and of 5 (the last batch padded with 3
    repeats of the last tile, which are not added); a scene smaller than a
    tile, zero-padded to it (one tile, 2 repeats).  Every tile runs at the
    batch's shape, and the map equals the host path's bit for bit here."""
    from segland_tpu_torch.evallib.tiled import predict_scene, predict_scene_device

    _, p_fwd = scene_model
    shapes = []

    def fwd(t):
        shapes.append(tuple(t.shape))
        return p_fwd(t)

    scene = np.random.RandomState(6).rand(*hw, 3).astype(np.float32)
    _, want = predict_scene(lambda t: p_fwd(t).numpy(), scene, 8, tile=TILE, overlap=OVERLAP,
                            batch=batch)
    got = predict_scene_device(fwd, scene, 8, "cpu", tile=TILE, overlap=OVERLAP, batch=batch)
    assert got.dtype == np.uint8 and got.shape == hw
    np.testing.assert_array_equal(got, want)
    n_tiles = 12 if hw == (150, 200) else 1
    assert shapes == [(batch, TILE, TILE, 3)] * -(-n_tiles // batch)


def test_predict_cli_matches_jax_cli(pth_members, tmp_path):
    """Both packages' predict CLIs on one 100x130 scene from one .pth take the
    device path (3 batches of 2 tiles, so the JAX path adds no repeated tile)
    and write the same map; --int8 takes the port's host path."""
    from segland_tpu.cli.predict import main as j_main
    from segland_tpu_torch.cli.predict import main
    from segland_tpu_torch.data.tileio import read_label

    (tmp_path / "in").mkdir()
    write_tiff(str(tmp_path / "in" / "scene.tif"),
               np.random.RandomState(8).randint(0, 256, (100, 130, 3)).astype(np.uint8))
    common = ["--data-dir", str(tmp_path), "--input", str(tmp_path / "in"), "--model",
              "convnext_pop", "--backbone", "convnext-t",
              "--restore-from", pth_members[0].split(":")[2],
              "--tile", str(TILE), "--overlap", str(OVERLAP), "--eval-batch", "2"]
    assert j_main(common + ["--output", str(tmp_path / "jax")]) == 1
    assert main(common + ["--output", str(tmp_path / "port"), "--device", "cpu"]) == 1
    want = read_label(str(tmp_path / "jax" / "scene.tif"))
    got = read_label(str(tmp_path / "port" / "scene.tif"))
    assert got.shape == (100, 130)
    np.testing.assert_array_equal(got, want)
    main(common + ["--output", str(tmp_path / "int8"), "--device", "cpu", "--int8",
                   "--calib-batches", "1"])
    assert read_label(str(tmp_path / "int8" / "scene.tif")).shape == (100, 130)
