"""The port's trained-model accuracy gates (segland_tpu_torch/benchmarks/
accuracy_gates.py) against the JAX package's benchmarks/tpu_accuracy_gates.py,
and the PIL-free synthetic task (benchmarks/synthtask.py) against
tests/synthtask.py.

The JAX script is imported from its file.  Importing it points JAX's
persistent compilation cache at ~/.cache/segland_tpu/jax and puts two fixed
folders at the front of sys.path; the module fixture puts both JAX settings
and sys.path back as they were, so the other tests of the worker import and
run as before.  On the CPU every kernel arm of the port takes the
kernels' plain versions: these tests hold the wiring, the task and the
verdict; the card holds the kernels (chip_smoke.py --phases gates)."""

import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import synthtask as jax_task
from torch_helpers import load_port, meta_build, random_variables
from segland_tpu_torch.benchmarks import accuracy_gates as G
from segland_tpu_torch.benchmarks import synthtask as port_task

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def jax_gates():
    old = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    path, modules = list(sys.path), set(sys.modules)
    spec = importlib.util.spec_from_file_location(
        "tpu_accuracy_gates", ROOT / "benchmarks" / "tpu_accuracy_gates.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in old.items():
            jax.config.update(k, v)
        sys.path[:] = path
    assert sys.path == path
    # nothing was imported from the folders it put first
    assert set(sys.modules) == modules
    return mod


@pytest.fixture(scope="module")
def task_root(tmp_path_factory):
    return port_task.build_task(tmp_path_factory.mktemp("gates") / "task")


def test_task_equals_the_jax_task(tmp_path, task_root):
    """Tile for tile the same decoded images and labels, the same list files:
    the port's tiles read by the port's readers (the native decoder), the JAX
    side's by PIL."""
    from PIL import Image

    from segland_tpu_torch import native
    from segland_tpu_torch.data.tileio import read_image, read_label

    jroot = tmp_path / "jax"
    jroot.mkdir()
    jax_task.build_task(jroot)
    assert np.array_equal(port_task.PALETTE, jax_task.PALETTE)
    assert (port_task.SIZE, port_task.NOISE) == (jax_task.SIZE, jax_task.NOISE)
    lists = sorted(p.name for p in (jroot / "list").iterdir())
    assert lists == sorted(p.name for p in (task_root / "list").iterdir())
    assert lists == ["all_5shot_seed123.txt", "train.txt", "val.txt", "val_base.txt"]
    for name in lists:
        assert (task_root / "list" / name).read_text() == (jroot / "list" / name).read_text()
    ids = sorted(p.stem for p in (jroot / "images").iterdir())
    assert len(ids) == 16 + 20 + 4 + 4
    for d in ("images", "labels"):
        assert ids == sorted(p.stem for p in (task_root / d).iterdir())
    for tid in ids:
        img, lab = (str(task_root / d / f"{tid}.tif") for d in ("images", "labels"))
        if native.get_lib() is not None:
            assert native.decode(img) is not None and native.decode(lab) is not None
        want_img = np.asarray(Image.open(jroot / "images" / f"{tid}.tif"))
        want_lab = np.asarray(Image.open(jroot / "labels" / f"{tid}.tif"))
        got_img, got_lab = read_image(img), read_label(lab)
        assert got_img.dtype == want_img.dtype == np.uint8 and got_img.shape == (64, 64, 3)
        assert np.array_equal(got_img, want_img), tid
        assert np.array_equal(got_lab, want_lab), tid


def _verdict_case(case):
    """(a, b, pred_a, pred_b) of ``case``: 10,000 pixels."""
    pred_a = np.arange(10_000, dtype=np.uint8) % 8
    pred_b = pred_a.copy()
    a = (0.5, 0.4)
    if case == "agreement_just_under":
        pred_b[:101] += 1  # 0.9899
        return a, a, pred_a, pred_b
    if case == "total_just_over":
        return a, (0.5, 0.4 + 0.00201), pred_a, pred_b
    if case == "base_alone_over":
        return a, (0.5 - 0.00201, 0.4), pred_a, pred_b
    pred_b[:99] += 1  # 0.9901
    return a, (0.5 + 0.0019, 0.4 - 0.0019), pred_a, pred_b


@pytest.mark.parametrize("case,want", [("agreement_just_under", False),
                                       ("total_just_over", False),
                                       ("base_alone_over", False), ("pass", True)])
def test_gate_verdict_equals_the_jax_scripts(jax_gates, case, want, capsys):
    a, b, pa, pb = _verdict_case(case)
    assert jax_gates.gate(case, a, b, pa, pb) is want
    rec = G.gate(case, a, b, pa, pb)
    assert rec["ok"] is want
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith("PASS" if want else "FAIL") and out[1].endswith(out[0][-4:])
    assert rec["agreement"] == pytest.approx(float(np.mean(pa == pb)))


def test_run_eval_equals_the_jax_scripts(jax_gates, task_root):
    """pspnet_pop / resnet10 in fp32 on the CPU, the JAX variables drawn with
    numpy and carried into the port by the converter: the same (base, total)
    mIoU within 1e-6 and the same predictions as the JAX script's run_eval."""
    import jax.numpy as jnp

    from segland_tpu.models import build_model as j_build
    from segland_tpu_torch.models import build_model

    jm = j_build("pspnet_pop", "resnet10", n_base=7)
    v = random_variables(jm, jnp.zeros((1, 64, 64, 3)), train=False)
    port = load_port(meta_build(build_model, "pspnet_pop", "resnet10", n_base=7), v)
    (jb, jt), jpred = jax_gates.run_eval(task_root, jm, v, fused_epilogue=False)
    (b, t), pred = G.run_eval(task_root, port, torch.device("cpu"))
    assert pred.shape == jpred.shape == (4, 64, 64) and pred.dtype == np.uint8
    assert len(np.unique(pred)) >= 2
    assert abs(b - jb) <= 1e-6 and abs(t - jt) <= 1e-6, ((b, t), (jb, jt))
    assert np.array_equal(pred, np.asarray(jpred))


def _spy_on_records(monkeypatch):
    """Records the (trained, gate records) that ``main`` judges."""
    got = []
    faults = G.faults

    def spy(trained, records, device):
        got.append((trained, records))
        return faults(trained, records, device)

    monkeypatch.setattr(G, "faults", spy)
    return got


def test_main_rehearsal_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``main --device cpu`` on G2 after one epoch: it trains through the
    port's train_base, prints the GATE line and the trained model's line, and
    its exit code is that of its faults.  One epoch leaves the model near its
    init (it predicts fewer than 4 classes), so the run also shows the
    degenerate check failing it.  (chip_smoke.py runs each model's gates in a
    process of their own, ``--jobs``: the slow test below takes that path.)"""
    got = _spy_on_records(monkeypatch)
    rc = G.main(["--device", "cpu", "--gates", "G2", "--epochs", "1",
                 "--work-dir", str(tmp_path / "work")])
    lines = capsys.readouterr().out.splitlines()
    ((trained,), (gate,)), = got
    assert trained["model"] == "pspnet_pop" and trained["epochs"] == 1
    assert trained["weights"] == G.fingerprint(tmp_path / "work" / "snap_pspnet" / "best.pth")
    assert gate["gate"] == "G2" and gate["dtype"] == "bfloat16" and gate["hard"]
    assert gate["launches_a"] == gate["launches_b"] == {} and gate["batches"] == 4
    gate_lines = [ln for ln in lines if ln.startswith("GATE G2 pspnet_pop/resnet10 bfloat16")]
    assert len(gate_lines) == 1
    assert f"agreement {gate['agreement']:.5f}" in gate_lines[0]
    assert f"d_total {gate['d_total']:.5f}" in gate_lines[0]
    assert any(re.match(r"trained pspnet_pop/resnet10 \(bfloat16, 1 epochs of 32\^2", ln)
               and ln.endswith(f"weights {trained['weights']} -> DEGENERATE") for ln in lines)
    found = G.faults([trained], [gate], "cpu")
    assert trained["degenerate"] and any("degenerate" in f for f in found)
    assert rc == 1 and [ln for ln in lines if ln.startswith("FAULT")] == [
        f"FAULT {f}" for f in found]
    # training left the process's deterministic settings as they were
    assert not torch.are_deterministic_algorithms_enabled()
    assert not torch.backends.cudnn.deterministic


@pytest.mark.parametrize("out_hw,align_corners", [((32, 32), True), ((13, 21), True),
                                                  ((13, 21), False), ((3, 2), False)])
def test_resize_as_products_equals_interpolate(out_hw, align_corners):
    """The deterministic training's resize: values and gradients of the two
    matmuls equal ``F.interpolate``'s (bf16 in, as the trainer's decoders
    take it, and fp32, as its loss does)."""
    from segland_tpu_torch.ops.resize import resize_as_products, resize_bilinear

    x = torch.from_numpy(np.random.RandomState(0).randn(2, 8, 7, 5).astype(np.float32))
    g = torch.from_numpy(np.random.RandomState(1).randn(2, *out_hw, 5).astype(np.float32))
    # fp32: the two products round otherwise than interpolate's lerps, a few ulp
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        xs = [x.to(dtype).detach().clone().requires_grad_() for _ in range(2)]
        ys = [resize_as_products(xs[0], out_hw, align_corners),
              resize_bilinear(xs[1], out_hw, align_corners)]
        assert ys[0].dtype == dtype and ys[0].shape == ys[1].shape
        for y in ys:
            (y.float() * g).sum().backward()
        assert torch.allclose(ys[0].float(), ys[1].float(), atol=tol, rtol=tol)
        assert torch.allclose(xs[0].grad.float(), xs[1].grad.float(), atol=tol * 10, rtol=tol)


@pytest.mark.parametrize("in_hw,out", [((4, 4), 6), ((4, 4), 3), ((7, 5), 2), ((8, 8), 1)])
def test_pool_as_products_equals_adaptive_avg_pool(in_hw, out):
    """The deterministic training's adaptive pooling, PSP's and ASPP's bins
    on the task's small maps included: values and gradients as torch's."""
    from segland_tpu_torch.ops.pooling import adaptive_avg_pool, pool_as_products

    x = torch.from_numpy(np.random.RandomState(2).randn(2, *in_hw, 5).astype(np.float32))
    g = torch.from_numpy(np.random.RandomState(3).randn(2, out, out, 5).astype(np.float32))
    xs = [x.clone().requires_grad_() for _ in range(2)]
    ys = [pool_as_products(xs[0], out), adaptive_avg_pool(xs[1], out)]
    for y in ys:
        (y * g).sum().backward()
    assert torch.allclose(ys[0], ys[1], atol=1e-6)
    assert torch.allclose(xs[0].grad, xs[1].grad, atol=1e-6)


@pytest.mark.slow
def test_jax_scripts_gates_at_its_epochs_on_the_cpu(tmp_path, monkeypatch):
    """The JAX script's two gates at its epochs (convnext_pop 60, pspnet_pop
    80), trained by the port in bf16 on the CPU, each model's gates in a
    process of their own as chip_smoke.py runs them: every kernel arm takes
    the plain versions here, so G1 holds the fused route's formulation (bf16
    tanh-GELU) and G2 the int8 path to the stock route on trained weights."""
    got = _spy_on_records(monkeypatch)
    rc = G.main(["--device", "cpu", "--gates", "G1,G2", "--dtypes", "bfloat16", "--jobs", "2",
                 "--work-dir", str(tmp_path / "work")])
    (trained, gates), = got
    assert [t["epochs"] for t in trained] == [60, 80]
    assert [g["gate"] for g in gates] == ["G1", "G2"]
    assert rc == 0, G.faults(trained, gates, "cpu")


@pytest.mark.slow
def test_k7_route_parts_from_per_conv_int8_as_the_jax_packages(task_root, tmp_path):
    """G4 on a deeplab_pop / resnet50 trained on 32^2 crops (ROADMAP C8): the
    JAX package's CLI trains it in a process of its own on one CPU device
    (fp32, 300 epochs of 32^2 crops, ~6 min; this suite's eight virtual
    devices would train another model), its variables are carried into the
    port, and both packages score the base validation tiles in bf16 int8
    conv by conv and int8 with fused bottlenecks (the port's K7 plain
    version, the JAX package's Pallas kernel in interpret mode).  The port's
    two routes part from each other as the JAX package's two do, within how
    far the two packages' int8 maps part (their bf16 maps already differ in
    rounding on near-ties).  It prints the figures: on this model G4 misses
    its 0.99 bar in both packages."""
    import jax.numpy as jnp

    from segland_tpu.ckpt import load_params
    from segland_tpu.data import Loader as JLoader, OEMValDataset as JValDataset
    from segland_tpu.evallib import Evaluator as JEvaluator
    from segland_tpu.models import build_model as j_build
    from segland_tpu.quant import QuantConfig as JQuantConfig
    from segland_tpu_torch.models import build_model
    from segland_tpu_torch.quant import QuantConfig

    snap = str(tmp_path / "snap")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    subprocess.run(
        [sys.executable, "-m", "segland_tpu.cli.train_base", "--data-dir", str(task_root),
         "--train-list", str(task_root / "list" / "train.txt"),
         "--val-list", str(task_root / "list" / "val_base.txt"),
         "--snapshot-dir", snap, "--input-size", "32,32", "--batch-size", "4",
         "--num-epoch", "300", "--learning-rate", "1e-3", "--val-start", "0",
         "--val-frequency", "20", "--snapshot-frequency", "300",
         "--model", "deeplab_pop", "--backbone", "resnet50", "--num-workers", "0",
         "--norm-stats", "train"],
        cwd=ROOT, env=dict(env, JAX_PLATFORMS="cpu"), check=True, timeout=1800,
        stdout=subprocess.DEVNULL)
    jm = j_build("deeplab_pop", "resnet50", n_base=7, dtype=jnp.bfloat16)
    v = jax.jit(lambda k, x: jm.init(k, x, train=False))(jax.random.PRNGKey(0),
                                                          jnp.zeros((1, 64, 64, 3)))
    v = jax.tree_util.tree_map(np.asarray, load_params(
        f"{snap}/best.ckpt", jax.tree_util.tree_map(np.asarray, v)))
    port = load_port(meta_build(build_model, "deeplab_pop", "resnet50", n_base=7,
                                dtype=torch.bfloat16), v).eval()

    def jax_eval(**kw):
        ev = JEvaluator(jm, v, num_classes=8, n_base=7, fused_epilogue=False, int8=True, **kw)
        ds = JValDataset(str(task_root), str(task_root / "list" / "val_base.txt"),
                         base_size=(64, 64), stats="train")
        ev.run(JLoader(ds, 2, shuffle=False), logger=None)
        return np.concatenate([np.asarray(ev.predict_batch(
            np.asarray(img, np.float32), (64, 64), want_logits=False)[1])
            for img, _, _ in JLoader(ds, 2, shuffle=False)])

    cpu = torch.device("cpu")
    _, port_conv = G.run_eval(task_root, port, cpu, plain_kernels=True, int8=True)
    _, port_k7 = G.run_eval(task_root, port, cpu, plain_kernels=True, int8=True,
                            quant_cfg=QuantConfig(fused_blocks=True, fused_interpret=True))
    jax_conv = jax_eval()
    jax_k7 = jax_eval(quant_cfg=JQuantConfig(fused_blocks=True, fused_interpret=True))
    assert len(np.unique(port_conv)) >= G.MIN_CLASSES

    def agree(a, b):
        return float(np.mean(a == b))

    parting_port, parting_jax = agree(port_conv, port_k7), agree(jax_conv, jax_k7)
    across = min(agree(port_conv, jax_conv), agree(port_k7, jax_k7))
    print(f"G4 agreement: port {parting_port:.5f}, JAX package {parting_jax:.5f}; "
          f"port against JAX package {across:.5f}")
    assert abs(parting_port - parting_jax) <= 1 - across
