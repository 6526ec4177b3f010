"""The port imports torch and never jax, flax, PIL or anything of
segland_tpu, at import time or inside a function, and needs no nvcc to
import: the kernels build at the first CUDA call.  The entry points run in
processes of their own, the eval ones over every model of the last slice
(pspplus_pop, the plain pspnet, lsk_pop, vggunet_pop), train_base over the
plain pspnet's CE step and lsk_pop and as two ranks of a process group,
ft_pop over lsk_pop."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "segland_tpu_torch"
MODULES = ["segland_tpu_torch", "segland_tpu_torch.ops.fused_mlp",
           "segland_tpu_torch.ops.fused_epilogue", "segland_tpu_torch.ops.fused_attn",
           "segland_tpu_torch.ops.pooling", "segland_tpu_torch.models",
           "segland_tpu_torch.models.backbones.swin", "segland_tpu_torch.models.decoders",
           "segland_tpu_torch.evallib", "segland_tpu_torch.metrics",
           "segland_tpu_torch.ckpt", "segland_tpu_torch.cli.eval_base",
           "segland_tpu_torch.cli.eval_ft", "segland_tpu_torch.cli.common",
           "segland_tpu_torch.data", "segland_tpu_torch.data.tileio",
           "segland_tpu_torch.data.geotiff", "segland_tpu_torch.data.augment",
           "segland_tpu_torch.data.oem", "segland_tpu_torch.data.loader",
           "segland_tpu_torch.native", "segland_tpu_torch.utils",
           "segland_tpu_torch.kernels", "segland_tpu_torch.ops.fused_bottleneck",
           "segland_tpu_torch.ops.int8", "segland_tpu_torch.ops.layers",
           "segland_tpu_torch.models.backbones.resnet", "segland_tpu_torch.quant",
           "segland_tpu_torch.quant.ptq", "segland_tpu_torch.benchmarks.conv3_probe",
           "segland_tpu_torch.ops.hg_attn", "segland_tpu_torch.benchmarks.swin_attn_hg",
           "segland_tpu_torch.ops.section_variants",
           "segland_tpu_torch.benchmarks.swin_attn_variants", "segland_tpu_torch.losses",
           "segland_tpu_torch.train", "segland_tpu_torch.train.state",
           "segland_tpu_torch.train.base", "segland_tpu_torch.ckpt.io",
           "segland_tpu_torch.cli.train_base", "segland_tpu_torch.train.ft",
           "segland_tpu_torch.data.oem_ft", "segland_tpu_torch.cli.ft_pop",
           "segland_tpu_torch.cli.gen_fs_list", "segland_tpu_torch.models.backbones.droppath",
           "segland_tpu_torch.models.init", "segland_tpu_torch.models.backbones.hrnet",
           "segland_tpu_torch.evallib.ensemble", "segland_tpu_torch.evallib.tiled",
           "segland_tpu_torch.evallib.fuse", "segland_tpu_torch.cli.ensemble_eval",
           "segland_tpu_torch.cli.predict", "segland_tpu_torch.cli.fuse",
           "segland_tpu_torch.cli.trans", "segland_tpu_torch.cli.translabel",
           "segland_tpu_torch.cli.gen_new_samples", "segland_tpu_torch.cli.get_list",
           "segland_tpu_torch.models.backbones.lsknet",
           "segland_tpu_torch.models.backbones.vggunet", "segland_tpu_torch.models.pspnet_plain",
           "segland_tpu_torch.dist", "segland_tpu_torch.dist.process",
           "segland_tpu_torch.ops.device_aug", "segland_tpu_torch.benchmarks.synthtask",
           "segland_tpu_torch.benchmarks.accuracy_gates"]
FOREIGN = ("jax", "flax", "PIL", "segland_tpu")
# The entry points' processes run torch on one thread (OMP_NUM_THREADS): by default each
# takes every core of a machine that tier-1's workers share.

PROBE = """
import sys
for m in {mods!r}:
    __import__(m)
from segland_tpu_torch import kernels
assert kernels.library.cache_info().currsize == 0, "a kernel was built at import"
print(sorted(m for m in sys.modules if m.split('.')[0] in {foreign!r}))
"""

# eval_base.main and eval_ft.main over natively decoded tiles, then the same check
RUN_CLI = """
import sys
from segland_tpu_torch.cli import eval_base, eval_ft
from segland_tpu_torch import native
assert native.get_lib() is not None, "no native decoder: the readers would need PIL"
common = ["--data-dir", {root!r}, "--model", "swin_pop", "--backbone", "swin-t",
          "--device", "cpu", "--base-size", "32,32", "--eval-batch", "2", "--num-workers", "0"]
res = eval_base.main(common + ["--val-list", {root!r} + "/val.txt", "--save-path", {out!r} + "/a"])
assert 0.0 <= res[123][2] <= 1.0
eval_ft.main(common + ["--val-list", {root!r} + "/test.txt", "--save-path", {out!r} + "/b",
                       "--device-normalize"])
int8 = ["--data-dir", {root!r}, "--model", "deeplab_pop", "--backbone", "resnet10", "--device",
        "cpu", "--base-size", "32,32", "--eval-batch", "2", "--num-workers", "0", "--int8",
        "--calib-batches", "1", "--val-list", {root!r} + "/val.txt"]
res = eval_base.main(int8 + ["--save-path", {out!r} + "/c"])
assert 0.0 <= res[123][2] <= 1.0
res = eval_base.main(int8 + ["--fused", "--dtype", "bfloat16", "--save-path", {out!r} + "/d"])
assert 0.0 <= res[123][2] <= 1.0
for i, (model, backbone) in enumerate((("pspplus_pop", "resnet10"), ("pspnet", "resnet10"),
                                       ("lsk_pop", "lsk-t"), ("vggunet_pop", "vgg16bn-unet"))):
    res = eval_base.main(common + ["--model", model, "--backbone", backbone, "--val-list",
                                   {root!r} + "/val.txt", "--save-path", {out!r} + "/m%d" % i])
    assert 0.0 <= res[123][2] <= 1.0
print(sorted(m for m in sys.modules if m.split('.')[0] in {foreign!r}))
"""


def test_main_path_imports_no_jax_flax_or_pil():
    env = dict(os.environ, PATH=os.path.dirname(sys.executable), CUDA_HOME="/nonexistent",
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", PROBE.format(mods=MODULES, foreign=FOREIGN)],
                         cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_eval_entry_points_run_without_jax_flax_pil_or_the_jax_package(tmp_path):
    """Tiles written here with PIL; the entry points, in a process of their
    own, decode them natively and export GTiffs, and none of the foreign
    modules is loaded when they are done."""
    import numpy as np
    from PIL import Image

    from segland_tpu_torch import native

    if native.get_lib() is None:
        pytest.skip("no C++ compiler or zlib here: tiles would be read through PIL")
    root = tmp_path / "data"
    for d in ("images", "labels"):
        (root / d).mkdir(parents=True)
    rng = np.random.RandomState(0)
    for tid in ("a", "b", "c", "u"):
        Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(root / "images" / f"{tid}.tif")
        if tid != "u":
            Image.fromarray(rng.randint(0, 12, (32, 32)).astype(np.uint8)).save(
                root / "labels" / f"{tid}.tif")
    (root / "val.txt").write_text("a\nb\nc\n")
    (root / "test.txt").write_text("u\n")
    code = RUN_CLI.format(root=str(root), out=str(tmp_path / "out"), foreign=FOREIGN)
    env = dict(os.environ, CUDA_HOME="/nonexistent", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert (tmp_path / "out" / "b" / "u.tif").exists()


# train_base.main over tiles the port writes itself (no PIL), then the same check
RUN_TRAIN = """
import sys
import numpy as np
from segland_tpu_torch.cli import train_base
from segland_tpu_torch.data.geotiff import write_tiff
rng = np.random.RandomState(0)
for d in ("images", "labels"):
    __import__("os").makedirs({root!r} + "/" + d, exist_ok=True)
for tid in ("a", "b", "c"):
    img = rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)
    write_tiff({root!r} + "/images/" + tid + ".tif", img)
    write_tiff({root!r} + "/labels/" + tid + ".tif", (img[..., 0] // 32).astype(np.uint8))
open({root!r} + "/train.txt", "w").write("a\\nb\\n")
open({root!r} + "/val.txt", "w").write("c\\n")
best = train_base.main(["--data-dir", {root!r}, "--train-list", {root!r} + "/train.txt",
                        "--val-list", {root!r} + "/val.txt", "--model", "convnext_pop",
                        "--device", "cpu", "--fused", "--input-size", "32,32",
                        "--base-size", "32,32", "--batch-size", "2", "--num-epoch", "1",
                        "--val-start", "0", "--num-workers", "0", "--snapshot-dir", {out!r}])
assert 0.0 <= best <= 1.0
for model, backbone in (("pspnet", "resnet10"), ("lsk_pop", "lsk-t")):
    best = train_base.main(["--data-dir", {root!r}, "--train-list", {root!r} + "/train.txt",
                            "--val-list", {root!r} + "/val.txt", "--model", model,
                            "--backbone", backbone, "--device", "cpu", "--input-size", "32,32",
                            "--base-size", "32,32", "--batch-size", "2", "--num-epoch", "1",
                            "--val-start", "0", "--num-workers", "0",
                            "--snapshot-dir", {out!r} + "_" + model])
    assert 0.0 <= best <= 1.0
print(sorted(m for m in sys.modules if m.split('.')[0] in {foreign!r}))
"""


def test_train_entry_point_runs_without_jax_flax_pil_or_the_jax_package(tmp_path):
    from segland_tpu_torch import native

    if native.get_lib() is None:
        pytest.skip("no C++ compiler or zlib here: tiles would be read through PIL")
    code = RUN_TRAIN.format(root=str(tmp_path / "data"), out=str(tmp_path / "snap"),
                            foreign=FOREIGN)
    env = dict(os.environ, CUDA_HOME="/nonexistent", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert (tmp_path / "snap" / "best.pth").exists()


# train_base.main as one rank of two (gloo), --device-augment, then eval_base --int8
# --calib-percentile (dist.all_gather), on RUN_TRAIN's tiles
RUN_TRAIN_RANK = """
import sys
from segland_tpu_torch import dist
from segland_tpu_torch.cli import eval_base, train_base
best = train_base.main(["--data-dir", {root!r}, "--train-list", {root!r} + "/train.txt",
                        "--val-list", {root!r} + "/val.txt", "--model", "convnext_pop",
                        "--device", "cpu", "--fused", "--input-size", "32,32",
                        "--base-size", "32,32", "--batch-size", "2", "--num-epoch", "1",
                        "--val-start", "0", "--num-workers", "0", "--device-augment",
                        "--snapshot-dir", {out!r}])
assert dist.world() == 2 and 0.0 <= best <= 1.0
res = eval_base.main(["--data-dir", {root!r}, "--val-list", {root!r} + "/train.txt",
                      "--model", "deeplab_pop", "--backbone", "resnet10", "--device", "cpu",
                      "--base-size", "32,32", "--eval-batch", "2", "--num-workers", "0",
                      "--int8", "--calib-percentile", "99.9", "--save-path", {out!r} + "_int8"])
assert 0.0 <= res[123][2] <= 1.0
print(sorted(m for m in sys.modules if m.split('.')[0] in {foreign!r}))
"""


def test_train_entry_point_runs_over_two_processes_without_the_foreign_modules(tmp_path):
    """train_base under WORLD_SIZE=2 (gloo, --device-augment), then eval_base
    --int8 --calib-percentile over the same ranks (the calibration's
    all_gather): both ranks end, rank 0 writes the snapshots and the
    confusion matrix, and neither loads a foreign module."""
    import socket

    from segland_tpu_torch import native

    if native.get_lib() is None:
        pytest.skip("no C++ compiler or zlib here: tiles would be read through PIL")
    root, snap = tmp_path / "data", tmp_path / "snap"
    code = RUN_TRAIN.split("best = train_base.main")[0]  # the tiles, written once
    assert subprocess.run([sys.executable, "-c", code.format(root=str(root))], cwd=ROOT,
                          timeout=120).returncode == 0
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", RUN_TRAIN_RANK.format(root=str(root), out=str(snap),
                                                     foreign=FOREIGN)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, CUDA_HOME="/nonexistent", OMP_NUM_THREADS="1", WORLD_SIZE="2",
                 RANK=str(r), LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port), GLOO_SOCKET_IFNAME="lo")) for r in range(2)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0, stderr
        assert stdout.strip().splitlines()[-1] == "[]"
    assert (snap / "best.pth").exists() and (snap / "epoch_1.pth").exists()
    assert (tmp_path / "snap_int8" / "cmatrix_123.npy").exists()


# gen_fs_list.main and ft_pop.main over tiles the port writes itself, from a base
# model's .pth, then the same check
RUN_FT = """
import os, sys
import numpy as np
import torch
from segland_tpu_torch.ckpt import save_params
from segland_tpu_torch.cli import ft_pop, gen_fs_list
from segland_tpu_torch.data.geotiff import write_tiff
from segland_tpu_torch.models import build_model
rng = np.random.RandomState(0)
for d in ("images", "labels"):
    os.makedirs({root!r} + "/" + d, exist_ok=True)
ids = ["t%d" % i for i in range(6)]
for i, tid in enumerate(ids):
    lab = rng.randint(0, 12, (2, 2)).repeat(16, 0).repeat(16, 1).astype(np.uint8)
    lab[0, 0] = 8 + i % 4
    write_tiff({root!r} + "/images/" + tid + ".tif", rng.randint(0, 256, (32, 32, 3)).astype(np.uint8))
    write_tiff({root!r} + "/labels/" + tid + ".tif", lab)
open({root!r} + "/train.txt", "w").write("\\n".join(ids[:5]) + "\\n")
open({root!r} + "/val.txt", "w").write(ids[5] + "\\n")
gen_fs_list.main(["--data-dir", {root!r}, "--train-list", {root!r} + "/train.txt", "--shot", "1"])
save_params({root!r} + "/base.pth", build_model("convnext_pop", n_base=7))
res = ft_pop.main(["--data-dir", {root!r}, "--train-list", {root!r} + "/train.txt",
                   "--val-list", {root!r} + "/val.txt", "--model", "convnext_pop", "--fused",
                   "--device", "cpu", "--restore-from", {root!r} + "/base.pth",
                   "--input-size", "32,32", "--base-size", "32,32", "--batch-size", "1",
                   "--num-epoch", "1", "--shot", "1", "--update-base", "--fix-lr",
                   "--num-workers", "0", "--snapshot-dir", {out!r}])
assert set(res) == {{123}}
save_params({root!r} + "/lsk.pth", build_model("lsk_pop", n_base=7))
res = ft_pop.main(["--data-dir", {root!r}, "--train-list", {root!r} + "/train.txt",
                   "--val-list", {root!r} + "/val.txt", "--model", "lsk_pop",
                   "--device", "cpu", "--restore-from", {root!r} + "/lsk.pth",
                   "--input-size", "32,32", "--base-size", "32,32", "--batch-size", "1",
                   "--num-epoch", "1", "--shot", "1", "--fix-lr", "--num-workers", "0",
                   "--snapshot-dir", {out!r} + "_lsk"])
assert set(res) == {{123}}
print(sorted(m for m in sys.modules if m.split('.')[0] in {foreign!r}))
"""


def test_ft_entry_points_run_without_jax_flax_pil_or_the_jax_package(tmp_path):
    from segland_tpu_torch import native

    if native.get_lib() is None:
        pytest.skip("no C++ compiler or zlib here: tiles would be read through PIL")
    code = RUN_FT.format(root=str(tmp_path / "data"), out=str(tmp_path / "snap"),
                         foreign=FOREIGN)
    env = dict(os.environ, CUDA_HOME="/nonexistent", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# ensemble_eval.main over two resnet10 members at 32^2, then the check; then fuse.main and
# trans.main, whose PNG writers import PIL at the call, and the check without PIL
RUN_TOOLS = """
import os, sys
import numpy as np
from segland_tpu_torch.ckpt import save_params
from segland_tpu_torch.cli import ensemble_eval, fuse, trans
from segland_tpu_torch.data.geotiff import write_tiff
from segland_tpu_torch.data.tileio import OEM_COLORMAP, write_pred_tiff, write_prob_mat
from segland_tpu_torch.models import build_model
root = {root!r}
rng = np.random.RandomState(0)
for d in ("images", "labels", "m0", "m1", "preds"):
    os.makedirs(root + "/" + d, exist_ok=True)
for tid in ("a", "b"):
    write_tiff(root + "/images/" + tid + ".tif", rng.randint(0, 256, (32, 32, 3)).astype(np.uint8))
    write_tiff(root + "/labels/" + tid + ".tif", rng.randint(0, 12, (32, 32)).astype(np.uint8))
    write_pred_tiff(root + "/preds/" + tid + ".tif", rng.randint(0, 8, (32, 32)), OEM_COLORMAP)
    for m in ("m0", "m1"):
        write_prob_mat(root + "/" + m + "/" + tid + ".mat",
                       rng.randn(1, 8, 32, 32).astype(np.float32))
open(root + "/val.txt", "w").write("a\\nb\\n")
save_params(root + "/r.pth", build_model("pspnet_pop", "resnet10"))
specs = ["pspnet_pop:resnet10:" + root + "/r.pth"] * 2
res = ensemble_eval.main(["--data-dir", root, "--val-list", root + "/val.txt", "--members",
                          ",".join(specs), "--base-size", "32,32", "--eval-batch", "2",
                          "--num-workers", "0", "--device", "cpu", "--save-path", root + "/ens"])
assert 0.0 <= res["total"] <= 1.0
print(sorted(m for m in sys.modules if m.split('.')[0] in {foreign!r}))
assert fuse.main(["--inputs", root + "/m0", root + "/m1", "--output", root + "/fused",
                  "--device", "cpu"]) == ["a.mat", "b.mat"]
assert trans.main(["--input", root + "/preds", "--output", root + "/png"]) == ["a.png", "b.png"]
print(sorted(m for m in sys.modules if m.split('.')[0] in {foreign!r} and m.split('.')[0] != "PIL"))
"""


def test_tool_entry_points_run_without_jax_flax_or_the_jax_package(tmp_path):
    """ensemble_eval loads none of the foreign modules; fuse and trans none
    but PIL, which their PNG writers import at the call."""
    from segland_tpu_torch import native

    if native.get_lib() is None:
        pytest.skip("no C++ compiler or zlib here: tiles would be read through PIL")
    code = RUN_TOOLS.format(root=str(tmp_path / "data"), foreign=FOREIGN)
    env = dict(os.environ, CUDA_HOME="/nonexistent", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert [ln for ln in out.stdout.splitlines() if ln.startswith("[")] == ["[]", "[]"]
    assert (tmp_path / "data" / "ens" / "cmatrix_ensemble.npy").exists()
    assert (tmp_path / "data" / "fused" / "b.png").exists()


SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_flax_import_statement(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from) (jax|flax)\b", text, re.M)
    assert not re.search(r"^\s*(import|from) segland_tpu(\.|\s|$)", text, re.M)
