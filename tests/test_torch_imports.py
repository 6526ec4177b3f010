"""The port imports torch and never jax, flax, PIL or anything of
segland_tpu, at import time or inside a function, and needs no nvcc to
import: the kernels build at the first CUDA call."""

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
           "segland_tpu_torch.benchmarks.swin_attn_variants"]
FOREIGN = ("jax", "flax", "PIL", "segland_tpu")

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
print(sorted(m for m in sys.modules if m.split('.')[0] in {foreign!r}))
"""


def test_main_path_imports_no_jax_flax_or_pil():
    env = dict(os.environ, PATH=os.path.dirname(sys.executable), CUDA_HOME="/nonexistent")
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
    env = dict(os.environ, CUDA_HOME="/nonexistent")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert (tmp_path / "out" / "b" / "u.tif").exists()


SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_flax_import_statement(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from) (jax|flax)\b", text, re.M)
    assert not re.search(r"^\s*(import|from) segland_tpu(\.|\s|$)", text, re.M)
