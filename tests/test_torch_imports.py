"""The port imports torch and never jax, flax or PIL, and needs no nvcc to
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
           "segland_tpu_torch.ops.fused_epilogue", "segland_tpu_torch.models",
           "segland_tpu_torch.evallib", "segland_tpu_torch.metrics",
           "segland_tpu_torch.ckpt", "segland_tpu_torch.cli.eval_base",
           "segland_tpu_torch.kernels"]

PROBE = """
import sys
for m in {mods!r}:
    __import__(m)
from segland_tpu_torch import kernels
assert kernels.library.cache_info().currsize == 0, "a kernel was built at import"
print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'PIL')))
"""


def test_main_path_imports_no_jax_flax_or_pil():
    env = dict(os.environ, PATH=os.path.dirname(sys.executable), CUDA_HOME="/nonexistent")
    out = subprocess.run([sys.executable, "-c", PROBE.format(mods=MODULES)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_flax_import_statement(path):
    assert not re.search(r"^\s*(import|from) (jax|flax)\b", path.read_text(), re.M)
