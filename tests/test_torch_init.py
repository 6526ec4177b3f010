"""The port's fresh init against the JAX package's (ROADMAP C6), on the CPU:
every parameter and BatchNorm statistic of ``pspnet_pop`` / ``resnet10``,
``convnext_pop`` and ``swin_pop`` (narrow ``convnext-t`` and ``swin-t``,
``tests/ft_helpers.py``), ``seghr_pop`` / ``hr-w32`` (full depth; the JAX
HRNet has no explicit initializer, its W-packed chains draw as nn.Conv does),
``pspplus_pop`` and the plain ``pspnet`` / ``resnet10`` (its classifiers and
aux head torch's Conv2d default) and ``lsk_pop`` / ``lsk-t`` (layer-scales at
1e-2) and ``vggunet_pop`` at full width, drawn by ``build_model`` from a seeded generator
and by the JAX module's ``init``, matched by upstream key.  A tensor that is
constant on the JAX side (norm scales and shifts, biases, layer-scales,
running statistics) must equal it; any other must have its standard
deviation within 6 / sqrt(2 n) of the JAX one, relative, for n elements (the
sample spread of a std is about 1 / sqrt(2 n) of it: 3 of it on each side),
and its mean within 6 std / sqrt(n) of 0.  Upstream's schemes, which the
port drew before, fail it in every model: the first tensor checked stands at
0.31 (resnet10's stem conv), 0.14 (the convnext stem) and 0.08 (a swin
projection, trunc-normal 0.02 at C = 16) of the JAX std."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft_helpers import narrow_backbones
from segland_tpu.models import build_model as j_build
from segland_tpu_torch.ckpt import from_jax_variables
from segland_tpu_torch.models import build_model
from torch_helpers import one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MODELS = [("pspnet_pop", "resnet10"), ("convnext_pop", "convnext-t"), ("swin_pop", "swin-t"),
          ("seghr_pop", "hr-w32"), ("pspplus_pop", "resnet10"), ("pspnet", "resnet10"),
          ("lsk_pop", "lsk-t"), ("vggunet_pop", "vgg16bn-unet")]


def _std_by_fan_in(name, a):
    """std * sqrt(fan_in) of a weight (the lecun-normal scale is 1), for the
    failure message."""
    fan_in = a[0].size if a.ndim > 1 else a.size
    return float(a.std() * np.sqrt(fan_in))


@pytest.mark.parametrize("name,backbone", MODELS, ids=[m for m, _ in MODELS])
def test_fresh_init_scales_match_jax(name, backbone, monkeypatch):
    narrow_backbones(monkeypatch)
    jm = j_build(name, backbone=backbone, n_base=7)
    # seghr_pop at tests/test_torch_hrnet.py's input: a process that ran that file has
    # compiled the forward's ops for it
    x = jnp.zeros((2, 64, 64, 3) if name == "seghr_pop" else (1, 32, 32, 3))
    # HRNet repeats a few dozen op shapes over its 8 modules: eager init compiles each once
    # (~20 s), where jit compiles the whole graph (~40 s)
    init = jm.init if name == "seghr_pop" else jax.jit(jm.init, static_argnames="train")
    # the plain pspnet's aux head is created by a train-mode init
    want = {k: v for k, v in from_jax_variables(jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(0), x, train=name == "pspnet"))).items()
        if not k.endswith("num_batches_tracked")}
    got = {k: v.numpy() for k, v in build_model(
        name, backbone, n_base=7, generator=torch.Generator().manual_seed(0)).state_dict().items()
        if not k.endswith("num_batches_tracked")}
    assert set(got) == set(want)
    random = 0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if np.all(w == w.flat[0]):
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        random += 1
        n = w.size
        ratio = g.std() / w.std()
        assert abs(ratio - 1) <= 6 / np.sqrt(2 * n), (
            f"{k}: std {g.std():.4g} against {w.std():.4g} (x sqrt(fan_in): "
            f"{_std_by_fan_in(k, g):.3f} against {_std_by_fan_in(k, w):.3f}), n={n}")
        assert abs(g.mean()) <= 6 * w.std() / np.sqrt(n), k
    assert random >= 10
