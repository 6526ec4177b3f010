"""seghr_pop / hr-w32 (the HRNet backbone, the HRFPN decoder) of the port
against the JAX package, fp32 on the CPU, the same numpy weights
(``random_variables``, tamed by ``tame_hrnet`` so that the branches stay O(1)
through HRNet's 8 modules) and the same inputs; the repo's 5e-4 bar (atol).

The JAX package runs the branch chains of 32 and 64 channels W-packed by
default (``packed=True``; at hr-w32 k = 4 and 2, at hr-w18 nothing), a TPU
lane layout the port does not carry: every forward case runs against that
default and against ``packed=False``, counting the packed chains the JAX side
took, at 64^2 and at 80x48, which 32 does not divide (branch 3 is then 3x2
and the lattice resizes to each branch's own shape, not by 2^k).  One JAX
model and variable tree serve the whole file: the JAX applies are eager, and
their op compiles are most of its time."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import load_port, meta_build, random_variables, t, tame_hrnet
import segland_tpu.models.pop as jpop
from segland_tpu.models import build_model as j_build
from segland_tpu.models import decoders as JD
from segland_tpu.models.backbones import hrnet as JH
from segland_tpu_torch.ckpt import from_jax_variables
from segland_tpu_torch.models import build_model
from segland_tpu_torch.models import decoders as D

ATOL = 5e-4
KW = dict(n_base=7, n_novel=4, is_ft=True)
# the W-packed chains of the JAX default at hr-w32: branches 0 and 1 of every module
# (stage 2: 1 module, stage 3: 4, stage 4: 3), eval and train (packed_train's default)
PACKED_CHAINS = 2 * (1 + 4 + 3)


@contextlib.contextmanager
def jax_route(packed: bool):
    """The JAX seghr_pop's backbone packed (its default) or not, while the
    context is open (flax builds it at apply time); yields a list that
    collects a W-packed chain's channel count each time one runs."""
    runs = []
    get, branch = jpop.get_backbone, JH._packed_branch

    def counted(ops, x, ch, names, k):
        runs.append(ch)
        return branch(ops, x, ch, names, k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JH, "_packed_branch", counted)
        if not packed:
            mp.setattr(jpop, "get_backbone", lambda name, **kw: get(name, packed=False, **kw))
        yield runs


@pytest.fixture(scope="module")
def hr():
    jm = j_build("seghr_pop", "hr-w32", **KW)
    v = tame_hrnet(random_variables(jm, jnp.zeros((1, 64, 64, 3)), seed=0))
    port = load_port(meta_build(build_model, "seghr_pop", "hr-w32", **KW), v)
    return jm, v, port


def _image(hw, seed=1):
    return np.random.RandomState(seed).randn(2, *hw, 3).astype(np.float32)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("hw", [(64, 64), (80, 48)], ids=["64x64", "80x48"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_branches_and_logits_match_jax(hr, packed, hw):
    """The four branches fine -> coarse and forward_all's logits (is_ft: 1 +
    7 + 4 classes at 1/4 of the input)."""
    jm, v, port = hr
    x = _image(hw)
    with jax_route(packed) as runs:
        logits, inter = jm.apply(v, jnp.asarray(x),
                                 capture_intermediates=lambda m, _: m.name == "backbone")
    assert runs == ([32, 64] * (PACKED_CHAINS // 2) if packed else [])
    want = inter["intermediates"]["backbone"]["__call__"][0]
    with torch.no_grad():
        feats = port.backbone(t(x).permute(0, 3, 1, 2))
        got = port(t(x).permute(0, 3, 1, 2))
    sides, side = [], hw
    for i in range(5):  # two stride-2 stem convs, then one a branch: ceil halvings
        side = tuple(-(-s // 2) for s in side)
        sides += [side] if i else []
    assert [tuple(f.shape) for f in feats] == [(2, c) + s for c, s in
                                               zip((32, 64, 128, 256), sides)]
    for g, w in zip(feats, want):
        assert 0.5 < float(np.abs(np.asarray(w)).max()) < 50  # tamed, and not flat
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=0, atol=ATOL)
    assert got.shape == (2, 12) + sides[0]
    np.testing.assert_allclose(_nhwc(got), np.asarray(logits), rtol=0, atol=ATOL)


def test_forward_base_matches_jax(hr):
    jm, v, port = hr
    x = _image((64, 64), seed=2)
    with jax_route(True):
        want = jm.apply(v, jnp.asarray(x), method="forward_base")
    with torch.no_grad():
        got = port.forward_base(t(x).permute(0, 3, 1, 2))
    assert got.shape == (2, 8, 16, 16)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("sides", [((16, 16), (8, 8), (4, 4), (2, 2)),
                                   ((20, 12), (10, 6), (5, 3), (3, 2))], ids=["pow2", "ragged"])
def test_hrfpn_decoder_matches_jax(sides):
    rng = np.random.RandomState(3)
    feats = [rng.randn(2, *s, c).astype(np.float32) for s, c in zip(sides, (32, 64, 128, 256))]
    want = JD.HRFPNDecoder().apply({}, [jnp.asarray(f) for f in feats])
    dec = D.HRFPNDecoder((32, 64, 128, 256), out_features=480)
    assert not list(dec.parameters()) and not dec.state_dict()
    got = dec([t(f).permute(0, 3, 1, 2) for f in feats])
    assert got.shape == (2, 480) + sides[0]
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0, atol=1e-5)


def test_train_mode_forward_and_batch_stats_match_jax(hr):
    """apply(train=True) at the JAX default (packed_train=True: the packed
    chains' BatchNorm reduces over the packed layout) against the port in
    train mode: the logits, and every BatchNorm's moved running statistics
    within 5e-4 of their tensor's largest |value|."""
    jm, v, _ = hr
    port = load_port(meta_build(build_model, "seghr_pop", "hr-w32", **KW), v).train()
    x = _image((64, 64), seed=4)
    with jax_route(True) as runs:
        want, new = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    assert len(runs) == PACKED_CHAINS
    got = port(t(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(_nhwc(got.detach()), np.asarray(want), rtol=0, atol=ATOL)
    stats = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": v["params"], "batch_stats": new["batch_stats"]}))
    sd = port.state_dict()
    keys = [k for k in stats if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in port.modules())
    old = from_jax_variables(v)
    assert all(not np.array_equal(stats[k], old[k]) for k in keys)  # every statistic moved
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), stats[k], rtol=0,
                                   atol=ATOL * max(1.0, float(np.abs(stats[k]).max())), err_msg=k)


@pytest.mark.parametrize("name", ["hr-w18", "hr-w32", "hr-w48"])
def test_every_width_builds_with_upstream_keys(name):
    """d_model = sum(filters) (480 at hr-w32); upstream's keys, None in the
    transitions' untouched slots; branch shapes fine -> coarse; bf16 compute
    with fp32 parameters."""
    from segland_tpu_torch.models.backbones import backbone_filters

    f = backbone_filters(name)
    m = build_model("seghr_pop", name, n_base=7, dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(0))
    assert m.d_model == sum(f) and m.base_emb.shape == (7, sum(f))
    keys = set(m.state_dict())
    assert {"backbone.conv1.weight", "backbone.bn2.running_var",
            "backbone.layer1.0.downsample.0.weight", "backbone.layer1.3.bn3.bias",
            "backbone.transition1.0.0.weight", "backbone.transition1.1.0.1.running_mean",
            "backbone.transition2.2.0.0.weight", "backbone.transition3.3.0.1.weight",
            "backbone.stage2.0.branches.1.3.conv2.weight",
            "backbone.stage3.3.branches.2.0.bn1.running_var",
            "backbone.stage4.2.fuse_layers.0.3.0.weight",
            "backbone.stage4.2.fuse_layers.3.0.2.1.weight",
            "backbone.stage3.1.fuse_layers.2.1.0.0.weight"} <= keys
    assert not any(k.startswith(("backbone.transition2.0", "backbone.transition2.1",
                                 "backbone.transition3.2", "decoder.")) for k in keys)
    assert not any("fuse_layers.1.1" in k or "branches.0.0.downsample" in k for k in keys)
    assert m.state_dict()["backbone.stage4.0.fuse_layers.3.0.0.0.weight"].shape == (
        f[0], f[0], 3, 3)
    assert m.state_dict()["backbone.stage4.0.fuse_layers.3.0.2.0.weight"].shape == (
        f[3], f[0], 3, 3)
    assert all(p.dtype == torch.float32 for p in m.parameters())
    with torch.no_grad():
        feats = m.backbone(torch.randn(1, 3, 32, 32))
        logits = m(torch.randn(1, 3, 32, 32))
    assert [tuple(x.shape) for x in feats] == [(1, c, 8 >> i, 8 >> i) for i, c in enumerate(f)]
    assert all(x.dtype == torch.bfloat16 and x.is_contiguous(memory_format=torch.channels_last)
               for x in feats)
    assert logits.shape == (1, 8, 8, 8) and logits.dtype == torch.float32


@pytest.mark.parametrize("packed_train", [None, False, True])
def test_packed_train(packed_train):
    """None and False build hrnet's plain form; True asks for the W-packed
    layout, which the port does not carry, and raises; any value on another
    backbone raises, as before."""
    if packed_train:
        with pytest.raises(ValueError, match="W-packed"):
            build_model("seghr_pop", "hr-w18", packed_train=True)
    else:
        m = build_model("seghr_pop", "hr-w18", packed_train=packed_train)
        assert m.backbone.filters == (18, 36, 72, 144)
    if packed_train is not None:
        with pytest.raises(ValueError, match="takes no packed_train"):
            build_model("pspnet_pop", "resnet10", packed_train=packed_train)
