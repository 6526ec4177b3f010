"""The last four models of the registry in the port against the JAX package,
fp32 on the CPU, the same numpy weights (``random_variables``) and inputs:
``pspplus_pop`` (ResNet, PSP+ over [x4, x2]), the plain ``pspnet`` (a linear
classifier, an aux head in train mode), ``lsk_pop`` / ``lsk-t`` (LSKNet-T,
SimpleDecoder) and ``vggunet_pop`` / ``vgg16bn-unet`` (the VGG U-Net, no
decoder).  Logits base and ``is_ft`` at the repo's 5e-4 bar (atol); pspplus_pop
at its own resnet50v2 under ``-m slow``.

The JAX package runs LSKNet's C < 128 stages and the VGG U-Net's enc1 chain
W-packed at eval by default (``packed=True``), a TPU lane layout the port
does not carry: those two models run against that default, counting the
packs the JAX side took, and against ``packed=False``.  Then every registry
key builds, ``packed_train`` as for HRNet, K2's plan and plain version at the
VGG U-Net's factor-1 serving shapes, and the checkpoint converter both ways."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_epilogue import _kernel_replay, _np_ref, _tiled_replay
from torch_helpers import load_port, meta_build, one_torch_thread, random_variables, t
import segland_tpu.models.pop as jpop
from segland_tpu.ckpt.torch_convert import convert_torch_state_dict, merge_variables
from segland_tpu.models import MODEL_NAMES as J_MODEL_NAMES
from segland_tpu.models import build_model as j_build
from segland_tpu.ops import packed as jpacked
from segland_tpu_torch.ckpt import from_jax_variables
from segland_tpu_torch.models import MODEL_NAMES, build_model
from segland_tpu_torch.ops import fused_epilogue as FE

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL = 5e-4
# model -> (narrow backbone for the parity cases, the JAX converter's arch)
MODELS = {"pspplus_pop": ("resnet10", "pspplus"), "pspnet": ("resnet10", None),
          "lsk_pop": ("lsk-t", "lsknet"), "vggunet_pop": ("vgg16bn-unet", "vggunet")}
PACKS = ("lsk_pop", "vggunet_pop")


def _kw(is_ft):
    return dict(n_base=7, n_novel=4 if is_ft else 0, is_ft=is_ft)


@functools.lru_cache(maxsize=None)
def pair(name, backbone, is_ft):
    """(JAX model, its variables, the port model loaded with them).  The plain
    pspnet's JAX init runs in train mode, which creates its aux head."""
    jm = j_build(name, backbone, **_kw(is_ft))
    train = {"train": True} if name == "pspnet" and not is_ft else {}
    v = random_variables(jm, jnp.zeros((1, 64, 64, 3)), seed=1, **train)
    return jm, v, load_port(meta_build(build_model, name, backbone, **_kw(is_ft)), v)


def jax_apply(jm, v, x, packed=True):
    """The JAX model's eval logits, its LSKNet or VGG U-Net packed (its
    default) or not; returns (logits, W-packs the JAX side took)."""
    packs = []
    get, pack = jpop.get_backbone, jpacked.pack
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpacked, "pack", lambda x, k: packs.append(k) or pack(x, k))
        if not packed:
            mp.setattr(jpop, "get_backbone", lambda name, **kw: get(name, packed=False, **kw))
        return np.asarray(jm.apply(v, jnp.asarray(x))), packs


def _image(hw, seed=0):
    return np.random.RandomState(seed).randn(2, *hw, 3).astype(np.float32)


CASES = [(m, ft, p) for m in MODELS for ft in (False, True)
         for p in ((True, False) if m in PACKS else (True,))]


@pytest.mark.parametrize("name,is_ft,packed", CASES,
                         ids=[f"{m}-{'ft' if ft else 'base'}{'' if p else '-unpacked'}"
                              for m, ft, p in CASES])
def test_logits_match_jax(name, is_ft, packed):
    jm, v, port = pair(name, MODELS[name][0], is_ft)
    x = _image((64, 64))
    want, packs = jax_apply(jm, v, x, packed)
    if name in PACKS:  # the JAX default packs; packed=False runs the plain chains
        assert bool(packs) is packed
    with torch.no_grad():
        got = port(t(x).permute(0, 3, 1, 2))
    stride = 1 if name == "vggunet_pop" else 4 if name == "lsk_pop" else 8
    assert got.shape == (2, 12 if is_ft else 8, 64 // stride, 64 // stride)
    assert got.dtype == torch.float32 and 0.05 < float(np.abs(want).max()) < 50
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.slow
def test_pspplus_resnet50v2_matches_jax():
    """pspplus_pop's own backbone, the deep-stem resnet50v2, fine-tuned form;
    under -m slow: tests/test_torch_resnet.py holds the deep stem in tier-1
    and tests/test_torch_heads_quant.py builds pspplus_pop / resnet50v2."""
    jm, v, port = pair("pspplus_pop", "resnet50v2", True)
    x = _image((32, 32), seed=3)
    want, _ = jax_apply(jm, v, x)
    with torch.no_grad():
        got = port(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 4, 4, 12)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_plain_pspnet_train_mode_returns_the_aux_logits():
    """In train mode the plain pspnet returns (logits, aux logits), both at
    stride 8 and in fp32, each as the JAX model's (BatchNorm on the batch's
    statistics on both sides)."""
    jm, v, _ = pair("pspnet", "resnet10", False)
    port = load_port(meta_build(build_model, "pspnet", "resnet10", **_kw(False)), v).train()
    x = _image((64, 64), seed=4)
    (want, want_aux), _ = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got, aux = port(t(x).permute(0, 3, 1, 2), train=True)
    for g, w in ((got, want), (aux, want_aux)):
        assert g.shape == (2, 8, 8, 8) and g.dtype == torch.float32
        np.testing.assert_allclose(g.detach().permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   rtol=0, atol=ATOL)


def test_every_registry_key_builds():
    """Every key of the JAX registry builds: the four of this file on the CPU
    at their default backbones, with upstream's keys; the others on the meta
    device (the shapes, not the draws: other files build them on the CPU)."""
    assert set(MODEL_NAMES) == set(J_MODEL_NAMES)
    for name in set(MODEL_NAMES) - set(MODELS):
        with torch.device("meta"):
            assert build_model(name, device="meta").d_model > 0
    keys = {name: set(build_model(name, generator=torch.Generator().manual_seed(0))
                      .state_dict()) for name in MODELS}
    assert {"backbone.patch_embed1.proj.weight", "backbone.patch_embed4.norm.running_var",
            "backbone.block1.0.layer_scale_1", "backbone.block3.4.attn.proj_2.bias",
            "backbone.block2.2.attn.spatial_gating_unit.conv_squeeze.weight",
            "backbone.block4.1.mlp.dwconv.dwconv.weight", "backbone.norm4.weight",
            "decoder.semantic_embedding.1.weight", "decoder.lateral_convs.3.0.weight",
            "decoder.fpn_convs.3.4.1.running_mean"} <= keys["lsk_pop"]
    assert {"net.inc.0.weight", "net.inc.4.running_var", "net.down1.7.bias",
            "net.down4.41.weight", "net.up1.conv.double_conv.0.weight",
            "net.up4.conv.double_conv.4.running_mean", "base_emb"} <= keys["vggunet_pop"]
    assert not any(k.startswith(("backbone.", "decoder.")) for k in keys["vggunet_pop"])
    assert {"decoder.psp.bottleneck.3.bias", "decoder.reduce.0.weight", "decoder.reduce.1.bias",
            "decoder.fc.0.bias", "decoder.fc.3.weight"} <= keys["pspplus_pop"]
    assert {"classifier.weight", "aux.0.weight", "aux.1.running_var",
            "aux.3.bias"} <= keys["pspnet"]


@pytest.mark.parametrize("backbone", ["lsk-t", "vgg16bn-unet"])
@pytest.mark.parametrize("packed_train", [None, False, True])
def test_packed_train(backbone, packed_train):
    """None and False build the plain form; True asks for the JAX package's
    W-packed layout, which the port does not carry, and raises."""
    name = "lsk_pop" if backbone == "lsk-t" else "vggunet_pop"
    if packed_train:
        with pytest.raises(ValueError, match="W-packed"):
            build_model(name, backbone, packed_train=True)
    else:
        assert build_model(name, backbone, packed_train=packed_train).d_model == (
            192 if backbone == "lsk-t" else 64)


# ---- K2 at the VGG U-Net's full-resolution logits --------------------------
# eval (K = 8), eval_ft (K = 12) and the ft step's pseudo-labels (K = 1 + 4) at
# factor 1 on 1024^2 tiles and 768^2 crops
VGG_K2 = [((1024, 1024, 8), (1024, 1024)), ((1024, 1024, 12), (1024, 1024)),
          ((1024, 1024, 5), (1024, 1024)), ((768, 768, 8), (768, 768))]


@pytest.mark.parametrize("hwk,out_hw", VGG_K2, ids=lambda v: "x".join(map(str, v)))
def test_k2_plan_fits_at_factor_one(hwk, out_hw):
    """K2's plan covers every tap of its tiles (a row and the next, a column
    and the next) and fits its shared-memory budget, in one pass or several;
    the JAX Pallas epilogue refuses these shapes (its scoped VMEM), where the
    JAX Evaluator falls back to XLA."""
    from segland_tpu.ops.fused_epilogue import upsample_argmax_supported

    h, w, k = hwk
    oh, ow = out_hw
    plan = FE.upsample_plan(h, w, k, oh, ow)
    assert plan["smem"] <= FE.SMEM_BUDGET and (plan["passes"] - 1) * plan["kc"] < k
    assert k <= plan["passes"] * plan["kc"]
    for lo, hi, n, tile, room in (
            (*FE.linear_table(h, oh, True)[:2], oh, plan["ty"] * plan["groups"], plan["prows"]),
            (*FE.linear_table(w, ow, True)[:2], ow, FE.PIXELS * plan["txt"], plan["pcols"])):
        for s0 in range(0, n, tile):
            taps = np.concatenate([lo[s0:s0 + tile], hi[s0:s0 + tile]])
            assert lo[s0] <= taps.min() and taps.max() < lo[s0] + room
    assert not upsample_argmax_supported((8, h, w, k), (oh, ow))


@pytest.mark.parametrize("k", [8, 12])
def test_k2_plain_at_factor_one_matches_jax(k):
    """The plain version at factor 1 against the JAX Pallas epilogue
    (interpreted, at a shape it takes) and the fp64 oracle, and K2's order
    replayed tile by tile over its passes: the same classes wherever the
    oracle's top-2 gap exceeds 1e-3 (at factor 1 the lerps weigh 0, so
    everywhere but exact ties)."""
    from segland_tpu.ops.fused_epilogue import upsample_argmax as j_upsample_argmax

    logits = np.random.RandomState(k).randn(1, 256, 256, k).astype(np.float32) * 10.0
    ref, gap = _np_ref(logits, 256, 256)
    got = FE.upsample_argmax(t(logits), (256, 256)).numpy()
    np.testing.assert_array_equal(got, logits.argmax(-1))
    assert ((got == ref) | (gap <= 1e-3)).all()
    jax_pred = np.asarray(j_upsample_argmax(jnp.asarray(logits), (256, 256), interpret=True))
    assert ((got == jax_pred) | (gap <= 1e-3)).all()
    small = logits[:, :40, :200]
    assert FE.upsample_plan(40, 200, k, 40, 200)["passes"] > 1
    classes, _ = _tiled_replay(small, 40, 200)
    np.testing.assert_array_equal(classes, _kernel_replay(small, 40, 200))
    np.testing.assert_array_equal(classes, small.argmax(-1))


# ---- the checkpoint converter, both ways -----------------------------------
def _assert_same_tree(a, b):
    fa = jax.tree_util.tree_leaves_with_path(a)
    fb = dict(jax.tree_util.tree_leaves_with_path(b))
    assert len(fa) == len(fb)
    for path, leaf in fa:
        np.testing.assert_array_equal(np.asarray(fb[path]), leaf, err_msg=str(path))


@pytest.mark.parametrize("name", list(MODELS))
def test_round_trip_through_the_jax_converter(name):
    """JAX tree -> the port's state_dict (``from_jax_variables``) -> the JAX
    package's converter under its arch for the model -> the same tree, leaf
    for leaf, BatchNorm statistics included.  The plain pspnet's classifiers
    and aux head have no rule there: those leaves come back unexpected, and
    are checked against their JAX leaves by hand."""
    backbone, arch = MODELS[name]
    _, v, port = pair(name, backbone, name != "pspnet")  # POP models with the novel head
    sd = {k: x.detach().numpy() for k, x in port.state_dict().items()}
    assert set(sd) == set(from_jax_variables(v))
    converted, unexpected = convert_torch_state_dict(sd, arch=arch)
    heads = {"classifier": "classifier", "aux_conv": "aux.0", "aux_bn": "aux.1",
             "aux_out": "aux.3"} if name == "pspnet" else {}
    assert set(unexpected) == {k for k in sd if k.startswith(tuple(f"{h}." for h in
                                                                   heads.values()))
                               and not k.endswith("num_batches_tracked")}
    merged, missing, _ = merge_variables(jax.tree_util.tree_map(np.zeros_like, v), converted)
    assert {path[1] for path in missing} == set(heads)
    for path, leaf in jax.tree_util.tree_leaves_with_path(v):
        keys = tuple(k.key for k in path)
        got = merged
        for key in keys:
            got = got[key]
        if keys[1] not in heads:
            np.testing.assert_array_equal(np.asarray(got), leaf, err_msg=str(keys))
            continue
        # the heads the JAX converter has no rule for, by hand: conv kernels OIHW,
        # BatchNorm scale as weight, its statistics as running_*
        leaf_key = {"kernel": "weight", "scale": "weight", "bias": "bias",
                    "mean": "running_mean", "var": "running_var"}[keys[-1]]
        want = leaf.transpose(3, 2, 0, 1) if keys[-1] == "kernel" else leaf
        np.testing.assert_array_equal(sd[f"{heads[keys[1]]}.{leaf_key}"], want)
