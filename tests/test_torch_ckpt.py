"""Weights carried between the packages, both ways: from_jax_variables
(JAX tree -> port state_dict) and the JAX package's own converter
(port state_dict -> JAX tree) must round-trip the full-width convnext_pop
tree and the swin_pop tree (swin-t with the UperNet+ decoder and its
BatchNorm statistics) leaf for leaf, and the deeplab_pop and pspnet_pop trees
(resnet50, ASPP, PSPModule) with the int8 activation scales beside them, and
the seghr_pop tree (hr-w32, BatchNorm statistics; HRFPN has no parameters)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import load_port, meta_build, one_torch_thread, random_variables
from segland_tpu.ckpt.torch_convert import (convert_torch_state_dict, load_torch_checkpoint,
                                            merge_variables)
from segland_tpu.models import build_model as j_build
from segland_tpu_torch.ckpt import from_jax_variables
from segland_tpu_torch.models import build_model

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def trees():
    jm = j_build("convnext_pop", "convnext-t", n_base=7, n_novel=4, is_ft=True,
                 fused_mlp=True)
    v = random_variables(jm, jnp.zeros((1, 64, 64, 3)), seed=0)
    port = load_port(meta_build(build_model, "convnext_pop", "convnext-t", n_base=7, n_novel=4,
                                is_ft=True, fused_mlp=True), v)
    return v, port


def _assert_same_tree(a, b):
    fa = jax.tree_util.tree_leaves_with_path(a)
    fb = dict(jax.tree_util.tree_leaves_with_path(b))
    assert len(fa) == len(fb)
    for path, leaf in fa:
        np.testing.assert_array_equal(np.asarray(fb[path]), leaf, err_msg=str(path))


def test_round_trip_through_the_jax_converter(trees):
    v, port = trees
    sd = {k: x.detach().numpy() for k, x in port.state_dict().items()}
    converted, unexpected = convert_torch_state_dict(sd, arch="convnext")
    assert not unexpected
    merged, missing, _ = merge_variables(jax.tree_util.tree_map(np.zeros_like, v), converted)
    assert not missing
    _assert_same_tree(v, merged)


def test_state_dict_keys_are_upstream_keys(trees):
    v, port = trees
    keys = set(from_jax_variables(v))
    assert keys == set(port.state_dict())
    assert {"backbone.downsample_layers.0.0.weight", "backbone.stages.2.8.gamma",
            "backbone.stages.3.2.pwconv2.weight", "decoder.conv.weight", "decoder.norm.bias",
            "base_emb", "novel_emb", "classifier.4.weight", "classifier_n.0.weight"} <= keys
    assert port.state_dict()["backbone.stages.0.0.dwconv.weight"].shape == (96, 1, 7, 7)
    assert port.state_dict()["classifier.4.weight"].shape == (1, 192, 1, 1)


def test_pth_loads_into_the_jax_package(trees, tmp_path):
    v, port = trees
    path = str(tmp_path / "port.pth")
    torch.save({"state_dict": {"module." + k: x for k, x in port.state_dict().items()}}, path)
    got, info = load_torch_checkpoint(path, jax.tree_util.tree_map(np.zeros_like, v),
                                      is_restore=True, arch="convnext")
    assert not info["missing"] and not info["unexpected"]
    _assert_same_tree(v, got)


@pytest.fixture(scope="module")
def swin_trees():
    kw = dict(n_base=7, n_novel=4, is_ft=True, fused_mlp=True, fused_attn=True)
    jm = j_build("swin_pop", "swin-t", **kw)
    v = random_variables(jm, jnp.zeros((1, 64, 64, 3)), seed=1)
    return v, load_port(meta_build(build_model, "swin_pop", "swin-t", **kw), v)


def test_swin_round_trip_through_the_jax_converter(swin_trees):
    """swin backbone + UperNet+ decoder, BatchNorm running statistics included."""
    v, port = swin_trees
    assert "batch_stats" in v and "psp" in v["batch_stats"]["decoder"]
    sd = {k: x.detach().numpy() for k, x in port.state_dict().items()}
    converted, unexpected = convert_torch_state_dict(sd)
    assert not unexpected
    merged, missing, _ = merge_variables(jax.tree_util.tree_map(np.zeros_like, v), converted)
    assert not missing
    _assert_same_tree(v, merged)


def test_swin_state_dict_keys_are_upstream_keys(swin_trees):
    v, port = swin_trees
    keys = set(from_jax_variables(v))
    assert keys == set(port.state_dict())
    assert {"backbone.patch_embed.proj.weight", "backbone.layers.2.blocks.5.attn.qkv.weight",
            "backbone.layers.0.blocks.1.attn.relative_position_bias_table",
            "backbone.layers.1.downsample.reduction.weight", "backbone.norm3.weight",
            "decoder.psp.stages.3.1.weight", "decoder.psp.stages.0.2.running_var",
            "decoder.psp.bottleneck.1.running_mean", "decoder.lateral_convs.2.0.bias",
            "decoder.fpn_convs.3.4.0.weight", "decoder.fpn_convs.0.0.1.num_batches_tracked",
            "classifier_n.4.weight"} <= keys
    sd = port.state_dict()
    assert sd["backbone.layers.0.blocks.0.attn.qkv.weight"].shape == (288, 96)
    assert sd["backbone.layers.0.blocks.0.attn.relative_position_bias_table"].shape == (169, 3)
    assert sd["decoder.psp.bottleneck.0.weight"].shape == (96, 768 + 4 * 96, 1, 1)
    assert float(sd["decoder.psp.stages.0.2.running_var"].min()) >= 0.5


def test_swin_pth_loads_into_the_jax_package(swin_trees, tmp_path):
    v, port = swin_trees
    path = str(tmp_path / "swin.pth")
    torch.save({"state_dict": {"module." + k: x for k, x in port.state_dict().items()}}, path)
    got, info = load_torch_checkpoint(path, jax.tree_util.tree_map(np.zeros_like, v),
                                      is_restore=True)
    assert not info["missing"] and not info["unexpected"]
    _assert_same_tree(v, got)


def test_unknown_leaf_raises():
    with pytest.raises(KeyError):  # a module of no model
        from_jax_variables({"params": {"backbone": {"patch_embed1_fc": {
            "kernel": np.zeros((1, 1, 2, 2), np.float32)}}}})
    with pytest.raises(KeyError):
        from_jax_variables({"batch_stats": {"x": {"mean": np.zeros(2, np.float32)}}})
    with pytest.raises(KeyError):
        from_jax_variables({"batch_stats": {"backbone": {"norm1": {
            "mean": np.zeros(2, np.float32)}}}})
    with pytest.raises(KeyError):
        from_jax_variables({"params": {"backbone": {"layer1_0": {"conv4": {
            "kernel": np.zeros((1, 1, 2, 2), np.float32)}}}}})


@pytest.fixture(scope="module")
def hrnet_trees():
    """seghr_pop / hr-w32 with its novel head: flat JAX names
    (stage3_2_fuse_2_0_0_conv) to upstream's nested ones."""
    kw = dict(n_base=7, n_novel=4, is_ft=True)
    v = random_variables(j_build("seghr_pop", "hr-w32", **kw), jnp.zeros((1, 64, 64, 3)), seed=4)
    return v, load_port(meta_build(build_model, "seghr_pop", "hr-w32", **kw), v)


def test_hrnet_round_trip_through_the_jax_converter(hrnet_trees):
    """The JAX package's converter under ``arch="hrnet"`` (``_HRNET_RULES``)
    reads the port's state_dict back into the tree, leaf for leaf, BatchNorm
    statistics included."""
    v, port = hrnet_trees
    assert "stage4_2_fuse_3_0_2_bn" in v["batch_stats"]["backbone"]
    sd = {k: x.detach().numpy() for k, x in port.state_dict().items()}
    converted, unexpected = convert_torch_state_dict(sd, arch="hrnet")
    assert not unexpected
    merged, missing, _ = merge_variables(jax.tree_util.tree_map(np.zeros_like, v), converted)
    assert not missing
    _assert_same_tree(v, merged)


def test_hrnet_state_dict_keys_are_upstream_keys(hrnet_trees):
    v, port = hrnet_trees
    keys = set(from_jax_variables(v))
    assert keys == set(port.state_dict())
    assert {"backbone.conv1.weight", "backbone.bn2.running_mean",
            "backbone.layer1.0.downsample.1.running_var", "backbone.layer1.2.conv3.weight",
            "backbone.transition1.0.1.bias", "backbone.transition1.1.0.0.weight",
            "backbone.transition2.2.0.1.running_mean", "backbone.transition3.3.0.0.weight",
            "backbone.stage2.0.branches.0.3.bn2.weight",
            "backbone.stage3.3.fuse_layers.0.2.1.running_var",
            "backbone.stage4.2.fuse_layers.3.0.2.1.num_batches_tracked",
            "classifier_n.4.weight", "novel_emb"} <= keys
    sd = port.state_dict()
    assert sd["backbone.stage4.0.fuse_layers.0.3.0.weight"].shape == (32, 256, 1, 1)
    assert sd["backbone.stage4.0.fuse_layers.3.0.2.0.weight"].shape == (256, 32, 3, 3)
    assert sd["base_emb"].shape == (7, 480)


def test_hrnet_pth_loads_into_the_jax_package(hrnet_trees, tmp_path):
    v, port = hrnet_trees
    path = str(tmp_path / "seghr.pth")
    torch.save({"state_dict": {"module." + k: x for k, x in port.state_dict().items()}}, path)
    got, info = load_torch_checkpoint(path, jax.tree_util.tree_map(np.zeros_like, v),
                                      is_restore=True, arch="hrnet")
    assert not info["missing"] and not info["unexpected"]
    _assert_same_tree(v, got)


@pytest.fixture(scope="module", params=["deeplab_pop", "pspnet_pop"])
def resnet_trees(request):
    kw = dict(n_base=7, n_novel=4, is_ft=True)
    jm = j_build(request.param, "resnet50", **kw)
    v = random_variables(jm, jnp.zeros((1, 64, 64, 3)), seed=2)
    port = load_port(meta_build(build_model, request.param, "resnet50", **kw), v)
    return request.param, jm, v, port


def test_resnet_round_trip_through_the_jax_converter(resnet_trees):
    """resnet50 backbone with the ASPP or PSPModule decoder, BatchNorm running
    statistics included."""
    _, _, v, port = resnet_trees
    assert "layer3_5" in v["batch_stats"]["backbone"]
    sd = {k: x.detach().numpy() for k, x in port.state_dict().items()}
    converted, unexpected = convert_torch_state_dict(sd)
    assert not unexpected
    merged, missing, _ = merge_variables(jax.tree_util.tree_map(np.zeros_like, v), converted)
    assert not missing
    _assert_same_tree(v, merged)


def test_resnet_state_dict_keys_are_upstream_keys(resnet_trees):
    name, _, v, port = resnet_trees
    keys = set(from_jax_variables(v))
    assert keys == set(port.state_dict())
    assert {"backbone.conv1.weight", "backbone.bn1.running_mean",
            "backbone.layer1.0.downsample.0.weight", "backbone.layer1.0.downsample.1.running_var",
            "backbone.layer3.5.conv2.weight", "backbone.layer4.2.bn3.num_batches_tracked",
            "classifier_n.4.weight", "base_emb"} <= keys
    own = ({"decoder.stages.c0.conv.weight", "decoder.stages.c3.bn.running_mean",
            "decoder.stages.imagepool.conv.conv.weight", "decoder.fc.bn.weight"}
           if name == "deeplab_pop" else
           {"decoder.stages.0.1.weight", "decoder.stages.3.2.running_var",
            "decoder.bottleneck.0.weight", "decoder.bottleneck.1.bias",
            "decoder.bottleneck.3.bias"})
    assert own <= keys
    sd = port.state_dict()
    assert sd["backbone.conv1.weight"].shape == (64, 3, 7, 7)
    assert sd["backbone.layer4.0.conv2.weight"].shape == (512, 512, 3, 3)


def test_resnet_pth_loads_into_the_jax_package(resnet_trees, tmp_path):
    name, _, v, port = resnet_trees
    path = str(tmp_path / f"{name}.pth")
    torch.save({"state_dict": {"module." + k: x for k, x in port.state_dict().items()}}, path)
    got, info = load_torch_checkpoint(path, jax.tree_util.tree_map(np.zeros_like, v),
                                      is_restore=True)
    assert not info["missing"] and not info["unexpected"]
    _assert_same_tree(v, got)


def test_quant_collection_round_trip(resnet_trees):
    """The JAX package's calibrated ``"quant"`` collection -> the port's
    {module name: act_amax} -> the same collection, leaf for leaf; every name
    is a module of the port."""
    from segland_tpu.quant import calibrate as j_calibrate
    from segland_tpu_torch.ckpt import quant_from_jax, quant_to_jax

    name, jm, v, port = resnet_trees
    img = np.random.RandomState(3).randn(1, 32, 32, 3).astype(np.float32)
    quant = jax.tree_util.tree_map(np.asarray, j_calibrate(jm, v, [jnp.asarray(img)])["quant"])
    flat = quant_from_jax(quant)
    modules = dict(port.named_modules())
    assert len(flat) == len(jax.tree_util.tree_leaves(quant)) >= 52
    assert all(isinstance(modules[k], torch.nn.Conv2d) for k in flat)
    assert {"backbone.layer1.0.downsample.0", "backbone.layer4.2.conv3"} <= set(flat)
    assert "backbone.conv1" not in flat and not any(k.startswith("classifier") for k in flat)
    _assert_same_tree(quant, quant_to_jax(flat, v["params"]))
    assert "quant" not in "".join(from_jax_variables({**v, "quant": quant}))
