"""The port's ResNet family against the JAX package, fp32 on the CPU with the
same weights (carried by from_jax_variables) and the same inputs: the
backbone with the v1 and the deep stem, output stride 8 and 16, multigrid,
``last_relu`` off and the pyramid output; the ASPP and PSPModule decoders; the
stem pool.  Tolerance 5e-4 on every output, the repo's parity bar (sums run
in another order in the two frameworks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import load_port, one_torch_thread, random_variables, t
from segland_tpu.models import decoders as JD
from segland_tpu.models.backbones import resnet as JR
from segland_tpu.ops.pooling import max_pool_3x3_s2 as j_max_pool
from segland_tpu_torch.models import decoders as D
from segland_tpu_torch.models.backbones import backbone_filters, get_backbone
from segland_tpu_torch.models.backbones import resnet as R
from segland_tpu_torch.ops.pooling import max_pool_3x3_s2

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL = 5e-4

CASES = {
    "v1_os8": dict(layers=(1, 1, 1, 1)),
    "deep_os8": dict(layers=(1, 1, 1, 1), deep_stem=True),
    "v1_os16": dict(layers=(1, 1, 1, 1), os=16),
    "deep_os16_multigrid": dict(layers=(1, 1, 1, 3), os=16, deep_stem=True, multi_grid=True),
    "os8_multigrid": dict(layers=(1, 1, 1, 3), multi_grid=True),
    "not_dilated": dict(layers=(1, 1, 1, 1), dilated=False),
    "no_last_relu": dict(layers=(1, 1, 2, 2), relu_l3=False, relu_l4=False),
    "two_blocks": dict(layers=(2, 2, 1, 1)),
}


def _under(v, name):
    """A subtree's variables as the whole model would name them."""
    return {k: {name: tree} for k, tree in v.items()}


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(0).randn(2, 48, 40, 3).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_backbone_matches_jax(image, case):
    kw = CASES[case]
    jm = JR.ResNet(**kw)
    v = random_variables(jm, jnp.zeros((1, 32, 32, 3)), seed=3)
    port = load_port(R.ResNet(**kw).eval(), _under(v, "backbone"), prefix="backbone.")
    want = jm.apply(v, jnp.asarray(image), return_list=True)
    with torch.no_grad():
        got = port(t(image).permute(0, 3, 1, 2), return_list=True)
        last = port(t(image).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 4
    stride = 32 if not kw.get("dilated", True) else kw.get("os", 8)
    assert got[0].shape == (2, 2048, -(-48 // stride), -(-40 // stride))
    for g, w in zip(got, want):  # [x4, x3, x2, x1]
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)
    torch.testing.assert_close(last, got[0], rtol=0, atol=0)


def test_last_relu_off_lets_negatives_through():
    port = R.ResNet((1, 1, 1, 2), relu_l4=False).eval()
    port.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        x4 = port(torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(1)))
    assert float(x4.min()) < 0.0
    assert [b.last_relu for b in port.layer4] == [True, False]
    assert [b.last_relu for b in port.layer3] == [True]


def test_block_attributes_and_dilations():
    """What the int8 router reads: stride, dilation, multi_grid,
    has_downsample, last_relu; resnet50 has 12 of 16 blocks fused-eligible."""
    net = R.resnet50()
    blocks = [b for layer in (net.layer1, net.layer2, net.layer3, net.layer4) for b in layer]
    assert len(blocks) == 16
    eligible = [b for b in blocks if b.stride == 1 and not b.has_downsample]
    assert len(eligible) == 12
    assert [len([b for b in layer if b.stride == 1 and not b.has_downsample])
            for layer in (net.layer1, net.layer2, net.layer3, net.layer4)] == [2, 3, 5, 2]
    assert {b.dilation for b in net.layer3} == {2} and {b.dilation for b in net.layer4} == {4}
    assert net.layer2[0].stride == 2 and net.layer2[0].has_downsample
    assert net.layer3[0].conv2.dilation == (2, 2) and net.layer3[0].conv2.padding == (2, 2)
    mg = R.ResNet((1, 1, 1, 3), multi_grid=True)
    assert [b.multi_grid for b in mg.layer4] == [1, 2, 4]
    assert mg.layer4[2].conv2.dilation == (16, 16)


@pytest.mark.parametrize("name,depth,deep", [("resnet10", 4, False), ("resnet50", 16, False),
                                             ("resnet101", 33, False), ("resnet50v2", 16, True),
                                             ("resnet101v2", 33, True)])
def test_factory_builds_every_resnet(name, depth, deep):
    net = get_backbone(name, os=16)
    assert isinstance(net, R.ResNet) and net.deep_stem == deep
    assert sum(len(getattr(net, f"layer{i}")) for i in (1, 2, 3, 4)) == depth
    assert net.layer3[0].stride == 2  # os 16 reached the constructor
    assert backbone_filters(name) == (2048, 1024, 512, 256)
    keys = set(net.state_dict())
    assert {"conv1.weight", "bn1.running_var", "layer1.0.conv1.weight",
            "layer1.0.downsample.0.weight", "layer1.0.downsample.1.running_mean",
            "layer4.0.bn3.num_batches_tracked"} <= keys
    assert ("conv3.weight" in keys) == deep


def test_channels_last_inside_and_dtype():
    net = get_backbone("resnet10", dtype=torch.bfloat16).eval()
    with torch.no_grad():
        x4 = net(torch.randn(1, 3, 32, 32))
    assert x4.dtype == torch.bfloat16 and x4.is_contiguous(memory_format=torch.channels_last)
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_max_pool_matches_jax():
    x = np.random.RandomState(1).randn(2, 9, 12, 5).astype(np.float32)
    np.testing.assert_array_equal(max_pool_3x3_s2(t(x)).numpy(), np.asarray(j_max_pool(jnp.asarray(x))))


@pytest.mark.parametrize("hw", [(9, 7), (6, 6), (1, 3)])
def test_aspp_matches_jax(hw):
    jm = JD.ASPP(out_features=32)
    x = np.random.RandomState(2).randn(2, *hw, 64).astype(np.float32)
    v = random_variables(jm, jnp.asarray(x), seed=4)
    port = load_port(D.ASPP((64,), out_features=32).eval(), _under(v, "decoder"),
                     prefix="decoder.")
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = port(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, *hw, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert port.fc.bn.momentum == 0.999 and port.stages["c2"].conv.dilation == (12, 12)
    assert {"stages.c0.conv.weight", "stages.c3.bn.running_var", "fc.bn.weight",
            "stages.imagepool.conv.conv.weight"} <= set(port.state_dict())


@pytest.mark.parametrize("hw", [(9, 7), (6, 6), (13, 2)])
def test_psp_module_matches_jax(hw):
    jm = JD.PSPModule(out_features=32)
    x = np.random.RandomState(3).randn(2, *hw, 64).astype(np.float32)
    v = random_variables(jm, jnp.asarray(x), seed=5)
    port = load_port(D.PSPModule((64,), out_features=32).eval(), _under(v, "decoder"),
                     prefix="decoder.")
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = port(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, *hw, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    sd = port.state_dict()
    assert sd["bottleneck.0.weight"].shape == (32, 64 + 4 * 32, 3, 3)
    assert "bottleneck.0.bias" not in sd and sd["bottleneck.3.bias"].shape == (32,)
    assert {"stages.0.1.weight", "stages.3.2.running_mean", "bottleneck.1.weight"} <= set(sd)
