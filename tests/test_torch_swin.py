"""The port's Swin backbone, UperNet+ decoder and adaptive pooling against
the JAX package at a narrow width, fp32 on the CPU, same weights (carried by
from_jax_variables) and inputs: every pyramid level and the decoder output
within atol 5e-4, for the unfused blocks, the fused ones (both packages run
their plain references on the CPU) and the use_pallas route (the JAX side
through its Pallas kernel in interpret mode)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import load_port, random_variables, t
from segland_tpu.models.backbones.swin import SwinTransformer as JSwin
from segland_tpu.models.decoders import UperNetPlusDecoder as JUperNet
from segland_tpu.ops import pallas_attn as J
from segland_tpu.ops.pooling import adaptive_avg_pool as j_pool
from segland_tpu_torch.models.backbones import get_backbone
from segland_tpu_torch.models.backbones.swin import SwinBlock, SwinTransformer, get_swin
from segland_tpu_torch.models.decoders import UperNetPlusDecoder
from segland_tpu_torch.ops.pooling import adaptive_avg_pool

ATOL = 5e-4
CFG = dict(depths=(2, 2), num_heads=(2, 4), embed_dim=32)
ROUTES = {"unfused": {}, "fused": dict(fused_mlp=True, fused_attn=True),
          "fused_attn_only": dict(fused_attn=True), "fused_mlp_only": dict(fused_mlp=True),
          "use_pallas": dict(use_pallas=True)}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("hw", [(56, 56), (45, 30)], ids=["aligned", "padded"])
def test_backbone_matches_jax(route, hw, monkeypatch):
    if route == "use_pallas":  # no TPU here: the JAX kernel runs in interpret mode
        monkeypatch.setattr(J, "window_attention_fused",
                            functools.partial(J.window_attention_fused, interpret=True))
    jm = JSwin(drop_path_rate=0.0, **CFG, **ROUTES[route])
    x = np.random.RandomState(1).randn(2, *hw, 3).astype(np.float32)
    v = random_variables(jm, jnp.zeros((1, *hw, 3)), seed=2)
    port = load_port(SwinTransformer(**CFG, **ROUTES[route]),
                     {"params": {"backbone": v["params"]}}, prefix="backbone.").eval()
    want = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = port(t(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 2
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w_), rtol=0,
                                   atol=ATOL)


def test_decoder_matches_jax():
    filters = (24, 48, 96, 192)
    rng = np.random.RandomState(3)
    feats = [rng.randn(2, 24 // 2 ** i, 20 // 2 ** i, f).astype(np.float32)
             for i, f in enumerate(filters)]
    jm = JUperNet(filters=filters, out_features=24)
    v = random_variables(jm, [jnp.zeros(f.shape) for f in feats], seed=4)
    assert "batch_stats" in v
    port = load_port(UperNetPlusDecoder(filters, 24),
                     {k: {"decoder": tree} for k, tree in v.items()}, prefix="decoder.").eval()
    want = np.asarray(jm.apply(v, [jnp.asarray(f) for f in feats]))
    with torch.no_grad():
        got = port([t(f).permute(0, 3, 1, 2) for f in feats]).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 24, 20, 24)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("size", [1, 2, 3, 6])
@pytest.mark.parametrize("hw", [(32, 32), (35, 23)], ids=["32x32", "35x23"])
def test_adaptive_avg_pool_matches_jax(size, hw):
    x = np.random.RandomState(size).randn(2, *hw, 5).astype(np.float32)
    want = np.asarray(j_pool(jnp.asarray(x), size))
    got = adaptive_avg_pool(t(x), size).numpy()
    assert got.shape == want.shape == (2, size, size, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_state_dict_keys_are_upstream_keys():
    keys = set(get_backbone("swin-t").state_dict())
    assert {"patch_embed.proj.weight", "patch_embed.norm.bias",
            "layers.2.blocks.5.attn.qkv.weight", "layers.0.blocks.1.attn.proj.bias",
            "layers.1.blocks.0.attn.relative_position_bias_table",
            "layers.3.blocks.1.mlp.fc2.weight", "layers.0.blocks.0.norm1.weight",
            "layers.2.downsample.reduction.weight", "layers.0.downsample.norm.bias",
            "norm0.weight", "norm3.bias"} <= keys
    assert not any("downsample" in k for k in keys if k.startswith("layers.3"))
    assert not any("relative_position_index" in k for k in keys)


@pytest.mark.parametrize("make,item", [
    (lambda: get_swin("swin-b", fused_attn=True, fused_mlp=True), "A6"),
    (lambda: get_swin("swin-l", fused_attn=True), "A6"),
    (lambda: SwinTransformer(fused_attn=True, fused_mlp=True, fused_block_stages=(2,)), "B4"),
    (lambda: SwinBlock(96, 3, attn_group=2, fused_attn=True), "B5"),
], ids=["swin-b-fused", "swin-l-fused", "fused_block_stages", "attn_group"])
def test_unported_options_raise(make, item):
    with pytest.raises(NotImplementedError, match=item):
        make()


@pytest.mark.parametrize("env,item", [("SEGLAND_SWIN_WR", "A6"), ("SEGLAND_SWIN_V3_STAGES", "B4")])
def test_unported_env_switches_raise(monkeypatch, env, item):
    monkeypatch.setenv(env, "1" if env.endswith("WR") else "all")
    with pytest.raises(NotImplementedError, match=item):
        get_swin("swin-t", fused_attn=True, fused_mlp=True)
    assert get_swin("swin-b").layers[3].blocks[0].num_heads == 32  # unfused swin-b builds
