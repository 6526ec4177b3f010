"""The port's Swin backbone, UperNet+ decoder and adaptive pooling against
the JAX package at a narrow width, fp32 on the CPU, same weights (carried by
from_jax_variables) and inputs: every pyramid level and the decoder output
within atol 5e-4, for the unfused blocks, the fused ones (both packages run
their plain references on the CPU), the use_pallas route (the JAX side
through its Pallas kernel in interpret mode) and the other fused routes, each
against the JAX backbone by the same route with its Pallas kernels in
interpret mode: the whole-block kernel (fused_block_stages), per-stage gating
(fused_attn_stages), window-resident stages (SEGLAND_SWIN_WR=1) and, a block
at a time, super-window groups (attn_group)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import load_port, meta_build, one_torch_thread, random_variables, t
from segland_tpu.models import build_model as j_build
from segland_tpu.models.backbones import swin as j_swin_mod
from segland_tpu.models.backbones.swin import SwinBlock as JSwinBlock
from segland_tpu.models.backbones.swin import SwinTransformer as JSwin
from segland_tpu.models.decoders import UperNetPlusDecoder as JUperNet
from segland_tpu.ops import pallas_attn as J
from segland_tpu.ops.pooling import adaptive_avg_pool as j_pool
from segland_tpu.models.pop import GFSSModel as JGFSS
from segland_tpu_torch.models import build_model
from segland_tpu_torch.models.backbones import get_backbone
from segland_tpu_torch.models.backbones import swin as p_swin_mod
from segland_tpu_torch.models.backbones.swin import SwinBlock, SwinTransformer, get_swin
from segland_tpu_torch.models.decoders import UperNetPlusDecoder
from segland_tpu_torch.ops.pooling import adaptive_avg_pool

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL = 5e-4
CFG = dict(depths=(2, 2), num_heads=(2, 4), embed_dim=32)
FUSED = dict(fused_mlp=True, fused_attn=True)
ROUTES = {"unfused": {}, "fused": FUSED,
          "fused_attn_only": dict(fused_attn=True), "fused_mlp_only": dict(fused_mlp=True),
          "use_pallas": dict(use_pallas=True),
          "fused_block": dict(fused_block_stages=(0, 1), **FUSED),
          "fused_block_stage1": dict(fused_block_stages=(1,), **FUSED),
          "fused_attn_stages": dict(fused_attn_stages=(1,), **FUSED),
          "window_resident": FUSED}
# routes whose JAX side runs its Pallas kernels in interpret mode, and their switches
ENV = {"fused_block": {}, "fused_block_stage1": {}, "fused_attn_stages": {},
       "window_resident": {"SEGLAND_SWIN_WR": "1"}}


def _run_both(route, hw, monkeypatch, port_kw=None):
    """(port pyramid, JAX pyramid, port module) for one route on one input."""
    if route == "use_pallas":  # no TPU here: the JAX kernel runs in interpret mode
        monkeypatch.setattr(J, "window_attention_fused",
                            functools.partial(J.window_attention_fused, interpret=True))
    if route in ENV:
        monkeypatch.setenv("SEGLAND_PALLAS_INTERPRET", "1")
        for k, val in ENV[route].items():
            monkeypatch.setenv(k, val)
    jm = JSwin(drop_path_rate=0.0, **CFG, **ROUTES[route])
    x = np.random.RandomState(1).randn(2, *hw, 3).astype(np.float32)
    v = random_variables(jm, jnp.zeros((1, *hw, 3)), seed=2)
    port = load_port(SwinTransformer(**CFG, **ROUTES[route], **(port_kw or {})),
                     {"params": {"backbone": v["params"]}}, prefix="backbone.").eval()
    want = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = port(t(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 2
    return got, want, port


@pytest.mark.parametrize("hw", [(56, 56), (45, 30)], ids=["aligned", "padded"])
def test_use_pallas_hands_the_kernel_a_bias_it_takes(hw, monkeypatch):
    """The use_pallas route's bias passes K6's wrapper checks (bf16, contiguous,
    4-byte aligned, nW_img dividing NW), as a run on the card needs: K6 reads it
    in place, with no cast or copy pass."""
    from segland_tpu_torch.models.backbones import swin as p_swin
    from segland_tpu_torch.ops import fused_attn as P

    seen = []

    def checked(qkv, bias, nh):
        P._window_bias(bias, qkv.to(torch.bfloat16), nh, qkv.shape[1])
        seen.append((bias.dtype, bias.shape[0]))
        return P.window_attention_reference(qkv, bias, nh)

    monkeypatch.setattr(p_swin, "window_attention_fused", checked)
    with torch.no_grad():
        SwinTransformer(**CFG, use_pallas=True).eval()(torch.randn(1, 3, *hw))
    assert seen and {dt for dt, _ in seen} == {torch.bfloat16}
    assert any(n > 1 for _, n in seen)  # the shifted blocks' per-window bias + mask


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("hw", [(56, 56), (45, 30)], ids=["aligned", "padded"])
def test_backbone_matches_jax(route, hw, monkeypatch):
    got, want, _ = _run_both(route, hw, monkeypatch)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w_), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("route", ["fused_block", "fused_attn_stages", "window_resident"])
def test_new_routes_match_the_unfused_port(route, monkeypatch):
    """28x28 input: 7x7 and 4x4 token maps, so window padding is live in the
    second stage.  The route against the port's own unfused blocks."""
    got, _, port = _run_both(route, (28, 28), monkeypatch)
    plain = SwinTransformer(**CFG).eval()
    plain.load_state_dict(port.state_dict())
    x = np.random.RandomState(1).randn(2, 28, 28, 3).astype(np.float32)
    monkeypatch.delenv("SEGLAND_SWIN_WR", raising=False)
    with torch.no_grad():
        want = plain(t(x).permute(0, 3, 1, 2))
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=ATOL)


@pytest.mark.parametrize("env,kw,calls", [("1", FUSED, 4), ("0", FUSED, 0), (None, FUSED, 0),
                                          ("1", dict(fused_attn=True), 0),
                                          ("1", dict(fused_attn_stages=(1,), **FUSED), 2)])
def test_window_resident_switch_engages_the_resident_body(env, kw, calls, monkeypatch):
    """SEGLAND_SWIN_WR=1 under fused_attn and fused_mlp sends every block of a
    fused stage through SwinBlock._win_resident, on all the tokens of the
    padded windows; any other setting sends none."""
    seen = []

    def counted(self, wins, win_shape, _fn=SwinBlock._win_resident):
        seen.append((tuple(wins.shape), win_shape))
        return _fn(self, wins, win_shape)

    monkeypatch.setattr(SwinBlock, "_win_resident", counted)
    if env is None:
        monkeypatch.delenv("SEGLAND_SWIN_WR", raising=False)
    else:
        monkeypatch.setenv("SEGLAND_SWIN_WR", env)
    model = SwinTransformer(**CFG, **kw).eval()
    with torch.no_grad():
        model(torch.zeros(2, 3, 40, 40))  # 10x10 and 5x5 token maps, padded to 14 and 7
    assert len(seen) == calls
    stage1 = ((2, 49, 64), (2, 5, 5, 7, 7))
    if calls == 4:
        assert seen == [((8, 49, 32), (2, 10, 10, 14, 14))] * 2 + [stage1] * 2
    elif calls:
        assert seen == [stage1] * 2


def test_fused_attn_stages_gates_the_section_per_stage():
    """Stages outside the tuple run the unfused attention with fused_mlp still
    on; get_swin resolves "auto" to all four stages."""
    m = SwinTransformer(**CFG, fused_attn_stages=(1,), fused_block_stages=(0, 1), **FUSED)
    flags = [[(b.fused_attn, b.fused_mlp, b.fused_block) for b in layer.blocks]
             for layer in m.layers]
    assert flags == [[(False, True, False)] * 2, [(True, True, True)] * 2]
    full = get_swin("swin-t", **FUSED)
    assert all(b.fused_attn and not b.fused_block for layer in full.layers for b in layer.blocks)
    assert not any(b.fused_attn for layer in get_swin("swin-t", fused_mlp=True).layers
                   for b in layer.blocks)


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("group", [1, 2, 3])
def test_block_with_attn_group_matches_jax(group, shift, monkeypatch):
    """One block with attn_group on a 26x19 map (28x21 padded, 12 windows a
    tile, 36 over the 3 tiles): the JAX block runs its v1 Pallas kernel in
    interpret mode with that group."""
    monkeypatch.setenv("SEGLAND_PALLAS_INTERPRET", "1")
    kw = dict(shift_size=shift, attn_group=group, **FUSED)
    jm = JSwinBlock(32, 2, **kw)
    x = np.random.RandomState(4).randn(3, 26, 19, 32).astype(np.float32)
    v = random_variables(jm, jnp.zeros((1, 26, 19, 32)), seed=5)
    tree = {"params": {"backbone": {"layers_0_blocks_0": v["params"]}}}
    port = load_port(SwinBlock(32, 2, **kw), tree, prefix="backbone.layers.0.blocks.0.").eval()
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = port(t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_backbone_with_attn_group_matches_jax(monkeypatch):
    """SwinTransformer(attn_group=2), also window-resident, against the JAX
    backbone (which has no such argument: its fused route gives the same
    values, the other windows' keys having weight zero)."""
    for route in ("fused", "window_resident"):
        got, want, port = _run_both(route, (45, 30), monkeypatch, port_kw=dict(attn_group=2))
        assert all(b.attn_group == 2 for layer in port.layers for b in layer.blocks)
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


@pytest.mark.parametrize("make,route", [
    (lambda: get_swin("swin-b", fused_attn=True, fused_mlp=True, fused_block_stages=(0, 1, 2, 3)),
     "fused_block"),
    (lambda: SwinTransformer(depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48), embed_dim=192,
                             fused_attn=True, fused_mlp=True, attn_group=2), "attn_group"),
], ids=["swin-b-fused", "swin-l-fused"])
def test_unported_options_raise(make, route):
    """The options that raised while the whole-block kernel (K4) and the v1
    kernel (K5, attn_group) had no build at swin-b's and swin-l's widths now
    build, with the route on in every stage: K4 and K5 are built at every
    width of swin-t/s/b/l."""
    with torch.device("meta"):
        m = make()
    blocks = [b for layer in m.layers for b in layer.blocks]
    assert len(blocks) == 24 and all(b.fused_attn and b.fused_mlp for b in blocks)
    if route == "fused_block":
        assert all(b.fused_block and b.attn_group == 1 for b in blocks)
    else:
        assert all(b.attn_group == 2 and not b.fused_block for b in blocks)


@pytest.mark.parametrize("env,value,stages", [
    ("SEGLAND_SWIN_WR", "1", None), ("SEGLAND_SWIN_V3_STAGES", "all", (0, 1, 2, 3)),
    ("SEGLAND_SWIN_V3_STAGES", "0,2", (0, 2)), ("SEGLAND_SWIN_V3_STAGES", "none", None)])
def test_env_switches_build(monkeypatch, env, value, stages):
    """The JAX package's switches no longer raise: SEGLAND_SWIN_V3_STAGES picks
    the whole-block stages when the model is built, SEGLAND_SWIN_WR is read at
    the forward.  Fused swin-b builds under them, with the whole-block kernel
    in the stages the switch names."""
    monkeypatch.setenv(env, value)
    m = get_swin("swin-t", fused_attn=True, fused_mlp=True)
    on = tuple(i for i, layer in enumerate(m.layers) if layer.blocks[0].fused_block)
    assert on == (stages or ())
    assert not any(b.fused_block for layer in get_swin("swin-t", fused_attn=True).layers
                   for b in layer.blocks)  # needs fused_mlp too
    with torch.device("meta"):
        fused = get_swin("swin-b", fused_attn=True, fused_mlp=True)
        assert all(b.fused_attn and b.fused_block == (i in (stages or ()))
                   for i, layer in enumerate(fused.layers) for b in layer.blocks)
        assert get_swin("swin-b").layers[3].blocks[0].num_heads == 32  # unfused swin-b builds


# ---- swin_pop on swin-b and swin-l, fused, at full width --------------------------------
# their widths and heads, the depth cut to two blocks a stage (one shifted)
WIDE_CUT = {"swin-b": dict(depths=(2, 2, 2, 2), num_heads=(4, 8, 16, 32), embed_dim=128),
            "swin-l": dict(depths=(2, 2, 2, 2), num_heads=(6, 12, 24, 48), embed_dim=192)}


@pytest.fixture(scope="module", params=sorted(WIDE_CUT))
def wide_swin_pop(request):
    """swin_pop on swin-b or swin-l at full width on both sides, the fused route
    (both packages run their plain references on the CPU), one weight tree
    carried by from_jax_variables; the 18-block stage cut to 2 through the
    configs table, as tests/test_torch_slice_swin.py cuts swin-s."""
    name = request.param
    kw = dict(n_base=7, n_novel=4, is_ft=True, fused_mlp=True, fused_attn=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(j_swin_mod._CONFIGS, name, WIDE_CUT[name])
        mp.setitem(p_swin_mod._CONFIGS, name, WIDE_CUT[name])
        jm = j_build("swin_pop", name, **kw)
        v = random_variables(jm, jnp.zeros((1, 64, 64, 3)), seed=9)
        port = load_port(meta_build(build_model, "swin_pop", name, **kw), v)
        blocks = [b for layer in port.backbone.layers for b in layer.blocks]
        assert len(blocks) == 8 and all(b.fused_attn and b.fused_mlp for b in blocks)
        yield name, jm, v, port


@pytest.mark.parametrize("method", ["forward_base", "forward_all"])
def test_wide_swin_pop_matches_jax(wide_swin_pop, method):
    """forward_base (eval_base's logits) and the ft forward (eval_ft's, 4 novel
    classes) of fused swin_pop on swin-b and swin-l against the JAX model,
    fp32, atol 5e-4 (the repo's parity bar); a 60x44 image pads every stage's
    windows."""
    import jax

    name, jm, v, port = wide_swin_pop
    image = np.random.RandomState(10).randn(1, 60, 44, 3).astype(np.float32)
    kw = dict(method=JGFSS.forward_base) if method == "forward_base" else {}
    # jitted: the eager apply compiles op by op (30 s a model here, 5 s jitted)
    want = np.asarray(jax.jit(lambda v_, x: jm.apply(v_, x, **kw))(v, jnp.asarray(image)))
    with torch.no_grad():
        got = getattr(port, method)(t(image).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 15, 11, 8 if method == "forward_base" else 12)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("route", ["whole_block", "attn_group"])
def test_wide_swin_pop_routes_match_jax(wide_swin_pop, route, monkeypatch):
    """forward_base of swin_pop on swin-b and swin-l by the whole-block route
    (SEGLAND_SWIN_V3_STAGES=all: K4's plain version in every block) and by
    super-window groups (attn_group=2: K5's plain version, then K1's) against
    the JAX model with the same switch, fp32, atol 5e-4.  The JAX backbone has
    no attn_group (its fused route gives the same values, the other windows'
    keys having weight zero), so that route is held to the JAX fused model."""
    import jax

    name, jm, v, port = wide_swin_pop
    image = np.random.RandomState(11).randn(1, 60, 44, 3).astype(np.float32)
    kw = dict(n_base=7, n_novel=4, is_ft=True, fused_mlp=True, fused_attn=True)
    if route == "whole_block":
        monkeypatch.setenv("SEGLAND_SWIN_V3_STAGES", "all")
        jm = j_build("swin_pop", name, **kw)
        routed = meta_build(build_model, "swin_pop", name, **kw)
        routed.load_state_dict(port.state_dict())
    else:
        cfg = p_swin_mod._CONFIGS[name]
        routed = meta_build(build_model, "swin_pop", name, **kw)
        routed.load_state_dict(port.state_dict())
        routed.backbone = SwinTransformer(**cfg, fused_attn=True, fused_mlp=True,
                                          attn_group=2).eval()
        routed.backbone.load_state_dict(port.backbone.state_dict())
    blocks = [b for layer in routed.backbone.layers for b in layer.blocks]
    assert len(blocks) == 8 and all(
        (b.fused_block if route == "whole_block" else b.attn_group == 2) for b in blocks)
    want = np.asarray(jax.jit(lambda v_, x: jm.apply(v_, x, method=JGFSS.forward_base))(
        v, jnp.asarray(image)))
    with torch.no_grad():
        got = routed.eval().forward_base(t(image).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
