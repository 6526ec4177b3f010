"""The port's swin_pop / swin-s slice against the JAX package at full width
and depth, fp32 on the CPU, with the same weights and inputs (split from
tests/test_torch_slice.py): forward_base and forward_all logits within atol
5e-4, fused and unfused, and by the whole-block route
(SEGLAND_SWIN_V3_STAGES=all on both sides, both on their plain references)
at full width with the third stage cut to 2 blocks (at full depth marked
slow); the eval_ft protocol's Evaluator confusion matrix equal to the JAX
one except for pixels whose top-2 logits lie within 1e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import load_port, meta_build, near_tie_pixels, random_variables, t
from segland_tpu.evallib.infer import Evaluator as JEvaluator
from segland_tpu.models import build_model as j_build
from segland_tpu.models.pop import GFSSModel as JGFSS
from segland_tpu_torch.evallib import Evaluator
from segland_tpu_torch.models import build_model

ATOL = 5e-4


def _port_logits(port, image, method):
    with torch.no_grad():
        out = getattr(port, method)(t(image).permute(0, 3, 1, 2))
    return out.permute(0, 2, 3, 1).numpy()


# ---- swin_pop / swin-s at full width and depth ------------------------------
@pytest.fixture(scope="module")
def swin_models():
    kw = dict(n_base=7, n_novel=4, is_ft=True)
    fused = dict(fused_mlp=True, fused_attn=True)
    jm = {"unfused": j_build("swin_pop", "swin-s", **kw),
          "fused": j_build("swin_pop", "swin-s", **kw, **fused)}
    v = random_variables(jm["fused"], jnp.zeros((1, 64, 64, 3)), seed=5)
    port = {"unfused": load_port(meta_build(build_model, "swin_pop", "swin-s", **kw), v),
            "fused": load_port(meta_build(build_model, "swin_pop", "swin-s", **kw, **fused), v)}
    return jm, v, port


@pytest.fixture(scope="module")
def swin_image():
    # 60x44 -> 15x11 tokens: every stage pads its windows
    return np.random.RandomState(6).randn(2, 60, 44, 3).astype(np.float32)


@pytest.mark.parametrize("route", ["fused", "unfused"])
def test_swin_forward_base_parity(swin_models, swin_image, route):
    jm, v, port = swin_models
    want = np.asarray(jm[route].apply(v, jnp.asarray(swin_image), method=JGFSS.forward_base))
    got = _port_logits(port[route], swin_image, "forward_base")
    assert got.shape == want.shape == (2, 15, 11, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("route", ["fused", "unfused"])
def test_swin_forward_all_parity_ft(swin_models, swin_image, route):
    jm, v, port = swin_models
    want = np.asarray(jm[route].apply(v, jnp.asarray(swin_image)))
    got = _port_logits(port[route], swin_image, "forward_all")
    assert got.shape == want.shape == (2, 15, 11, 12)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _block_route_models(monkeypatch, depth_cut):
    """swin_pop / swin-s on both sides with the whole-block kernel's switch on
    while the models are built; with ``depth_cut`` the 18-block stage has 2."""
    from segland_tpu.models.backbones import swin as j_swin
    from segland_tpu_torch.models.backbones import swin as p_swin

    monkeypatch.setenv("SEGLAND_SWIN_V3_STAGES", "all")
    if depth_cut:
        cut = dict(depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24), embed_dim=96)
        monkeypatch.setitem(j_swin._CONFIGS, "swin-s", cut)
        monkeypatch.setitem(p_swin._CONFIGS, "swin-s", cut)
    kw = dict(n_base=7, n_novel=4, is_ft=True, fused_mlp=True, fused_attn=True)
    # the JAX model builds its backbone, and reads the switch, when traced
    jm = j_build("swin_pop", "swin-s", **kw)
    v = random_variables(jm, jnp.zeros((1, 64, 64, 3)), seed=8)
    port = load_port(meta_build(build_model, "swin_pop", "swin-s", **kw), v)
    blocks = [b for layer in port.backbone.layers for b in layer.blocks]
    assert len(blocks) == (8 if depth_cut else 24) and all(b.fused_block for b in blocks)
    return jm, v, port


def _check_block_route(monkeypatch, swin_image, depth_cut):
    from segland_tpu.ops import pallas_attn as J

    jm, v, port = _block_route_models(monkeypatch, depth_cut)
    j_calls = []

    def counted(*a, _fn=J.swin_block_fused, **kw):
        j_calls.append(1)
        return _fn(*a, **kw)

    monkeypatch.setattr(J, "swin_block_fused", counted)
    for method, j_method, k in (("forward_base", JGFSS.forward_base, 8),
                                ("forward_all", None, 12)):
        kw = {} if j_method is None else dict(method=j_method)
        want = np.asarray(jm.apply(v, jnp.asarray(swin_image), **kw))
        got = _port_logits(port, swin_image, method)
        assert got.shape == want.shape == (2, 15, 11, k)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert len(j_calls) == 2 * (8 if depth_cut else 24)  # the JAX side went the same way


def test_swin_whole_block_route_parity_depth_cut(monkeypatch, swin_image):
    _check_block_route(monkeypatch, swin_image, depth_cut=True)


@pytest.mark.slow
def test_swin_whole_block_route_parity_full_depth(monkeypatch, swin_image):
    _check_block_route(monkeypatch, swin_image, depth_cut=False)


def test_swin_evaluator_square_pad_matches_jax(swin_models):
    """The eval_ft protocol: logits upsampled to (longside, longside) against
    ignore-padded labels, on non-square tiles."""
    jm, v, port = swin_models
    rng = np.random.RandomState(7)
    imgs = rng.randint(0, 256, (2, 48, 64, 3)).astype(np.uint8)
    labels = rng.randint(0, 12, (2, 48, 64)).astype(np.uint8)
    batches = [(imgs, labels, ["a", "b"])]
    jcm, _, _ = JEvaluator(jm["fused"], v, num_classes=12, n_base=7,
                           normalize_on_device=True).run(batches, square_pad_eval=True)
    ev = Evaluator(port["fused"], "cpu", num_classes=12, n_base=7, normalize_on_device=True)
    cm, _, _ = ev.run(batches, square_pad_eval=True)
    assert cm.sum() == 2 * 48 * 64
    ties = int(near_tie_pixels(ev.predict_batch(imgs, (64, 64))[0].numpy()).sum())
    assert np.abs(cm - np.asarray(jcm)).sum() <= 2 * ties
