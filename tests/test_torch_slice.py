"""The port's convnext_pop slice against the JAX package at full width, fp32
on the CPU, with the same weights (carried by from_jax_variables) and the
same inputs: forward_base and forward_all logits within atol 5e-4 (the
repo's parity bar), and Evaluator.run confusion matrices equal except for
pixels whose top-2 logits lie within 1e-3 (swin_pop / swin-s:
tests/test_torch_slice_swin.py).  The same for deeplab_pop and pspnet_pop over resnet50 at full width and depth, with an
Evaluator run in int8 whose scales were calibrated by the JAX package; a
1024^2 tile is marked slow."""

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


@pytest.fixture(scope="module")
def models():
    kw = dict(n_base=7, n_novel=4, is_ft=True, fused_mlp=True)
    jm = j_build("convnext_pop", "convnext-t", **kw)
    v = random_variables(jm, jnp.zeros((1, 64, 64, 3)), seed=0)
    port = load_port(meta_build(build_model, "convnext_pop", "convnext-t", **kw), v)
    return jm, v, port


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)


def _port_logits(port, image, method):
    with torch.no_grad():
        out = getattr(port, method)(t(image).permute(0, 3, 1, 2))
    return out.permute(0, 2, 3, 1).numpy()


def test_forward_base_parity(models, image):
    jm, v, port = models
    want = np.asarray(jm.apply(v, jnp.asarray(image), method=JGFSS.forward_base))
    got = _port_logits(port, image, "forward_base")
    assert got.shape == want.shape == (2, 16, 16, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_forward_all_parity_ft(models, image):
    jm, v, port = models
    want = np.asarray(jm.apply(v, jnp.asarray(image)))
    got = _port_logits(port, image, "forward_all")
    assert got.shape == want.shape == (2, 16, 16, 12)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _batches():
    rng = np.random.RandomState(2)
    out = []
    for i in range(2):
        imgs = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
        labels = rng.randint(0, 12, (2, 64, 64)).astype(np.uint8)
        labels[:, :4] = 255
        out.append((imgs, labels, [f"t{i}a", f"t{i}b"]))
    return out


def test_evaluator_run_matches_jax(models):
    jm, v, port = models
    batches = _batches()
    jcm, jres, _ = JEvaluator(jm, v, num_classes=12, n_base=7,
                              normalize_on_device=True).run(batches)
    ev = Evaluator(port, "cpu", num_classes=12, n_base=7, normalize_on_device=True)
    cm, res, tps = ev.run(batches)
    assert cm.shape == (12, 12) and cm.sum() == 2 * 2 * 60 * 64 and tps > 0
    ties = sum(int(near_tie_pixels(ev.predict_batch(imgs, (64, 64))[0].numpy()).sum())
               for imgs, _, _ in batches)
    assert np.abs(cm - np.asarray(jcm)).sum() <= 2 * ties
    if ties == 0:
        np.testing.assert_allclose(res[0], jres[0], rtol=0, atol=1e-12)


def test_ragged_batch_is_padded_and_sliced(models):
    _, _, port = models
    imgs = _batches()[0][0]
    ev = Evaluator(port, "cpu", num_classes=12, n_base=7, normalize_on_device=True)
    logits, pred = ev.predict_batch(imgs[:1], (64, 64), batch_pad=2)
    full_logits, full_pred = ev.predict_batch(imgs, (64, 64))
    assert pred.shape == (1, 64, 64) and logits.shape == (1, 64, 64, 12)
    torch.testing.assert_close(logits, full_logits[:1], rtol=0, atol=1e-5)


def test_loader_error_is_raised_not_swallowed(models):
    _, _, port = models
    ev = Evaluator(port, "cpu", num_classes=12, n_base=7, normalize_on_device=True)

    def loader():
        yield _batches()[0]
        raise OSError("tile 7 unreadable")

    with pytest.raises(OSError, match="tile 7"):
        ev.run(loader())


# ---- deeplab_pop and pspnet_pop / resnet50 at full width and depth ----------
@pytest.fixture(scope="module", params=["deeplab_pop", "pspnet_pop"])
def resnet_models(request):
    kw = dict(n_base=7, n_novel=4, is_ft=True)
    jm = j_build(request.param, "resnet50", **kw)
    v = random_variables(jm, jnp.zeros((1, 64, 64, 3)), seed=9)
    port = load_port(meta_build(build_model, request.param, "resnet50", **kw), v)
    return request.param, jm, v, port


@pytest.fixture(scope="module")
def resnet_image():
    return np.random.RandomState(10).randn(2, 72, 56, 3).astype(np.float32)


def test_resnet_forward_base_parity(resnet_models, resnet_image):
    name, jm, v, port = resnet_models
    want = np.asarray(jm.apply(v, jnp.asarray(resnet_image), method=JGFSS.forward_base))
    got = _port_logits(port, resnet_image, "forward_base")
    assert got.shape == want.shape == (2, 9, 7, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert port.d_model == (256 if name == "deeplab_pop" else 512) and not port.needs_pyramid


def test_resnet_forward_all_parity_ft(resnet_models, resnet_image):
    _, jm, v, port = resnet_models
    want = np.asarray(jm.apply(v, jnp.asarray(resnet_image)))
    got = _port_logits(port, resnet_image, "forward_all")
    assert got.shape == want.shape == (2, 9, 7, 12)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.slow
def test_resnet_forward_parity_at_1024(resnet_models):
    _, jm, v, port = resnet_models
    image = np.random.RandomState(11).randn(1, 1024, 1024, 3).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(image)))
    got = _port_logits(port, image, "forward_all")
    assert got.shape == want.shape == (1, 128, 128, 12)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_resnet_os16_and_undilated_reach_the_backbone():
    for kw, side in ((dict(os=16), 4), (dict(dilated=False), 2)):
        jm = j_build("deeplab_pop", "resnet10", n_base=7, **kw)
        v = random_variables(jm, jnp.zeros((1, 64, 64, 3)), seed=12)
        port = load_port(meta_build(build_model, "deeplab_pop", "resnet10", n_base=7, **kw), v)
        image = np.random.RandomState(13).randn(1, 64, 64, 3).astype(np.float32)
        want = np.asarray(jm.apply(v, jnp.asarray(image)))
        got = _port_logits(port, image, "forward_base")
        assert got.shape == want.shape == (1, side, side, 8)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_resnet_evaluator_run_matches_jax_fp32_and_int8(resnet_models):
    """Evaluator.run in fp32, and in int8 with the scales the JAX package
    calibrated on the first batch: confusion matrices equal up to near-ties
    (fp32) and on 98% of the pixels (int8, where single roundings flip)."""
    from segland_tpu.quant import calibrate as j_calibrate
    from segland_tpu_torch.ckpt import quant_from_jax
    import jax

    _, jm, v, port = resnet_models
    batches = _batches()
    kw = dict(num_classes=12, n_base=7, normalize_on_device=True)
    jcm, _, _ = JEvaluator(jm, v, **kw).run(batches)
    ev = Evaluator(port, "cpu", **kw)
    cm, _, _ = ev.run(batches)
    ties = sum(int(near_tie_pixels(ev.predict_batch(imgs, (64, 64))[0].numpy()).sum())
               for imgs, _, _ in batches)
    assert cm.sum() == 2 * 2 * 60 * 64 and np.abs(cm - np.asarray(jcm)).sum() <= 2 * ties

    jev = JEvaluator(jm, v, int8=True, calib_batches=1, fused_epilogue=False, **kw)
    jqcm, _, _ = jev.run(batches, device_prefetch=0)
    quant = quant_from_jax(jax.tree_util.tree_map(np.asarray, jev._quant))
    qcm, _, _ = Evaluator(port, "cpu", int8=True, quant=quant, **kw).run(batches)
    assert qcm.sum() == cm.sum()
    assert np.abs(qcm - np.asarray(jqcm)).sum() <= 2 * 0.02 * cm.sum()
