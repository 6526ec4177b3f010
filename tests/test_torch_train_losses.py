"""The port's losses and intersection_and_union against segland_tpu/losses.py
and segland_tpu/metrics.py on the CPU: the same numpy inputs, fp32.  Loss
values and their gradients to 1e-6 relative; counts exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import t
from segland_tpu import losses as JL
from segland_tpu.metrics import intersection_and_union as j_inter_union
from segland_tpu_torch import losses as L
from segland_tpu_torch.metrics import intersection_and_union

RTOL = 1e-6


def _labels(rng, shape, k):
    """Labels in [0, K) with ignore (255), negative and out-of-range values."""
    lab = rng.randint(0, k, shape).astype(np.int32)
    lab[..., :2] = 255
    lab[..., 2, :3] = -1
    lab[..., 3, :3] = k + 2
    return lab


@pytest.mark.parametrize("k", [3, 8])
def test_cross_entropy_and_its_gradient(k):
    rng = np.random.RandomState(k)
    logits = rng.randn(2, 9, 7, k).astype(np.float32)
    lab = _labels(rng, (2, 9, 7), k)
    want, jg = jax.value_and_grad(JL.cross_entropy)(jnp.asarray(logits), jnp.asarray(lab))
    x = t(logits).requires_grad_(True)
    got = L.cross_entropy(x, t(lab))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=RTOL, atol=1e-8)


def test_cross_entropy_all_ignored_is_zero_not_nan():
    lab = np.full((1, 4, 4), 255, np.int32)
    got = L.cross_entropy(torch.zeros(1, 4, 4, 5), t(lab))
    assert float(got) == float(JL.cross_entropy(jnp.zeros((1, 4, 4, 5)), jnp.asarray(lab))) == 0


@pytest.mark.parametrize("shape", [(7, 7), (4, 11), (1, 1)])
def test_orth_penalty(shape):
    sim = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    np.testing.assert_allclose(float(L.orth_penalty(t(sim))),
                               float(JL.orth_penalty(jnp.asarray(sim))), rtol=RTOL)


@pytest.mark.parametrize("aux", [False, True])
@pytest.mark.parametrize("name", ["ce_loss", "orth_loss"])
def test_loss_dicts(name, aux):
    """Logits at a quarter of the label size are upsampled (align_corners=True)
    before the CE; same keys, same values, same gradients."""
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 5, 6, 8).astype(np.float32)
    aux_l = rng.randn(2, 5, 6, 8).astype(np.float32) if aux else None
    sim = rng.randn(7, 7).astype(np.float32)
    lab = _labels(rng, (2, 20, 24), 8)
    jfn, fn = getattr(JL, name), getattr(L, name)
    jargs = [jnp.asarray(logits), jnp.asarray(lab)]
    jargs += [jnp.asarray(sim)] if name == "orth_loss" else []
    want = jfn(*jargs, aux_logits=None if aux_l is None else jnp.asarray(aux_l))
    jg = jax.grad(lambda a: jfn(a, *jargs[1:], aux_logits=None if aux_l is None
                                else jnp.asarray(aux_l))["total_loss"])(jargs[0])
    x = t(logits).requires_grad_(True)
    args = [x, t(lab)] + ([t(sim)] if name == "orth_loss" else [])
    got = fn(*args, aux_logits=None if aux_l is None else t(aux_l))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=RTOL, err_msg=key)
    got["total_loss"].backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=RTOL, atol=1e-8)


def test_get_loss_picks_by_name():
    assert L.get_loss("convnext_pop") is L.orth_loss and L.get_loss("pspnet") is L.ce_loss
    assert (L.ORTH_WEIGHT, L.AUX_WEIGHT) == (JL.ORTH_WEIGHT, JL.AUX_WEIGHT) == (10.0, 0.4)


@pytest.mark.parametrize("k", [8, 12])
def test_intersection_and_union(k):
    """The prediction is masked to ignore where the ground truth is; values past
    K - 1 drop out and negative ones land in class 0, as jnp.bincount counts."""
    rng = np.random.RandomState(k)
    pred = rng.randint(0, k, (2, 16, 16)).astype(np.int32)
    pred[0, 0, :4] = k + 3
    gt = _labels(rng, (2, 16, 16), k)
    want = j_inter_union(jnp.asarray(pred), jnp.asarray(gt), k)
    got = intersection_and_union(t(pred), t(gt), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
