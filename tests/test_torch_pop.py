"""Port's POP core (segland_tpu_torch/ops/pop.py) vs the JAX package's
segland_tpu/ops/pop.py on the same numpy inputs, fp32, atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_helpers import t
from segland_tpu.ops import pop as jpop
from segland_tpu_torch.ops import pop as tpop

ATOL = 1e-5


def _inputs(seed, b=2, h=5, w=6, c=16, kb=7, kn=4):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    return dict(feats=f(b, h, w, c), emb_b=f(kb, c), emb_n=f(kn, c),
                wb=(f(c, c) / 4, f(c, c) / 4, f(c) / 4),
                wn=(f(c, c) / 4, f(c, c) / 4, f(c) / 4))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed,kb", [(0, 7), (1, 1), (2, 11)])
def test_pop_logits_base(seed, kb):
    a = _inputs(seed, kb=kb)
    want = jpop.pop_logits_base(jnp.asarray(a["feats"]), jnp.asarray(a["emb_b"]),
                                *map(jnp.asarray, a["wb"]))
    got = tpop.pop_logits_base(t(a["feats"]), t(a["emb_b"]), *map(t, a["wb"]))
    assert got.shape == (2, 5, 6, 1 + kb)
    _close(got, want)


@pytest.mark.parametrize("seed", [0, 3])
def test_pop_logits_all(seed):
    a = _inputs(seed)
    jw = lambda ws: tuple(map(jnp.asarray, ws))
    want, want_n = jpop.pop_logits_all(jnp.asarray(a["feats"]), jnp.asarray(a["emb_b"]),
                                       jnp.asarray(a["emb_n"]), jw(a["wb"]), jw(a["wn"]))
    tw = lambda ws: tuple(map(t, ws))
    got, got_n = tpop.pop_logits_all(t(a["feats"]), t(a["emb_b"]), t(a["emb_n"]),
                                     tw(a["wb"]), tw(a["wn"]))
    _close(got, want)
    _close(got_n, want_n)


@pytest.mark.parametrize("with_b", [False, True])
def test_proto_similarity(with_b):
    a = _inputs(4)
    if with_b:
        want = jpop.proto_similarity(jnp.asarray(a["emb_n"]), jnp.asarray(a["emb_b"]))
        got = tpop.proto_similarity(t(a["emb_n"]), t(a["emb_b"]))
    else:
        want = jpop.proto_similarity(jnp.asarray(a["emb_b"]))
        got = tpop.proto_similarity(t(a["emb_b"]))
    _close(got, want)


def test_rank1_collapse_matches_materialized_classifier():
    """The collapsed scalars equal the classifier run on each rank-1 map."""
    a = _inputs(5)
    s = tpop.l2_normalize(t(a["emb_b"]))
    p = t(a["feats"])[..., :1]  # any scalar map
    alpha, beta = tpop.classifier_scalars(s, *map(t, a["wb"]))
    for k in range(s.shape[0]):
        full = tpop.classifier_apply(p * s[k], *map(t, a["wb"]))
        fused = p[..., 0].clamp_min(0) * alpha[k] + (-p[..., 0]).clamp_min(0) * beta[k]
        np.testing.assert_allclose(full.numpy(), fused.numpy(), rtol=0, atol=ATOL)
