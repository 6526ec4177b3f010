"""The port's DropPath and element-wise dropout (``models/backbones/droppath.py``)
against the JAX package's ``DropPath`` and flax's ``nn.Dropout`` on the CPU:
the linspace rates equal the JAX list; given the masks the JAX modules drew
(read back from their outputs), the port's modules give the JAX outputs
exactly in fp32 and bf16; both are the identity in eval mode and at rate 0;
two generators draw different masks, one seed twice the same; a training
forward handed no generator raises.  Then PSPModuleV2 in train mode against
the JAX module, the mask its ``nn.Dropout`` drew handed to the port's
(output within the repo's 5e-4 bar; seen 1.9e-6)."""

import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import inject_masks, load_port, random_variables, t
from segland_tpu.models import decoders as jdec
from segland_tpu.models.backbones.droppath import DropPath as JDropPath
from segland_tpu.models.backbones.droppath import drop_path_rates as j_rates
from segland_tpu.models.backbones.swin import _CONFIGS as J_SWIN
from segland_tpu_torch.models import decoders as pdec
from segland_tpu_torch.models.backbones import droppath as D

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("depths,rate", [(J_SWIN["swin-t"]["depths"], 0.2),
                                         (J_SWIN["swin-s"]["depths"], 0.2),
                                         ((1,), 0.2), ((2, 2, 1, 1), 0.3), ((3,), 0.0)],
                         ids=["swin-t", "swin-s", "one-block", "narrow", "rate0"])
def test_drop_path_rates_equal_the_jax_list(depths, rate):
    got = D.drop_path_rates(rate, depths)
    assert got == j_rates(rate, depths)
    assert len(got) == sum(depths) and got[0] == 0.0
    if sum(depths) > 1:
        assert got[-1] == pytest.approx(rate, abs=1e-12)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_droppath_given_the_jax_mask_gives_the_jax_output(dtype, monkeypatch):
    """16 samples at rate 0.5: the JAX module drops some and keeps the others
    (asserted); a sample's mask is read back as 'any output element != 0'."""
    jdt, pdt = DTYPES[dtype]
    x = np.random.RandomState(0).randn(16, 5, 6, 8).astype(np.float32)
    want = np.asarray(JDropPath(0.5).apply({}, jnp.asarray(x, jdt), train=True,
                                           rngs={"dropout": jax.random.PRNGKey(3)})
                      .astype(jnp.float32))
    kept = np.abs(want).reshape(16, -1).max(1) > 0
    assert 0 < kept.sum() < 16
    queue = inject_masks(monkeypatch, [t(kept).reshape(16, 1, 1, 1)])
    got = D.DropPath(0.5).train()(t(x).to(pdt)).float().numpy()
    assert not queue
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dropout_given_the_jax_mask_gives_the_jax_output(dtype, monkeypatch):
    jdt, pdt = DTYPES[dtype]
    x = np.random.RandomState(1).randn(2, 7, 9, 16).astype(np.float32)
    want = np.asarray(fnn.Dropout(0.1, deterministic=False).apply(
        {}, jnp.asarray(x, jdt), rngs={"dropout": jax.random.PRNGKey(4)}).astype(jnp.float32))
    kept = want != 0
    assert 0 < (~kept).sum() < kept.size // 4
    queue = inject_masks(monkeypatch, [t(kept)])
    got = D.dropout(t(x).to(pdt), 0.1, training=True).float().numpy()
    assert not queue
    np.testing.assert_array_equal(got, want)


def test_identity_in_eval_mode_and_at_rate_0():
    """No draw at all: no generator is handed to these calls."""
    x = torch.randn(4, 3, 5, 6)
    for m in (D.DropPath(0.3).eval(), D.DropPath(0.0).train()):
        assert m(x) is x
    assert D.dropout(x, 0.1, training=False) is x
    assert D.dropout(x, 0.0, training=True) is x


def test_a_training_draw_with_no_generator_raises():
    x = torch.randn(4, 3)
    with pytest.raises(RuntimeError, match="dropout_generator"):
        D.DropPath(0.3).train()(x)
    with pytest.raises(RuntimeError, match="dropout_generator"):
        D.dropout(x, 0.1, training=True)


def test_generators_decide_the_masks():
    """One seed twice: bit-equal outputs; two seeds, or two steps of one run:
    different ones.  The masks are drawn in forward order from the one
    generator."""
    x = torch.randn(64, 8, 4, 4)
    dp = D.DropPath(0.5).train()

    def draw(seed):
        with D.dropout_generator(torch.Generator().manual_seed(seed)):
            return dp(x), D.dropout(x, 0.1, training=True)

    a, b, c = draw(1), draw(1), draw(2)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    for u, v in zip(a, c):
        assert not torch.equal(u, v)
    assert D.step_seed(123, 0) != D.step_seed(123, 1) != D.step_seed(124, 1)
    assert D.step_seed(123, 5) == D.step_seed(123, 5)


def test_a_generator_on_another_device_type_is_refused():
    with D.dropout_generator(torch.Generator()):
        with pytest.raises(ValueError, match="dropout generator is on cpu"):
            D.keep_mask((2, 1), 0.5, "meta")


class _RecordingDropout(fnn.Module):
    """flax's nn.Dropout inside, recording its input: the JAX PSPModuleV2's
    mask is 'output != 0' where the input is not 0 (elsewhere it changes
    nothing)."""
    rate: float
    deterministic: bool = None

    @fnn.compact
    def __call__(self, x):
        self.sow("intermediates", "x", x)
        y = fnn.Dropout(self.rate, deterministic=self.deterministic, name="inner")(x)
        self.sow("intermediates", "y", y)
        return y


def test_psp_v2_dropout_in_train_mode_matches_jax(monkeypatch):
    """BatchNorm in train mode and the dropout after the bottleneck's ReLU,
    element-wise at 0.1, in both packages."""
    proxy = types.ModuleType("nn")
    proxy.__getattr__ = lambda k: getattr(fnn, k)
    proxy.Dropout = _RecordingDropout
    monkeypatch.setattr(jdec, "nn", proxy)
    jm = jdec.PSPModuleV2(out_features=16)
    x = np.random.RandomState(2).randn(2, 6, 6, 24).astype(np.float32)
    v = random_variables(jm, jnp.zeros((1, 6, 6, 24)), seed=5)
    want, new = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats", "intermediates"],
                         rngs={"dropout": jax.random.PRNGKey(7)})
    rec = new["intermediates"]["bottleneck_drop"]
    xin, y = np.asarray(rec["x"][0]), np.asarray(rec["y"][0])
    dropped = (xin != 0) & (y == 0)
    assert dropped.sum() > 0
    port = load_port(pdec.PSPModuleV2(24, 16),
                     {"params": {"decoder": {"psp": v["params"]}},
                      "batch_stats": {"decoder": {"psp": v["batch_stats"]}}},
                     prefix="decoder.psp.").train()
    queue = inject_masks(monkeypatch, [t(~dropped).permute(0, 3, 1, 2)])
    got = port(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert not queue
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=5e-4)
    assert float((got == 0).float().mean()) > float((xin == 0).mean())
