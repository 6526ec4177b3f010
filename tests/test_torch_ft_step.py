"""The port's fine-tune step (``train/ft.py``) against the JAX package's
``make_ft_train_step`` + ``create_optimizer(trainable_fn=ft_trainable)`` on
the CPU, fp32, 3 steps of SGD at a fixed LR on the same weights and episodes:
``pspnet_pop`` / ``resnet10`` (a BatchNorm trunk, with and without
``skip_nonfinite``) and a narrow ``convnext_pop`` with ``--fused`` (K1's plain
version in the frozen trunk).  Then a non-finite episode, and the eval step
on a fine-tuned model.

Bars, those of tests/test_torch_train_step.py: loss dicts 1e-5 relative, the
grad norm 5e-3 relative, ``novel_emb`` and ``classifier_n`` 5e-4 of their
tensor's largest |value|.  Every frozen parameter and BatchNorm statistic
stays bit-equal to its start on the port's side."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft_helpers import ft_batches, ft_models, ft_pair, narrow_backbones, run_ft
from torch_helpers import near_tie_pixels, t
from train_helpers import check_log, check_weights
from segland_tpu_torch.train import ft_trainable


@pytest.mark.parametrize("name,backbone,hw,fused,skip", [
    ("pspnet_pop", "resnet10", 32, False, False), ("pspnet_pop", "resnet10", 32, False, True),
    ("convnext_pop", "convnext-t", 64, True, True)])
def test_ft_step_matches_jax(name, backbone, hw, fused, skip, monkeypatch):
    narrow_backbones(monkeypatch)
    jstate, jstep, state, step = ft_pair(name, backbone, hw, fused, skip_nonfinite=skip)
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    jstate, log = run_ft(jstate, jstep, state, step, ft_batches(3, hw))
    check_log(log, 1e-5, 5e-3)
    check_weights(jstate, state.model, 5e-4)
    assert state.step == int(jstate.step) == 3
    trained = {k for k in start if ft_trainable(k)}
    assert {k.split(".")[0] for k in trained} == {"novel_emb", "classifier_n"}
    sd = state.model.state_dict()
    for k, v in start.items():
        assert torch.equal(sd[k], v) != (k in trained), k
    assert all(p.requires_grad == ft_trainable(n) for n, p in state.model.named_parameters())
    assert len(state.tx.params) == len(trained)


def test_nonfinite_episode_leaves_everything_as_it_was():
    """A NaN in a base image: both sides skip that step and flag it; the
    model, the optimizer's momentum buffers and the count stay; the steps
    around it match."""
    jstate, jstep, state, step = ft_pair("pspnet_pop", "resnet10", 32, skip_nonfinite=True)
    data = ft_batches(3, 32, seed=1)
    data[1][2][1, 4, 4, 0] = np.nan
    jstate, log = run_ft(jstate, jstep, state, step, data[:1])
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt = [v.clone() for s in state.tx.torch.state.values() for v in s.values()]
    jstate, log2 = run_ft(jstate, jstep, state, step, data[1:2])
    (jld, jgn, ld, gn), = log2
    assert ld["nonfinite_skipped"] == jld["nonfinite_skipped"] == 1.0
    assert not np.isfinite(gn) and not np.isfinite(jgn)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    now = [v for s in state.tx.torch.state.values() for v in s.values()]
    assert len(now) == len(opt) and all(torch.equal(a, b) for a, b in zip(opt, now))
    assert state.step == int(jstate.step) == 1
    jstate, log3 = run_ft(jstate, jstep, state, step, data[2:])
    check_log(log + log3, 1e-5, 5e-3)
    check_weights(jstate, state.model, 5e-4)


def test_eval_step_on_a_fine_tuned_model_matches_jax():
    """The eval step scores through model(...): forward_all's 12 classes, as
    the JAX eval_step's model.apply; counts differ by at most twice the
    pixels whose top-2 upsampled logits lie within 1e-3."""
    from segland_tpu.train.base import make_eval_step as j_eval_step
    from segland_tpu_torch.ops.resize import resize_bilinear
    from segland_tpu_torch.train import make_eval_step

    jm, v, pm = ft_models("pspnet_pop", "resnet10", 32)
    rng = np.random.RandomState(3)
    img = rng.randn(2, 32, 32, 3).astype(np.float32)
    mask = rng.randint(0, 12, (2, 32, 32)).astype(np.int32)
    mask[:, :2] = 255
    want = jax.jit(j_eval_step(jm, 12))(v["params"], v["batch_stats"], jnp.asarray(img),
                                        jnp.asarray(mask))
    got = make_eval_step(pm, 12)(t(img), t(mask))
    with torch.no_grad():
        logits = pm.forward_all(t(img).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        ties = int(near_tie_pixels(resize_bilinear(logits, (32, 32), True).numpy()).sum())
    for g, w in zip(got, want):
        assert g.shape == (12,)
        assert int(np.abs(g.numpy() - np.asarray(w)).sum()) <= 2 * ties
    assert int(got[0][8:].sum()) > 0  # the novel classes are scored
    assert int(got[2].sum()) == int((mask != 255).sum())
