"""The port's train step (``train/base.py``) against the JAX package's
``make_base_train_step`` + ``create_optimizer`` on the CPU, fp32, 3 steps on
the same weights and batches: ``pspnet_pop`` / ``resnet10`` (BatchNorm in
train mode, with and without ``fix_bn``) and ``deeplab_pop`` / ``resnet10``, ``double_step`` and
``skip_nonfinite``; and BatchNorm in train mode against flax's; ``seghr_pop`` /
``hr-w32`` under ``-m slow``.

Bars: loss dicts 1e-5 relative (seen: 3.4e-7); the grad norm 5e-3 relative
and the parameters and BatchNorm statistics 5e-4 of their tensor's largest
|value| after the last step (seen: 1.7e-3 and 1.1e-4): a ReLU whose input
lies within rounding (~1e-6) of 0 takes the other branch on one side (1-2 of
layer4's 262,144 outputs at these shapes, counted), and each such flip moves
the norm by up to 1e-3 and the elements its gradient reaches by lr times
that.  SGD, because Adam would turn such a flip into a whole +-lr
update of the elements it reaches; AdamW's arithmetic is held to optax's in
test_torch_train_state.py and on a model in test_torch_train_convnext.py."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import t
from train_helpers import batches, check_log, check_weights, pair, run
from segland_tpu_torch.ops.layers import batch_norm

HW = 32


@pytest.mark.parametrize("name,fix_bn", [("pspnet_pop", False), ("pspnet_pop", True),
                                         ("deeplab_pop", False)])
def test_resnet_step_matches_jax(name, fix_bn):
    """deeplab_pop adds ASPP, whose BatchNorm momentum is flax's 0.001 (0.999
    here) and whose image pool normalises one value a channel and image."""
    jstate, jstep, state, step = pair(name, "resnet10", HW, "sgd", fix_bn=fix_bn)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    jstate, log = run(jstate, jstep, state, step, batches(3, HW))
    check_log(log, 1e-5, 5e-3)
    check_weights(jstate, state.model, 5e-4)
    assert state.step == 3
    stats = [k for k in before if k.endswith(("running_mean", "running_var"))]
    moved = [k for k in stats if not torch.equal(before[k], state.model.state_dict()[k])]
    assert moved == ([] if fix_bn else stats)


@pytest.mark.slow
def test_seghr_step_matches_jax():
    """seghr_pop / hr-w32, the JAX step at its default packed_train=True (its
    W-packed chains' batch statistics and gradients, exact by construction)
    against the port's plain form, at 64^2 and LR 1e-4; under -m slow: the
    JAX step compiles for about a minute.  At 32^2 branch 3 is 1x1, and
    train-mode BatchNorm there normalises 2 values a channel: E[x^2] - E[x]^2
    cancels to about the size of its rounding, and the two frameworks' sums
    part (step 0's seg loss 1.5% apart, first at transition3's BatchNorm); at
    64^2 each channel holds 8.  These random weights give a gradient norm of
    175, so at LR 1e-3 a step moves the weights far enough that step 0's
    gradient gap (6.3e-4 of the norm, the ReLU flips of the module docstring)
    makes step 1's gradients 1.6% apart and its seg loss 7.6e-5; at 1e-4 the
    gaps stay 5.8e-6 and 2.6e-3 (seen), inside the bars."""
    jstate, jstep, state, step = pair("seghr_pop", "hr-w32", 64, "sgd", lr=1e-4)
    jstate, log = run(jstate, jstep, state, step, batches(3, 64))
    check_log(log, 1e-5, 5e-3)
    check_weights(jstate, state.model, 5e-4)
    assert state.step == 3


def test_double_step_applies_each_gradient_twice():
    jstate, jstep, state, step = pair("pspnet_pop", "resnet10", HW, "sgd", double_step=True)
    jstate, log = run(jstate, jstep, state, step, batches(2, HW))
    check_log(log, 1e-5, 5e-3)
    check_weights(jstate, state.model, 5e-4)
    assert state.step == int(jstate.step) == 4


def test_skip_nonfinite_drops_the_whole_update():
    """A NaN image: both sides skip that step (params, optimizer state,
    BatchNorm statistics and count as before it) and flag it; the steps around
    it match."""
    jstate, jstep, state, step = pair("pspnet_pop", "resnet10", HW, "sgd",
                                      skip_nonfinite=True)
    data = batches(3, HW)
    data[1][0][0, 3, 3, 0] = np.nan
    jstate, log = run(jstate, jstep, state, step, data[:1])
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt = [v.clone() for s in state.tx.torch.state.values() for v in s.values()]
    jstate, log2 = run(jstate, jstep, state, step, data[1:2])
    (jld, jgn, ld, gn), = log2
    assert ld["nonfinite_skipped"] == jld["nonfinite_skipped"] == 1.0
    assert not np.isfinite(gn) and not np.isfinite(jgn)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    for a, b in zip(opt, [v for s in state.tx.torch.state.values() for v in s.values()]):
        assert torch.equal(a, b)
    assert state.step == int(jstate.step) == 1
    jstate, log3 = run(jstate, jstep, state, step, data[2:])
    check_log(log + log3, 1e-5, 5e-3)
    assert log3[0][2]["nonfinite_skipped"] == 0.0


def test_eval_step_matches_jax():
    """(intersection, union, target) of the upsampled argmax, in eval mode
    (running statistics); a pixel whose top-2 logits lie within 1e-3 may go
    either way, so the counts may differ by twice the number of such pixels."""
    from segland_tpu.train.base import make_eval_step as j_eval_step
    from segland_tpu_torch.train import make_eval_step
    from segland_tpu_torch.ops.resize import resize_bilinear
    from torch_helpers import near_tie_pixels

    jstate, _, state, _ = pair("pspnet_pop", "resnet10", HW, "sgd")
    img, mask = batches(1, HW, seed=3)[0]
    want = jax.jit(j_eval_step(jstate.apply_fn.__self__, 8))(
        jstate.params, jstate.batch_stats, jnp.asarray(img), jnp.asarray(mask))
    got = make_eval_step(state.model, 8)(t(img), t(mask))
    with torch.no_grad():
        logits = state.model.forward_base(t(img).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        ties = int(near_tie_pixels(resize_bilinear(logits, (HW, HW), True).numpy()).sum())
    assert not state.model.training
    for g, w in zip(got, want):
        assert int(np.abs(g.numpy() - np.asarray(w)).sum()) <= 2 * ties
    assert int(got[2].sum()) == int((mask != 255).sum())


@pytest.mark.parametrize("momentum", [0.9, 0.001])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_in_train_mode_matches_flax(momentum, dtype):
    """Normalised with the batch's mean and biased variance, running statistics
    moved by (1 - flax momentum): output 1e-5 (fp32) / 1e-2 (bf16, the output
    rounded once), statistics 1e-6."""
    rng = np.random.RandomState(0)
    x = (3.0 + 2.0 * rng.randn(4, 5, 6, 7)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    bn = fnn.BatchNorm(use_running_average=False, momentum=momentum, epsilon=1e-5, dtype=jdt)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, 7).astype(np.float32),
                    "bias": rng.randn(7).astype(np.float32)},
         "batch_stats": {"mean": rng.randn(7).astype(np.float32),
                         "var": rng.uniform(0.5, 1.5, 7).astype(np.float32)}}
    want, new = bn.apply(v, jnp.asarray(x).astype(jdt), mutable=["batch_stats"])
    m = torch.nn.BatchNorm2d(7, eps=1e-5, momentum=1 - momentum).train()
    with torch.no_grad():
        m.weight.copy_(t(v["params"]["scale"]))
        m.bias.copy_(t(v["params"]["bias"]))
        m.running_mean.copy_(t(v["batch_stats"]["mean"]))
        m.running_var.copy_(t(v["batch_stats"]["var"]))
    with torch.no_grad():
        got = batch_norm(m, t(x).permute(0, 3, 1, 2).to(getattr(torch, dtype)))
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=0,
                               atol=1e-5 if dtype == "float32" else 1e-2)
    for key, name in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(getattr(m, name).numpy(),
                                   np.asarray(new["batch_stats"][key]), rtol=1e-6, atol=1e-6)
    m.eval()  # eval mode: the running statistics, unchanged
    before = m.running_mean.clone()
    batch_norm(m, t(x).permute(0, 3, 1, 2))
    assert torch.equal(before, m.running_mean)
