"""The port's train step on ``convnext_pop`` / ``convnext-t`` (full width and
depth, 32x32 images) with ``--fused``, so every block's LN+MLP runs through
K1's autograd Function (its plain version forward on the CPU, the plain
version's autograd backward), against the JAX package's step with
``fused_mlp`` over 3 steps, fp32, on the same weights and batches.

SGD: loss dicts 1e-5 relative, grad norm 1e-4, parameters 1e-5 of their
tensor's largest |value| (seen over three data seeds: 2.3e-7, 2.3e-5, 1.6e-6,
the last where a ReLU of the POP classifier flips).  AdamW, the CLI's
optimizer: loss dicts 2e-5, grad norm 2e-4, parameters 5e-3 of (their
largest |value| + their largest change) (seen: 3.5e-6, 3.8e-5, 1.4e-3):
Adam normalises each element's update, so an element whose gradient lies
within rounding of 0 (the POP classifier's ReLUs) moves a whole step either
way; its arithmetic alone is held to optax's in test_torch_train_state.py."""

import pytest

from train_helpers import batches, check_log, check_weights, pair, run

BARS = {"sgd": (1e-5, 1e-4, 1e-5), "adamw": (2e-5, 2e-4, 5e-3)}


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_convnext_step_through_k1s_function_matches_jax(optimizer):
    jstate, jstep, state, step = pair("convnext_pop", None, 32, optimizer, fused=True)
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    jstate, log = run(jstate, jstep, state, step, batches(3, 32, seed=5))
    loss_tol, norm_tol, w_tol = BARS[optimizer]
    check_log(log, loss_tol, norm_tol)
    assert any(gn > 5.0 for _, gn, _, _ in log) or optimizer == "sgd"  # the clip acted
    check_weights(jstate, state.model, w_tol, start=start if optimizer == "adamw" else None)
