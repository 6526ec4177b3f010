"""Shared by the train-step tests: one model's weights (random, from numpy)
in a JAX train state and in the port's, the same batches through both."""

import jax
import jax.numpy as jnp
import numpy as np

from torch_helpers import load_port, meta_build, random_variables, t
from segland_tpu.models import build_model as j_build
from segland_tpu.train import create_optimizer as j_create
from segland_tpu.train import create_train_state, make_base_train_step as j_make_step
from segland_tpu_torch.ckpt import from_jax_variables
from segland_tpu_torch.models import build_model
from segland_tpu_torch.train import TrainState, create_optimizer, make_base_train_step


def batches(n, hw, seed=0):
    """n batches of 2 images [2, hw, hw, 3] and labels in 0..7 with an
    ignored band."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        mask = rng.randint(0, 8, (2, hw, hw)).astype(np.int32)
        mask[:, :2] = 255
        out.append((rng.randn(2, hw, hw, 3).astype(np.float32), mask))
    return out


def _opt_kw(optimizer, lr):
    return dict(base_lr=lr, num_epochs=4, steps_per_epoch=1, optimizer=optimizer)


def pair(name, backbone, hw, optimizer, fused=False, lr=1e-3, **step_kw):
    """(JAX state, jitted JAX step, port state, port step): the same weights,
    the optimizer of ``create_optimizer`` with the LR falling every step (one
    step an epoch, 4 epochs).  ``fused`` sets both fused_mlp and fused_attn."""
    jm = j_build(name, backbone=backbone, n_base=7, fused_mlp=fused, fused_attn=fused)
    v = random_variables(jm, jnp.zeros((1, hw, hw, 3)), seed=1)
    jstate = create_train_state(jm, v, j_create(v["params"], **_opt_kw(optimizer, lr)))
    jstep = jax.jit(j_make_step(jm, "orth", **step_kw))
    return (jstate, jstep) + port_pair(name, backbone, v, optimizer, fused, lr, **step_kw)


def port_pair(name, backbone, variables, optimizer, fused=False, lr=1e-3, **step_kw):
    """(port state, port step) of ``pair`` from a JAX variable tree."""
    pm = load_port(meta_build(build_model, name, backbone, n_base=7, fused_mlp=fused,
                              fused_attn=fused),
                   variables)
    state = TrainState(pm, create_optimizer(pm, **_opt_kw(optimizer, lr)))
    return state, make_base_train_step(pm, "orth", **step_kw)


def run(jstate, jstep, state, step, data):
    """Both steps over ``data``; returns the JAX state and, per step, (JAX loss
    dict, JAX norm, port loss dict, port norm) as floats."""
    log = []
    for img, mask in data:
        jstate, jld, jgn = jstep(jstate, jnp.asarray(img), jnp.asarray(mask))
        ld, gn = step(state, t(img), t(mask))
        log.append(({k: float(v) for k, v in jld.items()}, float(jgn),
                    {k: float(v) for k, v in ld.items()}, float(gn)))
    return jstate, log


def check_log(log, loss_rtol, norm_rtol):
    for i, (jld, jgn, ld, gn) in enumerate(log):
        assert sorted(ld) == sorted(jld), i
        for k in jld:
            np.testing.assert_allclose(ld[k], jld[k], rtol=loss_rtol, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(gn, jgn, rtol=norm_rtol, err_msg=f"step {i} grad norm")


def check_weights(jstate, model, tol, start=None):
    """Every parameter and BatchNorm statistic within ``tol`` x its tensor's
    largest |value| (plus its largest change from ``start``, a state dict,
    when given)."""
    want = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    sd = model.state_dict()
    assert set(want) == set(sd)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        scale = np.abs(w).max() + (0 if start is None else np.abs(w - start[k].numpy()).max())
        np.testing.assert_allclose(sd[k].numpy(), w, rtol=0, atol=tol * scale, err_msg=k)
