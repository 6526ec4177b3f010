"""The port's optimizer (``train/state.py``) against segland_tpu/train/state.py
on the CPU: parameter groups against ``_param_labels`` on whole models, the
LR at epoch boundaries against ``poly_lr_schedule`` (1e-6 relative: JAX takes
the power in fp32), and AdamW and SGD updates, with the global-norm clip,
against the optax chain on the same parameters and gradients over 6 updates.
Each parameter is held to tol x (its largest |value| + its largest change):
SGD 2e-6 (a float32 ulp is 1.2e-7, and the two libraries round each update
in another order), AdamW 1e-5: optax takes Adam's bias correction
1 - 0.999^t in float32, where 0.999 rounds to 0.99900001, so its first
update is 6.4e-6 smaller than torch's, which takes it in float64."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_helpers import t
from segland_tpu.models import build_model as j_build
from segland_tpu.train.state import _param_labels, create_optimizer as j_create
from segland_tpu.train.state import poly_lr_schedule as j_poly
from segland_tpu_torch.ckpt import from_jax_variables
from segland_tpu_torch.models import build_model
from segland_tpu_torch.train import create_optimizer, param_labels, poly_lr_schedule
from segland_tpu_torch.train.base import global_norm


@pytest.mark.parametrize("name,backbone", [("pspnet_pop", "resnet10"), ("deeplab_pop", "resnet10"),
                                           ("convnext_pop", None)])
def test_param_labels_match_the_jax_groups(name, backbone):
    """Each flax leaf is filled with its index, carried to the port's keys by
    from_jax_variables, and its JAX label compared with the port's."""
    jm = j_build(name, backbone=backbone, n_base=7)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    flat = flax.traverse_util.flatten_dict(shapes["params"])
    idx = {p: i for i, p in enumerate(flat)}
    tree = flax.traverse_util.unflatten_dict(
        {p: np.full(s.shape, idx[p], np.float32) for p, s in flat.items()})
    labels = flax.traverse_util.flatten_dict(_param_labels(shapes["params"]))
    by_index = {i: labels[p] for p, i in idx.items()}
    got = param_labels(build_model(name, backbone, n_base=7))
    carried = from_jax_variables({"params": tree})
    assert set(got) == {k for k in carried if not k.endswith(("running_mean", "running_var",
                                                               "num_batches_tracked"))}
    for key, label in got.items():
        assert label == by_index[int(carried[key].reshape(-1)[0])], key
    assert {"backbone", "head_bias", "head_weight"} == set(got.values())


def test_poly_lr_at_epoch_boundaries():
    spe, epochs = 65, 200
    j, p = j_poly(1e-3, epochs, spe), poly_lr_schedule(1e-3, epochs, spe)
    for step in (0, 64, 65, 129, 130, 6499, 13000 - 66, 13000 - 65, 12999, 13000, 13065):
        np.testing.assert_allclose(p(step), float(j(step)), rtol=1e-6, atol=1e-12,
                                   err_msg=str(step))
    assert p(64) == p(0) == 1e-3 and p(13000) == 0.0


class _Tiny(torch.nn.Module):
    """Parameters named as the JAX tree below names them, one a group."""

    def __init__(self, params):
        super().__init__()
        self.backbone = torch.nn.ParameterDict({k: torch.nn.Parameter(t(v).clone())
                                                for k, v in params["backbone"].items()})
        self.decoder = torch.nn.ParameterDict({k: torch.nn.Parameter(t(v).clone())
                                               for k, v in params["decoder"].items()})
        self.base_emb = torch.nn.Parameter(t(params["base_emb"]).clone())


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
@pytest.mark.parametrize("fix_lr", [False, True])
def test_updates_match_optax(optimizer, fix_lr):
    rng = np.random.RandomState(0)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    params = {"backbone": {"kernel": f(6, 5), "bias": f(5)},
              "decoder": {"kernel": f(5, 4), "bias": f(4)}, "base_emb": f(3, 4)}
    # the third and fifth are past the clip of 5.0
    grads = [jax.tree_util.tree_map(lambda a, s=s: a * s * 0.3 + 0.01 * rng.randn(*a.shape)
                                    .astype(np.float32), params)
             for s in (1.0, 0.2, 20.0, 0.5, 40.0, 1.0)]
    kw = dict(base_lr=1e-2, num_epochs=3, steps_per_epoch=2, optimizer=optimizer, fix_lr=fix_lr)
    jtx = j_create(params, **kw)
    jstate, jp = jtx.init(params), jax.tree_util.tree_map(jnp.asarray, params)
    model = _Tiny(params)
    tx = create_optimizer(model, **kw)
    named = dict(model.named_parameters())
    tol = {"adamw": 1e-5, "sgd": 2e-6}[optimizer]
    start = flax.traverse_util.flatten_dict(params, sep=".")
    for g in grads:
        upd, jstate = jtx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for path, v in flax.traverse_util.flatten_dict(g, sep=".").items():
            named[path].grad = t(v).clone()
        gs = [p.grad for p in tx.params]
        norm = global_norm(gs)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
        tx.clip_(gs, norm)
        tx.apply()
        for path, v in flax.traverse_util.flatten_dict(jp, sep=".").items():
            w, w0 = np.asarray(v), start[path]
            np.testing.assert_allclose(named[path].detach().numpy(), w, rtol=0,
                                       atol=tol * (np.abs(w).max() + np.abs(w - w0).max()),
                                       err_msg=path)
    assert tx.count == len(grads)
    assert {g["label"]: (g["scale"], g["weight_decay"]) for g in tx.torch.param_groups} == {
        "backbone": (1.0, 1e-4), "head_bias": (10.0, 0.0), "head_weight": (10.0, 1e-4)}
