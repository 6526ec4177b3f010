"""Base training and the fine-tune step of the last four registry models in
the port against the JAX package's steps on the CPU, fp32, 3 steps of SGD on
the same weights and batches (``tests/train_helpers.py``): the plain
``pspnet``'s CE step with its aux head (``loss_name`` "ce": main, aux and
total loss), the orth step of ``pspplus_pop`` / ``resnet10``, of a
depth-cut ``lsk_pop`` (one block a stage at lsk-t's widths; the whole
network under ``-m slow``) and of ``vggunet_pop`` (the JAX step at its
default packed_train=True: its W-packed enc1 chain's batch statistics, exact
by construction), and the ft step of ``lsk_pop``; the VGG U-Net (upstream's
``net``) in the optimizer's backbone group.  LSKNet's DropPath and MLP
dropout are at rate 0 on both sides (the two frameworks draw different
masks).

Bars, those of tests/test_torch_train_step.py: loss dicts 1e-5 relative, the
grad norm 5e-3 relative, parameters and BatchNorm statistics 5e-4 of their
tensor's largest |value| after the last step."""

import jax
import jax.numpy as jnp
import pytest

from ft_helpers import ft_batches, ft_pair, run_ft
from torch_helpers import load_port, meta_build, random_variables
from train_helpers import batches, check_log, check_weights, run
from segland_tpu.models import build_model as j_build
from segland_tpu.models.backbones import lsknet as JL
from segland_tpu.train import create_optimizer as j_create
from segland_tpu.train import create_train_state, make_base_train_step as j_make_step
from segland_tpu_torch.models import build_model
from segland_tpu_torch.models.backbones import lsknet as PL
from segland_tpu_torch.train import TrainState, create_optimizer, make_base_train_step

HW = 64


def still_lsknet(monkeypatch, depths=(3, 3, 5, 2)):
    """lsk-t in both packages with DropPath and dropout at 0, at ``depths``."""
    monkeypatch.setattr(JL, "lsknet_tiny", lambda dtype, packed=True, packed_train=False:
                        JL.LSKNet(depths=depths, drop_rate=0.0, drop_path_rate=0.0,
                                  packed=packed, packed_train=packed_train, dtype=dtype))
    monkeypatch.setattr(PL, "lsknet_tiny", lambda dtype: PL.LSKNet(
        depths=depths, drop_rate=0.0, drop_path_rate=0.0, dtype=dtype))


def step_pair(name, backbone, loss="orth", hw=HW):
    """(JAX state, jitted JAX step, port state, port step) over the same
    weights, SGD with the LR falling every step, as train_helpers.pair; the
    plain pspnet's JAX init runs in train mode, which creates its aux head."""
    jm = j_build(name, backbone=backbone, n_base=7)
    train = {"train": True} if loss == "ce" else {}
    v = random_variables(jm, jnp.zeros((1, hw, hw, 3)), seed=1, **train)
    kw = dict(base_lr=1e-3, num_epochs=4, steps_per_epoch=1, optimizer="sgd")
    jstate = create_train_state(jm, v, j_create(v["params"], **kw))
    pm = load_port(meta_build(build_model, name, backbone, n_base=7), v)
    state = TrainState(pm, create_optimizer(pm, **kw))
    return jstate, jax.jit(j_make_step(jm, loss)), state, make_base_train_step(pm, loss)


def _steps(name, backbone, loss="orth", hw=HW):
    jstate, jstep, state, step = step_pair(name, backbone, loss, hw)
    jstate, log = run(jstate, jstep, state, step, batches(3, hw))
    check_log(log, 1e-5, 5e-3)
    check_weights(jstate, state.model, 5e-4)
    assert state.step == int(jstate.step) == 3
    return log


def test_plain_pspnet_ce_step_matches_jax():
    """The CE step: the main and aux losses (aux at 0.4) and their sum."""
    log = _steps("pspnet", "resnet10", "ce", hw=32)
    for jld, _, ld, _ in log:
        assert {"total_loss", "main_loss", "aux_loss"} <= set(ld)
        assert abs(ld["total_loss"] - ld["main_loss"] - 0.4 * ld["aux_loss"]) < 1e-5


def test_pspplus_step_matches_jax():
    _steps("pspplus_pop", "resnet10", hw=32)


def test_lsk_step_matches_jax_depth_cut(monkeypatch):
    still_lsknet(monkeypatch, depths=(1, 1, 1, 1))
    _steps("lsk_pop", "lsk-t")


@pytest.mark.slow
def test_lsk_step_matches_jax(monkeypatch):
    still_lsknet(monkeypatch)
    _steps("lsk_pop", "lsk-t")


def test_vggunet_step_matches_jax():
    _steps("vggunet_pop", "vgg16bn-unet")


def test_lsk_ft_step_matches_jax(monkeypatch):
    """The ft step over a frozen LSKNet trunk and SimpleDecoder: only the
    novel head moves (K2's plain version makes the pseudo-labels)."""
    still_lsknet(monkeypatch, depths=(1, 1, 1, 1))
    jstate, jstep, state, step = ft_pair("lsk_pop", "lsk-t", HW)
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    jstate, log = run_ft(jstate, jstep, state, step, ft_batches(3, HW))
    check_log(log, 1e-5, 5e-3)
    check_weights(jstate, state.model, 5e-4)
    sd = state.model.state_dict()
    moved = {k for k, v in start.items() if not (sd[k] == v).all()}
    assert {k.split(".")[0] for k in moved} == {"novel_emb", "classifier_n"}


def test_the_vgg_unet_trains_in_the_backbone_group():
    """vggunet_pop's U-Net is upstream's ``net`` and the JAX package's
    ``backbone``: the optimizer puts it in the backbone group (lr x1, weight
    decay), the POP head in the head groups, as the JAX ``_param_labels``
    does."""
    from segland_tpu_torch.train.state import param_labels

    labels = param_labels(build_model("vggunet_pop", n_base=7))
    assert {v for k, v in labels.items() if k.startswith("net.")} == {"backbone"}
    assert labels["base_emb"] == "head_weight" and labels["classifier.0.weight"] == "head_weight"
