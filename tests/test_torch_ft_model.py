"""The fine-tune forward of the port (``GFSSModel.forward_novel``) and the
pieces of ``train/ft.py`` around it against the JAX package, fp32 on the CPU,
same weights (numpy, carried by ``from_jax_variables``) and inputs.

``forward_novel`` for narrow convnext and swin models (fused and unfused:
the fused routes run their plain versions on both sides) and for
``pspnet_pop`` and ``deeplab_pop`` / ``resnet10``: logits, novel-head logits
and the prototype similarities within 1e-5.  The trunk (backbone and decoder) runs frozen: its
output requires no grad, and after a backward no backbone or decoder
parameter holds a gradient, which is what lets K1 and K3 run forward-only on
the card; BatchNorm keeps its running statistics even after ``model.train()``.
``pseudo_label`` equals the JAX one except where the novel head's top-2
upsampled logits lie within 1e-3; ``init_cls_n`` copies the same weights and
raises without a classifier pair."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft_helpers import ft_models, narrow_backbones
from torch_helpers import near_tie_pixels, t
from segland_tpu.train.ft import init_cls_n as j_init_cls_n, pseudo_label as j_pseudo_label
from segland_tpu_torch.models import build_model
from segland_tpu_torch.ops.resize import resize_bilinear
from segland_tpu_torch.train import FT_FROZEN_PREFIXES, ft_trainable, init_cls_n, pseudo_label

ATOL = 1e-5
CASES = [("convnext_pop", "convnext-t", 64, False), ("convnext_pop", "convnext-t", 64, True),
         ("swin_pop", "swin-t", 64, False), ("swin_pop", "swin-t", 64, True),
         ("pspnet_pop", "resnet10", 32, False), ("deeplab_pop", "resnet10", 32, False)]


@pytest.mark.parametrize("name,backbone,hw,fused", CASES)
def test_forward_novel_matches_jax(name, backbone, hw, fused, monkeypatch):
    narrow_backbones(monkeypatch)
    jm, v, pm = ft_models(name, backbone, hw, fused)
    x = np.random.RandomState(2).randn(2, hw, hw, 3).astype(np.float32)
    want = jm.apply(v, jnp.asarray(x), method=jm.forward_novel)
    trunk = []
    extract = pm.extract_features
    monkeypatch.setattr(pm, "extract_features", lambda img: trunk.append(extract(img)) or trunk[-1])
    stats = {k: b.clone() for k, b in pm.named_buffers()}
    pm.train()  # forward_novel runs the trunk in eval mode whatever the model's mode
    got = pm.forward_novel(t(x).permute(0, 3, 1, 2))
    for g, w, nchw in zip(got, want, (True, True, False)):
        g = g.permute(0, 2, 3, 1) if nchw else g
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=ATOL)
    assert got[0].shape[1] == 12 and got[1].shape[1] == 5 and got[2].shape == (4, 11)
    assert len(trunk) == 1 and not trunk[0].requires_grad
    (got[0].sum() + got[1].sum() + got[2].sum()).backward()
    held = [n for n, p in pm.named_parameters() if p.grad is not None]
    assert held and not [n for n in held if n.startswith(("backbone.", "decoder."))]
    assert {n.split(".")[0] for n in held} == {"base_emb", "novel_emb", "classifier",
                                               "classifier_n"}
    for k, b in pm.named_buffers():
        assert torch.equal(b, stats[k]), k


@pytest.mark.parametrize("seed,size", [(0, (32, 32)), (1, (24, 40))])
def test_pseudo_label_matches_jax(seed, size):
    """Background pixels of the base half take the novel head's class (1..4 ->
    n_base + 1..4, its background stays 0); labelled and ignored pixels stay."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(2, 8, 10, 5).astype(np.float32)
    mask = rng.randint(0, 8, (2, *size)).astype(np.int32)
    mask[rng.rand(2, *size) < 0.4] = 0
    mask[:, :2] = 255
    want = np.asarray(j_pseudo_label(jnp.asarray(mask), jnp.asarray(logits), 7))
    got = pseudo_label(t(mask), t(logits), 7)
    assert got.dtype == torch.int32
    ties = near_tie_pixels(resize_bilinear(t(logits), size, True).numpy())
    differ = got.numpy() != want
    assert not (differ & ~ties).any()
    assert set(np.unique(want[mask == 0])) <= {0, 8, 9, 10, 11}
    np.testing.assert_array_equal(got.numpy()[mask != 0], mask[mask != 0])


def test_init_cls_n_matches_jax_and_raises_without_a_pair():
    jm, v, pm = ft_models("pspnet_pop", "resnet10", 32)
    want = j_init_cls_n(v["params"])
    init_cls_n(pm)
    from segland_tpu_torch.ckpt import from_jax_variables

    sd = pm.state_dict()
    for k, w in from_jax_variables(jax.tree_util.tree_map(
            np.asarray, {"params": want, "batch_stats": v["batch_stats"]})).items():
        np.testing.assert_array_equal(sd[k].numpy(), w, err_msg=k)
    for i in (0, 2, 4):
        assert torch.equal(sd[f"classifier_n.{i}.weight"], sd[f"classifier.{i}.weight"])
    base = build_model("pspnet_pop", "resnet10", n_base=7)
    with pytest.raises(ValueError, match="classifier_n"):
        init_cls_n(base)
    with pytest.raises(ValueError, match="classifier_n"):
        j_init_cls_n({"classifier": v["params"]["classifier"]})


def test_trainable_and_frozen_split_the_parameters():
    """novel_emb and classifier_n train; every other parameter lies under one
    of FT_FROZEN_PREFIXES (segland_tpu/train/ft.py:21)."""
    model = build_model("pspnet_pop", "resnet10", n_base=7, n_novel=4, is_ft=True)
    names = [n for n, _ in model.named_parameters()]
    trainable = [n for n in names if ft_trainable(n)]
    assert {n.split(".")[0] for n in trainable} == {"novel_emb", "classifier_n"}
    assert all(n.split(".")[0] in FT_FROZEN_PREFIXES for n in names if not ft_trainable(n))
