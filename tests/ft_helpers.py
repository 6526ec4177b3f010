"""Shared by the fine-tune tests (tests/test_torch_ft_*.py): narrow
``convnext-t`` and ``swin-t`` backbones in both packages' ``GFSSModel``, and
one fine-tune model's weights (random, from numpy) in a JAX train state and in
the port's, with both steps."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_helpers import load_port, meta_build, random_variables
from segland_tpu.models import build_model as j_build
from segland_tpu.train import create_optimizer as j_create, create_train_state
from segland_tpu.train.ft import ft_trainable as j_ft_trainable
from segland_tpu.train.ft import make_ft_train_step as j_make_ft_step
from segland_tpu_torch.models import build_model
from segland_tpu_torch.train import (TrainState, create_optimizer, ft_trainable,
                                     make_ft_train_step)

# narrow stand-ins: four levels (UperNet+ and FPN-OCR read all four), shifted
# windows in swin's first two stages at 64^2
CONVNEXT = dict(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128))
SWIN = dict(depths=(2, 2, 1, 1), num_heads=(1, 2, 2, 4), embed_dim=16)
FILTERS = {"convnext-t": CONVNEXT["dims"], "swin-t": tuple(16 * 2 ** i for i in range(4))}


def narrow_backbones(monkeypatch):
    """Make the keys ``convnext-t`` and ``swin-t`` build the narrow backbones
    above in both packages (the GFSSModel of each reads its module's
    ``get_backbone`` and ``backbone_filters``)."""
    import segland_tpu.models.pop as jpop
    import segland_tpu_torch.models.pop as ppop
    from segland_tpu.models.backbones import convnext as jconv, swin as jswin
    from segland_tpu_torch.models.backbones.convnext import ConvNeXt
    from segland_tpu_torch.models.backbones.swin import SwinTransformer

    j_get, p_get = jpop.get_backbone, ppop.get_backbone
    j_filters, p_filters = jpop.backbone_filters, ppop.backbone_filters

    def jget(name, dtype=jnp.float32, fused_mlp=False, fused_attn=False, **kw):
        if name == "convnext-t":
            return jconv.ConvNeXt(**CONVNEXT, fused_mlp=fused_mlp, dtype=dtype)
        if name == "swin-t":
            return jswin.SwinTransformer(**SWIN, drop_path_rate=0.0, fused_mlp=fused_mlp,
                                         fused_attn=fused_attn, dtype=dtype)
        return j_get(name, dtype=dtype, fused_mlp=fused_mlp, fused_attn=fused_attn, **kw)

    def pget(name, dtype=torch.float32, fused_mlp=False, fused_attn=False, **kw):
        if name == "convnext-t":
            return ConvNeXt(**CONVNEXT, fused_mlp=fused_mlp, dtype=dtype)
        if name == "swin-t":
            return SwinTransformer(**SWIN, fused_mlp=fused_mlp, fused_attn=fused_attn,
                                   dtype=dtype)
        return p_get(name, dtype=dtype, fused_mlp=fused_mlp, fused_attn=fused_attn, **kw)

    monkeypatch.setattr(jpop, "get_backbone", jget)
    monkeypatch.setattr(ppop, "get_backbone", pget)
    monkeypatch.setattr(jpop, "backbone_filters", lambda n: FILTERS.get(n) or j_filters(n))
    monkeypatch.setattr(ppop, "backbone_filters", lambda n: FILTERS.get(n) or p_filters(n))


def ft_models(name, backbone, hw, fused=False, seed=1):
    """(JAX module, its variables, the port model with the same weights): a
    fine-tune model (7 base, 4 novel classes) with random weights."""
    jm = j_build(name, backbone=backbone, n_base=7, n_novel=4, is_ft=True, fused_mlp=fused,
                 fused_attn=fused)
    v = random_variables(jm, jnp.zeros((1, hw, hw, 3)), seed=seed)
    pm = load_port(meta_build(build_model, name, backbone, n_base=7, n_novel=4, is_ft=True,
                              fused_mlp=fused, fused_attn=fused), v)
    return jm, v, pm


def ft_pair(name, backbone, hw, fused=False, lr=1e-3, skip_nonfinite=False):
    """(JAX state, jitted JAX ft step, port state, port ft step): the same
    weights, SGD (momentum 0.9, weight decay 1e-4) at a fixed LR over the
    trainable subset, as ``ft_pop`` builds it."""
    jm, v, pm = ft_models(name, backbone, hw, fused)
    kw = dict(base_lr=lr, num_epochs=4, steps_per_epoch=1, optimizer="sgd", fix_lr=True)
    jstate = create_train_state(jm, v, j_create(v["params"], trainable_fn=j_ft_trainable, **kw))
    jstep = jax.jit(j_make_ft_step(jm, 7, skip_nonfinite=skip_nonfinite))
    state = TrainState(pm, create_optimizer(pm, trainable_fn=ft_trainable, **kw))
    return jstate, jstep, state, make_ft_train_step(pm, 7, skip_nonfinite=skip_nonfinite)


def ft_batches(n, hw, seed=0):
    """n episodes of 2 pairs: novel-support images with labels in 8..11 and
    ignored background, base images with labels in 0..7 (a third background,
    which the pseudo-labels overwrite)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        mask = rng.choice([8, 9, 10, 11, 255], (2, hw, hw)).astype(np.int32)
        mask_b = rng.randint(0, 8, (2, hw, hw)).astype(np.int32)
        mask_b[rng.rand(2, hw, hw) < 0.3] = 0
        out.append((rng.randn(2, hw, hw, 3).astype(np.float32), mask,
                    rng.randn(2, hw, hw, 3).astype(np.float32), mask_b))
    return out


def run_ft(jstate, jstep, state, step, data):
    """Both ft steps over ``data``; returns the JAX state and, per step, (JAX
    loss dict, JAX norm, port loss dict, port norm) as floats."""
    from torch_helpers import t

    log = []
    for batch in data:
        jstate, jld, jgn = jstep(jstate, *map(jnp.asarray, batch))
        ld, gn = step(state, *map(t, batch))
        log.append(({k: float(v) for k, v in jld.items()}, float(jgn),
                    {k: float(v) for k, v in ld.items()}, float(gn)))
    return jstate, log
