"""Novel-class fine-tune step (reference ft_pop.py:242-256,
networks/pspnet_pop.py:191-243).  Port of segland_tpu/train/ft.py; under a
process group each rank holds its share of the global episode batch, the
head's gradients are averaged by DistributedDataParallel and the CE is the
global batch's mean (``train/base.py``).

The reference concatenates the novel-support batch and the base batch, runs
forward_novel, then overwrites mask_b in place with pseudo-labels from the
novel head (pspnet_pop.py:221-231).  Here pseudo-labelling is a function:
the base sample's background (mask_b == 0) takes the argmax of the novel
head's logits upsampled with align_corners=True, a novel index offset by
n_base.  Only ``novel_emb`` and ``classifier_n`` train (the optimizer built
with ``trainable_fn=ft_trainable``); the backbone and decoder run frozen in
eval mode (``GFSSModel.forward_novel``), so no BatchNorm statistic moves.
"""

import torch

from ..losses import orth_loss
from ..ops.fused_epilogue import upsample_argmax
from .base import data_parallel, finite_everywhere, global_norm
from .state import TrainState

# what the fine-tune leaves as it is (segland_tpu/train/ft.py:21)
FT_FROZEN_PREFIXES = ("backbone", "decoder", "classifier", "base_emb")


def ft_trainable(name: str) -> bool:
    """Trainable parameters of the fine-tune, by upstream name: ``novel_emb``
    and ``classifier_n.*`` only."""
    head = name.split(".", 1)[0]
    return head in ("novel_emb", "classifier_n")


def pseudo_label(mask_b: torch.Tensor, novel_logits_b: torch.Tensor,
                 n_base: int) -> torch.Tensor:
    """Relabel the base samples' background with the novel head's classes.

    mask_b [Bb, H, W] int; novel_logits_b [Bb, h, w, 1+Kn] (the base half).
    The upsample and argmax are ``ops.upsample_argmax`` (K2 on the card)."""
    idx = upsample_argmax(novel_logits_b.float().contiguous(), mask_b.shape[-2:])
    idx = idx.to(mask_b.dtype)
    idx = torch.where(idx > 0, idx + n_base, idx)
    return torch.where(mask_b == 0, idx, mask_b)


def make_ft_train_step(model, n_base: int, skip_nonfinite: bool = False):
    """Returns train_step(state, img, mask, img_b, mask_b) -> (loss_dict,
    grad_norm), updating ``state`` in place.  img/mask are the novel-support
    samples, img_b/mask_b the base samples ([B, H, W, 3] normalized, [B, H, W]
    int; equal halves: upstream's oem_ft returns the pair per item).
    ``grad_norm`` is the global norm of the trainable gradients before the
    clip.

    skip_nonfinite drops an update whose gradient norm is not finite, as
    ``make_base_train_step`` does: the parameters, the optimizer state and the
    count stay, and the loss dict gains 'nonfinite_skipped' (0 or 1)."""
    del model  # the state carries it, as in the JAX step's state.apply_fn

    def train_step(state: TrainState, img, mask, img_b, mask_b):
        model = state.model
        params = state.tx.params
        for p in params:
            p.grad = None
        logits, novel_logits, sim = data_parallel(model, "forward_novel")(
            torch.cat([img, img_b]).permute(0, 3, 1, 2))
        nb = img.shape[0]
        mask_new = pseudo_label(mask_b, novel_logits[nb:].detach().permute(0, 2, 3, 1), n_base)
        ld = orth_loss(logits.permute(0, 2, 3, 1), torch.cat([mask, mask_new]), sim)
        ld["total_loss"].backward()
        for p in params:  # a parameter off the graph gets a zero gradient, as in jax.grad
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        ok = True
        if skip_nonfinite:
            ok = finite_everywhere(norm)
            ld["nonfinite_skipped"] = torch.tensor(0.0 if ok else 1.0)
        if ok:
            state.tx.clip_(grads, norm)
            state.tx.apply()
        return {k: v.detach() for k, v in ld.items()}, norm.detach()

    return train_step


def init_cls_n(model) -> None:
    """Copy the base classifier's weights into ``classifier_n`` (reference
    GFSS_Model.init_cls_n, networks/pspnet_pop.py:76-78).  Raises ValueError
    where the model has no classifier / classifier_n pair."""
    sd = model.state_dict()
    pairs = {k: "classifier_n." + k[len("classifier."):] for k in sd
             if k.startswith("classifier.")}
    pairs = {k: v for k, v in pairs.items() if v in sd}
    if not pairs:
        raise ValueError("no classifier/classifier_n pair found")
    with torch.no_grad():
        for src, dst in pairs.items():
            sd[dst].copy_(sd[src])
