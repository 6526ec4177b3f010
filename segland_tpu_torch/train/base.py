"""Base-class train and eval steps (reference train_base.py:235-340).  Port
of segland_tpu/train/base.py.  Each train step hands the forward a random
generator seeded from (seed, step) for its DropPath and dropout masks, as
the JAX step folds the step into its ``"dropout"`` key.

Under a process group (``dist.init_from_env``) the step is data parallel, as
the JAX step over a data mesh is: each rank holds its share of the global
batch, the forward runs through ``DistributedDataParallel`` (which averages
the gradients), BatchNorm takes the global batch's statistics
(``ops/layers.py``), the CE is normalised by the global pixel count
(``losses.py``), and the masks are the global batch's rows of this rank.  A
step of N ranks then gives what one process gives on the global batch, to
rounding.
"""

import weakref

import torch
import torch.nn as nn
from torch.nn.parallel import DistributedDataParallel

from .. import dist
from ..losses import ce_loss, orth_loss
from ..models.backbones.droppath import dropout_generator, step_seed
from ..metrics import intersection_and_union
from ..ops.device_aug import aug_seed
from ..ops.fused_epilogue import upsample_argmax
from .state import TrainState


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def _bn_stats(model):
    return [b for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))]


class _Method(nn.Module):
    """``model.<method>`` as a module's forward, for DistributedDataParallel,
    which syncs the gradients of what its own forward ran."""

    def __init__(self, model: nn.Module, method: str):
        super().__init__()
        self.model = model
        self.method = method

    def forward(self, *args, **kwargs):
        return getattr(self.model, self.method)(*args, **kwargs)


_DDP = weakref.WeakKeyDictionary()  # model -> {method: its DDP wrapper}


def data_parallel(model: nn.Module, method: str):
    """``model.<method>``, through DistributedDataParallel under a process
    group (built once a model and method; the construction broadcasts rank 0's
    parameters and buffers).  The optimizer and the checkpoints keep the bare
    model, so no saved key gains a ``module.`` prefix."""
    if not dist.is_initialized():
        return getattr(model, method)
    wrappers = _DDP.setdefault(model, {})
    if method not in wrappers:
        dev = next(model.parameters()).device
        wrappers[method] = DistributedDataParallel(
            _Method(model, method), device_ids=[dev.index] if dev.type == "cuda" else None,
            broadcast_buffers=False, find_unused_parameters=True)
    return wrappers[method]


def finite_everywhere(norm: torch.Tensor) -> bool:
    """Whether the gradient norm is finite on every rank (on the host)."""
    bad = (~torch.isfinite(norm)).to(torch.float32).reshape(1)
    return not bool(dist.all_reduce_max(bad, group=dist.stats_group()))


def make_base_train_step(model, loss_name: str = "orth", double_step: bool = False,
                         skip_nonfinite: bool = False, seed: int = 0, fix_bn: bool = False,
                         augment_fn=None):
    """Returns train_step(state, img [B,H,W,3] normalized, mask [B,H,W] int) ->
    (loss_dict, grad_norm), updating ``state`` in place.  ``grad_norm`` is the
    global norm of the raw gradients, before the clip.

    The forward draws its DropPath and dropout masks from a generator on the
    batch's device seeded by ``droppath.step_seed(seed, state.step)``, so a
    run resumed at a step draws what the uninterrupted run drew there (a CPU
    and a CUDA generator draw different masks from one seed).

    double_step replicates a reference quirk: train_base.py:262-264 calls
    optimizer.step() a second time after the AMP scaler stepped, so each
    gradient is applied twice (Adam's moments and the LR's count advance
    twice).

    skip_nonfinite is the analog of the reference's AMP GradScaler skip
    (train_base.py:258-261): where the gradient norm is not finite the step
    leaves the parameters, the optimizer state, the BatchNorm statistics and
    the count as they were, and the loss dict gains 'nonfinite_skipped'
    (0 or 1).  It reads the norm on the host, once a step.

    fix_bn keeps the BatchNorm running statistics; normalization still uses
    the batch's (cli/common.py ``--fix-bn``).

    ``loss_name`` "orth" trains a POP model (``forward_base``, the orth loss),
    "ce" the plain ``pspnet`` (its logits and aux logits, the CE loss with
    the aux head at 0.4), as the JAX step picks by the model's name.

    ``augment_fn`` (``ops/device_aug.base_train_augment`` with its crop and
    ignore label bound): the batch is then the raw uint8 tiles and their
    labels, augmented on the device at the step's start from a CPU generator
    seeded by ``device_aug.aug_seed(seed, state.step)``, a stream apart from
    the masks'; the loss dict gains 'aug_fallback', the global batch's count
    of crop fallbacks."""
    if loss_name not in ("orth", "ce"):
        raise ValueError(f"unknown loss: {loss_name!r}")
    is_pop = loss_name == "orth"
    del model  # the state carries it, as in the JAX step's state.apply_fn

    def train_step(state: TrainState, img, mask):
        model = state.model
        model.train()
        shard = (dist.rank(), dist.world())
        fallback = None
        if augment_fn is not None:
            g_aug = torch.Generator().manual_seed(aug_seed(seed, state.step))
            img, mask, fallback = augment_fn(g_aug, img, mask, shard=shard)
        stats = _bn_stats(model)
        kept = [b.clone() for b in stats] if (fix_bn or skip_nonfinite) and stats else None
        params = state.tx.params
        for p in params:
            p.grad = None
        gen = torch.Generator(device=img.device).manual_seed(step_seed(seed, state.step))
        forward = data_parallel(model, "forward_base" if is_pop else "__call__")
        with dropout_generator(gen, shard):
            if is_pop:
                logits, sim = forward(img.permute(0, 3, 1, 2), train=True)
                ld = orth_loss(logits.permute(0, 2, 3, 1), mask, sim)
            else:
                logits, aux = forward(img.permute(0, 3, 1, 2), train=True)
                ld = ce_loss(logits.permute(0, 2, 3, 1), mask, aux.permute(0, 2, 3, 1))
        ld["total_loss"].backward()
        if fallback is not None:
            ld["aug_fallback"] = dist.all_reduce_sum(fallback, group=dist.stats_group())
        for p in params:  # a parameter off the graph gets a zero gradient, as in jax.grad
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        ok = True
        if skip_nonfinite:
            ok = finite_everywhere(norm)
            ld["nonfinite_skipped"] = torch.tensor(0.0 if ok else 1.0)
        if kept is not None and (fix_bn or not ok):
            torch._foreach_copy_(stats, kept)
        if ok:
            state.tx.clip_(grads, norm)
            state.tx.apply()
            if double_step:
                state.tx.apply()
        return {k: v.detach() for k, v in ld.items()}, norm.detach()

    return train_step


def make_eval_step(model, num_classes: int, ignore_index: int = 255):
    """Whole-tile eval step: the model's logits (``forward_all`` for a
    fine-tuned model, as the JAX ``eval_step``'s ``model.apply`` picks)
    upsampled to the label size (align_corners=True, reference
    train_base.py:331-333) and argmaxed by ``ops.upsample_argmax`` (K2 on the
    card), then per-class (intersection, union, target).  The model runs in
    eval mode."""

    @torch.inference_mode()
    def eval_step(img, mask):
        model.eval()
        logits = model(img.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        pred = upsample_argmax(logits.float().contiguous(), mask.shape[-2:])
        return intersection_and_union(pred, mask, num_classes, ignore_index)

    return eval_step
