"""Stochastic depth (DropPath) and element-wise dropout, drawn from the
step's random generator.  Port of segland_tpu/models/backbones/droppath.py
(timm's semantics, the reference backbones' ``drop_path_rate`` with the
linspace decay over all blocks) and of the ``nn.Dropout`` that the JAX
package's PSPModuleV2 applies.

A mask keeps an element (DropPath: a whole sample) with probability
``1 - rate`` and scales what it keeps by ``1 / (1 - rate)`` in x's dtype;
what it drops becomes zero.  Both are the identity in eval mode
(``module.training`` False) and at rate 0, so eval, the fine-tune's frozen
trunk and converted checkpoints never draw (neither has parameters).

The masks come from the generator that :func:`dropout_generator` hands to
the forward, on the tensors' device: the train step seeds one from (seed,
step), as the JAX step folds the step into its ``"dropout"`` key, so a
resumed run draws the masks of the run it resumes.  A training forward that
must draw and was handed no generator raises: nothing draws from torch's
global generator.
"""

import contextlib
import contextvars

import numpy as np
import torch
import torch.nn as nn

_GENERATOR = contextvars.ContextVar("segland_dropout_generator", default=None)


def drop_path_rates(drop_path_rate: float, depths) -> list:
    """Per-block rates 0 -> ``drop_path_rate`` over the network's depth
    (``torch.linspace(0, rate, sum(depths))``, as a list of floats)."""
    total = sum(depths)
    if total <= 1:
        return [0.0] * total
    return [drop_path_rate * i / (total - 1) for i in range(total)]


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s generator in a run seeded ``seed``."""
    return int(np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0])


@contextlib.contextmanager
def dropout_generator(generator: torch.Generator, shard=(0, 1)):
    """Every mask drawn inside comes from ``generator``, in forward order.

    ``shard`` (index, count): the forward sees share ``index`` of ``count``
    equal shares of a global batch (a rank of a process group).  Each mask is
    then drawn for the global batch and this share's rows are taken, so the
    masks do not depend on the process count, as a JAX key split over the
    global batch does not."""
    token = _GENERATOR.set((generator, tuple(shard)))
    try:
        yield generator
    finally:
        _GENERATOR.reset(token)


def keep_mask(shape, rate: float, device) -> torch.Tensor:
    """A bool mask of ``shape`` on ``device``, True with probability 1 - rate,
    from the generator of :func:`dropout_generator`; its dim 0 is the batch's."""
    g, (index, count) = _GENERATOR.get() or (None, (0, 1))
    if g is None:
        raise RuntimeError(
            "a training forward with a drop rate above 0 draws its masks from the step's "
            "generator, and none was handed to it: wrap the forward in "
            "droppath.dropout_generator(torch.Generator(device=...)), or call model.eval()")
    device = torch.device(device)
    if g.device.type != device.type:
        raise ValueError(f"the dropout generator is on {g.device}; the tensors are on {device}")
    if count == 1:
        return torch.rand(shape, generator=g, device=device) < 1.0 - rate
    n = shape[0]
    full = torch.rand((n * count,) + tuple(shape[1:]), generator=g, device=device)
    return full[index * n:(index + 1) * n] < 1.0 - rate


def apply_mask(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """x / (1 - rate) where ``keep`` (broadcast) holds, else 0; the scale is
    rounded to x's dtype first, as the JAX modules divide."""
    scale = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """Element-wise dropout (flax ``nn.Dropout``, not upstream's ``Dropout2d``)."""
    if rate == 0.0 or not training:
        return x
    return apply_mask(x, keep_mask(x.shape, rate, x.device), rate)


class DropPath(nn.Module):
    """Per-sample branch drop: a mask of shape (B, 1, ..., 1)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if self.rate == 0.0 or not self.training:
            return x
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        return apply_mask(x, keep_mask(shape, self.rate, x.device), self.rate)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
