"""Train state, the optimizer with the reference's parameter groups, poly LR.
Port of segland_tpu/train/state.py (reference utils/pyt_utils.py:216-249,
train_base.py:113-128):

  * three parameter groups: backbone (lr x1, weight decay), the other
    parameters whose name contains ``bias`` (lr x10, weight decay 0), the
    other head parameters (lr x10, weight decay);
  * poly decay by the epoch, power 0.9 (train_base.py:248), or a fixed LR;
  * AdamW (betas 0.9 / 0.999, eps 1e-8) or SGD with momentum;
  * a clip of the global gradient norm at 5.0 before the step.

The LR follows the count of updates applied, as optax's schedule reads its
own count: ``--double-step`` moves it two a step, a skipped step not at all.
``freeze_backbone`` is accepted and changes nothing here, as in the JAX
``create_optimizer``: the fine-tune freezes through ``trainable_fn``
(``train/ft.py:ft_trainable``).
"""

import torch

GROUPS = ("backbone", "head_bias", "head_weight")
HEAD_LR_SCALE = 10.0  # the head groups' LR against the backbone's


def poly_lr_schedule(base_lr: float, num_epochs: int, steps_per_epoch: int,
                     power: float = 0.9):
    """lr(step) = base * (1 - epoch / num_epochs) ** power, epoch = step //
    steps_per_epoch."""

    def schedule(step: int) -> float:
        frac = 1.0 - (step // steps_per_epoch) / num_epochs
        return base_lr * max(frac, 0.0) ** power

    return schedule


def param_labels(model: torch.nn.Module) -> dict:
    """{parameter name: 'backbone' | 'head_bias' | 'head_weight'}, the JAX
    ``_param_labels`` on upstream names: a non-backbone parameter whose leaf
    name contains 'bias' goes to the weight-decay-0 group.  vggunet_pop's
    U-Net, ``net`` upstream, is the JAX package's ``backbone``."""
    out = {}
    for name, _ in model.named_parameters():
        if name.startswith(("backbone.", "net.")):
            out[name] = "backbone"
        elif "bias" in name.rsplit(".", 1)[-1]:
            out[name] = "head_bias"
        else:
            out[name] = "head_weight"
    return out


class Optimizer:
    """optax's ``chain(clip_by_global_norm(clip), multi_transform(...))`` over a
    model's parameters: a torch optimizer with one group a label, the LR
    schedule and the count of updates applied.  ``clip_`` scales the
    gradients as optax does (by clip / norm, no epsilon, where norm >= clip);
    ``apply`` sets each group's LR from the count and steps.

    optax's ``adamw`` subtracts lr * (adam update + wd * p) and torch's
    ``AdamW`` multiplies p by (1 - lr * wd) before subtracting lr * (adam
    update): the same function of the old p, rounded in another order.  torch's
    SGD adds wd * p to the gradient before the momentum, as optax's chain
    here does."""

    def __init__(self, model, base_lr, lr_fn, weight_decay=1e-4, optimizer="adamw",
                 momentum=0.9, clip=5.0, trainable_fn=None):
        labels = param_labels(model)
        named = dict(model.named_parameters())
        if trainable_fn is not None:
            for n in [n for n in named if not trainable_fn(n)]:
                named.pop(n).requires_grad_(False)
        settings = {"backbone": (1.0, weight_decay), "head_bias": (HEAD_LR_SCALE, 0.0),
                    "head_weight": (HEAD_LR_SCALE, weight_decay)}
        groups = []
        for label in GROUPS:
            params = [p for n, p in named.items() if labels[n] == label]
            if params:
                scale, wd = settings[label]
                groups.append({"params": params, "label": label, "scale": scale,
                               "weight_decay": wd, "lr": base_lr * scale})
        if optimizer == "adamw":
            self.torch = torch.optim.AdamW(groups, lr=base_lr, betas=(0.9, 0.999), eps=1e-8)
        elif optimizer == "sgd":
            self.torch = torch.optim.SGD(groups, lr=base_lr, momentum=momentum)
        else:
            raise ValueError(optimizer)
        self.lr_fn = lr_fn
        self.clip = clip
        self.count = 0

    @property
    def params(self):
        return [p for g in self.torch.param_groups for p in g["params"]]

    def clip_(self, grads, norm: torch.Tensor):
        """Scales by min(clip / norm, 1) on the norm's device: no wait for it."""
        if self.clip is not None:
            torch._foreach_mul_(grads, (self.clip / norm).clamp(max=1.0))

    def apply(self):
        """One update from the parameters' ``.grad``; the count moves by one."""
        lr = self.lr_fn(self.count)
        for g in self.torch.param_groups:
            g["lr"] = lr * g["scale"]
        self.torch.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"torch": self.torch.state_dict(), "count": self.count}

    def load_state_dict(self, sd: dict):
        self.torch.load_state_dict(sd["torch"])
        self.count = int(sd["count"])


def create_optimizer(model, base_lr: float, num_epochs: int, steps_per_epoch: int,
                     weight_decay: float = 1e-4, power: float = 0.9, optimizer: str = "adamw",
                     momentum: float = 0.9, clip: float = 5.0, freeze_backbone: bool = False,
                     fix_lr: bool = False, trainable_fn=None) -> Optimizer:
    del freeze_backbone  # accepted and unused, as in the JAX package
    if fix_lr:
        lr_fn = lambda step: base_lr  # reference ft --fix-lr (ft_oem.sh)
    else:
        lr_fn = poly_lr_schedule(base_lr, num_epochs, steps_per_epoch, power)
    return Optimizer(model, base_lr, lr_fn, weight_decay, optimizer, momentum, clip,
                     trainable_fn)


class TrainState:
    """What a train step changes: the model (its parameters and BatchNorm
    statistics), the optimizer (its state and update count) and the epoch."""

    def __init__(self, model: torch.nn.Module, tx: Optimizer, epoch: int = 0):
        self.model = model
        self.tx = tx
        self.epoch = epoch

    @property
    def step(self) -> int:
        return self.tx.count
