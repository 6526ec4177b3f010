"""Checkpoints as ``.pth`` files with upstream SegLand keys.  Port of
segland_tpu/ckpt/io.py for torch: no msgpack or orbax files.

  * ``epoch_N.pth``: ``{"state_dict": <upstream keys>, "optimizer": ..., "epoch": N}``,
    which ``--resume-from`` restores (model, optimizer, the LR's count, epoch);
  * ``best.pth``: a plain upstream-keyed state dict, which the port's
    ``eval_base`` and the JAX package's ``load_torch_checkpoint`` both read.

Under a process group rank 0 alone writes (every rank holds the same
weights), and every rank waits for the file at a barrier, so that any rank
can read it next (``--resume-from``, eval).
"""

import os

import torch

from .. import dist


def _save(make, path: str):
    if dist.is_main():
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(make(), tmp)
        os.replace(tmp, path)
    dist.barrier()


def _cpu(sd: dict) -> dict:
    return {k: v.detach().cpu() for k, v in sd.items()}


def save_params(path: str, model: torch.nn.Module):
    _save(lambda: _cpu(model.state_dict()), path)


def save_checkpoint(path: str, state):
    _save(lambda: {"state_dict": _cpu(state.model.state_dict()),
                   "optimizer": state.tx.state_dict(), "epoch": state.epoch}, path)


def load_checkpoint(path: str, state):
    """Restore ``state`` (a ``train.TrainState``) from an ``epoch_N.pth``."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state.model.load_state_dict(blob["state_dict"], strict=True)
    state.tx.load_state_dict(blob["optimizer"])
    state.epoch = int(blob["epoch"])
    return state


def load_pth(model: torch.nn.Module, path: str, backbone_only: bool = False):
    """Load an upstream-keyed .pth (raw, or nested under 'state_dict' or
    'model'; the DDP 'module.' prefix stripped) non-strictly, like the
    reference's load_model.  ``backbone_only`` grafts a bare backbone
    checkpoint under ``backbone.`` (reference train_base.py:198-201).  Returns
    (tensors loaded, missing keys, unexpected keys)."""
    if not path.endswith(".pth"):
        raise NotImplementedError(
            f"{path}: the port restores .pth state dicts only; flax .ckpt files "
            "are read by the JAX package")
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    elif isinstance(blob, dict) and "model" in blob:
        blob = blob["model"]
    if backbone_only:
        sd = {"backbone." + k: v for k, v in blob.items()}
    else:
        sd = {(k[7:] if k.startswith("module.") else k): v for k, v in blob.items()}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    return len(sd) - len(unexpected), missing, unexpected
