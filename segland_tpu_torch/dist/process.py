"""The process group, set up from the launcher's environment (torchrun's:
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).
Port of segland_tpu/dist/mesh.py's role: where the JAX package shards each
global batch over a 'data' mesh of every device, here each process holds
one device and its contiguous share of each global batch.

With ``WORLD_SIZE`` unset nothing is set up and every helper is the
one-process identity.  With it set (1 included) the group is initialised:
NCCL for a CUDA device, gloo for the CPU, or the backend asked for.  Besides
the default group, which DistributedDataParallel uses for the gradients, a
second group over the same ranks carries the forward's collectives
(BatchNorm's statistics, the loss's pixel count), so that they never
interleave with DDP's bucket all-reduces on one group.
"""

import os
from datetime import timedelta

import torch
import torch.distributed as dist

_STATS = None  # the second group, set by init_from_env


def _env(name: str) -> str:
    try:
        return os.environ[name]
    except KeyError:
        raise ValueError(f"WORLD_SIZE is set, so {name} must be set too (torchrun sets "
                         f"WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR and MASTER_PORT)") from None


def init_from_env(device, backend=None, timeout_s: float = 600.0) -> torch.device:
    """Set up the group from the environment and return this process's device:
    ``cuda`` becomes ``cuda:LOCAL_RANK`` (an explicit index is kept), and the
    current CUDA device is set to it.  ``backend`` overrides the choice of
    NCCL on CUDA and gloo on the CPU (two ranks on one card need gloo: NCCL
    refuses them).  Without ``WORLD_SIZE`` returns ``device`` untouched."""
    global _STATS
    device = torch.device(device)
    if "WORLD_SIZE" not in os.environ:
        return device
    world_size, rank_ = int(_env("WORLD_SIZE")), int(_env("RANK"))
    for name in ("MASTER_ADDR", "MASTER_PORT"):  # env:// reads them
        _env(name)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", world_size=world_size,
                                rank=rank_, timeout=timedelta(seconds=timeout_s))
        _STATS = dist.new_group(backend=backend)
    return device


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def stats_group():
    """The group of the forward's collectives (None without a group)."""
    return _STATS if is_initialized() else None


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def barrier():
    if is_initialized():
        dist.barrier()


def destroy():
    global _STATS
    if is_initialized():
        dist.destroy_process_group()
    _STATS = None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks, in place (no gradient); ``t`` alone
    without a group."""
    if is_initialized():
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t``'s element-wise maximum over the ranks, in place."""
    if is_initialized():
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> list:
    """Every rank's ``t`` in rank order (no gradient; ``[t]`` without a group).
    The tensors may differ in length along dim 0; each is padded to the
    longest for the collective and cut back after it.  gloo gathers host
    copies, as it takes CUDA tensors in its all-reduce only."""
    if not is_initialized():
        return [t]
    world_ = dist.get_world_size(group)
    on = torch.device("cpu") if dist.get_backend(group) == "gloo" else t.device
    x = t.detach().to(on).contiguous()
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=on)
    sizes = [torch.empty_like(n) for _ in range(world_)]
    dist.all_gather(sizes, n, group=group)
    sizes = [int(s) for s in sizes]
    padded = x.new_zeros((max(sizes),) + tuple(x.shape[1:]))
    padded[:x.shape[0]] = x
    out = [torch.empty_like(padded) for _ in range(world_)]
    dist.all_gather(out, padded, group=group)
    return [o[:k].to(t.device) for o, k in zip(out, sizes)]


def shard_rows(n_local: int):
    """(first, last) of this rank's rows in a global batch of ``world()``
    equal shares of ``n_local`` rows: the rows a one-process run of the
    global batch gives this rank."""
    lo = rank() * n_local
    return lo, lo + n_local
