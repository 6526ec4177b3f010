"""Tensor ops of the port.  Public functions keep the JAX package's layout
(``[..., C]`` rows, ``(B, h, w, K)`` logits) so the tests compare like with
like.

An op with a CUDA kernel dispatches on the device of its input: a CPU tensor
runs the op's plain PyTorch version, a CUDA tensor launches the kernel or
raises.  Inside :func:`plain_versions` a CUDA tensor runs the plain version
instead; that exists to hold the kernels against their plain versions on
the card, and no product path opens it.

A kernel writes its output into a fresh tensor that autograd knows nothing
of.  So every kernel wrapper calls :func:`forward_only` before it launches:
where a gradient was asked for, it raises instead of handing back a result
cut off from its inputs.  K1 alone has a backward (``ops/fused_mlp.py``).
"""

import contextlib
import contextvars

import torch

_PLAIN = contextvars.ContextVar("segland_plain_versions", default=False)


@contextlib.contextmanager
def plain_versions(enabled: bool = True):
    token = _PLAIN.set(enabled)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def use_kernel(t) -> bool:
    """True when an op on ``t`` must launch its CUDA kernel."""
    if t.device.type == "cuda":
        return not _PLAIN.get()
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def forward_only(op: str, *tensors) -> None:
    """Raise RuntimeError, naming ``op``, where grad is enabled and one of
    ``tensors`` (None entries allowed) requires grad: the kernel ``op`` has
    no backward, and its output would carry no ``grad_fn``."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in tensors):
        raise RuntimeError(
            f"{op}: this CUDA kernel has no backward, and an input requires grad; run it "
            f"under torch.no_grad() / torch.inference_mode(), or take the route without it")
