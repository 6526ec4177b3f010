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
cut off from its inputs.  K1, K3/K5 and K4 have a backward: the public op
(``fused_ln_mlp``, ``swin_attn_section_fused``, ``swin_block_fused``) runs
under grad inside an autograd Function, whose forward launches the kernel
with grad off and whose backward recomputes a formulation in PyTorch and
differentiates it, as the JAX package's custom VJPs do (``ops/fused_mlp.py``,
``ops/fused_attn.py``).  K2 and K6-K11 have none.
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


def forward_only(op: str, *tensors, why: str = "") -> None:
    """Raise RuntimeError, naming ``op`` (and ``why``), where grad is enabled
    and one of ``tensors`` (None entries allowed) requires grad: the kernel
    ``op`` has no backward, and its output would carry no ``grad_fn``."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in tensors):
        raise RuntimeError(
            f"{op}: this CUDA kernel has no backward{', ' + why if why else ''}, and an input "
            f"requires grad; run it under torch.no_grad() / torch.inference_mode(), or take "
            f"the route without it")
