"""Tensor ops of the port.  Public functions keep the JAX package's layout
(``[..., C]`` rows, ``(B, h, w, K)`` logits) so the tests compare like with
like.

An op with a CUDA kernel dispatches on the device of its input: a CPU tensor
runs the op's plain PyTorch version, a CUDA tensor launches the kernel or
raises.  Inside :func:`plain_versions` a CUDA tensor runs the plain version
instead; that exists to hold the kernels against their plain versions on
the card, and no product path opens it.
"""

import contextlib
import contextvars

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
