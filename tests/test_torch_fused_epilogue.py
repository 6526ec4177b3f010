"""Port's eval epilogue (segland_tpu_torch/ops/fused_epilogue.py): the plain
version against the JAX Pallas kernel in interpret mode and an fp64 numpy
oracle, and the CUDA kernel's arithmetic (host tables + 4-tap lerp, rows
then columns, first max wins) replayed in torch against the same oracle.
Classes may differ only where the oracle's top-2 gap is <= 1e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import t
from segland_tpu.ops.fused_epilogue import upsample_argmax as j_upsample_argmax
from segland_tpu.ops.resize import _interp_matrix
from segland_tpu_torch.ops.fused_epilogue import upsample_argmax, upsample_argmax_reference
from segland_tpu_torch.ops.resize import linear_table, resize_bilinear

SHAPES = [
    ((2, 64, 128, 5), (256, 512)),
    ((1, 32, 128, 12), (256, 1024)),
    ((1, 256, 128, 3), (256, 256)),
]


def _np_ref(logits, oh, ow):
    """fp64 bilinear + argmax, and the top-2 gap."""
    mr = _interp_matrix(logits.shape[1], oh, True).astype(np.float64)
    mc = _interp_matrix(logits.shape[2], ow, True).astype(np.float64)
    x = np.einsum("bhwk,Hh->bHwk", logits.astype(np.float64), mr)
    x = np.einsum("bHwk,Ww->bHWk", x, mc)
    top2 = np.sort(x, axis=-1)[..., -2:]
    return np.argmax(x, -1).astype(np.uint8), top2[..., 1] - top2[..., 0]


def _logits(shape):
    return np.random.RandomState(0).randn(*shape).astype(np.float32) * 10.0


def _kernel_replay(logits, oh, ow):
    """The arithmetic of kernels/csrc/upsample_argmax.cu in torch fp32."""
    x = t(logits)
    rlo, rhi, rw = map(t, linear_table(x.shape[1], oh, True))
    clo, chi, cw = map(t, linear_table(x.shape[2], ow, True))
    a = lambda r, c: x[:, r.long()][:, :, c.long()]
    wy, wx = rw[None, :, None, None], cw[None, None, :, None]
    left = a(rlo, clo) * (1 - wy) + a(rhi, clo) * wy
    right = a(rlo, chi) * (1 - wy) + a(rhi, chi) * wy
    return (left * (1 - wx) + right * wx).argmax(-1).to(torch.uint8).numpy()


@pytest.mark.parametrize("shape,out_hw", SHAPES)
def test_plain_matches_fp64_oracle_and_jax(shape, out_hw):
    logits = _logits(shape)
    ref, gap = _np_ref(logits, *out_hw)
    got = upsample_argmax(t(logits), out_hw)  # CPU: the plain version
    assert got.dtype == torch.uint8 and got.shape == (shape[0],) + out_hw
    got = got.numpy()
    assert ((got == ref) | (gap <= 1e-3)).all()
    jax_pred = np.asarray(j_upsample_argmax(jnp.asarray(logits), out_hw, interpret=True))
    assert ((got == jax_pred) | (gap <= 1e-3)).all()


@pytest.mark.parametrize("shape,out_hw", SHAPES + [((2, 7, 9, 4), (30, 17))])
def test_kernel_arithmetic_matches_fp64_oracle(shape, out_hw):
    logits = _logits(shape)
    ref, gap = _np_ref(logits, *out_hw)
    assert ((_kernel_replay(logits, *out_hw) == ref) | (gap <= 1e-3)).all()


def test_any_shape_and_first_max_wins():
    """No shape gate (the TPU one was a VMEM limit); ties go to class 0."""
    logits = np.zeros((1, 3, 5, 4), np.float32)
    logits[..., 2] = 1.0
    logits[..., 3] = 1.0
    got = upsample_argmax_reference(t(logits), (7, 11)).numpy()
    assert (got == 2).all()
    assert (upsample_argmax_reference(t(np.zeros_like(logits)), (7, 11)).numpy() == 0).all()


def test_linear_table_matches_jax_resize():
    from segland_tpu.ops.resize import _linear_table

    for n_in, n_out, ac in [(256, 1024, True), (32, 256, True), (7, 30, False), (5, 1, True)]:
        for a, b in zip(linear_table(n_in, n_out, ac), _linear_table(n_in, n_out, ac)):
            np.testing.assert_array_equal(a, b)
    x = np.random.RandomState(1).randn(2, 5, 6, 3).astype(np.float32)
    from segland_tpu.ops.resize import resize_bilinear as j_resize

    for ac in (True, False):
        np.testing.assert_allclose(
            resize_bilinear(t(x), (11, 9), align_corners=ac).numpy(),
            np.asarray(j_resize(jnp.asarray(x), (11, 9), align_corners=ac)),
            rtol=0, atol=1e-5)
