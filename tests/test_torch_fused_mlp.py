"""Port's fused LN+MLP op (segland_tpu_torch/ops/fused_mlp.py): its plain
version against the JAX package's ln_mlp_reference and against the JAX
Pallas kernel in interpret mode, on the same numpy inputs.  The CUDA kernel
itself is held against this plain version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import t
from segland_tpu.ops.pallas_mlp import _tile_m, fused_ln_mlp as j_fused, ln_mlp_reference as j_ref
from segland_tpu_torch.ops import plain_versions, use_kernel
from segland_tpu_torch.ops.fused_mlp import contiguous_as, fused_ln_mlp, ln_mlp, ln_mlp_reference


def _params(c, hid, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    return dict(gamma=1.0 + 0.1 * f(c), beta=0.1 * f(c), w1=f(c, hid) * 0.05,
                b1=0.05 * f(hid), w2=f(hid, c) * 0.05, b2=0.05 * f(c))


def _rows(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("with_res,with_ls", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("c", [96, 128])
def test_plain_fp32_matches_jax_reference(c, with_res, with_ls):
    p = _params(c, 4 * c, seed=c)
    x = _rows((37, c), 1)
    res = _rows((37, c), 2) if with_res else None
    ls = np.random.RandomState(3).uniform(0.1, 1.0, c).astype(np.float32) if with_ls else None
    want = j_ref(jnp.asarray(x), **{k: jnp.asarray(v) for k, v in p.items()},
                 res=None if res is None else jnp.asarray(res),
                 ls=None if ls is None else jnp.asarray(ls), eps=1e-6)
    got = ln_mlp_reference(t(x), **{k: t(v) for k, v in p.items()},
                           res=None if res is None else t(res),
                           ls=None if ls is None else t(ls), eps=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_plain_matches_jax_pallas_interpret(dtype, atol):
    c, hid = 96, 384
    m = _tile_m(c, hid, 4 if dtype == "float32" else 2)
    assert m > 0  # a whole tile: JAX runs its kernel, not its fallback
    p = _params(c, hid, seed=4)
    x, res = _rows((m, c), 5), _rows((m, c), 6)
    ls = np.random.RandomState(7).uniform(0.1, 1.0, c).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = j_fused(jnp.asarray(x, jd), **{k: jnp.asarray(v) for k, v in p.items()},
                   res=jnp.asarray(res, jd), ls=jnp.asarray(ls), eps=1e-6, interpret=True)
    got = fused_ln_mlp(t(x).to(td), **{k: t(v) for k, v in p.items()},
                       res=t(res).to(td), ls=t(ls), eps=1e-6)
    assert got.dtype == td and got.shape == (m, c)
    tol = dict(rtol=0, atol=atol) if dtype == "bfloat16" else dict(rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_cpu_dispatch_runs_the_plain_version():
    c = 96
    p = {k: t(v) for k, v in _params(c, 4 * c, seed=8).items()}
    x = t(_rows((2, 3, 4, c), 9))
    want = ln_mlp_reference(x.reshape(-1, c), **p).reshape(x.shape)
    torch.testing.assert_close(fused_ln_mlp(x, **p), want, rtol=0, atol=0)
    with plain_versions():
        torch.testing.assert_close(fused_ln_mlp(x, **p), want, rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_and_other_devices():
    c = 96
    p = {k: t(v) for k, v in _params(c, 4 * c, seed=10).items()}
    before = ln_mlp.launches
    with pytest.raises(ValueError):
        ln_mlp(t(_rows((16, c), 11)), **p)
    assert ln_mlp.launches == before
    with pytest.raises(ValueError):
        use_kernel(torch.empty(2, device="meta"))


@pytest.mark.parametrize("src,dst", [(torch.float32, torch.float32),
                                     (torch.float32, torch.bfloat16),
                                     (torch.bfloat16, torch.bfloat16)])
def test_kernel_weights_are_row_major_in_the_compute_dtype(src, dst):
    """The blocks pass nn.Linear weights transposed (``weight.T``); the kernel
    reads its weights row-major, whatever their dtype was."""
    w = torch.randn(8, 4).to(src)
    got = contiguous_as(w.T, dst)
    assert got.is_contiguous() and got.dtype == dst
    torch.testing.assert_close(got, w.T.to(dst), rtol=0, atol=0)
