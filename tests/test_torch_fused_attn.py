"""The port's plain attention-section and window-attention functions against
the JAX package, on the CPU, same numpy inputs: against the JAX references
and against the Pallas kernels in interpret mode, fp32 within 1e-5 and bf16
within 2e-2 (bf16 rounds at other places in the two frameworks: the JAX
reference rounds the scores, the port keeps them fp32 as the kernels do).
Also the host mirror of the CUDA kernel's index math against the backbone's
static mask and region tables."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import t
from segland_tpu.models.backbones import swin as j_swin
from segland_tpu.ops import pallas_attn as J
from segland_tpu_torch.models.backbones import swin as p_swin
from segland_tpu_torch.ops import fused_attn as P

WS, N = 7, 49
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _section_inputs(seed, nw, c, nh):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    return dict(x=f(nw, N, c) * 0.5, gamma=rng.rand(c).astype(np.float32) + 0.5,
                beta=f(c) * 0.1, wqkv=f(c, 3 * c) * 0.1, bqkv=f(3 * c) * 0.1,
                wproj=f(c, c) * 0.1, bproj=f(c) * 0.1, bias=f(1, nh, N, N) * 0.3)


def _cast(a, dtype, lib):
    if lib == "jax":
        return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    return t(a).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)


def _run_section(lib, a, dtype, nh, geom, batch, interpret=None):
    h, w, hp, wp, ws, shift = geom
    mod = j_swin if lib == "jax" else p_swin
    mask = mod._pad_token_mask(*geom)
    regions = mod._shift_regions(hp, wp, ws, shift) if shift else None
    conv = jnp.asarray if lib == "jax" else t
    big = {k: _cast(a[k], dtype, lib) for k in ("x", "wqkv", "wproj", "bias")}
    vec = {k: conv(a[k]) for k in ("gamma", "beta", "bqkv", "bproj")}
    args = (big["x"], conv(mask), vec["gamma"], vec["beta"], big["wqkv"], vec["bqkv"],
            big["wproj"], vec["bproj"], big["bias"], nh)
    kw = dict(regions=None if regions is None else conv(regions))
    if lib == "jax":
        if interpret:
            out = J.swin_attn_section_fused(*args, interpret=True, geom=geom, **kw)
        else:
            out = J.attn_section_reference(*args, **kw)
        return np.asarray(out.astype(jnp.float32))
    fn = P.swin_attn_section_fused if interpret is None else P.attn_section_reference
    extra = dict(geom=geom) if interpret is None else {}
    return fn(*args, **kw, **extra).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("against", ["reference", "pallas_interpret"])
def test_attn_section_matches_jax(dtype, shift, against):
    """26x19 map -> 28x21 padded (hp != h, wp != w), batch 2, 4 heads."""
    geom = (26, 19, 28, 21, WS, shift)
    batch, c, nh = 2, 48, 4
    nw = batch * (28 // WS) * (21 // WS)
    a = _section_inputs(3 + shift, nw, c, nh)
    want = _run_section("jax", a, dtype, nh, geom, batch, interpret=against != "reference")
    got = _run_section("port", a, dtype, nh, geom, batch, interpret=False)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # the dispatching op takes the plain version on a CPU tensor
    np.testing.assert_array_equal(_run_section("port", a, dtype, nh, geom, batch), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nw_img,b", [(1, 4), (4, 2)])
def test_window_attention_matches_jax(dtype, nw_img, b):
    rng = np.random.RandomState(5)
    c, nh = 32, 4
    nw = nw_img * b
    qkv = rng.randn(nw, N, 3 * c).astype(np.float32)
    bias = (rng.randn(nw_img, nh, N, N) * 0.3).astype(np.float32)
    if nw_img > 1:
        bias[1, :, :, 20:] = -100.0  # a shift mask: window 1 cannot see tokens >= 20
    tol = TOL[dtype]
    got = P.window_attention_fused(_cast(qkv, dtype, "port"), _cast(bias, dtype, "port"), nh)
    got = got.float().numpy()
    for fn, kw in ((J.window_attention_reference, {}),
                   (J.window_attention_fused, dict(interpret=True))):
        want = fn(_cast(qkv, dtype, "jax"), _cast(bias, dtype, "jax"), nh, **kw)
        np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)), rtol=tol, atol=tol)


@pytest.mark.parametrize("geom", [
    (26, 19, 28, 21, WS, 0), (26, 19, 28, 21, WS, 3), (28, 28, 28, 28, WS, 3),
    (64, 64, 70, 70, WS, 3), (32, 32, 35, 35, WS, 0), (5, 9, 7, 14, WS, 3)],
    ids=lambda g: "x".join(map(str, g)))
def test_kernel_index_math_matches_the_static_tables(geom):
    """window_masks (the CUDA kernel's arithmetic, on the host) == the
    backbone's _pad_token_mask and _shift_regions, with the batch folded into
    the window index."""
    h, w, hp, wp, ws, shift = geom
    nw_img = (hp // ws) * (wp // ws)
    valid, rid = P.window_masks(3 * nw_img, geom)
    mask = p_swin._pad_token_mask(*geom)
    np.testing.assert_array_equal(valid, np.tile(np.broadcast_to(mask, (nw_img, N)), (3, 1)))
    if shift:
        np.testing.assert_array_equal(rid, np.tile(p_swin._shift_regions(hp, wp, ws, shift),
                                                   (3, 1)))
    else:
        assert not rid.any()


@pytest.mark.parametrize("name", ["_rel_pos_index", "_shift_regions", "_shift_attn_mask",
                                  "_pad_token_mask"])
def test_static_tables_match_jax(name):
    args = {"_rel_pos_index": (7,), "_shift_regions": (28, 21, 7, 3),
            "_shift_attn_mask": (28, 21, 7, 3), "_pad_token_mask": (26, 19, 28, 21, 7, 3)}[name]
    np.testing.assert_array_equal(getattr(p_swin, name)(*args), getattr(j_swin, name)(*args))


def test_cuda_only_routes_raise_on_the_cpu():
    x = torch.zeros(4, N, 96)
    with pytest.raises(ValueError, match="CUDA"):
        P.attn_section(x, (14, 14, 14, 14, 7, 0), *[None] * 7, 3)
    with pytest.raises(ValueError, match="CUDA"):
        P.window_attention(torch.zeros(4, N, 288), torch.zeros(1, 3, N, N), 3)
    with pytest.raises(NotImplementedError, match="B5"):
        P.swin_attn_section_fused(x, None, *[None] * 7, 3, group=2)
