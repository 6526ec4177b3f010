"""The port's plain attention-section, whole-block and window-attention
functions against the JAX package, on the CPU, same numpy inputs: against the
JAX references and against the Pallas kernels in interpret mode, fp32 within
1e-5 (2e-5 for the whole block and the grouped v1 section, whose sums run in
another order) and bf16 within 2e-2 (bf16 rounds at other places in the two
frameworks: the JAX reference rounds the scores, the port keeps them fp32 as
the kernels do).  Also the host mirrors of the CUDA kernels' index math and
row lookup against the backbone's static mask and region tables."""

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


def _mlp_inputs(seed, c):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    return dict(gamma2=rng.rand(c).astype(np.float32) + 0.5, beta2=f(c) * 0.1,
                w1=f(c, 4 * c) / np.sqrt(c), b1=f(4 * c) * 0.1,
                w2=f(4 * c, c) / np.sqrt(4 * c), b2=f(c) * 0.1)


def _block_args(lib, a, m, dtype, nh, geom):
    """(args, regions) of block_reference / swin_block_fused for one package."""
    h, w, hp, wp, ws, shift = geom
    mod = j_swin if lib == "jax" else p_swin
    conv = jnp.asarray if lib == "jax" else t
    regions = mod._shift_regions(hp, wp, ws, shift) if shift else None
    big = lambda k, d: _cast(d[k], dtype, lib)
    args = (big("x", a), conv(mod._pad_token_mask(*geom)), conv(a["gamma"]), conv(a["beta"]),
            big("wqkv", a), conv(a["bqkv"]), big("wproj", a), conv(a["bproj"]), big("bias", a),
            conv(m["gamma2"]), conv(m["beta2"]), big("w1", m), conv(m["b1"]), big("w2", m),
            conv(m["b2"]), nh)
    return args, None if regions is None else conv(regions)


BLOCK_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("against", ["reference", "pallas_interpret"])
def test_block_reference_matches_jax(dtype, shift, against):
    """The whole block (section, then LN2 + MLP + residual) on the padded
    26x19 -> 28x21 map: the port's plain version against the JAX reference and
    against the JAX whole-block kernel in interpret mode."""
    geom = (26, 19, 28, 21, WS, shift)
    c, nh = 64, 2
    nw = 2 * (28 // WS) * (21 // WS)
    a, m = _section_inputs(11 + shift, nw, c, nh), _mlp_inputs(13, c)
    jargs, jreg = _block_args("jax", a, m, dtype, nh, geom)
    if against == "reference":
        want = J.block_reference(*jargs, regions=jreg)
    else:
        want = J.swin_block_fused(*jargs, regions=jreg, interpret=True, geom=geom)
    pargs, preg = _block_args("port", a, m, dtype, nh, geom)
    got = P.block_reference(*pargs, regions=preg).float().numpy()
    tol = BLOCK_TOL[dtype]
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)), rtol=tol, atol=tol)
    # the dispatching op takes the plain version on a CPU tensor
    fused = P.swin_block_fused(*pargs, regions=preg, geom=geom).float().numpy()
    np.testing.assert_array_equal(fused, got)


@pytest.mark.parametrize("group", [1, 2, 3])
@pytest.mark.parametrize("shift", [0, 3])
def test_grouped_v1_section_matches_jax(group, shift):
    """geom=None: the v1 section with per-window mask rows (a padded map),
    regions when shifted, and 25 windows, which neither 2 nor 3 divides.  The
    JAX side runs its v1 Pallas kernel in interpret mode with that group; the
    port's plain version does not depend on it."""
    geom = (33, 30, 35, 35, WS, shift)
    c, nh = 32, 2
    a = _section_inputs(17 + shift, 25, c, nh)

    def run(lib):
        mod, conv = (j_swin, jnp.asarray) if lib == "jax" else (p_swin, t)
        mask = mod._pad_token_mask(*geom)
        assert mask.shape == (25, N)
        regions = conv(mod._shift_regions(35, 35, WS, shift)) if shift else None
        args = (conv(a["x"]), conv(mask), conv(a["gamma"]), conv(a["beta"]), conv(a["wqkv"]),
                conv(a["bqkv"]), conv(a["wproj"]), conv(a["bproj"]), conv(a["bias"]), nh)
        if lib == "jax":
            return np.asarray(J.swin_attn_section_fused(*args, regions=regions, interpret=True,
                                                        group=group))
        return P.swin_attn_section_fused(*args, regions=regions, group=group).numpy()

    np.testing.assert_allclose(run("port"), run("jax"), rtol=2e-5, atol=2e-5)


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


@pytest.mark.parametrize("geom", [
    (26, 19, 28, 21, WS, 3), (28, 28, 28, 28, WS, 0), (28, 28, 28, 28, WS, 3),
    (64, 64, 70, 70, WS, 3), (32, 32, 35, 35, WS, 0)], ids=lambda g: "x".join(map(str, g)))
def test_shipped_rows_agree_with_the_index_math(geom):
    """The v1 kernel's lookup (window w reads row w % rows of the shipped
    mask and region tables, one row when nothing is padded) gives what the
    index-math kernels compute from the window index, over a folded batch."""
    h, w, hp, wp, ws, shift = geom
    n = 3 * (hp // ws) * (wp // ws)
    valid, rid = P.window_masks(n, geom)
    mask = p_swin._pad_token_mask(*geom)
    assert mask.shape[0] == (1 if (h, w) == (hp, wp) else n // 3)
    np.testing.assert_array_equal(P.shipped_rows(mask, n), valid)
    if shift:
        np.testing.assert_array_equal(
            P.shipped_rows(p_swin._shift_regions(hp, wp, ws, shift), n), rid)


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
    with pytest.raises(ValueError, match="CUDA"):
        P.attn_section_v1(x, torch.ones(1, N), *[None] * 7, 3, group=2)
    with pytest.raises(ValueError, match="CUDA"):
        P.swin_block(x, (14, 14, 14, 14, 7, 0), *[None] * 13, 3)


def test_group_and_geom_are_checked():
    """group is a knob of the v1 kernel only (with geom it would be a silent
    no-op, so it raises, as in the JAX package), the v1 kernel is built for
    group in 1, 2, 4, 8, and the whole block needs geom."""
    x = torch.zeros(4, N, 96)
    with pytest.raises(ValueError, match="v1 kernel"):
        P.swin_attn_section_fused(x, None, *[None] * 7, 3, group=2,
                                  geom=(14, 14, 14, 14, 7, 0))
    with pytest.raises(ValueError, match=r"\(1, 2, 4, 8\)"):
        P.attn_section_v1(x, torch.ones(1, N), *[None] * 7, 3, group=3)
    with pytest.raises(ValueError, match="geom"):
        P.swin_block_fused(x, None, *[None] * 13, 3)
