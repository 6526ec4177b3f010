"""The port's plain attention-section, whole-block and window-attention
functions against the JAX package, on the CPU, same numpy inputs: against the
JAX references and against the Pallas kernels in interpret mode, fp32 within
1e-5 (2e-5 for the whole block and the grouped v1 section, whose sums run in
another order) and bf16 within 2e-2 (bf16 rounds at other places in the two
frameworks: the JAX reference rounds the scores, the port keeps them fp32 as
the kernels do).  Also the host mirrors of the CUDA kernels' index math and
row lookup against the backbone's static mask and region tables."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import t
from segland_tpu.models.backbones import swin as j_swin
from segland_tpu.ops import pallas_attn as J
from segland_tpu_torch.models.backbones import swin as p_swin
from segland_tpu_torch.ops import fused_attn as P
from segland_tpu_torch.ops.fused_mlp import ln_mlp_plan

WS, N = 7, 49
ROOT = pathlib.Path(__file__).resolve().parents[1]
SWIN_S_WIDTHS = (96, 192, 384, 768)  # embed 96, doubled a stage; heads of 32
SWIN_BL_WIDTHS = (128, 256, 512, 1024, 1536)  # swin-b's (embed 128) and swin-l's last (192)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _section_inputs(seed, nw, c, nh, w=0.1):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    return dict(x=f(nw, N, c) * 0.5, gamma=rng.rand(c).astype(np.float32) + 0.5,
                beta=f(c) * 0.1, wqkv=f(c, 3 * c) * w, bqkv=f(3 * c) * 0.1,
                wproj=f(c, c) * w, bproj=f(c) * 0.1, bias=f(1, nh, N, N) * 0.3)


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


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("c", SWIN_BL_WIDTHS[:1] + SWIN_BL_WIDTHS[-2:])
def test_attn_section_wide_matches_jax_reference(c, shift):
    """The plain version at swin-b's and swin-l's widths (C = 128, 1024,
    1536; heads of 32) against the JAX attn_section_reference, fp32 within
    1e-5: a 10x12 map padded to 14x14, batch 1, four windows.  The weights
    scale by fan-in (as 0.1 does at C = 48), so that q, k and the output stay
    O(1) and the bar reads the arithmetic, not the order of long sums."""
    geom = (10, 12, 14, 14, WS, shift)
    a = _section_inputs(11 + shift, 4, c, c // 32, w=0.1 * (48 / c) ** 0.5)
    want = _run_section("jax", a, "float32", c // 32, geom, 1, interpret=False)
    got = _run_section("port", a, "float32", c // 32, geom, 1, interpret=False)
    np.testing.assert_allclose(got, want, rtol=TOL["float32"], atol=TOL["float32"])


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


WIDE_WIDTHS = SWIN_BL_WIDTHS[:1] + SWIN_BL_WIDTHS[-2:]  # C = 128, 1024, 1536


def _wide_inputs(seed, nw, c):
    """Section inputs at swin-b's and swin-l's widths, weights scaled by fan-in
    (as 0.1 does at C = 48), so that q, k and the output stay O(1) and the bar
    reads the arithmetic, not the order of long sums."""
    return _section_inputs(seed, nw, c, c // 32, w=0.1 * (48 / c) ** 0.5)


@pytest.mark.parametrize("c", WIDE_WIDTHS)
def test_block_reference_wide_matches_jax(c):
    """The whole block's plain version at swin-b's and swin-l's widths against
    the JAX block_reference, fp32 within 2e-5: a 10x12 map padded to 14x14,
    shifted, four windows."""
    geom = (10, 12, 14, 14, WS, 3)
    a, m = _wide_inputs(21, 4, c), _mlp_inputs(23, c)
    jargs, jreg = _block_args("jax", a, m, "float32", c // 32, geom)
    pargs, preg = _block_args("port", a, m, "float32", c // 32, geom)
    want = np.asarray(J.block_reference(*jargs, regions=jreg))
    got = P.block_reference(*pargs, regions=preg).numpy()
    np.testing.assert_allclose(got, want, rtol=BLOCK_TOL["float32"], atol=BLOCK_TOL["float32"])


@pytest.mark.parametrize("c", WIDE_WIDTHS)
def test_grouped_v1_section_wide_matches_jax(c):
    """The v1 section at group 2 at swin-b's and swin-l's widths: the port's
    plain version against the JAX v1 Pallas kernel in interpret mode, fp32
    within 2e-5, on a 13x12 map padded to 14x14 (per-window mask rows),
    shifted (regions), three windows, which 2 does not divide."""
    geom = (13, 12, 14, 14, WS, 3)
    a = _wide_inputs(25, 3, c)
    nh = c // 32

    def run(lib):
        mod, conv = (j_swin, jnp.asarray) if lib == "jax" else (p_swin, t)
        mask = mod._pad_token_mask(*geom)[:3]
        regions = conv(mod._shift_regions(14, 14, WS, 3)[:3])
        args = (conv(a["x"]), conv(mask), conv(a["gamma"]), conv(a["beta"]), conv(a["wqkv"]),
                conv(a["bqkv"]), conv(a["wproj"]), conv(a["bproj"]), conv(a["bias"]), nh)
        if lib == "jax":
            return np.asarray(J.swin_attn_section_fused(*args, regions=regions, interpret=True,
                                                        group=2))
        return P.swin_attn_section_fused(*args, regions=regions, group=2).numpy()

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


@pytest.mark.parametrize("nw_img,b", [(1, 4), (4, 2)])
def test_window_attention_bias_in_bf16_is_its_fp32_cast(nw_img, b):
    """K6 reads a bf16 bias as it is; its plain version with that bias equals it
    with the bias cast to fp32 (bf16 -> fp32 is exact) and both match the JAX
    kernel in interpret mode given the bf16 bias."""
    rng = np.random.RandomState(6)
    c, nh = 64, 2
    qkv = rng.randn(nw_img * b, N, 3 * c).astype(np.float32)
    bias = (rng.randn(nw_img, nh, N, N) * 0.3).astype(np.float32)
    if nw_img > 1:
        bias[1, :, :, 20:] = -100.0
    qkv_p, bias_p = _cast(qkv, "bfloat16", "port"), _cast(bias, "bfloat16", "port")
    got = P.window_attention_reference(qkv_p, bias_p, nh)
    assert torch.equal(got, P.window_attention_reference(qkv_p, bias_p.float(), nh))
    want = J.window_attention_fused(_cast(qkv, "bfloat16", "jax"), _cast(bias, "bfloat16", "jax"),
                                    nh, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


# swin-s at a batch of 8 1024^2 tiles: (NW, C, heads, nW_img with the shift mask)
SWIN_S_WINDOWS = ((10952, 96, 3, 1369), (2888, 192, 6, 361), (800, 384, 12, 100),
                  (200, 768, 24, 25))


@pytest.mark.parametrize("nw,c,nh,nw_img", SWIN_S_WINDOWS + ((803, 384, 12, 1), (7, 768, 24, 7)),
                         ids=lambda v: str(v))
@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32], ids=str)
def test_window_attention_plan(nw, c, nh, nw_img, bias_dtype):
    """K6's ring body: 4 stages of q, k, v and a bias slice within the shared
    memory a block can have, a grid that is a multiple of the heads (a block
    keeps one head, so a shared bias is copied once a stage) and walks every
    item, ragged window counts included."""
    src = (ROOT / "segland_tpu_torch/kernels/csrc/window_attention.cu").read_text()
    assert int(re.search(r"constexpr int kRingStages = (\d+);", src).group(1)) == P.WINDOW_STAGES
    plan = P.window_attention_plan(nw, c, nh, nw_img, bias_dtype)
    esize = 2 if bias_dtype == torch.bfloat16 else 4
    assert plan["stage_bytes"] >= 3 * 64 * 64 + N * N * esize + 4
    assert plan["stage_bytes"] % 16 == 0
    assert plan["smem"] == plan["stages"] * plan["stage_bytes"] <= 232448
    assert plan["blocks_per_sm"] == (3 if esize == 2 else 2)
    assert plan["items"] == nw * nh
    assert plan["grid"] % nh == 0 and plan["one_head_per_block"]
    assert plan["grid"] * plan["items_per_block"] >= plan["items"]
    assert plan["grid"] <= 132 * plan["blocks_per_sm"]


def test_window_attention_plan_refuses_what_the_kernel_refuses():
    for args in ((800, 384, 11, 1), (800, 384, 12, 3), (0, 384, 12, 1), (2 ** 28, 384, 12, 1)):
        with pytest.raises(ValueError, match="window_attention"):
            P.window_attention_plan(*args)


def test_window_attention_bias_checks():
    """The bias K6 takes: bf16 or fp32, contiguous [nW_img, nh, 49, 49], 4-byte
    aligned, nW_img dividing NW.  A bf16 bias with bf16 qkv goes as it is (no cast
    pass); fp32 qkv (the fp32 body) gets it in fp32."""
    qkv = torch.zeros(8, N, 3 * 64, dtype=torch.bfloat16)
    bias = torch.zeros(4, 2, N, N, dtype=torch.bfloat16)
    assert P._window_bias(bias, qkv, 2, N) is bias
    assert P._window_bias(bias, qkv.float(), 2, N).dtype == torch.float32
    bad = {"float16": (bias.half(), "bfloat16 or float32"),
           "shape": (bias[:, :1], r"want \[\*, 2, 49, 49\]"),
           "strided": (bias.transpose(2, 3), "contiguous"),
           "misaligned": (torch.zeros(4 * 2 * N * N + 1, dtype=torch.bfloat16)[1:].view(
               4, 2, N, N), "4-byte aligned"),
           "images": (torch.zeros(3, 2, N, N, dtype=torch.bfloat16), "do not divide")}
    for name, (b, msg) in bad.items():
        with pytest.raises(ValueError, match=msg):
            P._window_bias(b, qkv, 2, N)


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


@pytest.mark.parametrize("c", SWIN_S_WIDTHS + SWIN_BL_WIDTHS)
def test_every_swin_s_stage_has_a_bf16_section_plan(c):
    """The wgmma section's plan at each swin-s, swin-b and swin-l width fits
    a block's shared memory, its m64 row tiles split evenly over the two
    consumer warpgroups (or, with one tile, its columns), and the accumulators
    leave a consumer thread most of its 168 registers for the attention core.
    Where 96 does not divide C the projection's last pass takes the rest (an
    n64 or n32 product, halved with one row tile); only C = 1536 streams y, one
    window a block, each slot a [64, 64] tile of y or the context beside the
    weights'."""
    plan = P.section_plan(c)
    assert plan["smem"] == sum(plan["smem_parts"].values()) <= P.SMEM_MAX
    assert plan["rows"] == plan["w"] * N
    assert plan["row_tiles"] == -(-plan["rows"] // 64)
    assert (plan["split"] == "rows") == (plan["row_tiles"] % 2 == 0)
    assert plan["acc_regs"] <= 96
    assert plan["last_pass"] == (c % 96 or 96) and plan["last_pass"] in (32, 64, 96)
    assert plan["last_n"] == plan["last_pass"] // (1 if plan["split"] == "rows" else 2)
    assert plan["stream_y"] == (c == 1536)
    if plan["stream_y"]:
        assert plan["w"] == 1 and plan["smem_parts"]["y"] == 0 and plan["overrun"] == 0
        assert plan["slot_bytes"] == 64 * 128 + 96 * 128
    else:
        # y's last row tile reads past y into the buffer after it, never past the block's
        # memory
        overrun = (plan["row_tiles"] * 64 - -(-plan["rows"] // 8) * 8) * 128
        assert overrun <= plan["smem_parts"]["qkv"]


@pytest.mark.parametrize("c", [64, 160, 480, 2048])
def test_section_widths_without_a_build_raise(c):
    with pytest.raises(ValueError, match="no bfloat16 build"):
        P.section_plan(c)


def test_section_build_table_matches_the_source():
    src = (ROOT / "segland_tpu_torch/kernels/csrc/attn_section.cu").read_text()
    table = src[src.index("#define SEGLAND_SECTION_BUILDS"):]
    table = table[:table.index("\n\n")]
    built = {int(m[0]): (int(m[1]), int(m[2]), bool(int(m[3])))
             for m in re.findall(r"X\((\d+), (\d+), (\d+), ([01])\)", table)}
    assert built == {c: tuple(b) for c, b in P.SECTION_BUILDS.items()}


@pytest.mark.parametrize("c", SWIN_S_WIDTHS + SWIN_BL_WIDTHS)
def test_every_swin_s_stage_has_a_bf16_block_plan(c):
    """The whole-block kernel's plan at each swin-s, swin-b and swin-l width:
    the section's layout within a block's shared memory, its row tiles cut into ln_mlp's row groups, ln_mlp's MLP tiling
    at the same width (at C = 96 and 128 half its hidden chunk, which keeps
    the hidden columns in the same k order), the shared h tile behind y, and
    accumulators and h fragments no more than K1's at that width, which
    compiles without spills.  Only C = 1536 streams y, in both halves: one
    window a block, K1's streamed tiling, ring slots of the MLP's 24 KB."""
    plan = P.block_plan(c)
    assert plan["smem"] == sum(plan["smem_parts"].values()) <= P.SMEM_MAX
    # K3's windows a block (at C = 128 two, not four: four spilled beside the MLP)
    assert plan["rows"] == plan["w"] * N and plan["rr"]
    assert plan["w"] == (2 if c == 128 else P.SECTION_BUILDS[c].w)
    assert plan["row_tiles"] % plan["rg"] == 0
    assert plan["items"] == plan["row_tiles"] // plan["rg"] * plan["np"]
    mlp = ln_mlp_plan(c, 4 * c)
    assert {k: plan[k] for k in ("rg", "cg", "np", "cs")} == \
        {k: mlp[k] for k in ("rg", "cg", "np", "cs")}
    assert plan["hs"] == (64 if c in (96, 128) else mlp["hs"])
    assert plan["hc"] * plan["chunks"] == 4 * c
    assert plan["mlp_regs"] <= min(mlp["acc_regs"], 176)
    assert plan["last_pass"] == (c % 96 or 96)
    assert plan["stream_y"] == mlp["stream_y"] == (c == 1536)
    kt1, kt2 = -(-c // 64), plan["hc"] // 64
    nt1, nt2 = plan["hs"] // 64, -(-plan["cs"] // 64)
    if plan["stream_y"]:
        assert plan["w"] == 1 and plan["smem_parts"]["y"] == 0
        assert plan["slot_bytes"] == plan["mlp_slot_bytes"] == mlp["slot_bytes"] == 3 * 8192
        tiles_per_chunk = kt1 + kt2 * nt2  # y2's tile beside both w1 tiles; both w2 tiles
    else:
        assert plan["slot_bytes"] == 96 * 128
        tiles_per_chunk = plan["cg"] * (kt1 * nt1 + kt2 * nt2)
    behind_y = sum(plan["smem_parts"][k] for k in ("qkv", "strips", "bias", "tokens"))
    assert plan["h_bytes"] <= behind_y and plan["overrun"] <= behind_y
    # the ring carries K3's section stream, then every item's MLP tiles
    assert plan["slots_per_block"] == P.section_plan(c)["slots_per_block"] + plan["items"] * (
        plan["chunks"] * tiles_per_chunk)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("c", SWIN_S_WIDTHS + SWIN_BL_WIDTHS)
def test_every_swin_s_stage_has_a_v1_plan(c, group):
    """The v1 kernel's plan at each swin-s, swin-b and swin-l width and built
    group: the windows path (whole super-windows in a block, q, k, v in shared
    memory) where the group fits the build's windows, which the attn_group=2
    route gets at C <= 384, else the scratch path in chunks of the build's
    windows; either within a block's shared memory, the scratch tensor only on
    its path.  At C = 1536 y streams on both paths (one window a block), and
    the scratch path's phase 2 lies over the ring."""
    plan = P.v1_plan(c, group)
    assert plan["smem"] <= P.SMEM_MAX and plan["group"] == group
    assert plan["stream_y"] == (c == 1536) and (plan["w"] == 1 or not plan["stream_y"])
    if group <= plan["w"]:
        assert plan["path"] == "windows" and not plan["scratch"]
        assert plan["w"] % group == 0 and plan["windows_a_block"] == plan["w"]
        assert plan["smem"] == sum(plan["smem_parts"].values())
        assert plan["smem_parts"]["tokens"] == -(-plan["rows"] * 4 // 128) * 128  # fp32 ids
    else:
        assert plan["path"] == "scratch" and plan["scratch"]
        assert plan["windows_a_block"] == group and plan["chunks"] == -(-group // plan["w"])
        parts = plan["smem_parts"]
        rest = parts["barriers"] + parts["align"]
        if plan["stream_y"]:
            assert parts["phase13"] == 0
            assert plan["smem"] == max(parts["ring"], parts["phase2"]) + rest
        else:
            assert parts["phase13"] == plan["k_tiles"] * plan["y_rows"] * 128 + plan["overrun"]
            assert plan["smem"] == parts["ring"] + max(parts["phase2"], parts["phase13"]) + rest
    assert (plan["path"] == "windows") == (group == 1 or (group == 2 and c <= 384))


@pytest.mark.parametrize("call,match", [
    (lambda: P.block_plan(160), "no bfloat16 build"),
    (lambda: P.block_plan(2048), "no bfloat16 build"),
    (lambda: P.block_plan(96, hidden=352), "not a multiple of 64"),
    (lambda: P.block_plan(384, hidden=1000), "not a multiple of 128"),
    (lambda: P.v1_plan(64, 1), "no bfloat16 build"),
    (lambda: P.v1_plan(480, 2), "no bfloat16 build"),
    (lambda: P.v1_plan(96, 3), r"\(1, 2, 4, 8\)"),
    (lambda: P.v1_plan(768, 16), r"\(1, 2, 4, 8\)")])
def test_block_and_v1_shapes_without_a_build_raise(call, match):
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("source,macro,table,fields", [
    ("swin_block.cu", "SEGLAND_BLOCK_BUILDS", "BLOCK_BUILDS", 7),
    ("attn_section_v1.cu", "SEGLAND_V1_BUILDS", "V1_BUILDS", 3)])
def test_block_and_v1_build_tables_match_the_sources(source, macro, table, fields):
    src = (ROOT / "segland_tpu_torch/kernels/csrc" / source).read_text()
    text = src[src.index(f"#define {macro}"):]
    text = text[:text.index("\n\n")]
    rows = re.findall(r"X\(" + ", ".join([r"(\d+)"] * fields) + r"\)", text)
    built = {int(m[0]): tuple(int(v) for v in m[1:]) for m in rows}
    want = {c: tuple(int(v) for v in b) for c, b in getattr(P, table).items()}
    assert built == want and len(rows) == len(want)


class _Recorder:
    """Stands for the kernels' library: records each entry's arguments."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] = args
            return 0
        return entry


@pytest.fixture
def recorded(monkeypatch):
    """The ops' launches on CPU tensors, recorded instead of run: the device
    check passes, ``kernels.ptr`` hands the tensors themselves to the fake
    library, and the launch counters are put back afterwards."""
    lib = _Recorder()
    monkeypatch.setattr(P, "_check_rows", lambda name, t: None)
    monkeypatch.setattr(P.kernels, "library", lambda: lib)
    monkeypatch.setattr(P.kernels, "ptr", lambda t: t)
    monkeypatch.setattr(P.kernels, "stream_of", lambda t: None)
    for op in (P.swin_block, P.attn_section_v1):
        monkeypatch.setattr(op, "launches", op.launches)
    return lib


def _linear(rng, n_out, n_in, dtype):
    """An nn.Linear-style weight [out, in] and the [in, out] view the models pass."""
    w = t(rng.randn(n_out, n_in).astype(np.float32)).to(dtype)
    return w, w.T


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_swin_block_hands_k_major_weights_to_the_kernel(recorded, dtype):
    """In bf16 the whole-block kernel reads every weight K-major: the models'
    weight.T views reach it as the nn.Linear storage itself, no copy, and an
    input-major [in, out] tensor as its contiguous transpose.  In fp32 the
    weights reach it input-major."""
    rng = np.random.RandomState(3)
    c, nh, nw = 96, 3, 8
    x = t(rng.randn(nw, N, c).astype(np.float32)).to(dtype)
    wqkv, wqkv_v = _linear(rng, 3 * c, c, dtype)
    wproj, wproj_v = _linear(rng, c, c, dtype)
    w1, w1_v = _linear(rng, 4 * c, c, dtype)
    w2_in = t(rng.randn(4 * c, c).astype(np.float32)).to(dtype)  # [in, out], contiguous
    vec = lambda n: t(rng.randn(n).astype(np.float32))
    P.swin_block(x, (14, 28, 14, 28, WS, 3), vec(c), vec(c), wqkv_v, vec(3 * c), wproj_v,
                 vec(c), torch.zeros(1, nh, N, N), vec(c), vec(c), w1_v, vec(4 * c), w2_in,
                 vec(c), nh)
    args = recorded.calls["segland_swin_block"]
    assert args[0] == P._DTYPES[dtype] and P.swin_block.launches == 1
    got = dict(wqkv=args[4], wproj=args[6], w1=args[11], w2=args[13])
    if dtype == torch.bfloat16:
        for name, lin in (("wqkv", wqkv), ("wproj", wproj), ("w1", w1)):
            assert got[name].data_ptr() == lin.data_ptr() and got[name].is_contiguous(), name
        assert got["w2"].shape == (c, 4 * c) and got["w2"].is_contiguous()
        assert torch.equal(got["w2"], w2_in.T)
    else:
        for name, want in (("wqkv", wqkv_v), ("wproj", wproj_v), ("w1", w1_v), ("w2", w2_in)):
            assert got[name].is_contiguous() and torch.equal(got[name], want), name
    assert args[16] is None  # no streamed y at this width: no scratch
    assert args[17:21] == (nw, c, nh, 4 * c)


@pytest.mark.parametrize("c,group", [(96, 2), (96, 8), (192, 2), (192, 4), (768, 1),
                                     (768, 2), (1536, 1), (1536, 4)])
def test_v1_allocates_the_scratch_tensor_only_on_its_scratch_path(recorded, c, group):
    """The bf16 v1 kernel gets a [NW, 49, 3C] scratch tensor only where its
    plan takes the scratch path (NULL otherwise), a [2 * NW * 64, C] one for
    y's and the context's rows only where y streams (C = 1536), and K-major
    weights."""
    rng = np.random.RandomState(4)
    nh, nw = c // 32, 10
    x = t(rng.randn(nw, N, c).astype(np.float32)).to(torch.bfloat16)
    wqkv, wqkv_v = _linear(rng, 3 * c, c, torch.bfloat16)
    wproj, wproj_v = _linear(rng, c, c, torch.bfloat16)
    vec = lambda n: t(rng.randn(n).astype(np.float32))
    P.attn_section_v1(x, torch.ones(1, N), vec(c), vec(c), wqkv_v, vec(3 * c), wproj_v, vec(c),
                      torch.zeros(1, nh, N, N), nh, group=group)
    args = recorded.calls["segland_attn_section_v1"]
    scratch, ysc = args[13], args[14]
    if P.v1_plan(c, group)["scratch"]:
        assert scratch.shape == (nw, N, 3 * c) and scratch.dtype == torch.bfloat16
    else:
        assert scratch is None
    if c == 1536:
        assert ysc.shape == (2 * nw * 64, c) and ysc.dtype == torch.bfloat16
    else:
        assert ysc is None
    assert args[8].data_ptr() == wqkv.data_ptr() and args[10].data_ptr() == wproj.data_ptr()
    assert args[16:20] == (nw, c, nh, group) and P.attn_section_v1.launches == 1


def test_kernel_outputs_compare_flags_any_difference(tmp_path, capsys):
    """The builds' fingerprint (benchmarks/kernel_outputs.py): ``compare``
    passes equal files and fails on one differing element or a missing tensor;
    ``save`` refuses a device without the kernels."""
    from segland_tpu_torch.benchmarks import kernel_outputs

    a = {"K1 bfloat16 C=96": torch.arange(6.0).to(torch.bfloat16), "K3": torch.zeros(2, 3)}
    b = {**a, "K3": torch.tensor([[0.0, 0.0, 0.0], [0.0, 1e-7, 0.0]])}
    for name, t_ in (("a", a), ("b", b), ("c", {"K3": a["K3"]})):
        torch.save(t_, tmp_path / f"{name}.pt")
    run = lambda x, y: kernel_outputs.main(["compare", str(tmp_path / x), str(tmp_path / y)])
    assert run("a.pt", "a.pt") == 0
    assert run("a.pt", "b.pt") == 1 and "1 of 2 tensors differ" in capsys.readouterr().out
    assert run("a.pt", "c.pt") == 1
    assert kernel_outputs.main(["save", str(tmp_path / "d.pt"), "--device", "cpu"]) == 2
