"""Port's eval epilogue (segland_tpu_torch/ops/fused_epilogue.py): the plain
version against the JAX Pallas kernel in interpret mode and an fp64 numpy
oracle, and the CUDA kernel's arithmetic (host tables + 4-tap lerp, rows
then columns, each lerp fma(hi, w, lo * (1 - w)) rounded as the card rounds
it, first max wins) replayed in torch against the same oracle.
Classes may differ only where the oracle's top-2 gap is <= 1e-3.  K2's plan
(tile, patch, class passes) is checked to cover every tap of its tiles and to
fit its shared-memory budget, and a tile-by-tile replay of K2's order (patch,
row lerps into a strip, column lerps over a 3-column window) equals the 4-tap
replay bit for bit."""

import pathlib
import re
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import t
from segland_tpu.ops.fused_epilogue import upsample_argmax as j_upsample_argmax
from segland_tpu.ops.resize import _interp_matrix
from segland_tpu_torch.ops import fused_epilogue as FE
from segland_tpu_torch.ops.fused_epilogue import upsample_argmax, upsample_argmax_reference
from segland_tpu_torch.ops.resize import linear_table, resize_bilinear

K2_SOURCE = (pathlib.Path(__file__).resolve().parents[1]
             / "segland_tpu_torch/kernels/csrc/upsample_argmax.cu")

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


def _fma(a, b, c):
    """fp32 fma(a, b, c) with one rounding, as __fmaf_rn gives it: a * b is exact
    in float64, two-sum recovers the float64 sum's rounding error e exactly, and
    a sum that lies on the midpoint of two fp32 values goes the way e points."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    z = s - p
    e = (p - (s - z)) + (c - z)  # p + c == s + e exactly
    r = s.float()
    d = s - r.double()
    o = torch.nextafter(r, torch.where(d > 0, torch.inf, -torch.inf).float())
    tie = (d != 0) & (2 * d.abs() == (o.double() - r.double()).abs())
    return torch.where(tie & (e * d > 0), o, r)


def _lerp(lo, hi, w):
    """The kernel's lerp: fma(hi, w, lo * (1 - w)), all fp32."""
    return _fma(hi, w, lo * (1 - w))


def _kernel_upsample(logits, oh, ow):
    """The upsampled logits in the arithmetic of kernels/csrc/upsample_argmax.cu,
    torch fp32: per output pixel, rows first, then columns, each by _lerp."""
    x = t(logits)
    rlo, rhi, rw = map(t, linear_table(x.shape[1], oh, True))
    clo, chi, cw = map(t, linear_table(x.shape[2], ow, True))
    a = lambda r, c: x[:, r.long()][:, :, c.long()]
    wy, wx = rw[None, :, None, None], cw[None, None, :, None]
    left = _lerp(a(rlo, clo), a(rhi, clo), wy)
    right = _lerp(a(rlo, chi), a(rhi, chi), wy)
    return _lerp(left, right, wx)


def _kernel_replay(logits, oh, ow):
    """The arithmetic of kernels/csrc/upsample_argmax.cu in torch fp32."""
    return _kernel_upsample(logits, oh, ow).argmax(-1).to(torch.uint8).numpy()


def _tiled_replay(logits, oh, ow):
    """K2's order, tile by tile and pass by pass as upsample_plan cuts the work:
    the tile's source patch; its row lerps into a strip (each output row and
    patch column once); the column lerps of each thread's 4 pixels, over the 3
    strip columns from its first pixel's left one with weights (1 - wx, wx, 0)
    placed by column where its pixels span at most 3, else from each pixel's two
    columns, in the kernel's fmas; the running argmax, replaced only by a
    strictly greater value.  Returns the class map and the winning values."""
    x = t(logits)
    nb, h, w, k = x.shape
    plan = FE.upsample_plan(h, w, k, oh, ow)
    rlo, rhi, rw = linear_table(h, oh, True)
    clo, chi, cw = linear_table(w, ow, True)
    tx, ty, kc = FE.PIXELS * plan["txt"], plan["ty"] * plan["groups"], plan["kc"]
    classes = torch.zeros((nb, oh, ow), dtype=torch.long)
    values = torch.zeros((nb, oh, ow))
    for yt in range(0, oh, ty):
        ys = np.arange(yt, min(yt + ty, oh))
        r0, nr = rlo[ys[0]], rhi[ys[-1]] - rlo[ys[0]] + 1
        assert nr <= plan["prows"]
        wy = t(rw[ys])[:, None, None]
        for xt in range(0, ow, tx):
            xs = np.arange(xt, min(xt + tx, ow))
            c0, nc = clo[xs[0]], chi[xs[-1]] - clo[xs[0]] + 1
            assert nc <= plan["pcols"]
            lo, hi, wx = clo[xs] - c0, chi[xs] - c0, cw[xs]
            first = lo[(np.arange(len(xs)) // FE.PIXELS) * FE.PIXELS]  # the thread's cb
            last = hi[np.minimum((np.arange(len(xs)) // FE.PIXELS + 1) * FE.PIXELS,
                                 len(xs)) - 1]
            win = t(last - first < 3)[None, :, None]
            l, r = (1 - wx).astype(np.float32), wx
            weights = [t(np.where(lo == first + i, l, np.float32(0))
                         + np.where(hi == first + i, r, np.float32(0)))[None, :, None]
                       for i in range(3)]
            cols = [t(np.minimum(first + i, nc - 1)).long() for i in range(3)]
            best = torch.full((nb, len(ys), len(xs)), -np.inf)
            arg = torch.zeros((nb, len(ys), len(xs)), dtype=torch.long)
            for k0 in range(0, k, kc):
                patch = x[:, r0:r0 + nr, c0:c0 + nc, k0:k0 + kc]
                strip = _lerp(patch[:, t(rlo[ys] - r0).long()],
                              patch[:, t(rhi[ys] - r0).long()], wy)
                a0, a1, a2 = (strip[:, :, c] for c in cols)
                v_win = _fma(a2, weights[2], _fma(a1, weights[1], a0 * weights[0]))
                v_dir = _lerp(strip[:, :, t(lo).long()], strip[:, :, t(hi).long()],
                              t(wx)[None, :, None])
                v = torch.where(win, v_win, v_dir)
                for j in range(v.shape[-1]):
                    up = v[..., j] > best
                    best = torch.where(up, v[..., j], best)
                    arg = torch.where(up, torch.full_like(arg, k0 + j), arg)
            classes[:, ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1] = arg
            values[:, ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1] = best
    return classes.to(torch.uint8).numpy(), values


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


def _round_f32(q):
    """The fp32 value nearest the rational q, ties to even."""
    r = np.float32(float(q))
    near = [np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf))]
    dist = [abs(Fraction(float(v)) - q) for v in near]
    best = [v for v, d in zip(near, dist) if d == min(dist)]
    return best[0] if len(best) == 1 else next(v for v in best if v.view(np.int32) % 2 == 0)


def test_fma_replay_rounds_once():
    """_fma is a * b + c rounded once to fp32, as the card's fma rounds it: on
    random triples, with cancellation, and where the float64 sum falls on an fp32
    midpoint that the exact sum misses (1 + 2^-23 + (1 + 2^-15)(1 - 2^-15) 2^-24
    rounds down to 1 + 2^-23; rounding through float64 gives 1 + 2^-22)."""
    rs = np.random.RandomState(3)
    a, b = (rs.randn(3000).astype(np.float32) for _ in range(2))
    c = np.where(rs.rand(3000) < 0.5, -(a * b), rs.randn(3000)).astype(np.float32)
    tie = np.float32([1 + 2 ** -15, 1 - 2 ** -15, 1 + 2 ** -23])
    a, b, c = (np.append(v, x * (2 ** -24 if i == 1 else 1))
               for i, (v, x) in enumerate(zip((a, b, c), tie)))
    got = _fma(t(a), t(b), t(c)).numpy()
    want = np.float32([_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                       for x, y, z in zip(a, b, c)])
    assert got[-1] == np.float32(1 + 2 ** -23)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


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


# K2's plan at the serving shape (K = 8, eval_ft's 12, the uint8 limit 255), the
# test shapes above, and downsampling; the tables depend on (h, w) -> (oh, ow) only
PLAN_SHAPES = [((256, 256, 8), (1024, 1024)), ((256, 256, 12), (1024, 1024)),
               ((256, 256, 255), (1024, 1024))] + [
    (s[1:], o) for s, o in SHAPES + [((2, 7, 9, 4), (30, 17))]] + [
    ((1024, 1024, 8), (256, 256)), ((1024, 1024, 255), (100, 60)), ((40, 52, 6), (9, 13))]


def test_plan_constants_match_the_source():
    src = K2_SOURCE.read_text()
    for name, val in (("kThreads", FE.THREADS), ("kPx", FE.PIXELS),
                      ("kSmemBudget", FE.SMEM_BUDGET)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == val


@pytest.mark.parametrize("hwk,out_hw", PLAN_SHAPES, ids=lambda v: "x".join(map(str, v)))
def test_plan_patch_covers_every_tap_and_fits(hwk, out_hw):
    """Every output pixel's four taps lie in its tile's patch of prows x pcols,
    every class is in one pass, and patch + strip fit the budget."""
    h, w, k = hwk
    oh, ow = out_hw
    plan = FE.upsample_plan(h, w, k, oh, ow)
    threads = plan["txt"] * plan["ty"]
    assert threads % 32 == 0 and threads <= FE.THREADS
    assert plan["smem"] <= FE.SMEM_BUDGET
    assert plan["smem"] == FE.plan_layout(plan["txt"], plan["ty"], plan["groups"], plan["kc"],
                                          plan["prows"], plan["pcols"])["smem"]
    kc = plan["kc"]
    assert kc == k or (kc % 4 == 0 or kc < 4) and plan["groups"] == 1
    assert (plan["passes"] - 1) * kc < k <= plan["passes"] * kc
    for lo, hi, n, tile, room in (
            (*linear_table(h, oh, True)[:2], oh, plan["ty"] * plan["groups"], plan["prows"]),
            (*linear_table(w, ow, True)[:2], ow, FE.PIXELS * plan["txt"], plan["pcols"])):
        for s0 in range(0, n, tile):
            first = lo[s0]
            taps = np.concatenate([lo[s0:s0 + tile], hi[s0:s0 + tile]])
            assert taps.min() >= first and taps.max() < first + room
    if (h, w, k, oh, ow) == (256, 256, 8, 1024, 1024):  # the serving shape: one pass, 128 x 32
        assert (plan["txt"], plan["ty"], plan["groups"], plan["passes"]) == (32, 8, 4, 1)


@pytest.mark.parametrize("shape,out_hw", SHAPES + [
    ((2, 7, 9, 4), (30, 17)), ((1, 12, 10, 255), (40, 37)), ((1, 40, 52, 6), (9, 13))],
    ids=lambda v: "x".join(map(str, v)))
def test_tiled_replay_is_the_kernel_arithmetic(shape, out_hw):
    """K2's tiles, passes, strip and 3-column window give the 4-tap replay's
    values and classes bit for bit, and the fp64 oracle's classes wherever its
    top-2 gap exceeds 1e-3.  The shapes take one pass and several (K = 255),
    the window and, downsampling, each pixel's own two columns."""
    logits = _logits(shape)
    classes, values = _tiled_replay(logits, *out_hw)
    want = _kernel_upsample(logits, *out_hw)
    assert torch.equal(values, want.max(-1).values)
    np.testing.assert_array_equal(classes, _kernel_replay(logits, *out_hw))
    ref, gap = _np_ref(logits, *out_hw)
    assert ((classes == ref) | (gap <= 1e-3)).all()
