"""The head-grouped attention sections of the head-group probe (port:
segland_tpu_torch/ops/hg_attn.py and benchmarks/swin_attn_hg.py) against the
JAX probe's kernels, benchmarks/swin_attn_hg.py:hg_section and hg2_section,
run in interpret mode on the CPU.  The geometry (pad masks, shift regions) is
the JAX probe's make_inputs at a 26x26 map; weights, biases and windows are
numpy draws handed to both packages (nonzero biases, so the pad keys of the
softmax ablation carry a value)."""

import pathlib
import re
import sys

import numpy as np
import pytest
import torch

from torch_helpers import t
from segland_tpu_torch.ops import hg_attn as H

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jhg():
    sys.path.insert(0, str(ROOT))
    from benchmarks import swin_attn_hg

    return swin_attn_hg


def _inputs(jhg, stage, dtype, seed):
    """numpy draws for both packages at the JAX probe's geometry."""
    import jax.numpy as jnp

    geo = jhg.make_inputs(stage, 1, dt=jnp.float32, h_override=26)
    c, nh = geo["c"], geo["nh"]
    nw = geo["wins"].shape[0]
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    a = dict(x=f(nw, 49, c), gamma=1.0 + 0.1 * f(c), beta=0.1 * f(c),
             wqkv=f(c, 3 * c) / np.sqrt(c), bqkv=0.1 * f(3 * c), wproj=f(c, c) / np.sqrt(c),
             bproj=0.1 * f(c), bias=f(1, nh, 49, 49))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    cast = ("x", "wqkv", "wproj", "bias")
    j = {k: jnp.asarray(v).astype(jdt) if k in cast else jnp.asarray(v) for k, v in a.items()}
    p = {k: t(v).to(dtype) if k in cast else t(v) for k, v in a.items()}
    tables = {k: np.asarray(geo[k]) for k in ("mask0", "mask1", "regions")}
    return j, p, tables, nh, tuple(int(v) for v in geo["geom"])


def _w(d, nh):
    return (d["gamma"], d["beta"], d["wqkv"], d["bqkv"], d["wproj"], d["bproj"], d["bias"], nh)


def _compare(got, want, atol, rtol, rows=None):
    got, want = got.float().numpy(), np.asarray(want).astype(np.float32)
    if rows is not None:
        got, want = got[rows], want[rows]
    d = np.abs(got - want)
    assert (d <= atol + rtol * np.abs(want)).all(), float(d.max())


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("stage,hg", [("stage0", 1), ("stage0", 3), ("stage2", 2), ("stage2", 4),
                                      ("stage2", 6)])
def test_plain_versions_match_the_jax_kernels(jhg, stage, hg, shift):
    """fp32 at the probe's own bar, 2e-5: both sections, every head group of
    the JAX check; on the CPU no kernel is launched."""
    j, p, tab, nh, geom = _inputs(jhg, stage, torch.float32, 1)
    mask = tab["mask1"] if shift else tab["mask0"]
    reg = tab["regions"] if shift else None
    launches = (H.hg_section.launches, H.hg2_section.launches)
    got1 = H.hg_section(p["x"], t(mask), None if reg is None else t(reg), *_w(p, nh), wblk=8,
                        hg=hg)
    want1 = jhg.hg_section(j["x"], mask, reg, *_w(j, nh), wblk=8, hg=hg, interpret=True)
    _compare(got1, want1, 2e-5, 0.0)
    got2 = H.hg2_section(p["x"], geom + (shift,), *_w(p, nh), wblk=8, hg=hg)
    want2 = jhg.hg2_section(j["x"], geom + (shift,), *_w(j, nh), wblk=8, hg=hg, interpret=True)
    _compare(got2, want2, 2e-5, 0.0)
    assert (H.hg_section.launches, H.hg2_section.launches) == launches


def test_bf16_scores_match_the_jax_kernels(jhg):
    """bf16 with score_f32=False (q * scale rounded to bf16 before the
    product), both sections, at the kernels' bf16 bar."""
    j, p, tab, nh, geom = _inputs(jhg, "stage0", torch.bfloat16, 2)
    kw = dict(wblk=16, hg=3, score_f32=False)
    got1 = H.hg_section(p["x"], t(tab["mask1"]), t(tab["regions"]), *_w(p, nh), **kw)
    want1 = jhg.hg_section(j["x"], tab["mask1"], tab["regions"], *_w(j, nh), interpret=True, **kw)
    _compare(got1, want1, 2e-2, 1e-2)
    got2 = H.hg2_section(p["x"], geom + (3,), *_w(p, nh), **kw)
    want2 = jhg.hg2_section(j["x"], geom + (3,), *_w(j, nh), interpret=True, **kw)
    _compare(got2, want2, 2e-2, 1e-2)


@pytest.mark.parametrize("ablate", ["ioraw", "io", "attn", "softmax", "build"])
def test_ablations_match_the_jax_modes(jhg, ablate):
    """Each ablation against the JAX body's same mode (``build``, per-head PV
    in place of the block-diagonal V, against the port's ``none``: the port
    builds no block-diagonal V).  softmax is held on the rows whose every
    per-head sum has |s| > 0.05; with the pad keys in the sums that is every
    row."""
    j, p, tab, nh, geom = _inputs(jhg, "stage0", torch.float32, 3)
    sums = []
    port_mode = "none" if ablate == "build" else ablate
    got = H.hg2_section_reference(p["x"], geom + (3,), *_w(p, nh), hg=3, ablate=port_mode,
                                  sums=sums if ablate == "softmax" else None)
    want = jhg.hg2_section(j["x"], geom + (3,), *_w(j, nh), wblk=16, hg=3, ablate=ablate,
                           interpret=True)
    rows = None
    if ablate == "softmax":
        rows = (sums[0].abs() > 0.05).all(-1).numpy()
        assert rows.all()
    _compare(got, want, 2e-5, 0.0, rows)


def test_probe_check_passes():
    from segland_tpu_torch.benchmarks import swin_attn_hg

    swin_attn_hg.check()


def test_probe_main_on_the_cpu():
    from segland_tpu_torch.benchmarks import swin_attn_hg

    rows = swin_attn_hg.main(["stage1", "1", "1-2-8,2-6-16-bf16,2-3-8-absoftmax", "--device",
                              "cpu", "--iters", "1"])
    assert [r["spec"] for r in rows] == ["1-2-8", "2-6-16-bf16", "2-3-8-absoftmax"]
    assert [(r["ver"], r["hg"], r["wblk"], r["score_f32"], r["ablate"]) for r in rows] == [
        (1, 2, 8, True, "none"), (2, 6, 16, False, "none"), (2, 3, 8, True, "softmax")]
    assert all(r["ms"] > 0 for r in rows)


@pytest.mark.parametrize("argv,match", [
    (["stage0", "1", "2-3-32-par"], "TPU compiler parameter"),
    (["stage0", "1", "2-3-32-vm64"], "VMEM"),
    (["stage0", "1", "2-3-32-flat"], "flat"),
    (["stage0", "1", "2-3-32-abbuild"], "block-diagonal"),
    (["stage0", "1", "2-3-32", "prepad"], "128-lane"),
    (["stage0p", "1"], "128-lane"),
    (["stage1p", "1"], "128-lane"),
    (["stage0", "1", "1-3-32-abio"], "no ablations"),
])
def test_tpu_layout_devices_raise(argv, match):
    from segland_tpu_torch.benchmarks import swin_attn_hg

    with pytest.raises(ValueError, match=match):
        swin_attn_hg.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("c,nh,hg,dtype,wblk,ablate,match", [
    (384, 12, 5, torch.bfloat16, 32, "none", "does not divide"),
    (384, 12, 4, torch.float32, 32, "none", "bfloat16 only"),
    (384, 12, 4, torch.bfloat16, 0, "none", "wblk"),
    (384, 12, 4, torch.bfloat16, 32, "build", "block-diagonal"),
    (384, 12, 6, torch.bfloat16, 32, "none", r"no build for C=384 hg=6: .* = 240,512 B > 232,448"),
    (768, 24, 8, torch.bfloat16, 32, "none", "no build for C=768 hg=8"),
])
def test_host_checks_raise(c, nh, hg, dtype, wblk, ablate, match):
    with pytest.raises(ValueError, match=match):
        H.check_hg_build(c, nh, hg, dtype, wblk, ablate)


def test_builds_match_the_source_and_fit():
    """The CUDA source instantiates exactly HG_BUILDS; each fits the block's
    shared memory and the register budget; hg = 1 and the JAX package's
    production head group are built at every swin-s width."""
    from segland_tpu_torch import kernels

    src = (ROOT / "segland_tpu_torch/kernels/csrc/attn_section_hg.cu")
    rows = re.findall(r"^\s*X\((\d+), (\d+), (\d+), (\d+), (\d+), (\d+), (\d+), (true|false), "
                      r"(true|false)\)", src.read_text(), re.M)
    built = {(int(r[1]), int(r[2])): H.HgBuild(*map(int, r[3:7]), r[7] == "true", r[8] == "true")
             for r in rows}
    assert built == H.HG_BUILDS
    # each part is compiled by a process of its own and instantiates some builds
    parts = [flags for s, flags in kernels.compile_units() if s == src]
    assert sorted({int(r[0]) for r in rows}) == list(range(len(parts)))
    for (c, hg), b in built.items():
        lay = H.hg_layout(c, hg, b)
        assert lay["smem"] <= H.SMEM_MAX and lay["frags"] <= H.MAX_FRAGS, (c, hg, lay)
        assert H.check_hg_build(c, c // 32, hg, torch.bfloat16, 32) == b
    for c, nh in ((96, 3), (192, 6), (384, 12), (768, 24)):
        assert (c, 1) in built and (c, H.V2_HG[nh]) in built


def test_window_tables_agree_with_the_section_kernel_masks():
    """hg2's host tables over the 49 real tokens equal fused_attn.window_masks
    (the arithmetic of K3), and every pad token is invalid."""
    from segland_tpu_torch.ops.fused_attn import window_masks

    for geom in ((26, 26, 28, 28, 7, 3), (64, 64, 70, 70, 7, 0), (30, 20, 35, 21, 7, 3)):
        nw = 2 * (geom[2] // 7) * (geom[3] // 7)
        valid, rid = H.window_tables(nw, 64, geom)
        v, r = window_masks(nw, geom)
        np.testing.assert_array_equal(valid[:, :49], v)
        np.testing.assert_array_equal(rid[:, :49] if geom[5] else 0 * rid[:, :49], r)
        assert not valid[:, 49:].any()
