"""The head-grouped attention sections of the head-group probe (port:
segland_tpu_torch/ops/hg_attn.py and benchmarks/swin_attn_hg.py) against the
JAX probe's kernels, benchmarks/swin_attn_hg.py:hg_section and hg2_section,
run in interpret mode on the CPU.  The geometry (pad masks, shift regions) is
the JAX probe's make_inputs at a 26x26 map; weights, biases and windows are
numpy draws handed to both packages (nonzero biases, so the pad keys of the
softmax ablation carry a value)."""

import contextlib
import ctypes
import ctypes.util
import pathlib
import re
import sys
import warnings

import numpy as np
import pytest
import torch

from torch_helpers import t, win_blocks, win_kernel_env, win_stream, win_takes
from segland_tpu_torch.ops import hg_attn as H

ROOT = pathlib.Path(__file__).resolve().parents[1]


_LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
_FE_TONEAREST = 0  # <fenv.h> on x86-64 and aarch64


@contextlib.contextmanager
def _to_nearest(found):
    """The block runs with the calling thread rounding to nearest; the mode it
    found there is appended to ``found`` and restored after.  The fp32 cases
    hold two summation orders to 2e-5, and a thread left rounding down, up or
    toward zero moves the plain version by 1e-5 in the windows that thread
    computes (ROADMAP C3)."""
    mode = _LIBM.fegetround()
    found.append(mode)
    _LIBM.fesetround(_FE_TONEAREST)
    try:
        yield
    finally:
        _LIBM.fesetround(mode)


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


def _compare(got, want, atol, rtol, rows=None, note=""):
    got, want = got.float().numpy(), np.asarray(want).astype(np.float32)
    if rows is not None:
        got, want = got[rows], want[rows]
    d = np.abs(got - want)
    assert (d <= atol + rtol * np.abs(want)).all(), f"{float(d.max())}{note}"


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("stage,hg", [("stage0", 1), ("stage0", 3), ("stage2", 2), ("stage2", 4),
                                      ("stage2", 6)])
def test_plain_versions_match_the_jax_kernels(jhg, stage, hg, shift):
    """fp32 at the probe's own bar, 2e-5: both sections, every head group of
    the JAX check; on the CPU no kernel is launched.  Each plain version runs
    rounding to nearest; the mode that its thread was left in is reported on a
    failure, and a warning names any other than to-nearest (ROADMAP C3)."""
    j, p, tab, nh, geom = _inputs(jhg, stage, torch.float32, 1)
    mask = tab["mask1"] if shift else tab["mask0"]
    reg = tab["regions"] if shift else None
    launches = (H.hg_section.launches, H.hg2_section.launches)
    found = []
    note = lambda: f" (rounding modes found before the plain versions: {found})"
    with _to_nearest(found):
        got1 = H.hg_section(p["x"], t(mask), None if reg is None else t(reg), *_w(p, nh),
                            wblk=8, hg=hg)
    want1 = jhg.hg_section(j["x"], mask, reg, *_w(j, nh), wblk=8, hg=hg, interpret=True)
    with _to_nearest(found):
        got2 = H.hg2_section(p["x"], geom + (shift,), *_w(p, nh), wblk=8, hg=hg)
    want2 = jhg.hg2_section(j["x"], geom + (shift,), *_w(j, nh), wblk=8, hg=hg, interpret=True)
    if any(m != _FE_TONEAREST for m in found):
        warnings.warn("ROADMAP C3: a plain version's thread was left rounding other than to "
                      f"nearest{note()}")
    _compare(got1, want1, 2e-5, 0.0, note=note())
    _compare(got2, want2, 2e-5, 0.0, note=note())
    assert (H.hg_section.launches, H.hg2_section.launches) == launches


@pytest.mark.parametrize("mode", [0x400, 0x800, 0xC00])  # FE_DOWNWARD, FE_UPWARD, FE_TOWARDZERO
def test_the_calling_threads_rounding_mode_moves_the_fp32_plain_version(jhg, mode):
    """ROADMAP C3: a calling thread left rounding other than to nearest moves
    the fp32 plain version by about 1e-5 in the windows that thread computes,
    five times the distance between the two packages under round-to-nearest,
    and past 2e-6 in at least one window: what _to_nearest pins."""
    j, p, tab, nh, _ = _inputs(jhg, "stage0", torch.float32, 1)
    mask = t(tab["mask0"])
    want = np.asarray(jhg.hg_section(j["x"], tab["mask0"], None, *_w(j, nh), wblk=8, hg=1,
                                     interpret=True))
    with _to_nearest([]):
        near = H.hg_section(p["x"], mask, None, *_w(p, nh), wblk=8, hg=1).numpy()
    _LIBM.fesetround(mode)
    try:
        moved = H.hg_section(p["x"], mask, None, *_w(p, nh), wblk=8, hg=1).numpy()
    finally:
        _LIBM.fesetround(_FE_TONEAREST)
    by_window = np.abs(moved - near).max(axis=(1, 2))
    print(f"mode {mode:#x}: by window {np.round(by_window, 7).tolist()}; "
          f"port vs JAX under round-to-nearest {float(np.abs(near - want).max()):.3g}")
    assert float(np.abs(near - want).max()) <= 2e-6
    assert float(by_window.max()) >= 5 * float(np.abs(near - want).max())
    assert float(by_window.max()) > 2e-6


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


@pytest.mark.parametrize("kernel,c,nh,hg,dtype,wblk,ablate,match", [
    ("K10", 384, 12, 5, torch.bfloat16, 32, "none", "does not divide"),
    ("K10", 384, 12, 4, torch.float16, 32, "none", "bfloat16 and float32"),
    ("K10", 1536, 48, 4, torch.float32, 32, "none",
     r"no float32 build for C=1536: one window needs .* = 377,860 B > 232,448"),
    ("K10", 384, 12, 4, torch.bfloat16, 0, "none", "wblk"),
    ("K10", 384, 12, 4, torch.bfloat16, 32, "build", "block-diagonal"),
    # the new body's arithmetic (section_win.cuh's layout, as K9's), under the old ids
    pytest.param("K10", 384, 12, 6, torch.bfloat16, 32, "none",
                 r"hg2_section has no build for C=384 hg=6: one window a pass needs .* = "
                 r"181,792 B \(<= 232,448\) and 24 accumulator registers a thread \(of 96\); "
                 r"built at \(C, hg\) in .*\(768, 4\)\] only$",
                 id="K10-384-12-6-dtype5-32-none-no build for C=384 hg=6: .* = 240,512 B > "
                    "232,448"),
    pytest.param("K10", 768, 24, 8, torch.bfloat16, 32, "none",
                 r"hg2_section has no build for C=768 hg=8: one window a pass needs ring 24,576 "
                 r"\+ y 98,304 \+ qkv 98,304 \+ bias 43,904 \+ tokens 256 \+ barriers 32 \+ "
                 r"align 1,024 = 266,400 B \(> 232,448\) and 24 accumulator registers a thread "
                 r"\(of 96\)$",
                 id="K10-768-24-8-dtype6-32-none-no build for C=768 hg=8"),
    ("K9", 384, 12, 5, torch.bfloat16, 32, None, "does not divide"),
    ("K9", 384, 12, 4, torch.float16, 32, None, "bfloat16 and float32"),
    ("K9", 1536, 48, 4, torch.float32, 32, None,
     r"no float32 build for C=1536: one window needs .* = 377,860 B > 232,448"),
    ("K9", 384, 12, 4, torch.bfloat16, 0, None, "wblk"),
    ("K9", 384, 12, 3, torch.bfloat16, 32, None,
     r"hg_section has no build for C=384 hg=3: one window a pass needs .* = 128,416 B "
     r"\(<= 232,448\) and 24 accumulator registers a thread \(of 96\); built at \(C, hg\) in "
     r".*\(384, 4\)"),
    ("K9", 768, 24, 8, torch.bfloat16, 32, None,
     r"hg_section has no build for C=768 hg=8: one window a pass needs ring 24,576 \+ "
     r"y 98,304 \+ qkv 98,304 \+ bias 43,904 \+ tokens 256 \+ barriers 32 \+ align 1,024 = "
     r"266,400 B \(> 232,448\) and 24 accumulator registers a thread \(of 96\)$"),
    ("K10", 192, 6, 2, torch.bfloat16, 32, "attn",
     r"hg2_section builds ablate='attn' at \(C, hg\) in .* only \(hg = 1 and the default hg\), "
     r"not C=192 hg=2"),
])
def test_host_checks_raise(kernel, c, nh, hg, dtype, wblk, ablate, match):
    with pytest.raises(ValueError, match=match):
        if kernel == "K9":
            H.check_hg_sm90_build(c, nh, hg, dtype, wblk)
        else:
            H.check_hg_build(c, nh, hg, dtype, wblk, ablate)


@pytest.mark.parametrize("c,hg", [(96, 3), (384, 6), (768, 8)])
def test_fp32_is_accepted_at_every_built_width(c, hg):
    """fp32 goes to the fp32 body, which takes any hg and every ablation at
    C = 96..768, pairs that have no bf16 build included."""
    for ablate in H.ABLATIONS:
        assert H.check_hg_build(c, c // 32, hg, torch.float32, 32, ablate) is None


@pytest.mark.parametrize("kernel", ["K10", "K9"])
def test_builds_match_the_source_and_fit(kernel):
    """The CUDA sources instantiate exactly HG2_BUILDS and HG2_MODE_BUILDS (K10,
    attn_section_hg2_sm90.cu: its mode-none builds in the parts they name, the
    mode and measurement builds of a pair in the part its modes row names) and
    HG_SM90_BUILDS (K9, attn_section_hg_sm90.cu: its served builds in the parts
    they name, their measurement builds in as many parts again); each fits the
    block's shared memory and the register budget; hg = 1 and the JAX
    package's production head group are built at every swin-s width, for K10
    in every mode."""
    from segland_tpu_torch import kernels

    name = "attn_section_hg2_sm90.cu" if kernel == "K10" else "attn_section_hg_sm90.cu"
    src = ROOT / "segland_tpu_torch/kernels/csrc" / name
    text = src.read_text()
    rows = re.findall(r"^\s*X\((\d+), (\d+), (\d+), (\d+), (\d+)\)", text, re.M)
    built = {(int(r[1]), int(r[2])): H.HgSm90Build(int(r[3]), int(r[4])) for r in rows}
    served = sorted({int(r[0]) for r in rows})
    # each part is compiled by a process of its own and instantiates some builds
    parts = [flags for s, flags in kernels.compile_units() if s == src]
    if kernel == "K10":
        modes = re.findall(r"^\s*X\((\d+), (\d+), (\d+)\)\s*\\?$", text, re.M)
        assert built == H.HG2_BUILDS
        assert {(int(m[1]), int(m[2])) for m in modes} == H.HG2_MODE_BUILDS
        assert len(modes) == len(H.HG2_MODE_BUILDS) and H.HG2_MODE_BUILDS <= set(built)
        mode_parts = sorted({int(m[0]) for m in modes})
        assert served + mode_parts == list(range(len(parts)))
    else:
        assert built == H.HG_SM90_BUILDS
        assert served == list(range(len(parts) // 2))
    for (c, hg), b in built.items():
        lay = H.hg_sm90_layout(c, hg, b)
        assert lay["smem"] <= H.SMEM_MAX and lay["acc"] <= H.MAX_ACC_REGS, (c, hg, lay)
        if kernel == "K10":
            assert H.check_hg_build(c, c // 32, hg, torch.bfloat16, 32) == b
        else:
            assert H.check_hg_sm90_build(c, c // 32, hg, torch.bfloat16, 32) == b
    for c, nh in ((96, 3), (192, 6), (384, 12), (768, 24)):
        assert (c, 1) in built and (c, H.V2_HG[nh]) in built
        if kernel == "K10":
            assert {(c, 1), (c, H.V2_HG[nh])} <= H.HG2_MODE_BUILDS
            for ab in H.ABLATIONS:
                assert H.check_hg_build(c, nh, H.V2_HG[nh], torch.bfloat16, 32, ab) is not None


_STAGE_SIDES = [(96, 259), (192, 133), (384, 70), (768, 35)]


@pytest.mark.parametrize("c,side,kernel", [pytest.param(c, side, "K9", id=f"{c}-{side}")
                                           for c, side in _STAGE_SIDES]
                         + [pytest.param(c, side, "K10", id=f"K10-{c}-{side}")
                            for c, side in _STAGE_SIDES])
def test_pass_schedule_covers_each_window_once(c, side, kernel):
    """A host replay of the schedule of K9's and K10's kernel (section_hg.cuh's
    hg_kernel) at a swin-s stage of a batch of 8, every built hg, read from
    the sources (torch_helpers' C-source replay: the launcher's grid,
    section_win.cuh's win_passes, the kernel's pass loop, the plan structs): a
    block owns wblk windows (the last block what is left), walked W at a time
    (the last pass what is left); every window is in exactly one pass, and in
    every mode with a ring (K9: none; K10: none and, at the pairs of
    HG2_MODE_BUILDS, io, attn and softmax) the stream (HgItems' PASS) fills as
    many ring slots a pass as each consumer warpgroup takes (its
    section_product calls times the loops and guards around them), as
    ring_pass_end checks on the card."""
    from torch_helpers import c_enums, csrc

    src = "section_hg.cuh"
    modes = c_enums(csrc(src))
    assert [modes[k] for k in ("kHgNone", "kHgIoRaw", "kHgIo", "kHgAttn", "kHgSoftmax")] == \
        list(range(len(H.ABLATIONS)))
    nw = 8 * (side // 7) ** 2
    builds = H.HG_SM90_BUILDS if kernel == "K9" else H.HG2_BUILDS
    for (cc, hg), b in builds.items():
        if cc != c:
            continue
        for wblk in (32, 7, b.w):
            blocks = win_blocks(src, "hg_kernel", nw, wblk, b.w)
            seen = [w0 + i for passes in blocks for w0, n in passes for i in range(n)]
            assert seen == list(range(nw)), (hg, wblk)
            assert all(0 < n <= b.w for passes in blocks for _, n in passes)
        ringed = ["none"] + (["io", "attn", "softmax"] if kernel == "K10"
                             and (c, hg) in H.HG2_MODE_BUILDS else [])
        for ab in ringed:
            for g in (0, 1):
                env = win_kernel_env(src, "hg_kernel", "HgPlan", (c, hg, b.w, b.s),
                                     MODE=H.ABLATIONS.index(ab), g=g)
                stream = win_stream(src, "HgItems", env)
                assert stream == win_takes(src, "hg_kernel", env) > 0, (hg, ab, g)


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
