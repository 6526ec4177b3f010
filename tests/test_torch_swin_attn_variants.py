"""The variants probe's section (port: segland_tpu_torch/ops/section_variants.py
and benchmarks/swin_attn_variants.py) against the JAX probe's kernel,
benchmarks/swin_attn_variants.py:section, run in interpret mode on the CPU:
the JAX wrapper hardcodes ``interpret=False``, so the module fixture hands it
a ``pl`` whose ``pallas_call`` forces interpret mode, and puts the real one
back after this module's tests.  The geometry (pad masks, shift regions) is
the JAX head-group probe's make_inputs; weights, biases and windows are numpy
draws handed to both packages (nonzero biases, so the pad keys of the softmax
ablation carry a value).

Tolerances: fp32 5e-5, except the softmax ablation, whose output reaches
2e6 (|d| <= 5e-5 of its largest |ref|: fp32 resolves 0.25 there), and
bf16sm, which rounds s - max and its sum to bf16, so that a last-bit
difference in s flips a bf16 rounding (the bf16 bar); bf16 2e-2 + 1e-2*|ref|
in every mode."""

import pathlib
import re
import sys
import types

import numpy as np
import pytest
import torch

from torch_helpers import (c_block, c_enums, csrc, t, win_blocks, win_kernel_env, win_stream,
                           win_takes)
from segland_tpu_torch.ops import section_variants as S

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jprobe():
    """(the JAX variants probe with its pallas_call in interpret mode, the
    JAX head-group probe for its make_inputs)."""
    sys.path.insert(0, str(ROOT))
    from jax.experimental import pallas as pl
    from benchmarks import swin_attn_hg, swin_attn_variants

    fake = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    fake.pallas_call = lambda *a, **k: pl.pallas_call(*a, **dict(k, interpret=True))
    real = swin_attn_variants.pl
    swin_attn_variants.pl = fake
    yield swin_attn_variants, swin_attn_hg
    swin_attn_variants.pl = real


def _inputs(jhg, stage, h, dtype, seed):
    import jax.numpy as jnp

    geo = jhg.make_inputs(stage, 1, dt=jnp.float32, h_override=h)
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
    return j, p, tables, nh


def _w(d, nh):
    return (d["gamma"], d["beta"], d["wqkv"], d["bqkv"], d["wproj"], d["bproj"], d["bias"], nh)


def _run_both(jprobe, stage, h, dtype, shift, ablate, score_f32, seed):
    import jax.numpy as jnp

    jv, jhg = jprobe
    j, p, tab, nh = _inputs(jhg, stage, h, dtype, seed)
    mask = tab["mask1"] if shift else tab["mask0"]
    reg = tab["regions"] if shift else None
    launches = S.section.launches
    got = S.section(p["x"], t(mask), None if reg is None else t(reg), *_w(p, nh), wblk=8,
                    score_f32=score_f32, ablate=ablate)
    assert S.section.launches == launches  # on the CPU no kernel is launched
    want = jv.section(j["x"], mask, reg, *_w(j, nh), wblk=8,
                      score_dt=jnp.float32 if score_f32 else jnp.bfloat16, ablate=ablate)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


def _held(got, want, dtype, ablate):
    d = np.abs(got - want)
    assert np.isfinite(got).all()
    if dtype == torch.bfloat16 or ablate == "bf16sm":
        bar = 2e-2 + 1e-2 * np.abs(want)
    elif ablate == "softmax":
        bar = 5e-5 * max(1.0, float(np.abs(want).max()))
    else:
        bar = 5e-5
    assert (d <= bar).all(), (float(d.max()), int((d > bar).sum()))


@pytest.mark.parametrize("score_f32", [True, False], ids=["f32scores", "bf16scores"])
@pytest.mark.parametrize("ablate", S.ABLATIONS)
@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_plain_version_matches_the_jax_section(jprobe, dtype, shift, ablate, score_f32):
    """Every mode, both score dtypes, at a 26x26 map of stage 0 (16 windows,
    C = 96, 3 heads), shift 0 without and shift 3 with regions."""
    got, want = _run_both(jprobe, "stage0", 26, dtype, shift, ablate, score_f32, 1)
    _held(got, want, dtype, ablate)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_plain_version_matches_the_jax_section_at_c384(jprobe, dtype):
    """C = 384, 12 heads, at an 8x8 map (4 windows), shift 3 with regions."""
    got, want = _run_both(jprobe, "stage2", 8, dtype, 3, "none", True, 2)
    _held(got, want, dtype, "none")


def test_variants_match_the_jax_script():
    """The port's 15 variants are the JAX script's, in its order."""
    src = (ROOT / "benchmarks/swin_attn_variants.py").read_text()
    rows = re.findall(r'^\s*\("([^"]+)", (\d+), (jnp\.float32|DT), "(\w+)"\),', src, re.M)
    want = [(n.strip(), int(w), dt == "jnp.float32", ab) for n, w, dt, ab in rows]
    from segland_tpu_torch.benchmarks import swin_attn_variants as V

    assert [(n.strip(), w, sf, ab) for n, w, sf, ab in V.VARIANTS] == want
    assert len(want) == 15


def test_chain_time_on_the_cpu():
    """chain_time runs op(x + i) over the chain on the host clock and counts
    the wrapper's launches (none on the CPU); a graph needs a CUDA tensor."""
    from segland_tpu_torch.benchmarks.swin_attn_variants import chain_time

    seen = []
    x = torch.zeros(2, 3)
    ms, launches = chain_time(lambda a: seen.append(float(a[0, 0])) or a, x, chain=4, iters=2,
                              graph=False, counted=(S.section,))
    assert ms > 0 and launches == {"section": 0}
    assert seen == [0.0, 1.0, 2.0, 3.0] * 4  # two warm-up rounds and two timed
    with pytest.raises(ValueError, match="CUDA graph needs a CUDA tensor"):
        chain_time(lambda a: a, x, graph=True)


def test_probe_main_on_the_cpu():
    from segland_tpu_torch.benchmarks import swin_attn_variants as V

    rows = V.main(["stage1", "1", "9,5", "--device", "cpu", "--iters", "1"])
    assert [(r["variant"], r["wblk"], r["score_f32"], r["ablate"]) for r in rows] == [
        (9, 32, False, "io"), (5, 32, False, "softmax")]
    assert all(r["eager_ms"] > 0 and r["launches"] == 0 and "graph_ms" not in r for r in rows)


def test_probe_check_passes():
    from segland_tpu_torch.benchmarks import swin_attn_variants as V

    assert V.main(["check", "--device", "cpu"]) == []


@pytest.mark.parametrize("argv,match", [
    (["stage3", "1"], "unknown stage"),
    (["stage0", "1", "15"], "no variant"),
])
def test_probe_argv_raises(argv, match):
    from segland_tpu_torch.benchmarks import swin_attn_variants as V

    with pytest.raises(ValueError, match=match):
        V.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("c,nh,dtype,wblk,ablate,match", [
    (384, 6, torch.bfloat16, 32, "none", "heads of 32"),
    (384, 12, torch.bfloat16, 0, "none", "wblk"),
    (384, 12, torch.bfloat16, 32, "build", "not one of"),
    (384, 12, torch.float16, 32, "none", "bfloat16 and float32"),
    (768, 24, torch.bfloat16, 32, "none",
     r"no bfloat16 build for C=768: the per-head projection's fp32 accumulator \[64, 768\] "
     r"takes 192 registers a thread > 96"),
    (1536, 48, torch.float32, 32, "proj1", "no float32 build for C=1536"),
])
def test_host_checks_raise(c, nh, dtype, wblk, ablate, match):
    with pytest.raises(ValueError, match=match):
        S.check_section_build(c, nh, dtype, wblk, ablate)


def test_builds_match_the_source_and_fit():
    """attn_section_variants.cu builds exactly SECTION_BUILDS (one a width, each
    mode a part of its own), each within a block's shared memory and the
    accumulators' register budget at the probe's three widths, from
    section_win.cuh's constants; attn_section_f32.cu takes exactly F32_WIDTHS,
    whose layout is f32_layout, and every mode is accepted in fp32 there."""
    from segland_tpu_torch import kernels
    from segland_tpu_torch.ops import hg_attn as H

    csrc = ROOT / "segland_tpu_torch/kernels/csrc"
    src = csrc / "attn_section_variants.cu"
    rows = re.findall(r"^\s*X\((\d+), (\d+), (\d+)\)", src.read_text(), re.M)
    built = {int(r[0]): S.SectionBuild(*map(int, r[1:])) for r in rows}
    assert built == S.SECTION_BUILDS and sorted(built) == [96, 192, 384]
    parts = [flags for s_, flags in kernels.compile_units() if s_ == src]
    assert len(parts) == len(S.ABLATIONS)
    win = (csrc / "section_win.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", win))
    assert (int(consts["kWinRows"]), int(consts["kBiasLd"])) == (64, 56)
    assert H._TILE_Q == 64 * 64 and H._BIAS_HEAD == 49 * 56 * 2
    for c, b in built.items():
        lay = S.section_layout(c, b)
        assert lay["smem"] <= H.SMEM_MAX and lay["head_acc"] <= H.MAX_ACC_REGS, (c, lay)
        assert lay["acc"] + lay["head_acc"] <= 2 * H.MAX_ACC_REGS, (c, lay)
        assert S.check_section_build(c, c // 32, torch.bfloat16, 32) == b
    f32 = (csrc / "attn_section_f32.cu").read_text()
    widths = re.search(r"\(C != (\d+) && C != (\d+) && C != (\d+) && C != (\d+)\)", f32)
    assert tuple(map(int, widths.groups())) == H.F32_WIDTHS
    assert H.f32_layout(768)["smem"] == 205828 <= H.SMEM_MAX
    for c in H.F32_WIDTHS:
        for ab in S.ABLATIONS:
            assert S.check_section_build(c, c // 32, torch.float32, 32, ab) is None


@pytest.mark.parametrize("c,nh,side", [(96, 3, 259), (192, 6, 133), (384, 12, 70)])
def test_pass_schedule_covers_each_window_once(c, nh, side):
    """A host replay of K11's schedule at a swin-s stage of a batch of 8, read
    from the sources (torch_helpers' C-source replay: the launchers' grid,
    section_win.cuh's win_passes, the kernel's pass loop, the plan structs): a
    block owns wblk windows (the last block what is left), walked W at a time
    (the last pass what is left, io a block at once); every window is in
    exactly one pass.  In every mode but io (no ring) the stream (VarItems'
    PASS) fills as many ring slots a pass as each consumer warpgroup takes or
    skips (its section_product and head_projection calls times the loops and
    guards around them), as ring_pass_end checks on the card."""
    src = "attn_section_variants.cu"
    nw = 8 * (side // 7) ** 2
    w = S.SECTION_BUILDS[c].w
    assert re.search(r"win_passes\(NW, wblk, 1\)", c_block(csrc(src), r"\bio_kernel\("))
    for wblk in (32, 7, w):
        for kernel_w in (w, 1):  # the section kernel's passes; io's block at once
            blocks = win_blocks(src, "variants_kernel", nw, wblk, kernel_w)
            assert len(blocks) == -(-nw // wblk)
            seen = [w0 + i for passes in blocks for w0, n in passes for i in range(n)]
            assert seen == list(range(nw)), (wblk, kernel_w)
            assert all(0 < n <= kernel_w for passes in blocks for _, n in passes)
    modes = c_enums(csrc(src))
    assert [modes[k] for k in ("kNone", "kLn", "kIo", "kAttn", "kSoftmax", "kNoMax", "kBf16Sm",
                               "kProj1")] == list(range(len(S.ABLATIONS)))
    b = S.SECTION_BUILDS[c]
    for mode, ab in enumerate(S.ABLATIONS):
        if ab == "io":
            continue
        for g in (0, 1):
            env = win_kernel_env(src, "variants_kernel", "VarPlan", (c, b.w, b.s), MODE=mode, g=g)
            stream = win_stream(src, "VarItems", env)
            assert stream == win_takes(src, "variants_kernel", env) > 0, (ab, g)


def test_new_bodies_use_no_wmma():
    """K9's, K10's and K11's sources, with every header they include, hold no
    nvcuda::wmma: their products are wgmma and their core mma.sync."""
    csrc = ROOT / "segland_tpu_torch/kernels/csrc"
    for name in ("attn_section_variants.cu", "attn_section_hg_sm90.cu",
                 "attn_section_hg2_sm90.cu"):
        todo, seen = [name], set()
        while todo:
            f = todo.pop()
            if f in seen:
                continue
            seen.add(f)
            text = (csrc / f).read_text()
            code = "\n".join(line.split("//")[0] for line in text.splitlines())
            assert "wmma" not in code and "<mma.h>" not in code, (name, f)
            todo += re.findall(r'^#include "([\w.]+)"', text, re.M)
        assert {"section_win.cuh", "mma_sync.cuh", "section_sm90.cuh", "sm90.cuh"} <= seen


def test_mask_rows_must_divide_the_windows():
    """Window w takes row w % rows; rows that do not divide NW raise on the
    card's path, where the JAX wrapper's jnp.tile would come up short."""
    from segland_tpu_torch.ops.fused_attn import _mask_rows

    with pytest.raises(ValueError, match="rows dividing 10 windows"):
        _mask_rows("mask_tok", torch.ones(4, 49), 10, torch.device("cpu"))
