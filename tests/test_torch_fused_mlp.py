"""Port's fused LN+MLP op (segland_tpu_torch/ops/fused_mlp.py): its plain
version against the JAX package's ln_mlp_reference and against the JAX
Pallas kernel in interpret mode, on the same numpy inputs.  The CUDA kernel
itself is held against this plain version on the card by chip_smoke.py."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import t
from segland_tpu.ops.pallas_mlp import _tile_m, fused_ln_mlp as j_fused, ln_mlp_reference as j_ref
from segland_tpu_torch.ops import plain_versions, use_kernel
from segland_tpu_torch.ops.fused_mlp import (CONSUMER_REGS, MLP_BUILDS, SMEM_MAX, contiguous_as,
                                             fused_ln_mlp, kmajor, ln_mlp, ln_mlp_plan,
                                             ln_mlp_reference)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# stage widths whose LN+MLP sections K1 runs: ConvNeXt-T's (convnext.py: dims) and
# Swin-S's, Swin-B's and Swin-L's (embed 96, 128, 192, doubled a stage); all have hidden
# width 4C
STAGE_WIDTHS = {"convnext-t": (96, 192, 384, 768), "swin-s": (96, 192, 384, 768),
                "swin-b": (128, 256, 512, 1024), "swin-l": (192, 384, 768, 1536)}


def _params(c, hid, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    # weights 0.05 up to C = 128, then scaled by fan-in, so that h and the output stay
    # O(1) at every width and an fp32 bar of 1e-5 reads the arithmetic, not the order
    # in which sums of thousands of terms round
    w = 0.05 * min(1.0, (128 / c) ** 0.5)
    return dict(gamma=1.0 + 0.1 * f(c), beta=0.1 * f(c), w1=f(c, hid) * w,
                b1=0.05 * f(hid), w2=f(hid, c) * w, b2=0.05 * f(c))


def _rows(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("with_res,with_ls", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("c", [96, 128, 1024, 1536])
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


@pytest.mark.parametrize("model,c", [(m, c) for m, cs in STAGE_WIDTHS.items() for c in cs])
def test_every_stage_shape_has_a_bf16_plan(model, c):
    """The wgmma kernel's plan at each stage shape fits a block's shared
    memory and leaves a consumer thread 64 of its registers beyond the
    accumulators and h fragments; its chunks tile the hidden width.  Only
    swin-l's last stage streams y (its 192 KB tile would leave no ring): a
    first-product slot then carries y's K tile beside both warpgroups' w1
    tiles, and y takes no shared memory of its own."""
    plan = ln_mlp_plan(c, 4 * c)
    assert plan["smem"] == sum(plan["smem_parts"].values()) <= SMEM_MAX
    assert plan["acc_regs"] <= CONSUMER_REGS - 64
    assert plan["chunks"] * plan["hc"] == 4 * c
    assert plan["rg"] * plan["cg"] == 2  # two consumer warpgroups
    assert plan["np"] * plan["cg"] * plan["cs"] == c
    assert plan["regs"]["acc2"] <= 128  # the second product's accumulator, a thread
    assert plan["stream_y"] == (c == 1536)
    if plan["stream_y"]:
        assert plan["smem_parts"]["y"] == 0 and plan["rg"] == 1 and plan["cg"] == 2
        assert plan["slot_bytes"] == 3 * 64 * 64 * 2  # y's tile and two w1 tiles
    else:
        assert plan["smem_parts"]["y"] == plan["rg"] * -(-c // 64) * 64 * 64 * 2


@pytest.mark.parametrize("c,hidden,match", [(64, 256, "no bfloat16 build"),
                                            (160, 640, "no bfloat16 build"),
                                            (2048, 8192, "no bfloat16 build"),
                                            (96, 4 * 96 + 64, "multiple of 128"),
                                            (384, 4 * 384 + 64, "multiple of 128")])
def test_shapes_without_a_build_raise_with_the_arithmetic(c, hidden, match):
    with pytest.raises(ValueError, match=match):
        ln_mlp_plan(c, hidden)


def test_the_build_table_matches_the_source():
    """ln_mlp.cu instantiates exactly MLP_BUILDS, and its plan arithmetic is
    the one ln_mlp_plan mirrors (ring, y and h buffers of 8 KB tiles)."""
    src = (ROOT / "segland_tpu_torch/kernels/csrc/ln_mlp.cu").read_text()
    table = src[src.index("#define SEGLAND_MLP_BUILDS"):]
    table = table[:table.index("\n\n")]
    built = {int(m[0]): tuple(int(v) for v in m[1:])
             for m in re.findall(r"X\((\d+), (\d+), (\d+), (\d+), (\d+), (\d+)\)", table)}
    assert built == {c: tuple(b) for c, b in MLP_BUILDS.items()}
    assert ln_mlp_plan(384, 1536)["smem_parts"] == dict(ring=16 * 8192, y=6 * 8192,
                                                        h=2 * 2 * 8192, barriers=256,
                                                        align=1024)
    assert ln_mlp_plan(1536, 6144)["smem_parts"] == dict(ring=8 * 3 * 8192, y=0,
                                                         h=2 * 2 * 8192, barriers=128,
                                                         align=1024)
    # y streams where the resident tile would not fit, by MlpPlan's own test
    assert "resident_smem(C_, RG_, CG_, HS_, S_) > kSmemMax" in src


def test_kmajor_copy_is_the_transpose_and_follows_the_weight():
    """A weight that is not the transpose of a contiguous tensor gets a fresh
    K-major copy at every call, so an in-place change of the parameter shows
    in the next one."""
    w = torch.randn(16, 64)  # [in, out], contiguous
    k = kmajor(w, torch.bfloat16)
    assert k.is_contiguous() and k.dtype == torch.bfloat16 and tuple(k.shape) == (64, 16)
    torch.testing.assert_close(k, w.t().to(torch.bfloat16), rtol=0, atol=0)
    p = torch.nn.Parameter(torch.randn(16, 64))
    kp = kmajor(p, torch.bfloat16)
    with torch.no_grad():
        p.copy_(torch.randn(16, 64))
    torch.testing.assert_close(kmajor(p, torch.bfloat16), p.detach().t().to(torch.bfloat16),
                               rtol=0, atol=0)
    assert not torch.equal(kmajor(p, torch.bfloat16), kp)


def test_kmajor_takes_a_linear_weight_view_as_it_is():
    """The blocks pass ``weight.T`` of an nn.Linear: its transpose is the
    weight itself, K-major already, so no copy is made."""
    lin = torch.nn.Linear(16, 64).to(torch.bfloat16)
    k = kmajor(lin.weight.T, torch.bfloat16)
    assert k.data_ptr() == lin.weight.data_ptr() and k.is_contiguous()
    assert kmajor(lin.weight.T, torch.float32).dtype == torch.float32  # other dtype: a copy
