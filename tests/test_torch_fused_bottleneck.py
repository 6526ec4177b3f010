"""The fused int8 bottleneck ops' plain versions against the JAX package: the
XLA oracles (`bottleneck_int8_reference`, the conv3 arithmetic written out in
tests/test_quant.py) and the Pallas kernels in interpret mode, at the shapes
of tests/test_quant.py, from the same numpy inputs.

Integer sums are exact on both sides and the plain versions divide by the
scales as the oracles do, so against the oracles the bar is bit equality.
The Pallas bodies multiply by the reciprocal of each scale, which can flip a
requantized integer at a tie: against them the bars are the JAX tests' own,
atol 1e-3 (block) and 1e-2 (conv3), and the share of bit-equal elements is
printed and held above 99%.  The CUDA kernels themselves are held to their
plain versions on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import t
from segland_tpu.ops import pallas_bottleneck as J
from segland_tpu_torch.ops import fused_bottleneck as FB
from segland_tpu_torch.ops import plain_versions
from segland_tpu_torch.ops.int8 import int8_conv2d, int_matmul, quantize_sym, round_clip

BLOCK_SHAPES = [(2, 16, 16, 64, 16, 1, True), (1, 32, 8, 128, 32, 2, False),
                (1, 16, 16, 64, 16, 4, True), (1, 5, 7, 64, 64, 2, True)]
CONV3_SHAPES = [(260, 32, 128, True), (96, 16, 64, False)]
SCALES = dict(s_x=0.05, s_h1=0.01, s_h2=0.01)


def _block_inputs(shape, seed=0):
    b, h, w, c, p, _, _ = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    w1 = rng.randint(-127, 127, (c, p)).astype(np.int8)
    w2 = rng.randint(-127, 127, (3, 3, p, p)).astype(np.int8)
    w3 = rng.randint(-127, 127, (p, c)).astype(np.int8)
    aff = lambda n: ((rng.rand(n) * 1e-4 + 1e-5).astype(np.float32),
                     (rng.randn(n) * 0.1).astype(np.float32))
    (a1, b1), (a2, b2), (a3, b3) = aff(p), aff(p), aff(c)
    return x, (w1, w2, w3, a1, b1, a2, b2, a3, b3)


def _port_block(x, rest, d, lr, fn=FB.fused_bottleneck_int8):
    out = fn(t(x).bfloat16(), *[t(a) for a in rest], dilation=d, last_relu=lr, **SCALES)
    assert out.dtype == torch.bfloat16
    return out.float().numpy()


@pytest.mark.parametrize("shape", BLOCK_SHAPES, ids=str)
def test_block_reference_is_the_jax_oracle_bit_for_bit(shape):
    x, rest = _block_inputs(shape)
    d, lr = shape[5], shape[6]
    want = np.asarray(J.bottleneck_int8_reference(
        jnp.asarray(x, jnp.bfloat16), *[jnp.asarray(a) for a in rest], dilation=d,
        last_relu=lr, **SCALES), np.float32)
    got = _port_block(x, rest, d, lr)
    assert got.shape == want.shape == x.shape
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).all() == lr


@pytest.mark.parametrize("shape", BLOCK_SHAPES[:3], ids=str)
def test_block_reference_against_the_pallas_kernel_interpreted(shape):
    x, rest = _block_inputs(shape)
    d, lr = shape[5], shape[6]
    out = J.fused_bottleneck_int8(jnp.asarray(x, jnp.bfloat16), *[jnp.asarray(a) for a in rest],
                                  dilation=d, last_relu=lr, interpret=True, **SCALES)
    assert out is not None
    want, got = np.asarray(out, np.float32), _port_block(x, rest, d, lr)
    equal = float((got == want).mean())
    print(f"block {shape}: {equal:.6f} of elements bit-equal to the interpreted Pallas kernel")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert equal > 0.99


def _conv3_inputs(shape, seed=1):
    m, p, c, _ = shape
    rng = np.random.RandomState(seed)
    return (rng.randint(-127, 128, (m, p)).astype(np.int8),
            rng.randn(m, c).astype(np.float32),
            rng.randint(-127, 128, (p, c)).astype(np.int8),
            (rng.rand(c) * 1e-4 + 1e-5).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32))


@pytest.mark.parametrize("shape", CONV3_SHAPES, ids=str)
def test_conv3_reference_against_xla_and_the_pallas_kernel(shape):
    h2q, res, w3, a3, b3 = _conv3_inputs(shape)
    lr = shape[3]
    jres = jnp.asarray(res, jnp.bfloat16)
    acc = jnp.asarray(h2q).astype(jnp.int32) @ jnp.asarray(w3).astype(jnp.int32)
    ref = acc.astype(jnp.float32) * a3 + b3 + jres.astype(jnp.float32)
    ref = np.asarray((jnp.maximum(ref, 0.0) if lr else ref).astype(jnp.bfloat16), np.float32)
    got = FB.conv3_residual_int8(t(h2q), t(res).bfloat16(), t(w3), t(a3), t(b3), last_relu=lr)
    assert got.dtype == torch.bfloat16 and got.shape == res.shape
    got = got.float().numpy()
    np.testing.assert_array_equal(got, ref)  # the same arithmetic, written out in XLA
    out = np.asarray(J.conv3_residual_int8(jnp.asarray(h2q), jres, jnp.asarray(w3),
                                           jnp.asarray(a3), jnp.asarray(b3), last_relu=lr,
                                           interpret=True, mblk=64), np.float32)
    equal = float((got == out).mean())
    print(f"conv3 {shape}: {equal:.6f} of elements bit-equal to the interpreted Pallas kernel")
    np.testing.assert_allclose(got, out, rtol=0, atol=1e-2)
    assert equal > 0.99


def test_block_equals_its_three_stages_chained():
    """conv3_residual_int8 is the block's last stage: the block reference
    equals quantize -> conv1 -> conv2 (by hand) -> conv3_residual_reference."""
    shape = (1, 9, 11, 64, 32, 2, True)
    x, (w1, w2, w3, a1, b1, a2, b2, a3, b3) = _block_inputs(shape, seed=2)
    xb = t(x).bfloat16()
    s = lambda v: torch.tensor(v, dtype=torch.float32)
    xq = quantize_sym(xb.float(), s(0.05))
    h1 = torch.relu(int8_conv2d(xq, t(w1).t()[None, None]).float() * t(a1) + t(b1))
    h1q = quantize_sym(h1, s(0.01))
    acc2 = int8_conv2d(h1q, t(w2).permute(0, 1, 3, 2), padding=(2, 2), dilation=(2, 2))
    h2q = quantize_sym(torch.relu(acc2.float() * t(a2) + t(b2)), s(0.01))
    tail = FB.conv3_residual_reference(h2q.reshape(-1, 32), xb.reshape(-1, 64), t(w3), t(a3),
                                       t(b3), last_relu=True)
    whole = FB.bottleneck_int8_reference(xb, t(w1), t(w2), t(w3), t(a1), t(b1), t(a2), t(b2),
                                         t(a3), t(b3), dilation=2, last_relu=True, **SCALES)
    assert torch.equal(tail.view_as(whole), whole)


def test_h1_is_zero_outside_the_image():
    """The 3x3 pads the activation h1q with zeros; a zero x there would give
    relu(b1) != 0.  With b1 > 0 and a block that is all border, padding x
    instead of h1q changes the result, and the reference does not do that."""
    shape = (1, 3, 3, 64, 16, 1, False)
    x, (w1, w2, w3, a1, b1, a2, b2, a3, b3) = _block_inputs(shape, seed=3)
    b1 = np.abs(b1) + 0.5
    rest = (w1, w2, w3, a1, b1, a2, b2, a3, b3)
    got = _port_block(x, rest, 1, False)
    xpad = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))  # zero x, hence relu(b1) in the halo
    wrong = _port_block(xpad, rest, 1, False)[:, 1:-1, 1:-1]
    assert np.abs(got - wrong).max() > 0.0
    want = np.asarray(J.bottleneck_int8_reference(
        jnp.asarray(x, jnp.bfloat16), *[jnp.asarray(a) for a in rest], dilation=1,
        last_relu=False, **SCALES), np.float32)
    np.testing.assert_array_equal(got, want)


def test_round_clip_is_half_even_and_divides():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, 127.5, 300.0, -300.0])
    assert round_clip(x).tolist() == [0.0, 2.0, 2.0, -0.0, -2.0, 126.0, 127.0, 127.0, -127.0]
    # 2.25 / 0.3 is just under 7.5 in fp32; 2.25 * (1 / 0.3) is just over it
    v, s = torch.tensor([2.25]), torch.tensor(0.3)
    assert torch.round(v * (1.0 / s)).item() == 8.0
    q = quantize_sym(v, s)
    assert q.dtype == torch.int8 and q.item() == 7


@pytest.mark.parametrize("stride,padding,dilation", [((1, 1), (1, 1), (1, 1)),
                                                     ((2, 2), (1, 1), (1, 1)),
                                                     ((2, 2), (0, 0), (1, 1)),
                                                     ((1, 1), (6, 6), (6, 6)),
                                                     ((1, 1), (18, 18), (18, 18)),
                                                     ((2, 1), (2, 4), (2, 4))])
def test_int8_conv2d_is_exact(stride, padding, dilation):
    """Against a float64 convolution, which holds every int32 sum exactly; the
    values are the extremes, where a float32 sum would round."""
    rng = np.random.RandomState(4)
    xq = t(rng.choice([-127, 127], (2, 13, 11, 520)).astype(np.int8))
    w = t(rng.choice([-127, 127], (3, 3, 24, 520)).astype(np.int8))
    xq[0], w[:, :, 0] = 127, 127  # one image and one output channel at the maximum
    xq[0, ::2, ::3, 7] = 126      # and odd sums, which float32 cannot hold up there
    got = int8_conv2d(xq, w, stride, padding, dilation)
    want = torch.nn.functional.conv2d(xq.permute(0, 3, 1, 2).double(),
                                      w.permute(2, 3, 0, 1).double(), None, stride, padding,
                                      dilation).permute(0, 2, 3, 1)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got.double(), want)
    if max(dilation) < 11:  # beyond that only the centre tap meets this small map
        assert int(got.abs().max()) > 2 ** 24


def test_int_matmul_is_exact_and_typed():
    rng = np.random.RandomState(5)
    a = t(rng.randint(-127, 128, (5, 40)).astype(np.int8))
    b = t(rng.randint(-127, 128, (40, 7)).astype(np.int8))
    got = int_matmul(a, b)
    assert got.dtype == torch.int32 and torch.equal(got, a.int() @ b.int())
    assert torch.equal(int_matmul(a, b.t().contiguous().t()), got)
    with pytest.raises(TypeError):
        int_matmul(a.float(), b)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    shape = BLOCK_SHAPES[0]
    x, rest = _block_inputs(shape)
    before = (FB.bottleneck_int8.launches, FB.conv3_residual.launches)
    a = _port_block(x, rest, 1, True)
    b = _port_block(x, rest, 1, True, fn=FB.bottleneck_int8_reference)
    with plain_versions(True):
        c = _port_block(x, rest, 1, True)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)
    h2q, res, w3, a3, b3 = _conv3_inputs(CONV3_SHAPES[0])
    FB.conv3_residual_int8(t(h2q), t(res).bfloat16(), t(w3), t(a3), t(b3))
    assert (FB.bottleneck_int8.launches, FB.conv3_residual.launches) == before


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    x, rest = _block_inputs(BLOCK_SHAPES[0])
    args = [t(x).bfloat16()] + [t(a) for a in rest]
    with pytest.raises(ValueError, match="CUDA"):
        FB.bottleneck_int8(*args, dilation=1, **SCALES)
    h2q, res, w3, a3, b3 = _conv3_inputs(CONV3_SHAPES[0])
    with pytest.raises(ValueError, match="CUDA"):
        FB.conv3_residual(t(h2q), t(res).bfloat16(), t(w3), t(a3), t(b3))
    with pytest.raises(ValueError, match="multiples of 64"):
        FB._check_widths("bottleneck_int8", 96, 16)
    with pytest.raises(ValueError, match="multiples of 64"):
        FB._check_widths("conv3_residual", 64, 0)
    FB._check_widths("bottleneck_int8", 2048, 512)
    with pytest.raises(ValueError, match="int8"):
        FB._weight(t(rest[0]).float(), (64, 16), torch.device("cpu"))
    with pytest.raises(ValueError, match="vector of 3"):
        FB._vec(torch.zeros(3), 4, torch.device("cpu"))


def test_conv3_probe_runs_on_the_cpu(capsys):
    from segland_tpu_torch.benchmarks import conv3_probe

    rows = conv3_probe.main(["--m", "70", "--iters", "1", "--device", "cpu"])
    assert [(r["p"], r["c"]) for r in rows] == [(512, 2048), (256, 1024)]
    assert all(r["fused_ms"] > 0 and r["per_conv_ms"] > 0 for r in rows)
    assert "conv3_residual_int8" in capsys.readouterr().out
