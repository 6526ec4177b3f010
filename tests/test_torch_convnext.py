"""Port's ConvNeXt backbone + FPN-OCR decoder vs the JAX modules at narrow
widths, fp32 on the CPU, weights carried by from_jax_variables; atol 5e-4
(the repo's parity bar)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import load_port, random_variables, t
from segland_tpu.models.backbones.convnext import ConvNeXt as JConvNeXt
from segland_tpu.models.decoders import FPNOCRDecoder as JFPNOCR
from segland_tpu_torch.models.backbones.convnext import ConvNeXt
from segland_tpu_torch.models.decoders import FPNOCRDecoder

DEPTHS, DIMS, OUT = (1, 1, 2, 1), (16, 32, 64, 128), 32
ATOL = 5e-4


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)


@pytest.mark.parametrize("fused", [False, True])
def test_convnext_matches_jax(image, fused):
    jm = JConvNeXt(depths=DEPTHS, dims=DIMS, fused_mlp=fused)
    v = random_variables(jm, jnp.asarray(image), seed=1)
    want = jm.apply(v, jnp.asarray(image))
    port = load_port(ConvNeXt(DEPTHS, DIMS, fused_mlp=fused),
                     {"params": {"backbone": v["params"]}}, prefix="backbone.")
    with torch.no_grad():
        got = port(t(image).permute(0, 3, 1, 2))
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   rtol=0, atol=ATOL)


def test_fpn_ocr_decoder_matches_jax():
    rng = np.random.RandomState(2)
    feats = [rng.randn(2, 16 // 2 ** i, 16 // 2 ** i, c).astype(np.float32)
             for i, c in enumerate(DIMS)]
    jd = JFPNOCR(out_features=OUT)
    jf = [jnp.asarray(f) for f in feats]
    v = random_variables(jd, jf, seed=3)
    want = jd.apply(v, jf)
    port = load_port(FPNOCRDecoder(DIMS, out_features=OUT),
                     {"params": {"decoder": v["params"]}}, prefix="decoder.")
    with torch.no_grad():
        got = port([t(f).permute(0, 3, 1, 2) for f in feats])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)


def test_fused_and_unfused_blocks_agree_in_fp32(image):
    """fp32: the fused section (LN+MLP kernel path) is the unfused block."""
    v = random_variables(JConvNeXt(depths=DEPTHS, dims=DIMS), jnp.asarray(image), seed=4)
    x = t(image).permute(0, 3, 1, 2)
    outs = []
    for fused in (False, True):
        m = load_port(ConvNeXt(DEPTHS, DIMS, fused_mlp=fused),
                      {"params": {"backbone": v["params"]}}, prefix="backbone.")
        with torch.no_grad():
            outs.append(m(x)[-1])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-5)
