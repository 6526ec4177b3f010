"""int8 PTQ of the last four registry models in the port against the JAX
package's (segland_tpu/quant), the same numpy weights and inputs on the CPU.

``lsk_pop`` and ``vggunet_pop`` take per-conv int8 only.  The JAX
interceptor takes ``nn.Conv`` modules alone, so its W-packed chains (the JAX
default) and LSKNet's ``ConvParams`` convs (the attention's projections, the
LSK gate, the conv-MLP) stay in fp32; the port's own set is held to the JAX
``act_amax`` keys of the ``packed=False`` model, and each of its int8 convs,
fed the JAX conv's own input, to the JAX output within 1% of its largest
|value|.  The ResNet pair with ``--int8 --fused``: ``resnet50v2``'s 12
stride-1 Bottlenecks without a downsample and their fused inputs equal the
JAX route's; under ``-m slow``, ``pspplus_pop`` / ``resnet50v2`` and the plain
``pspnet`` / ``resnet50`` through K7's plain version, the rest conv by conv,
against the JAX ``quantized_apply`` with its fused route interpreted, within
tests/test_quant.py's 5% of the largest logit."""

import functools
import re

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from torch_helpers import load_port, meta_build, one_torch_thread, random_variables, t
import segland_tpu.models.pop as jpop
from segland_tpu.models import build_model as j_build
from segland_tpu.quant import QuantConfig as JQuantConfig
from segland_tpu.quant import calibrate as j_calibrate
from segland_tpu.quant import quantized_apply as j_quantized_apply
from segland_tpu.quant import ptq as JP
from segland_tpu_torch.ckpt import quant_from_jax, quant_to_jax
from segland_tpu_torch.ckpt.convert import _module_name
from segland_tpu_torch.models import build_model
from segland_tpu_torch.models.backbones.lsknet import ParamConv
from segland_tpu_torch.quant import (ActScales, QuantConfig, build_fused_block_inputs, calibrate,
                                     quant_interceptor, quantized_apply)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KW = dict(n_base=7)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(a):
    return t(a).permute(0, 3, 1, 2)


def unpacked(fn):
    """fn() with the JAX backbones built packed=False (flax builds them at apply)."""
    get = jpop.get_backbone
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpop, "get_backbone", lambda name, **kw: get(name, packed=False, **kw))
        return fn()


@functools.lru_cache(maxsize=None)
def pair(name, backbone, hw=64, seed=0):
    jm = j_build(name, backbone, **KW)
    v = _np_tree(random_variables(jm, jnp.zeros((1, hw, hw, 3)), seed=seed))
    port = load_port(meta_build(build_model, name, backbone, **KW), v)
    img = np.random.RandomState(1).randn(2, hw, hw, 3).astype(np.float32)
    return jm, v, port, img


def _jax_convs(jm, vq, img):
    """The JAX quantized_apply of the packed=False model over ``img``, jitted,
    with every nn.Conv's input and output sown ({module path: (x, y)}, NHWC)."""
    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if type(context.module) is fnn.Conv and context.method_name == "__call__":
            context.module.sow("intermediates", "conv_io", (args[0], out))
        return out

    def run(variables, x):
        with fnn.intercept_methods(record):
            with fnn.intercept_methods(JP.quant_interceptor("int8")):
                return jm.apply(variables, x, mutable=["intermediates"])[1]

    sown = unpacked(lambda: jax.jit(run)(vq, jnp.asarray(img)))["intermediates"]
    return {"/".join(path[:-1]): tuple(np.asarray(a) for a in io[0])
            for path, io in flax.traverse_util.flatten_dict(sown, is_leaf=lambda k, x: isinstance(
                x, tuple)).items()}


@pytest.mark.parametrize("name,backbone", [("lsk_pop", "lsk-t"),
                                           ("vggunet_pop", "vgg16bn-unet")])
def test_per_conv_int8_matches_jax(name, backbone):
    jm, v, port, img = pair(name, backbone)
    want = quant_from_jax(_np_tree(unpacked(lambda: j_calibrate(jm, v, [jnp.asarray(img)]))
                                   ["quant"]))
    quant = calibrate(port, [_nchw(img)])
    assert set(quant) == set(want)
    for k in quant:  # abs-max scales of fp32 activations 1e-5 apart (seen: 1.4e-6, LSK stage 4)
        np.testing.assert_allclose(float(quant[k]), float(want[k]), rtol=1e-5, err_msg=k)
    modules = dict(port.named_modules())
    convs = {n for n, m in modules.items()  # the POP head's run in fp32, not as modules
             if type(m) is nn.Conv2d and not n.startswith("classifier")}
    raw = {n for n, m in modules.items() if isinstance(m, ParamConv)}
    if name == "lsk_pop":  # 13 blocks: 2 projections, 6 gate convs, 3 MLP convs each
        assert len(raw) == 13 * 11 and not raw & set(quant)
        assert set(quant) == {n for n in convs if modules[n].in_channels >= 32}
        assert {"backbone.patch_embed2.proj", "decoder.semantic_embedding.1",
                "decoder.fpn_convs.3.4.0"} <= set(quant)
    else:  # every conv of the U-Net (13 encoder, 8 decoder) but its first (3 inputs)
        assert set(quant) == convs - {"net.inc.0"} and len(quant) == 20
    vq = {**v, "quant": quant_to_jax({k: a.numpy() for k, a in quant.items()}, v["params"])}
    rec = _jax_convs(jm, vq, img)
    names = {_module_name(p): p for p in rec}
    assert set(quant) <= set(names)
    with torch.no_grad(), quant_interceptor(port, "int8", quant=quant) as q:
        for k in quant:
            x, y = rec[names[k]]
            got = q._layer(k, modules[k], _nchw(x)).permute(0, 2, 3, 1).numpy()
            assert np.abs(got - y).max() < 0.01 * np.abs(y).max(), k
    with torch.no_grad():
        got = quantized_apply(port)(quant, _nchw(img)).permute(0, 2, 3, 1).numpy()
        fp32 = port(_nchw(img)).permute(0, 2, 3, 1).numpy()
    assert 0 < np.abs(got - fp32).max() < 0.2 * np.abs(fp32).max()  # quantized, the same model


def _resnet_pair(name, backbone):
    """The bf16 JAX model, its variables calibrated on one image, the port
    model with the same weights and the scales carried over, the image."""
    jm = j_build(name, backbone, dtype=jnp.bfloat16, **KW)
    train = {"train": True} if name == "pspnet" else {}
    v = _np_tree(random_variables(jm, jnp.zeros((1, 32, 32, 3)), seed=2, **train))
    port = load_port(meta_build(build_model, name, backbone, dtype=torch.bfloat16, **KW), v)
    img = np.random.RandomState(3).randn(1, 32, 32, 3).astype(np.float32)
    vq = _np_tree(j_calibrate(jm, v, [jnp.asarray(img)]))
    quant = ActScales({k: t(a) for k, a in quant_from_jax(vq["quant"]).items()})
    return jm, vq, port, quant, img


def test_resnet50v2_fused_blocks_match_jax():
    """pspplus_pop / resnet50v2 (the deep stem; its convs stay per-conv): the
    12 stride-1 Bottlenecks without a downsample, and each one's fused-route
    inputs as the JAX route builds them: int8 weights equal, the scales to
    1e-6 relative, the folded affines to 1e-6 of their tensor's largest
    |value| (a shift bias - mean * scale near 0 keeps only its absolute
    rounding; seen: 1.5e-8 on 0.0077)."""
    _, vq, port, quant, _ = _resnet_pair("pspplus_pop", "resnet50v2")
    jmap = JP.build_fused_block_inputs(vq, JQuantConfig(fused_blocks=True))
    pmap = build_fused_block_inputs(port, quant, QuantConfig(fused_blocks=True))
    blocks = [f"backbone.layer{i}.{j}" for i, n in enumerate((3, 4, 6, 3), 1) for j in range(1, n)]
    assert sorted(pmap) == sorted(blocks) and len(jmap) == 12
    assert {"backbone.conv2", "backbone.conv3"} <= set(quant)  # the deep stem: per-conv
    # the JAX route keys a block by its flax path, backbone/layer<i>_<j>
    names = {re.sub(r"layer(\d)_(\d+)", r"layer\1.\2", p).replace("/", "."): p for p in jmap}
    assert set(names) == set(pmap)
    for name, pre in pmap.items():
        jpre = jmap[names[name]]
        assert set(pre) == set(jpre)
        for k in ("w1", "w2", "w3"):
            np.testing.assert_array_equal(pre[k].numpy(), np.asarray(jpre[k]), err_msg=name)
        for k in ("a1", "b1", "a2", "b2", "a3", "b3"):
            want = np.asarray(jpre[k])
            np.testing.assert_allclose(pre[k].detach().numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max(), err_msg=f"{name} {k}")
        for k in ("s_x", "s_h1", "s_h2"):
            np.testing.assert_allclose(pre[k], float(jpre[k]), rtol=1e-6, err_msg=name)


@pytest.mark.slow
@pytest.mark.parametrize("name,backbone", [("pspplus_pop", "resnet50v2"), ("pspnet", "resnet50")])
def test_resnet_fused_route_matches_jax(name, backbone, monkeypatch):
    """bf16, scales calibrated in JAX and carried over: 12 Bottlenecks through
    K7's plain version a forward, the logits against the JAX fused route's
    (eager: a jitted apply keeps bf16 intermediates unrounded inside XLA's
    fusions and moves the logits by 5.7% of the largest; the port rounds where
    eager JAX does) within tests/test_quant.py's 5% of the largest logit
    (seen: 1.3%).  About a minute a model, most of it the JAX package's eager
    int8 ops compiling: under -m slow."""
    from segland_tpu_torch.ops import fused_bottleneck as FB

    jm, vq, port, quant, img = _resnet_pair(name, backbone)
    jcfg = JQuantConfig(fused_blocks=True, fused_interpret=True)
    cfg = QuantConfig(fused_blocks=True, fused_interpret=True)
    want = np.asarray(j_quantized_apply(jm, jcfg)(vq, jnp.asarray(img)), np.float32)
    calls = []
    monkeypatch.setattr(FB, "bottleneck_int8_reference",
                        lambda *a, _fn=FB.bottleneck_int8_reference, **kw:
                        calls.append(1) or _fn(*a, **kw))
    with torch.no_grad():
        got = quantized_apply(port, cfg)(quant, _nchw(img))
    assert len(calls) == 12 and got.dtype == torch.float32
    got = got.permute(0, 2, 3, 1).numpy()
    scale = np.abs(want).max()
    assert got.shape == want.shape == (1, 4, 4, 8)
    assert np.abs(got - want).max() < 0.05 * scale
