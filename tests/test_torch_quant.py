"""The port's int8 PTQ (segland_tpu_torch/quant) against the JAX package's
(segland_tpu/quant), from the same numpy weights and inputs, and the port's
mirrors of tests/test_quant.py's rules.

Bars: ``_wq``, ``_fold_bn`` and ``build_fused_block_inputs`` give the JAX
values exactly (integers) or to 1e-6 relative (fp32 products of the same
factors); calibrated scales agree to 1e-6 relative; int8 logits agree within
5% of the largest logit (tests/test_quant.py's own bar; a scale that differs
in its last bit flips single roundings), and within 1% when the scales are
carried across; seghr_pop / hr-w32's 304 int8 convs agree within 1% conv by
conv and its logits within the 5% bar (see its test).  At the end, the int8
accuracy gate on a model the JAX CLI trained on the synthetic task."""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from synthtask import build_task
from torch_helpers import load_port, meta_build, random_variables, t
from segland_tpu.models import build_model as j_build
from segland_tpu.models.backbones.resnet import _make_layer as j_make_layer
from segland_tpu.quant import QuantConfig as JQuantConfig
from segland_tpu.quant import calibrate as j_calibrate
from segland_tpu.quant import quantized_apply as j_quantized_apply
from segland_tpu.quant import ptq as JP
from segland_tpu_torch.ckpt import quant_from_jax, quant_to_jax
from segland_tpu_torch.ckpt.convert import _module_name
from segland_tpu_torch.models import build_model
from segland_tpu_torch.models.backbones.resnet import _make_layer
from segland_tpu_torch.quant import (ActScales, QuantConfig, build_fused_block_inputs, calibrate,
                                     quant_interceptor, quantized_apply)
from segland_tpu_torch.quant import ptq as P

import flax.linen as fnn


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(a):
    return t(a).permute(0, 3, 1, 2)


# ---- the pieces ------------------------------------------------------------
def test_wq_matches_jax_exactly():
    rng = np.random.RandomState(0)
    for shape, axes in (((3, 3, 16, 24), (0, 1, 2)), ((40, 12), (0,))):
        k = rng.randn(*shape).astype(np.float32)
        k[..., 0] = 0.0  # an all-zero channel takes the 1e-8 floor
        jq, js = JP._wq(jnp.asarray(k), axes)
        q, s = P._wq(t(k), axes)
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7, atol=0)


def test_fold_bn_matches_jax():
    rng = np.random.RandomState(1)
    p = dict(scale=rng.rand(8).astype(np.float32) + 0.5, bias=rng.randn(8).astype(np.float32))
    st = dict(mean=rng.randn(8).astype(np.float32), var=rng.rand(8).astype(np.float32) + 0.1)
    bn = nn.BatchNorm2d(8, eps=1e-5)
    bn.load_state_dict(dict(weight=t(p["scale"]), bias=t(p["bias"]), running_mean=t(st["mean"]),
                            running_var=t(st["var"]), num_batches_tracked=torch.tensor(0)))
    js, jb = JP._fold_bn({k: jnp.asarray(v) for k, v in p.items()},
                         {k: jnp.asarray(v) for k, v in st.items()})
    s, b = P._fold_bn(bn)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js), rtol=1e-6, atol=0)
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(jb), rtol=1e-6, atol=1e-7)


class JStage(fnn.Module):
    """A resnet layer as benchmarks/resnet_stage_probe.py stacks it, in bf16."""
    planes: int
    blocks: int
    in_planes: int
    stride: int = 1
    dilation: int = 1

    @fnn.compact
    def __call__(self, x, train: bool = False):
        for blk in j_make_layer(self.planes, self.blocks, self.in_planes, stride=self.stride,
                                dilation=self.dilation, dtype=jnp.bfloat16):
            x = blk(x, train)
        return x


class Stage(nn.Module):
    def __init__(self, planes, blocks, in_planes, stride=1, dilation=1):
        super().__init__()
        self.layer1 = _make_layer(planes, blocks, in_planes, stride=stride, dilation=dilation)

    def forward(self, x):
        return self.layer1(x.contiguous(memory_format=torch.channels_last))


def _as_backbone(tree):
    """A JStage collection ({layer_i: ...}) under the names the converter
    knows ({backbone: {layer1_i: ...}})."""
    return {"backbone": {k.replace("layer_", "layer1_"): v for k, v in tree.items()}}


@pytest.fixture(scope="module")
def stage():
    jm = JStage(32, 2, 128, 1, 2)
    x = (np.random.RandomState(2).randn(1, 32, 16, 128) * 2).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    v = _np_tree(random_variables(jm, xb, seed=6))
    vq = j_calibrate(jm, v, [xb])
    port = Stage(32, 2, 128, 1, 2).eval()
    load_port(port, {k: _as_backbone(v[k]) for k in ("params", "batch_stats")},
              prefix="backbone.")
    quant = ActScales({k[len("backbone."):]: t(a) for k, a in
                       quant_from_jax(_as_backbone(_np_tree(vq["quant"]))).items()})
    return jm, vq, xb, port, quant, _nchw(x).bfloat16()


def test_stage_calibration_matches_jax(stage):
    _, _, _, port, carried, x = stage
    own = calibrate(port, [x])
    assert set(own) == set(carried) and len(own) == 6  # 2 blocks x 3 convs, no downsample
    for k in own:
        np.testing.assert_allclose(float(own[k]), float(carried[k]), rtol=1e-6)


def test_build_fused_block_inputs_matches_jax(stage):
    jm, vq, _, port, quant, _ = stage
    jmap = JP.build_fused_block_inputs(vq, JQuantConfig(fused_blocks=True))
    pmap = build_fused_block_inputs(port, quant, QuantConfig(fused_blocks=True))
    assert sorted(jmap) == ["layer_0", "layer_1"] and sorted(pmap) == ["layer1.0", "layer1.1"]
    with_ds = Stage(32, 2, 64, 1, 2)  # 64 != 4 * 32: the first block gets a downsample
    scales = {f"layer1.{i}.conv{j}": 1.0 for i in (0, 1) for j in (1, 2, 3)}
    assert sorted(build_fused_block_inputs(with_ds, scales)) == ["layer1.1"]
    del scales["layer1.1.conv2"]  # a block lacking a scale is left out
    assert build_fused_block_inputs(with_ds, scales) == {}
    for jname, name in (("layer_0", "layer1.0"), ("layer_1", "layer1.1")):
        _assert_same_pre(jmap[jname], pmap[name])


def _assert_same_pre(jpre, pre):
    assert set(pre) == set(jpre)
    for k in ("w1", "w2", "w3"):
        assert pre[k].dtype == torch.int8 and pre[k].shape == jpre[k].shape
        np.testing.assert_array_equal(pre[k].numpy(), np.asarray(jpre[k]))
    for k in ("a1", "b1", "a2", "b2", "a3", "b3"):
        np.testing.assert_allclose(pre[k].detach().numpy(), np.asarray(jpre[k]), rtol=1e-6,
                                   atol=1e-9)
    for k in ("s_x", "s_h1", "s_h2"):
        assert isinstance(pre[k], float)
        np.testing.assert_allclose(pre[k], float(jpre[k]), rtol=1e-6)


@pytest.mark.parametrize("route", ["per_conv", "fused_blocks", "fused_conv3"])
def test_stage_int8_matches_jax_with_carried_scales(stage, route):
    """Scales calibrated in JAX, carried over; each route against the same
    route of the JAX package (its fused routes through the interpreter)."""
    jm, vq, xb, port, quant, x = stage
    flags = {} if route == "per_conv" else {route: True, "fused_interpret": True}
    want = np.asarray(j_quantized_apply(jm, JQuantConfig(**flags))(vq, xb), np.float32)
    with torch.no_grad():
        got = quantized_apply(port, QuantConfig(**flags))(quant, x)
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 0.05 * scale
    assert np.abs(got - want).mean() < 0.002 * scale


def test_fused_routes_stay_close_to_per_conv_and_are_taken(stage, monkeypatch):
    _, _, _, port, quant, x = stage
    from segland_tpu_torch.ops import fused_bottleneck as FB

    calls = []
    monkeypatch.setattr(FB, "bottleneck_int8_reference",
                        lambda *a, _fn=FB.bottleneck_int8_reference, **kw:
                        calls.append(kw["dilation"]) or _fn(*a, **kw))
    with torch.no_grad():
        plain = quantized_apply(port)(quant, x).float()
        blocks = quantized_apply(port, QuantConfig(fused_blocks=True, fused_interpret=True))(
            quant, x).float()
        assert calls == [2, 2]  # two eligible blocks, dilation 2
        conv3 = quantized_apply(port, QuantConfig(fused_conv3=True, fused_interpret=True))(
            quant, x).float()
        assert calls == [2, 2]  # fused_conv3 is stock torch, no fused op
        both = quantized_apply(port, QuantConfig(fused_blocks=True, fused_conv3=True,
                                                 fused_interpret=True))(quant, x).float()
        assert calls == [2] * 4  # fused_blocks wins
        fp32_in = quantized_apply(port, QuantConfig(fused_blocks=True, fused_interpret=True))(
            quant, x.float())
        assert calls == [2] * 4 and fp32_in.dtype == torch.float32  # bfloat16 input only
    scale = plain.abs().max()
    assert (plain - blocks).abs().max() < 0.05 * scale
    assert (plain - conv3).abs().max() < 0.05 * scale
    assert torch.equal(both, blocks)
    assert not torch.equal(blocks, plain) and not torch.equal(conv3, blocks)


def test_fused_request_that_cannot_take_effect_warns(stage, caplog):
    _, _, _, port, quant, x = stage
    with caplog.at_level(logging.WARNING, logger="segland_tpu_torch.quant.ptq"):
        with torch.no_grad():
            out = quantized_apply(port, QuantConfig(fused_blocks=True))(quant, x)
            ref = quantized_apply(port)(quant, x)
    assert "needs CUDA" in caplog.text and torch.equal(out, ref)
    caplog.clear()
    mlp = nn.Sequential(nn.Linear(64, 64))
    q = calibrate(mlp, [torch.randn(2, 64)])
    with caplog.at_level(logging.WARNING, logger="segland_tpu_torch.quant.ptq"):
        quantized_apply(mlp, QuantConfig(fused_conv3=True, fused_interpret=True))(
            q, torch.randn(2, 64))
    assert "no Bottleneck has a fused-eligible weight set" in caplog.text


# ---- narrow deeplab_pop, scales carried both ways --------------------------
@pytest.fixture(scope="module")
def deeplab():
    jm = j_build("deeplab_pop", "resnet10", n_base=7)
    v = _np_tree(random_variables(jm, jnp.zeros((1, 64, 64, 3)), seed=0))
    port = load_port(meta_build(build_model, "deeplab_pop", "resnet10", n_base=7), v)
    img = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    return jm, v, port, img


@pytest.mark.parametrize("estimator", ["absmax", "percentile"])
def test_calibrate_scales_match_jax(deeplab, estimator):
    jm, v, port, img = deeplab
    vq = j_calibrate(jm, v, [jnp.asarray(img)], cfg=JQuantConfig(act_estimator=estimator))
    want = quant_from_jax(_np_tree(vq["quant"]))
    got = calibrate(port, [_nchw(img)], QuantConfig(act_estimator=estimator))
    assert set(got) == set(want) and len(got) == 22
    assert "backbone.conv1" not in got  # 3 input channels: skipped
    assert all(a.shape == () and float(a) > 0 for a in got.values())
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_int8_logits_match_jax_with_scales_carried_across(deeplab, direction):
    jm, v, port, img = deeplab
    if direction == "jax_to_port":
        vq = j_calibrate(jm, v, [jnp.asarray(img)])
        quant = ActScales({k: t(a) for k, a in quant_from_jax(_np_tree(vq["quant"])).items()})
    else:
        quant = calibrate(port, [_nchw(img)])
        tree = quant_to_jax({k: a.numpy() for k, a in quant.items()}, v["params"])
        vq = {**v, "quant": tree}
        assert len(jax.tree_util.tree_leaves(tree)) == len(quant)
    want = np.asarray(j_quantized_apply(jm)(vq, jnp.asarray(img)))
    with torch.no_grad():
        got = quantized_apply(port)(quant, _nchw(img)).permute(0, 2, 3, 1).numpy()
        fp32 = port(_nchw(img)).permute(0, 2, 3, 1).numpy()
    scale = np.abs(want).max()
    assert got.shape == want.shape == (2, 8, 8, 8)
    assert np.abs(got - want).max() < 0.01 * scale
    assert 0 < np.abs(got - fp32).max() < 0.1 * scale  # quantized, and still the same model


def test_quant_to_jax_refuses_an_unknown_module(deeplab):
    _, v, _, _ = deeplab
    with pytest.raises(KeyError, match="nowhere"):
        quant_to_jax({"backbone.nowhere": np.float32(1.0)}, v["params"])
    with pytest.raises(KeyError):
        quant_from_jax({"backbone": {"conv1": {"other": np.float32(1.0)}}})


def test_int8_forward_tracks_fp32(deeplab):
    """The port's mirror of test_calibrate_and_int8_forward_close."""
    _, _, port, img = deeplab
    x = _nchw(img)
    quant = calibrate(port, [x])
    with torch.no_grad():
        ref = port(x)
        out = quantized_apply(port)(quant, x)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    a = ref.permute(0, 2, 3, 1).reshape(-1, 8).double().numpy()
    b = out.permute(0, 2, 3, 1).reshape(-1, 8).double().numpy()
    cos = (a * b).sum(-1) / np.maximum(np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1),
                                       1e-9)
    assert cos.mean() > 0.98 and (a.argmax(-1) == b.argmax(-1)).mean() > 0.90


def test_running_max_and_state_dict_untouched(deeplab):
    _, _, port, img = deeplab
    before = {k: v.clone() for k, v in port.state_dict().items()}
    small, big = _nchw(img[:1] * 0.1), _nchw(img[:1] * 3.0)
    q1 = calibrate(port, [small])
    a1 = {k: float(v) for k, v in q1.items()}
    v1 = q1.version
    q2 = calibrate(port, [big], quant=q1)
    assert q2 is q1 and q2.version == v1 + 1
    assert all(float(q2[k]) >= a1[k] - 1e-6 for k in a1)
    assert any(float(q2[k]) > a1[k] for k in a1)
    after = port.state_dict()
    assert list(after) == list(before)
    assert all(torch.equal(after[k], before[k]) for k in before)
    assert not any("forward" in m.__dict__ for m in port.modules())  # nothing left taken


# ---- skip rules, dense layers, errors --------------------------------------
class SkipNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.big = nn.Conv2d(64, 64, 3, padding=1)
        self.dw = nn.Conv2d(64, 64, 3, padding=1, groups=64)   # depthwise: skip
        self.grouped = nn.Conv2d(64, 64, 1, groups=2)          # grouped: skip
        self.narrow_in = nn.Conv2d(64, 16, 1)                  # < 32 out: skip
        self.widen = nn.Conv2d(16, 64, 1)                      # < 32 in: skip
        self.same = nn.Conv2d(64, 64, 3, padding="same", dilation=2)
        self.reflect = nn.Conv2d(64, 64, 3, padding=1, padding_mode="reflect")  # skip
        self.tiny_head = nn.Conv2d(64, 8, 1)                   # < 32 out: skip

    def forward(self, x):
        x = self.grouped(self.dw(self.big(x)))
        x = self.reflect(self.same(self.widen(self.narrow_in(x))))
        return self.tiny_head(x)


def test_skip_rules():
    net = SkipNet().eval()
    x = torch.randn(1, 64, 16, 16, generator=torch.Generator().manual_seed(0))
    quant = calibrate(net, [x])
    assert set(quant) == {"big", "same"}
    assert set(calibrate(net, [x], QuantConfig(skip_paths=("sam",)))) == {"big"}
    assert set(calibrate(net, [x], QuantConfig(min_in=16, min_out=8))) == {
        "big", "same", "narrow_in", "widen", "tiny_head"}
    with torch.no_grad():
        ref, out = net(x), quantized_apply(net)(quant, x)
    assert (out - ref).abs().max() < 0.05 * ref.abs().max()


class MLP(nn.Sequential):
    def __init__(self):
        super().__init__(nn.Linear(64, 128), nn.ReLU(), nn.Linear(128, 64))


def test_dense_quantization():
    net = MLP().eval()
    x = t(np.random.RandomState(2).randn(4, 17, 64).astype(np.float32))
    quant = calibrate(net, [x])
    assert set(quant) == {"0", "2"}
    with torch.no_grad():
        ref, out = net(x), quantized_apply(net)(quant, x)
    assert out.shape == ref.shape
    assert (out - ref).abs().max() / (ref.abs().max() + 1e-9) < 0.05
    assert not torch.equal(out, ref)
    assert set(calibrate(net, [x], QuantConfig(quantize_dense=False))) == set()


def test_dense_matches_jax_with_the_same_weights():
    class JMLP(fnn.Module):
        @fnn.compact
        def __call__(self, x, train: bool = False):
            return fnn.Dense(64, name="fc2")(fnn.relu(fnn.Dense(128, name="fc1")(x)))

    rng = np.random.RandomState(3)
    x = rng.randn(4, 17, 64).astype(np.float32)
    jm, net = JMLP(), MLP().eval()
    v = _np_tree(random_variables(jm, jnp.asarray(x), seed=7))
    for name, mod in (("fc1", net[0]), ("fc2", net[2])):
        mod.load_state_dict(dict(weight=t(v["params"][name]["kernel"].T),
                                 bias=t(v["params"][name]["bias"])))
    vq = j_calibrate(jm, v, [jnp.asarray(x)])
    want = np.asarray(j_quantized_apply(jm)(vq, jnp.asarray(x)))
    quant = calibrate(net, [t(x)])
    np.testing.assert_allclose(float(quant["0"]), float(vq["quant"]["fc1"]["act_amax"]), rtol=1e-6)
    np.testing.assert_allclose(float(quant["2"]), float(vq["quant"]["fc2"]["act_amax"]), rtol=1e-6)
    with torch.no_grad():
        got = quantized_apply(net)(quant, t(x)).numpy()
    assert np.abs(got - want).max() < 0.01 * np.abs(want).max()


def test_int8_without_calibration_raises():
    net = MLP().eval()
    x = torch.ones(1, 4, 64)
    with pytest.raises(ValueError, match="calibrate"):
        quantized_apply(net)(ActScales(), x)
    with pytest.raises(ValueError, match="calibrate"):
        quantized_apply(net)(None, x)
    with pytest.raises(ValueError, match="no batches"):
        calibrate(net, [])
    with pytest.raises(ValueError, match="no activation scale"):
        quantized_apply(net)(ActScales({"0": torch.tensor(1.0)}), x)  # "2" was never seen
    with pytest.raises(ValueError, match="unknown quant mode"):
        quant_interceptor(net, "fp4", quant=ActScales())


def test_percentile_calibration_outlier_robust():
    net = MLP().eval()
    x = np.random.RandomState(7).randn(4, 32, 64).astype(np.float32)
    x[0, 0, 0] = 500.0
    x = t(x)
    with torch.no_grad():
        ref = net(x)
        errs = {}
        for est in ("absmax", "percentile"):
            cfg = QuantConfig(act_estimator=est, percentile=99.9)
            out = quantized_apply(net, cfg)(calibrate(net, [x], cfg), x)
            errs[est] = float((out - ref)[1:].abs().mean())
    assert errs["percentile"] < errs["absmax"] * 0.5, errs


def test_weights_are_requantized_when_they_change():
    net = MLP().eval()
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(1))
    quant = calibrate(net, [x])
    apply = quantized_apply(net)
    with torch.no_grad():
        a = apply(quant, x)
        assert torch.equal(apply(quant, x), a)
        net[2].weight.mul_(2.0)
        net[2].bias.zero_()
        b = apply(quant, x)
    ref = (a - net[2].bias) * 2.0
    assert not torch.equal(a, b)
    with torch.no_grad():
        fresh = quantized_apply(net)(quant, x)
    assert torch.equal(b, fresh)


def test_interceptor_is_exclusive_and_restores_on_error():
    net = MLP().eval()
    quant = ActScales()
    with quant_interceptor(net, "calibrate", quant=quant):
        with pytest.raises(RuntimeError, match="another quant_interceptor"):
            quant_interceptor(net, "calibrate", quant=quant).__enter__()
    with pytest.raises(ZeroDivisionError):
        with quant_interceptor(net, "calibrate", quant=quant):
            1 / 0
    assert not any("forward" in m.__dict__ for m in net.modules())


# ---- the Evaluator's int8 mode ---------------------------------------------
def test_evaluator_int8_calibrates_then_predicts(deeplab):
    from segland_tpu_torch.evallib import Evaluator

    _, _, port, img = deeplab
    ev = Evaluator(port, "cpu", num_classes=8, int8=True, calib_batches=2)
    scales = []
    for gain in (1.0, 2.0, 1.5):
        logits, pred = ev.predict_batch(img * gain, (64, 64))
        scales.append({k: float(v) for k, v in ev._quant.items()})
    assert logits.shape == (2, 64, 64, 8) and pred.dtype == torch.uint8
    assert ev._calib_seen == 2 and len(scales[0]) == 22
    assert any(scales[1][k] > scales[0][k] for k in scales[0])  # the second batch raised them
    assert scales[2] == scales[1]                               # the third calibrates nothing
    fp32 = Evaluator(port, "cpu", num_classes=8).predict_batch(img * 1.5, (64, 64))[0]
    assert 0 < (logits - fp32).abs().max() < 0.1 * fp32.abs().max()
    with pytest.raises(ValueError, match="calib_batches"):
        Evaluator(port, "cpu", int8=True, calib_batches=0)


def test_evaluator_precalibrated_scales_skip_the_warm_up(deeplab):
    from segland_tpu.evallib import Evaluator as JEvaluator
    from segland_tpu_torch.evallib import Evaluator

    jm, v, port, img = deeplab
    vq = j_calibrate(jm, v, [jnp.asarray(img)])
    quant = quant_from_jax(_np_tree(vq["quant"]))
    ev = Evaluator(port, "cpu", num_classes=8, int8=True, quant=quant)
    assert ev.calib_batches == 0
    logits, pred = ev.predict_batch(img * 5.0, (64, 64))  # would raise the scales if it calibrated
    assert all(float(ev._quant[k]) == float(quant[k]) for k in quant)
    jlogits, jpred = JEvaluator(jm, vq, num_classes=8, int8=True,
                                fused_epilogue=False).predict_batch(img * 5.0, (64, 64))
    assert np.abs(logits.numpy() - np.asarray(jlogits)).max() < 0.01 * np.abs(jlogits).max()
    assert (pred.numpy() == np.asarray(jpred)).mean() > 0.97


# ---- a global batch over ranks (calibrate_across_ranks) --------------------
def _one_layer(kind):
    """A conv or a linear layer and an input of 3 rows whose rows hold 72,380
    and 72,415 values: the global percentile sample takes every third value,
    so the ranks' first values fall at offsets 1 and 2 of the stride."""
    rng = np.random.RandomState(9)
    if kind == "conv":
        return nn.Conv2d(35, 40, 1).eval(), t(rng.randn(3, 35, 44, 47).astype(np.float32))
    return nn.Linear(35, 40).eval(), t(rng.randn(3, 2069, 35).astype(np.float32))


@pytest.mark.parametrize("kind", ["conv", "linear"])
@pytest.mark.parametrize("estimator", ["absmax", "percentile"])
def test_ranks_shares_give_one_process_scales_exactly(kind, estimator):
    """Rows of one global batch split over ranks in every way (an empty share
    included): each share's part of the estimate, joined as
    calibrate_across_ranks joins them (the maximum; the samples in rank order,
    then the quantile), equals one process's scale bit for bit.  Without a
    process group calibrate_across_ranks is calibrate."""
    from segland_tpu_torch.quant import calibrate_across_ranks

    layer, x = _one_layer(kind)
    net = nn.Sequential(layer)
    cfg = QuantConfig(act_estimator=estimator)
    want = float(calibrate(net, [x], cfg)["0"])
    for shares in ([3], [2, 1], [1, 2], [1, 1, 1], [1, 0, 2]):
        parts, first = [], 0
        for n in shares:
            local = {}
            if n:
                shard = (first, 3, n) if estimator == "percentile" else None
                with torch.no_grad(), quant_interceptor(net, "calibrate", cfg, local,
                                                        shard=shard):
                    net(x[first:first + n])
                parts.append(local["0"])
            first += n
        if estimator == "percentile":
            got = torch.quantile(torch.cat(parts), cfg.percentile / 100.0)
        else:
            got = torch.stack(parts).max()
        assert float(got) == want, shares
    alone = calibrate_across_ranks(net, x, ActScales(), cfg)
    assert float(alone["0"]) == want and alone.version == 1


# ---- convnext_pop and swin_pop: whole models, dense layers in int8 ----------
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("name", ["convnext_pop", "swin_pop"])
def test_transformer_int8_matches_jax_with_scales_carried_across(monkeypatch, name, direction):
    """convnext_pop and swin_pop at a narrow width (tests/ft_helpers.py's
    backbones), every large conv and nn.Linear / nn.Dense in int8
    (``quantize_dense``, the default): the calibrations agree layer by layer at
    this file's scale bar, and with the scales carried across the logits agree
    within 1% of the largest, as the ResNet models' do."""
    from ft_helpers import narrow_backbones

    narrow_backbones(monkeypatch)
    backbone = "convnext-t" if name == "convnext_pop" else "swin-t"
    jm = j_build(name, backbone=backbone, n_base=7)
    v = _np_tree(random_variables(jm, jnp.zeros((1, 64, 64, 3)), seed=3))
    port = load_port(meta_build(build_model, name, backbone, n_base=7), v).eval()
    img = np.random.RandomState(4).randn(2, 64, 64, 3).astype(np.float32)
    own = calibrate(port, [_nchw(img)])
    vq = j_calibrate(jm, v, [jnp.asarray(img)])
    jown = quant_from_jax(_np_tree(vq["quant"]))
    dense = [n for n, m in port.named_modules() if type(m) is nn.Linear and n in own]
    assert set(own) == set(jown)
    assert len(dense) >= 6  # the MLPs of the blocks 32 channels or wider (swin: qkv, proj)
    for k in own:
        np.testing.assert_allclose(float(own[k]), float(jown[k]), rtol=1e-6, err_msg=k)
    if direction == "jax_to_port":
        quant = ActScales({k: t(a) for k, a in jown.items()})
    else:
        quant = own
        vq = {**v, "quant": quant_to_jax({k: a.numpy() for k, a in own.items()}, v["params"])}
    want = np.asarray(j_quantized_apply(jm)(vq, jnp.asarray(img)))
    with torch.no_grad():
        got = quantized_apply(port)(quant, _nchw(img)).permute(0, 2, 3, 1).numpy()
        fp32 = port(_nchw(img)).permute(0, 2, 3, 1).numpy()
    scale = np.abs(want).max()
    assert got.shape == want.shape == (2, 16, 16, 8)
    assert np.abs(got - want).max() < 0.01 * scale
    assert 0 < np.abs(got - fp32).max() < 0.1 * scale  # quantized, and still the same model


# ---- seghr_pop / hr-w32: conv by conv, no fused block ----------------------
@pytest.fixture(scope="module")
def seghr():
    """seghr_pop / hr-w32 and the JAX model with its branches unpacked: the JAX
    package's W-packed chains (its default) run raw weights outside nn.Conv,
    so its interceptor leaves their convs in fp32, where the port (which has
    no packed layout) quantizes every conv of 32 channels or more."""
    from torch_helpers import tame_hrnet
    import segland_tpu.models.pop as jpop

    kw = dict(n_base=7, n_novel=4, is_ft=True)  # tests/test_torch_hrnet.py's model
    jm = j_build("seghr_pop", "hr-w32", **kw)
    v = _np_tree(tame_hrnet(random_variables(jm, jnp.zeros((1, 64, 64, 3)), seed=0)))
    port = load_port(meta_build(build_model, "seghr_pop", "hr-w32", **kw), v)
    img = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    get = jpop.get_backbone

    def unpacked(fn):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jpop, "get_backbone", lambda name, **kw: get(name, packed=False, **kw))
            return fn()

    return jm, v, port, img, unpacked


def _jax_convs(jm, vq, img, unpacked):
    """The JAX package's quantized_apply over ``img`` with every nn.Conv's
    input and output recorded ({module path: (x, y)}, NHWC), and its logits."""
    rec = {}

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if type(context.module) is fnn.Conv and context.method_name == "__call__":
            rec["/".join(context.module.path)] = (np.asarray(args[0]), np.asarray(out))
        return out

    def run():
        with fnn.intercept_methods(record):  # the outer one sees the call first
            with fnn.intercept_methods(JP.quant_interceptor("int8")):
                return jm.apply(vq, jnp.asarray(img))

    return rec, np.asarray(unpacked(run))


def test_seghr_int8_matches_jax_with_scales_carried_across(seghr):
    """The port's calibration carried into the JAX tree (``quant_to_jax``):
    every conv of the backbone but the stem's first (3 inputs) takes a scale.
    Conv by conv, each of the port's int8 convs on the JAX conv's own input
    within 1% of the JAX output's largest |value| (seen: equal).  The whole
    model within 5% of the largest logit (tests/test_quant.py's own bar;
    seen 2.6%): the two frameworks' fp32 sums differ in their last bits, a
    value that sits on a rounding edge of the next quantization goes the
    other way (first at layer1.2.conv2, 0.0026 of 1.27), and over 304
    requantizations such flips decorrelate the roundings, so the whole-model
    gap approaches int8's own distance from fp32, not the 1% of resnet10's 22
    convs; quantized, and still the same model."""
    jm, v, port, img, unpacked = seghr
    quant = calibrate(port, [_nchw(img)])
    convs = [n for n, m in port.named_modules() if isinstance(m, nn.Conv2d)
             and n.startswith("backbone.")]
    assert set(quant) == set(convs) - {"backbone.conv1"} and len(quant) == 304
    vq = {**v, "quant": quant_to_jax({k: a.numpy() for k, a in quant.items()}, v["params"])}
    rec, want = _jax_convs(jm, vq, img, unpacked)
    modules = dict(port.named_modules())
    names = {_module_name(p): p for p in rec}
    assert set(names) == set(convs)
    with torch.no_grad(), quant_interceptor(port, "int8", quant=quant) as q:
        for name in quant:
            x, y = rec[names[name]]
            got_y = q._layer(name, modules[name], _nchw(x)).permute(0, 2, 3, 1).numpy()
            assert np.abs(got_y - y).max() < 0.01 * np.abs(y).max(), name
    with torch.no_grad():
        got = quantized_apply(port)(quant, _nchw(img)).permute(0, 2, 3, 1).numpy()
        fp32 = port(_nchw(img)).permute(0, 2, 3, 1).numpy()
    scale = np.abs(want).max()
    assert got.shape == want.shape == (2, 16, 16, 12)
    assert np.abs(got - want).max() < 0.05 * scale
    assert 0 < np.abs(got - fp32).max() < 0.1 * scale


def test_fused_route_takes_no_hrnet_block(seghr, stage, monkeypatch, caplog):
    """HRNet's stage-1 Bottlenecks (conv1-3, bn1-3, no downsample in blocks
    1-3) are not the fused route's, as in the JAX package (its HRNet has no
    Bottleneck module): no fused inputs on either side, the warning the JAX
    package gives, and --int8 --fused equal to --int8 with no fused call.
    The ResNet's blocks are still found."""
    from segland_tpu_torch.ops import fused_bottleneck as FB

    jm, v, port, img, _ = seghr
    x = _nchw(img[:1, :32, :32]).bfloat16()
    quant = calibrate(port, [x])
    assert {f"backbone.layer1.{i}.conv{j}" for i in range(4) for j in (1, 2, 3)} <= set(quant)
    cfg = QuantConfig(fused_blocks=True, fused_interpret=True)
    assert build_fused_block_inputs(port, quant, cfg) == {}
    assert JP.build_fused_block_inputs({**v, "quant": quant_to_jax(
        {k: a.numpy() for k, a in quant.items()}, v["params"])}, JQuantConfig(fused_blocks=True)) == {}
    _, _, _, resnet_layer, rquant, _ = stage
    assert sorted(build_fused_block_inputs(resnet_layer, rquant, cfg)) == ["layer1.0", "layer1.1"]
    calls = []
    monkeypatch.setattr(FB, "bottleneck_int8_reference",
                        lambda *a, _fn=FB.bottleneck_int8_reference, **kw:
                        calls.append(1) or _fn(*a, **kw))
    with caplog.at_level(logging.WARNING, logger="segland_tpu_torch.quant.ptq"):
        with torch.no_grad():
            fused = quantized_apply(port, cfg)(quant, x)
            plain = quantized_apply(port)(quant, x)
    assert "no Bottleneck has a fused-eligible weight set" in caplog.text
    assert calls == [] and torch.equal(fused, plain)


# The int8 accuracy gate on a TRAINED model (moved here from tests/test_torch_quant_gate.py, so
# that xdist's loadfile, which sends files with many tests first, starts it early):
# Accuracy gate of the port's int8 path on a TRAINED model: pspnet_pop /
# resnet10 is trained on the learnable colour task (tests/synthtask.py) by the
# JAX package's train_base CLI, its best checkpoint is carried into the port,
# and the port's Evaluator scores the base validation tiles in fp32 and in int8
# (two calibration batches).
#
# The gate (slow, 150 epochs, as tests/test_fewshot_learns.py trains it):
# |d mIoU| <= 0.002 and >= 99% of the pixels the same class.  Beside it a small
# case that tier-1 runs: 40 epochs, where the model has only begun to fit
# (val mIoU about 0.3; after 20 it still predicts three classes only), held to
# |d mIoU| <= 0.005 and >= 98%: a half-trained model has more pixels near a tie.
# In both, the port's fp32 mIoU equals the JAX Evaluator's on the same
# checkpoint.

GATE_ARGS = ["--model", "pspnet_pop", "--backbone", "resnet10", "--num-workers", "0",
             "--norm-stats", "train"]


@pytest.fixture(scope="module")
def task_root(tmp_path_factory):
    return build_task(tmp_path_factory.mktemp("oem_int8_gate"))


def _train(task_root, snap, epochs):
    from segland_tpu.cli.train_base import main

    return main(["--data-dir", str(task_root),
                 "--train-list", str(task_root / "list" / "train.txt"),
                 "--val-list", str(task_root / "list" / "val_base.txt"),
                 "--snapshot-dir", snap, "--input-size", "32,32", "--batch-size", "4",
                 "--num-epoch", str(epochs), "--learning-rate", "1e-3", "--val-start", "0",
                 "--val-frequency", "10", "--snapshot-frequency", str(epochs)] + GATE_ARGS)


def _gate(task_root, snap, d_miou, agreement):
    from segland_tpu.ckpt import load_params
    from segland_tpu.data import Loader as JLoader, OEMValDataset as JValDataset
    from segland_tpu.evallib import Evaluator as JEvaluator
    from segland_tpu.models import build_model as j_build
    from segland_tpu_torch.data import Loader, OEMValDataset
    from segland_tpu_torch.evallib import Evaluator
    from segland_tpu_torch.models import build_model

    jm = j_build("pspnet_pop", "resnet10", n_base=7)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)
    v = jax.tree_util.tree_map(np.asarray, load_params(
        os.path.join(snap, "best.ckpt"), jax.tree_util.tree_map(np.asarray, v)))
    port = load_port(meta_build(build_model, "pspnet_pop", "resnet10", n_base=7), v)
    val = str(task_root / "list" / "val_base.txt")

    def run(**kw):
        ev = Evaluator(port, "cpu", num_classes=8, n_base=7, **kw)
        ds = OEMValDataset(str(task_root), val, base_size=(64, 64), stats="train")
        _, (base, _, total, _), _ = ev.run(Loader(ds, 2, shuffle=False, num_workers=0))
        preds = [ev.predict_batch(np.asarray(img, np.float32), (64, 64), want_logits=False)[1]
                 for img, _, _ in Loader(ds, 2, shuffle=False, num_workers=0)]
        return base, total, np.concatenate([p.numpy() for p in preds])

    b_f, t_f, pred_f = run()
    b_q, t_q, pred_q = run(int8=True, calib_batches=2)
    jds = JValDataset(str(task_root), val, base_size=(64, 64), stats="train")
    _, (jb, _, jt, _), _ = JEvaluator(jm, v, num_classes=8, n_base=7,
                                      fused_epilogue=False).run(JLoader(jds, 2, shuffle=False))
    agree = float(np.mean(pred_f == pred_q))
    print(f"int8 gate: total mIoU fp32 {t_f:.4f} (JAX {jt:.4f}) int8 {t_q:.4f} "
          f"(d={abs(t_f - t_q):.5f}), agreement {agree:.5f}")
    assert abs(t_f - jt) < 1e-9 and abs(b_f - jb) < 1e-9
    assert len(np.unique(pred_f)) >= 4, "degenerate model: the gate would compare constants"
    assert agree >= agreement, f"int8 argmax agreement {agree:.4f}"
    assert abs(t_f - t_q) <= d_miou and abs(b_f - b_q) <= d_miou, (t_f, t_q, b_f, b_q)


def test_int8_gate_small_case(task_root, tmp_path_factory):
    snap = str(tmp_path_factory.mktemp("snap_small"))
    best = _train(task_root, snap, 40)
    assert best >= 0.15, f"training degenerate (val mIoU {best})"
    _gate(task_root, snap, d_miou=0.005, agreement=0.98)


@pytest.mark.slow
def test_int8_accuracy_gate_on_trained_model(task_root, tmp_path_factory):
    snap = str(tmp_path_factory.mktemp("snap_full"))
    best = _train(task_root, snap, 150)
    assert best >= 0.40, f"base training degenerate (val mIoU {best})"
    _gate(task_root, snap, d_miou=0.002, agreement=0.99)
