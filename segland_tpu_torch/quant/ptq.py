"""int8 post-training quantization by interception: no model changes, and
``state_dict()`` keeps its keys.

Port of segland_tpu/quant/ptq.py.  Where the JAX package swaps the
``__call__`` of flax modules with ``nn.intercept_methods``, an open
:func:`quant_interceptor` sets ``forward`` on the instance of every *large*
``nn.Conv2d`` / ``nn.Linear`` of the model (the ``conv2d`` / ``linear`` helpers
of ``ops/layers.py`` hand the call to it, as ``module(x)`` does) and takes it away on exit:

  * weights: per-output-channel symmetric int8, quantized from the fp32
    parameters when first used (the parameters are untouched, so upstream
    ``.pth`` checkpoints keep working);
  * activations: per-tensor symmetric int8 with a static scale from a
    calibration pass (running abs-max over the calibration batches), kept in
    an :class:`ActScales` dict apart from the ``state_dict``;
  * exact int32 accumulation (``ops/int8.py``), then
    ``y = acc * (s_x * s_w) + bias`` in fp32, cast to the input's dtype.

Skipped (stay bf16/fp32): grouped and depthwise convs, layers with fewer than
32 input or output channels (stems, classifier heads), anything matching
``QuantConfig.skip_paths``, and the fp32 POP head, whose classifier convs are
never called as modules (models/pop.py).

With ``fused_blocks`` (or ``fused_conv3``) each eligible ResNet ``Bottleneck``
(stride 1, no downsample, bfloat16 input; HRNet's stage-1 blocks are not
eligible, as in the JAX package) runs whole: through the fused
kernel of ``ops/fused_bottleneck.py`` on CUDA (its plain version on the CPU
with ``fused_interpret``), or as one chain of stock torch ops.
"""

import dataclasses
import logging
from typing import Tuple

import torch
import torch.nn as nn

from ..ops.int8 import int8_conv2d, int_matmul, quantize_sym
from ..ops.layers import conv2d_plain, linear_plain


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    min_in: int = 32       # skip convs/linears with fewer input channels (stem)
    min_out: int = 32      # skip tiny heads (classifiers)
    skip_paths: Tuple[str, ...] = ()   # substring match on the dotted module path
    quantize_dense: bool = True        # nn.Linear too (swin/convnext MLPs, qkv/proj)
    # activation-scale estimator: "absmax" (exact running max) or "percentile"
    # (robust to rare outliers: it clips the top tail).  The percentile is the
    # p-quantile of a strided subsample of at most ~131k magnitudes per batch,
    # under a running max across calibration batches.
    act_estimator: str = "absmax"
    percentile: float = 99.9
    # run each eligible resnet Bottleneck through the fused block kernel
    # (ops/fused_bottleneck.py): one launch a block
    fused_blocks: bool = False
    # run each eligible Bottleneck as one chain of stock torch ops instead of
    # conv by conv; fused_blocks wins if both are set
    fused_conv3: bool = False
    fused_interpret: bool = False  # take the fused routes on the CPU too (plain version)


DEFAULT_CONFIG = QuantConfig()


class ActScales(dict):
    """{dotted module name: act_amax, a 0-dim fp32 tensor}.  ``version`` counts
    the calibration passes, so that what was derived from the scales can be
    cached."""

    version = 0


def _fold_bn(bn: nn.BatchNorm2d):
    """Eval-mode BatchNorm as a per-channel affine (scale, shift), fp32."""
    bs = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    return bs, bn.bias.float() - bn.running_mean.float() * bs


def _wq(kernel: torch.Tensor, axes):
    """Per-output-channel symmetric int8 of a kernel whose last axis is the
    output channel; ``axes`` are the others.  Returns (int8, scale)."""
    k = kernel.float()
    s = k.abs().amax(dim=axes).clamp_min(1e-8) / 127.0
    return quantize_sym(k, s), s


def _act_scale(amax: torch.Tensor) -> torch.Tensor:
    return amax.clamp_min(1e-6) / 127.0


def build_fused_block_inputs(model: nn.Module, quant: dict, cfg: QuantConfig = DEFAULT_CONFIG):
    """The fused routes' inputs for every ResNet Bottleneck (a module whose
    ``int8_fusable`` is set, with conv1, bn1, conv2, conv3 and no downsample)
    whose three convs have calibrated scales, keyed by module name; weights in
    the JAX package's layouts.  HRNet's stage-1 Bottlenecks are left out, as
    the JAX package's route leaves them (they are not Bottleneck modules there)."""
    out = {}
    for name, m in model.named_modules():
        if not getattr(m, "int8_fusable", False):
            continue
        convs = [getattr(m, k, None) for k in ("conv1", "conv2", "conv3")]
        bns = [getattr(m, k, None) for k in ("bn1", "bn2", "bn3")]
        keys = [f"{name}.{k}" if name else k for k in ("conv1", "conv2", "conv3")]
        if (any(not isinstance(c, nn.Conv2d) for c in convs) or hasattr(m, "downsample")
                or any(not isinstance(b, nn.BatchNorm2d) for b in bns)
                or any(k not in quant for k in keys)):
            continue
        w1q, sw1 = _wq(convs[0].weight[:, :, 0, 0].t(), (0,))
        w2q, sw2 = _wq(convs[1].weight.permute(2, 3, 1, 0), (0, 1, 2))
        w3q, sw3 = _wq(convs[2].weight[:, :, 0, 0].t(), (0,))
        (bs1, bt1), (bs2, bt2), (bs3, bt3) = (_fold_bn(b) for b in bns)
        s_x, s_h1, s_h2 = (_act_scale(torch.as_tensor(quant[k], dtype=torch.float32,
                                                      device=w1q.device)) for k in keys)
        out[name] = dict(
            w1=w1q, w2=w2q, w3=w3q,
            a1=s_x * sw1 * bs1, b1=bt1, a2=s_h1 * sw2 * bs2, b2=bt2, a3=s_h2 * sw3 * bs3, b3=bt3,
            s_x=float(s_x), s_h1=float(s_h1), s_h2=float(s_h2))
    return out


def _canon_padding(m: nn.Conv2d):
    """Symmetric zero padding as (ph, pw), or None where the int8 path has none."""
    if m.padding_mode != "zeros":
        return None
    if isinstance(m.padding, str):
        if m.padding == "valid":
            return (0, 0)
        total = [d * (k - 1) for d, k in zip(m.dilation, m.kernel_size)]
        return None if any(t % 2 for t in total) else tuple(t // 2 for t in total)
    return tuple(m.padding)


def _skip_by_path(name: str, cfg: QuantConfig) -> bool:
    return any(s in name for s in cfg.skip_paths)


def _conv_quantizable(name: str, m: nn.Module, cfg: QuantConfig) -> bool:
    if type(m) is not nn.Conv2d or m.groups != 1:
        return False
    if m.in_channels < cfg.min_in or m.out_channels < cfg.min_out:
        return False
    if _canon_padding(m) is None:
        return False
    return not _skip_by_path(name, cfg)


def _dense_quantizable(name: str, m: nn.Module, cfg: QuantConfig) -> bool:
    if type(m) is not nn.Linear or not cfg.quantize_dense:
        return False
    if m.in_features < cfg.min_in or m.out_features < cfg.min_out:
        return False
    return not _skip_by_path(name, cfg)


def _plain(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The layer as the port's helpers run it: parameters cast to x's dtype."""
    return conv2d_plain(m, x) if isinstance(m, nn.Conv2d) else linear_plain(m, x)


def _fused_conv3_block(x, pre, dilation: int, last_relu: bool):
    """A Bottleneck as one chain over x [B,H,W,C]: the fused block's integer
    products, with h1 and h2 rounded to x's dtype before they are requantized
    and the residual added after conv3's result is rounded to it, as the
    conv-by-conv path rounds them."""
    d = (dilation, dilation)
    dt = x.dtype
    s = lambda key: torch.as_tensor(pre[key], dtype=torch.float32, device=x.device)
    xq = quantize_sym(x.float(), s("s_x"))
    acc1 = int8_conv2d(xq, pre["w1"].t()[None, None])
    h1 = torch.relu(acc1.float() * pre["a1"] + pre["b1"]).to(dt)
    h1q = quantize_sym(h1.float(), s("s_h1"))
    acc2 = int8_conv2d(h1q, pre["w2"].permute(0, 1, 3, 2), padding=d, dilation=d)
    h2 = torch.relu(acc2.float() * pre["a2"] + pre["b2"]).to(dt)
    h2q = quantize_sym(h2.float(), s("s_h2"))
    acc3 = int8_conv2d(h2q, pre["w3"].t()[None, None])
    y = (acc3.float() * pre["a3"] + pre["b3"]).to(dt).float() + x.float()
    if last_relu:
        y = torch.relu(y)
    return y.to(dt)


class quant_interceptor:
    """Context manager that takes the forward of every quantizable layer of
    ``model`` while it is open.

    mode="calibrate": the forward is numerically unchanged; the running
    abs-max (or percentile) of every quantizable layer's input goes into
    ``quant`` (an :class:`ActScales`, updated in place).  With ``shard``
    (first row, rows of the global batch, this rank's rows: the input holds
    a rank's contiguous rows of a global batch) a layer's entry is instead
    this rank's part of the estimate for :func:`calibrate_across_ranks`: its
    abs-max, or the elements of the global batch's strided percentile sample
    that fall in its rows.
    mode="int8": the quantized path; ``quant`` must hold a scale for every
    layer that is reached.  ``fused_map`` (:func:`build_fused_block_inputs`)
    turns on the fused routes of ``cfg``; ``cache`` (a dict the caller keeps)
    saves requantizing the weights at every call.
    """

    def __init__(self, model: nn.Module, mode: str, cfg: QuantConfig = DEFAULT_CONFIG,
                 quant: dict | None = None, fused_map: dict | None = None,
                 cache: dict | None = None, shard: Tuple[int, int, int] | None = None):
        if mode not in ("calibrate", "int8"):
            raise ValueError(f"unknown quant mode: {mode}")
        if quant is None:
            raise ValueError("quant_interceptor needs the ActScales to fill or to read")
        self.model, self.mode, self.cfg, self.quant = model, mode, cfg, quant
        self.shard = shard
        self.fused_map = fused_map if mode == "int8" else None
        self.cache = {} if cache is None else cache
        self._taken = []

    def __enter__(self):
        for name, m in self.model.named_modules():
            if _conv_quantizable(name, m, self.cfg) or _dense_quantizable(name, m, self.cfg):
                self._take(m, lambda x, _n=name, _m=m: self._layer(_n, _m, x))
            elif (self.fused_map and name in self.fused_map
                  and getattr(m, "int8_fusable", False) and getattr(m, "stride", None) == 1
                  and not getattr(m, "has_downsample", True)):
                self._take(m, lambda x, _n=name, _m=m: self._block(_n, _m, x))
        return self

    def __exit__(self, *exc):
        for m in self._taken:
            del m.__dict__["forward"]
        self._taken.clear()
        if self.mode == "calibrate" and isinstance(self.quant, ActScales):
            self.quant.version += 1
        return False

    def _take(self, m: nn.Module, fn):
        if "forward" in m.__dict__:
            raise RuntimeError("another quant_interceptor is open on this model")
        m.forward = fn
        self._taken.append(m)

    def _block(self, name: str, m: nn.Module, x: torch.Tensor):
        cfg = self.cfg
        if x.dim() == 4 and x.dtype == torch.bfloat16 and (cfg.fused_interpret or x.is_cuda):
            pre = self.fused_map[name]
            d = m.dilation * m.multi_grid
            xn = x.permute(0, 2, 3, 1).contiguous()
            if cfg.fused_blocks:
                from ..ops.fused_bottleneck import fused_bottleneck_int8

                out = fused_bottleneck_int8(xn, dilation=d, last_relu=m.last_relu, **pre)
                return out.permute(0, 3, 1, 2)
            if cfg.fused_conv3:
                return _fused_conv3_block(xn, pre, d, m.last_relu).permute(0, 3, 1, 2)
        return type(m).forward(m, x)

    def _estimate(self, x: torch.Tensor, is_conv: bool) -> torch.Tensor:
        mag = x.detach().float().abs()
        if self.cfg.act_estimator != "percentile":
            return mag.max()
        # a deterministic strided subsample, taken in channels-last order as
        # the JAX package takes it (a full sort would be 10^8 elements at 1024^2)
        flat = (mag.permute(0, 2, 3, 1) if is_conv else mag).reshape(-1)
        if self.shard is None:
            stride = max(1, flat.numel() // 65536)
            return torch.quantile(flat[::stride], self.cfg.percentile / 100.0)
        # this rank's rows of the global batch: the global stride's elements among them
        first, rows, local = self.shard
        per_row = flat.numel() // local
        stride = max(1, rows * per_row // 65536)
        return flat[(-first * per_row) % stride::stride]

    def _weights(self, m: nn.Module, is_conv: bool):
        """(int8 weight, out-major per tap for a conv, and its scales), cached
        until the parameter changes."""
        w = m.weight
        key = (w.data_ptr(), w._version, w.device)
        hit = self.cache.get(m)
        if hit is None or hit[0] != key:
            wf = w.detach().float()
            if is_conv:
                s_w = wf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-8) / 127.0
                wq = quantize_sym(wf, s_w[:, None, None, None]).permute(2, 3, 0, 1).contiguous()
            else:
                s_w = wf.abs().amax(dim=1).clamp_min(1e-8) / 127.0
                wq = quantize_sym(wf, s_w[:, None])
            hit = self.cache[m] = (key, wq, s_w)
        return hit[1], hit[2]

    def _layer(self, name: str, m: nn.Module, x: torch.Tensor):
        is_conv = isinstance(m, nn.Conv2d)
        if x.dim() != 4 if is_conv else x.dim() < 2:
            return _plain(m, x)
        if self.mode == "calibrate":
            est = self._estimate(x, is_conv)
            seen = self.quant.get(name)
            if seen is not None and est.dim():
                raise ValueError(f"{name!r} ran twice in one forward: percentile calibration "
                                 "over ranks takes one input a layer")
            self.quant[name] = est if seen is None else torch.maximum(
                torch.as_tensor(seen, dtype=torch.float32, device=est.device), est)
            return _plain(m, x)
        if name not in self.quant:
            raise ValueError(f"int8 inference reached {name!r}, which has no activation "
                             "scale - run quant.calibrate over this path first")
        s_x = _act_scale(torch.as_tensor(self.quant[name], dtype=torch.float32, device=x.device))
        wq, s_w = self._weights(m, is_conv)
        if is_conv:
            xq = quantize_sym(x.permute(0, 2, 3, 1).float(), s_x).contiguous()
            acc = int8_conv2d(xq, wq, m.stride, _canon_padding(m), m.dilation)
        else:
            xq = quantize_sym(x.float(), s_x)
            acc = int_matmul(xq.reshape(-1, xq.shape[-1]), wq.t()).view(*x.shape[:-1], -1)
        y = acc.float() * (s_x * s_w)
        if m.bias is not None:
            y = y + m.bias.float()
        y = y.to(x.dtype)
        return y.permute(0, 3, 1, 2) if is_conv else y


def calibrate(model: nn.Module, batches, cfg: QuantConfig = DEFAULT_CONFIG,
              quant: ActScales | None = None, **apply_kwargs) -> ActScales:
    """Run calibration forwards over ``batches`` (an iterable of model
    inputs); returns the scales, a running max across all batches and over
    what ``quant`` already held."""
    quant = ActScales() if quant is None else quant
    n = 0
    with torch.inference_mode(), quant_interceptor(model, "calibrate", cfg, quant):
        for img in batches:
            model(img, **apply_kwargs)
            n += 1
    if n == 0 and not quant:
        raise ValueError("calibrate: no batches provided")
    return quant


def calibrate_across_ranks(model: nn.Module, x: torch.Tensor | None, quant: ActScales,
                           cfg: QuantConfig = DEFAULT_CONFIG, group=None) -> ActScales:
    """One calibration forward of a global batch whose rows are spread over the
    ranks of ``group`` in rank order: ``x`` holds this rank's contiguous rows,
    or is None where its share is empty (every rank makes the call, for the
    collectives).  The scales then equal one process's calibration of the
    whole global batch: the abs-max is reduced by a maximum over the ranks (one
    collective over every layer); the percentile is taken of the global
    batch's strided sample, each rank giving the elements of the global stride
    that fall in its rows, gathered in rank order.  ``quant`` keeps the
    running maximum, as :func:`calibrate` does."""
    from .. import dist

    names = [n for n, m in model.named_modules()
             if _conv_quantizable(n, m, cfg) or _dense_quantizable(n, m, cfg)]
    dev = x.device if x is not None else next(model.parameters()).device
    rows = 0 if x is None else x.shape[0]
    shard = None
    if cfg.act_estimator == "percentile":
        counts = torch.cat(dist.all_gather(torch.tensor([rows], device=dev), group)).tolist()
        shard = (sum(counts[:dist.rank()]), sum(counts), rows)
    local = {}
    if rows:
        with torch.inference_mode(), quant_interceptor(model, "calibrate", cfg, local,
                                                       shard=shard):
            model(x)
    if shard is None:
        # -1 marks a layer this rank did not reach (an abs-max is >= 0)
        amax = torch.stack([local[n].reshape(()) if n in local
                            else torch.tensor(-1.0, device=dev) for n in names])
        dist.all_reduce_max(amax, group)
        new = {n: a for n, a, reached in zip(names, amax, (amax >= 0).tolist()) if reached}
    else:
        sizes = torch.tensor([local[n].numel() if n in local else 0 for n in names], device=dev)
        flat = (torch.cat([local[n] for n in names if n in local]) if local
                else torch.zeros(0, device=dev))
        parts = [f.split(c.tolist()) for f, c in zip(dist.all_gather(flat, group),
                                                      dist.all_gather(sizes, group))]
        new = {}
        for i, n in enumerate(names):
            sample = torch.cat([p[i] for p in parts])
            if sample.numel():
                new[n] = torch.quantile(sample, cfg.percentile / 100.0)
    for n, v in new.items():
        seen = quant.get(n)
        quant[n] = v if seen is None else torch.maximum(
            torch.as_tensor(seen, dtype=torch.float32, device=v.device), v)
    if isinstance(quant, ActScales):
        quant.version += 1
    return quant


def quantized_apply(model: nn.Module, cfg: QuantConfig = DEFAULT_CONFIG):
    """Returns an ``apply(quant, *args, **kwargs)`` that runs the model with
    int8 conv/linear layers.  ``quant`` holds the scales from
    :func:`calibrate`."""
    log = logging.getLogger(__name__)
    state = {"key": None, "fused_map": None, "cache": {}}

    def apply_fn(quant, *args, **kwargs):
        if not quant:
            raise ValueError(
                "int8 inference requires activation scales - run quant.calibrate first")
        fused = cfg.fused_blocks or cfg.fused_conv3
        key = (id(quant), getattr(quant, "version", None))
        if fused and (state["key"] != key or key[1] is None):
            state["key"], state["fused_map"] = key, build_fused_block_inputs(model, quant, cfg)
            # the fused routes also gate per call on bfloat16 activations, on
            # CUDA tensors (or fused_interpret) and on stride-1, no-downsample
            # Bottlenecks: warn where the request cannot take effect
            which = "fused_blocks" if cfg.fused_blocks else "fused_conv3"
            on_cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
            if not state["fused_map"]:
                log.warning("%s requested but no Bottleneck has a fused-eligible weight set; "
                            "per-conv int8 only", which)
            elif not (cfg.fused_interpret or on_cuda):
                log.warning("%s requested but the input is on the CPU (needs CUDA, or "
                            "QuantConfig(fused_interpret=True)); per-conv int8 only", which)
        with quant_interceptor(model, "int8", cfg, quant, state["fused_map"] if fused else None,
                               state["cache"]):
            return model(*args, **kwargs)

    return apply_fn
