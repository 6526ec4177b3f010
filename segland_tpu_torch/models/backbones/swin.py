"""Swin Transformer backbone (T/S/B/L), PyTorch.

Port of segland_tpu/models/backbones/swin.py with upstream SegLand's module
names (networks/backbones/swintransformer.py), so ``state_dict()`` keys are
the upstream keys: 4x4 patch embed + LN, 4 stages of shifted 7x7-window
attention with relative position bias, PatchMerging between stages, a
LayerNorm per output level, 4-level pyramid out, fine -> coarse.

Tokens run channels-last ([B,H,W,C]) inside the backbone; the pyramid comes
out NCHW as views of that storage.  Parameters stay fp32 and are cast to the
compute dtype at use.  The shifted-window mask, the pad-token mask and the
region ids are static numpy tables of the map size, cached per device.
In train mode (``module.training``) each block drops its two residual
branches per sample (``DropPath``, rates 0 -> ``drop_path_rate`` over the
blocks, masks from the step's generator, ``droppath.py``); at eval DropPath
is the identity.

The routes through a block, as in the JAX package:
  * unfused: LN, pad, roll, partition, WindowAttention (stock torch);
  * ``use_pallas``: the same, with WindowAttention's core through
    ``ops.fused_attn.window_attention_fused`` (bias and mask in bf16);
  * ``fused_attn``: raw windows through ``swin_attn_section_fused`` with
    ``geom`` set (LN, qkv, attention, proj and residual in one kernel), in
    the stages of ``fused_attn_stages``;
  * ``attn_group != 1``: the same through the v1 kernel (``geom=None``: masks
    shipped in, ``attn_group`` windows a super-window);
  * ``fused_block_stages``: with ``fused_attn`` and ``fused_mlp``, the whole
    block of those stages through ``swin_block_fused``, one kernel, in a
    block whose DropPath is inactive (eval, or rate 0);
  * ``SEGLAND_SWIN_WR=1`` with ``fused_attn`` and ``fused_mlp``: window-
    resident stages (partition once a stage, the MLP in window layout), in
    eval mode only.
``fused_mlp`` routes LN2 + MLP + residual through ``fused_ln_mlp``.  The
fused ops add the residual inside, so with DropPath active a block recovers
each branch as (output - shortcut), as the JAX package does.  Under grad
the fused section and block run through their autograd Functions
(``ops/fused_attn.py``); ``use_pallas`` (K6) has no backward.
"""

import functools
import os
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.fused_attn import (swin_attn_section_fused, swin_block_fused,
                                window_attention_fused)
from ...ops.fused_mlp import fused_ln_mlp
from ...ops.layers import conv2d, linear
from ..init import flax_defaults_, truncated_normal_
from .convnext import layer_norm_nhwc
from .droppath import DropPath, drop_path_rates

_CONFIGS = {
    "swin-t": dict(depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24), embed_dim=96),
    "swin-s": dict(depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24), embed_dim=96),
    "swin-b": dict(depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), embed_dim=128),
    "swin-l": dict(depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48), embed_dim=192),
}


def _rel_pos_index(ws: int) -> np.ndarray:
    """Static relative-position index table (reference swin :97-108)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)  # [ws*ws, ws*ws]


def _shift_regions(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """Static per-window SW-MSA region ids [nW, ws*ws] (reference swin
    :360-374): tokens attend only within equal-id regions."""
    img = np.zeros((hp, wp), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, vs] = cnt
            cnt += 1
    return (img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3)
            .reshape(-1, ws * ws).astype(np.float32))


def _shift_attn_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """Static SW-MSA mask [nW, ws*ws, ws*ws] of {0, -100} (reference swin
    :360-379)."""
    win = _shift_regions(hp, wp, ws, shift)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def _pad_token_mask(h, w, hp, wp, ws, shift) -> np.ndarray:
    """Static per-window valid-token mask [nW or 1, ws*ws] (1=real, 0=pad)."""
    if hp == h and wp == w:
        return np.ones((1, ws * ws), np.float32)
    valid = np.zeros((hp, wp), np.float32)
    valid[:h, :w] = 1.0
    if shift > 0:
        valid = np.roll(valid, (-shift, -shift), axis=(0, 1))
    win = valid.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3)
    return win.reshape(-1, ws * ws)


_TABLES = {"rel_pos_index": _rel_pos_index, "shift_regions": _shift_regions,
           "shift_attn_mask": _shift_attn_mask, "pad_token_mask": _pad_token_mask}


@functools.lru_cache(maxsize=256)
def _table(name: str, device: torch.device, *args) -> torch.Tensor:
    """One of the static tables above as a tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(_TABLES[name](*args))).to(device)


def _window_partition(x, ws):
    """[B,Hp,Wp,C] -> [B*nW, ws*ws, C]"""
    b, hp, wp, c = x.shape
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def _window_reverse(x, ws, b, hp, wp):
    c = x.shape[-1]
    x = x.reshape(b, hp // ws, wp // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 use_pallas: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.use_pallas = use_pallas
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))

    def rel_pos_bias(self) -> torch.Tensor:
        """[nh, N, N] fp32."""
        n = self.window_size ** 2
        table = self.relative_position_bias_table
        idx = _table("rel_pos_index", table.device, self.window_size).reshape(-1)
        return table[idx].reshape(n, n, self.num_heads).permute(2, 0, 1)

    def forward(self, x, mask):
        """x: [B_, N, C]; mask: [nW, N, N] of {0, -100} or None."""
        b_, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv = linear(self.qkv, x)
        bias = self.rel_pos_bias()
        if self.use_pallas:
            # bias and mask in bf16, as the JAX package hands them to its kernel; K6
            # reads the bias in place, so it is built contiguous (rel_pos_bias is a
            # permuted view: copying its [nh, N, N] makes the masked sum contiguous too)
            bias = bias.contiguous()
            if mask is None:
                bias_arr = bias[None].to(torch.bfloat16)
            else:
                bias_arr = (bias[None].float() + mask[:, None].float()).to(torch.bfloat16)
            out = window_attention_fused(qkv.contiguous(), bias_arr, nh)
        else:
            q, k, v = qkv.reshape(b_, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
            attn = (q * (hd ** -0.5)) @ k.transpose(-1, -2)
            attn = attn + bias[None].to(attn.dtype)
            if mask is not None:
                nw = mask.shape[0]
                attn = attn.reshape(b_ // nw, nw, nh, n, n) + mask.to(attn.dtype)[None, :, None]
                attn = attn.reshape(b_, nh, n, n)
            attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
            out = (attn @ v).permute(0, 2, 1, 3).reshape(b_, n, c)
        return linear(self.proj, out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return linear(self.fc2, F.gelu(linear(self.fc1, x)))


class SwinBlock(nn.Module):
    """``attn_group``: windows fused into one super-window by the v1
    attention-section kernel (1 = the index-math kernel).  ``fused_block``:
    attention section and MLP in one kernel; engages only with ``fused_attn``,
    ``fused_mlp``, ``attn_group == 1`` and no active DropPath.  ``drop_path``:
    the block's DropPath rate (two DropPaths, no parameters)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4.0, use_pallas: bool = False, fused_mlp: bool = False,
                 fused_attn: bool = False, attn_group: int = 1, fused_block: bool = False,
                 drop_path: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift_size = shift_size
        self.fused_mlp = fused_mlp
        self.fused_attn = fused_attn
        self.attn_group = attn_group
        self.fused_block = fused_block
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window_size, use_pallas)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)

    def _windows(self, x, pad_b, pad_r):
        """Pad, roll and partition [B,H,W,C] into windows."""
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        if self.shift_size > 0:
            x = torch.roll(x, (-self.shift_size, -self.shift_size), dims=(1, 2))
        return _window_partition(x, self.window_size)

    def _unwindows(self, wins, b, h, w, hp, wp):
        x = _window_reverse(wins, self.window_size, b, hp, wp)
        if self.shift_size > 0:
            x = torch.roll(x, (self.shift_size, self.shift_size), dims=(1, 2))
        return x[:, :h, :w, :] if (hp != h or wp != w) else x

    def _section_args(self, x, h, w, hp, wp):
        """(mask_tok, the section's parameters, bias, heads) and the keywords
        of the fused section ops for a map of (h, w) padded to (hp, wp)."""
        a, ws, shift, dev = self.attn, self.window_size, self.shift_size, x.device
        bias_dt = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
        bias = a.rel_pos_bias()[None].to(bias_dt)  # rel-pos only [1,nh,N,N]
        regions = _table("shift_regions", dev, hp, wp, ws, shift) if shift > 0 else None
        mask_tok = _table("pad_token_mask", dev, h, w, hp, wp, ws, shift)
        args = (mask_tok, self.norm1.weight, self.norm1.bias, a.qkv.weight.T, a.qkv.bias,
                a.proj.weight.T, a.proj.bias, bias)
        return args, dict(eps=1e-5, regions=regions), (h, w, hp, wp, ws, shift)

    def _mlp_args(self):
        m = self.mlp
        return (self.norm2.weight, self.norm2.bias, m.fc1.weight.T, m.fc1.bias, m.fc2.weight.T,
                m.fc2.bias)

    def _attn_section(self, wins, args, kw, geom):
        """The fused section by the kernel that ``attn_group`` picks."""
        return swin_attn_section_fused(wins, *args, self.num_heads, group=self.attn_group,
                                       geom=geom if self.attn_group == 1 else None, **kw)

    def forward(self, x, win_shape=None):
        """x: [B,H,W,C] -> [B,H,W,C].  With ``win_shape = (b, h, w, hp, wp)``
        x is already window-partitioned, [B*nW, ws*ws, C] on the padded
        unshifted domain, and comes back in that layout (window-resident
        serving, see :meth:`_win_resident`)."""
        if win_shape is not None:
            return self._win_resident(x, win_shape)
        b, h, w, c = x.shape
        ws = self.window_size
        pad_b, pad_r = (-h) % ws, (-w) % ws
        hp, wp = h + pad_b, w + pad_r
        dp = self.training and self.drop_path1.rate > 0.0
        if self.fused_attn:
            args, kw, geom = self._section_args(x, h, w, hp, wp)
            wins = self._windows(x, pad_b, pad_r).contiguous()
            use_block = self.fused_block and self.fused_mlp and self.attn_group == 1 and not dp
            if use_block:
                wins = swin_block_fused(wins, *args, *self._mlp_args(), self.num_heads,
                                        geom=geom, **kw)
            else:
                wins = self._attn_section(wins, args, kw, geom)
            # the residual was added inside, on the padded and rolled domain,
            # where it commutes with reverse, unroll and unpad
            out = self._unwindows(wins, b, h, w, hp, wp)
            if use_block:
                return out  # attention and MLP both done
            # the branch for stochastic depth is what the section added
            x = x + self.drop_path1(out - x) if dp else out
        else:
            y = layer_norm_nhwc(self.norm1, x)
            mask = (_table("shift_attn_mask", x.device, hp, wp, ws, self.shift_size)
                    if self.shift_size > 0 else None)
            wins = self.attn(self._windows(y, pad_b, pad_r), mask)
            x = x + self.drop_path1(self._unwindows(wins, b, h, w, hp, wp))
        if self.fused_mlp:
            out = fused_ln_mlp(x.contiguous(), *self._mlp_args(), eps=1e-5)
            return x + self.drop_path2(out - x) if dp else out
        return x + self.drop_path2(self.mlp(layer_norm_nhwc(self.norm2, x)))

    def _win_resident(self, wins, win_shape):
        """Eval-only window-resident body (no DropPath); needs ``fused_attn``
        and ``fused_mlp``.  Every op of a block is token-local except attention,
        so an unshifted block runs with no layout change and a shifted one
        with two windows-to-windows permutations (reverse, roll, partition).
        Pad tokens ride through the MLP, masked in attention by ``mask_tok``,
        and are dropped at stage exit."""
        b, h, w, hp, wp = win_shape
        ws, s = self.window_size, self.shift_size
        args, kw, geom = self._section_args(wins, h, w, hp, wp)
        if s > 0:  # canonical (unshifted) windows -> shifted windows
            x = torch.roll(_window_reverse(wins, ws, b, hp, wp), (-s, -s), dims=(1, 2))
            wins = _window_partition(x, ws)
        wins = self._attn_section(wins.contiguous(), args, kw, geom)
        out = fused_ln_mlp(wins, *self._mlp_args(), eps=1e-5)
        if s > 0:  # back to canonical windows for the next block
            x = torch.roll(_window_reverse(out, ws, b, hp, wp), (s, s), dims=(1, 2))
            out = _window_partition(x, ws)
        return out


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        b, h, w, c = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return linear(self.reduction, layer_norm_nhwc(self.norm, x))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x):
        """[B,3,H,W] -> [B,h,w,C]."""
        ps = self.patch_size
        h, w = x.shape[-2:]
        if h % ps or w % ps:
            x = F.pad(x, (0, (-w) % ps, 0, (-h) % ps))
        return layer_norm_nhwc(self.norm, conv2d(self.proj, x).permute(0, 2, 3, 1))


class BasicLayer(nn.Module):
    """One stage: its blocks and the PatchMerging that follows it (upstream
    keeps the downsample inside the layer)."""

    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """``fused_attn_stages``: stages where ``fused_attn`` engages (None = all).
    ``fused_block_stages``: stages where the whole-block kernel engages (None
    = none); needs ``fused_attn`` and ``fused_mlp`` at that stage.
    ``drop_path_rate``: the last block's DropPath rate (upstream's default
    0.2), the others on the linspace from 0.  Parameters and state-dict keys
    are the same on every route."""

    def __init__(self, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), embed_dim: int = 96,
                 window_size: int = 7, patch_size: int = 4, drop_path_rate: float = 0.2,
                 use_pallas: bool = False,
                 fused_mlp: bool = False, fused_attn: bool = False, fused_attn_stages=None,
                 fused_block_stages=None, attn_group: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.window_size = window_size
        self.fused_mlp = fused_mlp
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        layers = []
        dpr = drop_path_rates(drop_path_rate, depths)
        for i, depth in enumerate(depths):
            dim = int(embed_dim * 2 ** i)
            fa = fused_attn and (fused_attn_stages is None or i in fused_attn_stages)
            fb = (fa and fused_mlp and fused_block_stages is not None
                  and i in fused_block_stages)
            blocks = [SwinBlock(dim, num_heads[i], window_size,
                                shift_size=0 if j % 2 == 0 else window_size // 2,
                                use_pallas=use_pallas, fused_mlp=fused_mlp,
                                fused_attn=fa, attn_group=attn_group, fused_block=fb,
                                drop_path=dpr[sum(depths[:i]) + j])
                      for j in range(depth)]
            layers.append(BasicLayer(blocks,
                                     PatchMerging(dim) if i < len(depths) - 1 else None))
            setattr(self, f"norm{i}", nn.LayerNorm(dim, eps=1e-5))
        self.layers = nn.ModuleList(layers)

    def reset_parameters(self, generator=None):
        """The JAX package's init: lecun-normal linear and patch-embed weights,
        zero biases, unit norms (``models/init.py``), rel-pos tables
        truncated-normal at 0.02."""
        flax_defaults_(self, generator)
        for m in self.modules():
            if isinstance(m, WindowAttention):
                truncated_normal_(m.relative_position_bias_table, 0.02, generator)

    def forward(self, x):
        """[B,3,H,W] -> 4-level pyramid, fine -> coarse, NCHW."""
        x = self.patch_embed(x.to(self.dtype))
        outs = []
        # read at call time, as the JAX package reads it at trace time; eval only
        wr_env = not self.training and os.environ.get("SEGLAND_SWIN_WR", "0") == "1"
        for i, layer in enumerate(self.layers):
            if wr_env and self.fused_mlp and layer.blocks[0].fused_attn:
                # window-resident serving: partition once a stage
                ws = self.window_size
                b, h, w, _ = x.shape
                hp, wp = h + (-h) % ws, w + (-w) % ws
                if hp != h or wp != w:
                    x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
                wins = _window_partition(x, ws)
                for blk in layer.blocks:
                    wins = blk(wins, win_shape=(b, h, w, hp, wp))
                x = _window_reverse(wins, ws, b, hp, wp)[:, :h, :w, :]
            else:
                for blk in layer.blocks:
                    x = blk(x)
            outs.append(layer_norm_nhwc(getattr(self, f"norm{i}"), x).permute(0, 3, 1, 2))
            if layer.downsample is not None:
                x = layer.downsample(x)
        return outs


def get_swin(name: str, dtype=torch.float32, use_pallas: bool = False,
             fused_mlp: bool = False, fused_attn: bool = False, fused_attn_stages="auto",
             fused_block_stages="auto") -> SwinTransformer:
    cfg = _CONFIGS[name]
    if (fused_attn or fused_mlp) and cfg["embed_dim"] != 96:
        raise NotImplementedError(
            f"fused kernels for {name}: the LN+MLP kernel has no build for widths "
            f"{[cfg['embed_dim'] * 2 ** i for i in range(4)]} (ROADMAP item A6)")
    if fused_block_stages == "auto":
        # the JAX package's switch for its whole-block kernel: "all", "none" or "0,1,2"
        env = os.environ.get("SEGLAND_SWIN_V3_STAGES", "")
        if env == "all":
            fused_block_stages = (0, 1, 2, 3)
        elif env in ("", "none"):
            fused_block_stages = None
        else:
            fused_block_stages = tuple(int(s) for s in env.split(","))
    if fused_attn_stages == "auto":
        fused_attn_stages = (0, 1, 2, 3)
    return SwinTransformer(dtype=dtype, use_pallas=use_pallas, fused_mlp=fused_mlp,
                           fused_attn=fused_attn, fused_attn_stages=fused_attn_stages,
                           fused_block_stages=fused_block_stages, **cfg)
