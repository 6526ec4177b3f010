"""Backbone factory with the JAX package's string keys
(segland_tpu/models/backbones/__init__.py)."""

import torch

_FILTERS = {
    "swin-t": (96, 192, 384, 768),
    "swin-s": (96, 192, 384, 768),
    "swin-b": (128, 256, 512, 1024),
    "swin-l": (192, 384, 768, 1536),
    "hr-w18": (18, 36, 72, 144),
    "hr-w32": (32, 64, 128, 256),
    "hr-w48": (48, 96, 192, 384),
    "convnext-t": (96, 192, 384, 768),
    "lsk-t": (32, 64, 160, 256),
    "vgg16bn-unet": (64,),
}


def get_backbone(name: str, dtype=torch.float32, fused_mlp: bool = False,
                 fused_attn: bool = False, **kw):
    """``fused_mlp`` routes each ConvNeXt or Swin block's LN+MLP section
    through the fused kernel, ``fused_attn`` each Swin block's attention
    section; conv-only families (ResNet, HRNet, LSKNet, the VGG U-Net) take
    neither.  ``kw`` goes to the ResNet family (``os``, ``dilated``, ...)."""
    if name in ("resnet10", "resnet50", "resnet101", "resnet50v2", "resnet101v2"):
        from .resnet import get_resnet

        return get_resnet(name, dtype=dtype, **kw)
    if name == "convnext-t":
        from .convnext import convnext_tiny

        return convnext_tiny(dtype=dtype, fused_mlp=fused_mlp)
    if name in ("swin-t", "swin-s", "swin-b", "swin-l"):
        from .swin import get_swin

        return get_swin(name, dtype=dtype, fused_mlp=fused_mlp, fused_attn=fused_attn)
    if name in ("hr-w18", "hr-w32", "hr-w48"):
        from .hrnet import get_hrnet

        return get_hrnet(name, dtype=dtype)
    if name == "lsk-t":
        from .lsknet import lsknet_tiny

        return lsknet_tiny(dtype=dtype)
    if name == "vgg16bn-unet":
        from .vggunet import VGGUNet

        return VGGUNet(dtype=dtype)
    raise ValueError(f"unknown backbone: {name}")


def backbone_filters(name: str):
    """Per-level channel counts (reference get_filters()/.filters)."""
    if name.startswith("resnet"):
        return (2048, 1024, 512, 256)  # coarse->fine [x4,x3,x2,x1]
    if name in _FILTERS:
        return _FILTERS[name]
    raise ValueError(f"unknown backbone: {name}")
