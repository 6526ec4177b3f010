"""Model registry with the JAX package's keys (segland_tpu/models/__init__.py):
the eight POP models and the plain ``pspnet``."""

import torch

from .pop import GFSSModel
from .pspnet_plain import PlainPSPNet

# model name -> (decoder_name, default_backbone)
_POP_CONFIGS = {
    "pspnet_pop": ("psp", "resnet50"),
    "pspplus_pop": ("pspplus", "resnet50v2"),
    "deeplab_pop": ("aspp", "resnet50"),
    "swin_pop": ("upernetplus", "swin-s"),
    "convnext_pop": ("fpn_ocr", "convnext-t"),
    "lsk_pop": ("simple", "lsk-t"),
    "seghr_pop": ("hrfpn", "hr-w32"),
    "vggunet_pop": ("identity", "vgg16bn-unet"),
}


def build_model(model: str, backbone: str | None = None, n_base: int = 7,
                n_novel: int = 0, is_ft: bool = False, os: int = 8,
                dilated: bool = True, dtype: torch.dtype = torch.float32,
                fused_mlp: bool = False, fused_attn: bool = False, packed_train=None,
                device: torch.device | str = "cpu",
                generator: torch.Generator | None = None):
    """Build ``model`` on ``device`` in eval mode, its weights drawn from
    ``generator`` (a CPU generator)."""
    if model == "pspnet":
        if packed_train is not None:
            raise ValueError("packed_train is not supported by the plain pspnet model "
                             "(resnet backbones have no packed path)")
        net = PlainPSPNet(backbone_name=backbone or "resnet50", n_base=n_base, n_novel=n_novel,
                          is_ft=is_ft, os=os, dilated=dilated, dtype=dtype, generator=generator)
        return net.to(device).eval()
    if model not in _POP_CONFIGS:
        raise ValueError(f"unknown model: {model!r}; known: {MODEL_NAMES}")
    decoder, default_bk = _POP_CONFIGS[model]
    net = GFSSModel(
        backbone_name=backbone or default_bk, decoder_name=decoder,
        n_base=n_base, n_novel=n_novel, is_ft=is_ft, os=os, dilated=dilated,
        fused_mlp=fused_mlp, fused_attn=fused_attn, packed_train=packed_train,
        dtype=dtype, generator=generator)
    return net.to(device).eval()


MODEL_NAMES = sorted(_POP_CONFIGS) + ["pspnet"]
