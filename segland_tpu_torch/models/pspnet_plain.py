"""The plain (non-POP) PSPNet baseline, NCHW PyTorch.  Port of
segland_tpu/models/pspnet_plain.py (reference networks/pspnet.py).

Base mode: a bias-free 1x1 ``classifier`` over the PSPModule's features of
x4, and in train mode an aux head on x3 (3x3 conv 1024 -> 256 without bias,
BatchNorm, ReLU, 1x1 conv with bias to 1 + n_base), which the CE loss weighs
at 0.4.  Fine-tune mode: the backbone runs on its running statistics, and a
bias-free ``classifier_n`` gives n_novel logits concatenated after the base
logits.  Logits come out NCHW in fp32.

The upstream keys of ``backbone``, ``decoder``, ``classifier`` and
``classifier_n`` are those of the POP models.  The aux head's are the port's
own choice, ``aux.0`` (conv), ``aux.1`` (BatchNorm) and ``aux.3`` (conv), an
upstream-style Sequential: the JAX package's converter has no rule for its
``aux_conv``, ``aux_bn`` and ``aux_out``.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.layers import batch_norm, conv2d
from .backbones import backbone_filters, get_backbone
from .decoders import PSPModule


class PlainPSPNet(nn.Module):
    def __init__(self, backbone_name: str = "resnet50", n_base: int = 7, n_novel: int = 0,
                 is_ft: bool = False, os: int = 8, dilated: bool = True,
                 dtype: torch.dtype = torch.float32, d_model: int = 512,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.backbone_name = backbone_name
        self.is_ft = is_ft
        bk = dict(os=os, dilated=dilated) if backbone_name.startswith("resnet") else {}
        self.backbone = get_backbone(backbone_name, dtype=dtype, **bk)
        filters = backbone_filters(backbone_name)
        self.decoder = PSPModule(filters, d_model, dtype=dtype)
        self.classifier = nn.Conv2d(d_model, 1 + n_base, 1, bias=False)
        if is_ft:
            if n_novel <= 0:
                raise ValueError("is_ft needs n_novel > 0")
            self.classifier_n = nn.Conv2d(d_model, n_novel, 1, bias=False)
        else:
            self.aux = nn.Sequential(
                nn.Conv2d(filters[1], 256, 3, padding=1, bias=False),
                nn.BatchNorm2d(256, eps=1e-5), nn.ReLU(), nn.Conv2d(256, 1 + n_base, 1))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """The JAX package's init: the backbone's and the decoder's (flax's
        defaults), torch's Conv2d default (the JAX package's
        ``_torch_conv_init``, uniform within 1 / sqrt(fan_in)) for the
        classifiers' and the aux head's kernels, zero bias, unit BatchNorm."""
        self.backbone.reset_parameters(generator)
        self.decoder.reset_parameters(generator)
        heads = [self.classifier] + ([self.classifier_n] if self.is_ft else list(self.aux))
        for m in heads:
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def forward(self, img, train: bool = False):
        """Logits [B, K, h, w]; with ``train`` (base mode) also the aux head's.
        BatchNorm follows ``module.training``, as in the POP models."""
        if self.is_ft:
            self.backbone.eval()  # the JAX model runs it with train=False
            feats = self.decoder(self.backbone(img))
            return torch.cat([conv2d(self.classifier, feats),
                              conv2d(self.classifier_n, feats)], dim=1).float()
        x4, x3 = self.backbone(img, return_list=True)[:2]
        out = conv2d(self.classifier, self.decoder(x4)).float()
        if not train:
            return out
        a = self.aux
        aux = conv2d(a[3], F.relu(batch_norm(a[1], conv2d(a[0], x3))))
        return out, aux.float()
