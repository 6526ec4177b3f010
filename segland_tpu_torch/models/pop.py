"""GFSSModel, the POP segmentation head over a backbone and a decoder.

Port of segland_tpu/models/pop.py with upstream SegLand's parameter names
(networks/convnext_pop.py GFSS_Model), so ``state_dict()`` keys are the
upstream keys.  The backbone and decoder run in the compute dtype; the
decoder output is cast to fp32 and the POP head runs in fp32 through the
rank-1 collapse of ops/pop.py.  Logits come out NCHW, [B, K, h, w], as
upstream returns them; they are a view of channels-last storage, so
``permute(0, 2, 3, 1)`` gives the ops' (B, h, w, K) layout without a copy.
"""

import math

import torch
import torch.nn as nn

from .backbones import get_backbone, backbone_filters
from . import decoders as D
from ..ops import pop as pop_ops


class Classifier(nn.Sequential):
    """The shared bias-free 3-layer 1x1-conv classifier (upstream
    ``classifier.{0,2,4}``)."""

    def __init__(self, d_model: int):
        super().__init__(
            nn.Conv2d(d_model, d_model, 1, bias=False), nn.ReLU(),
            nn.Conv2d(d_model, d_model, 1, bias=False), nn.ReLU(),
            nn.Conv2d(d_model, 1, 1, bias=False))

    def weights(self):
        """(w1 [C,C], w2 [C,C], w3 [C]) as input-major dense mats."""
        return (self[0].weight[:, :, 0, 0].T, self[2].weight[:, :, 0, 0].T,
                self[4].weight[0, :, 0, 0])


class GFSSModel(nn.Module):
    def __init__(self, backbone_name: str = "resnet50", decoder_name: str = "psp",
                 n_base: int = 7, n_novel: int = 0, is_ft: bool = False, os: int = 8,
                 dilated: bool = True, fused_mlp: bool = False, fused_attn: bool = False,
                 packed_train=None, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.backbone_name = backbone_name
        self.decoder_name = decoder_name
        self.is_ft = is_ft
        packs = backbone_name.startswith("hr-") or backbone_name in ("lsk-t", "vgg16bn-unet")
        if packed_train and packs:
            raise ValueError(
                f"packed_train=True asks for the W-packed layout of the JAX package's "
                f"{backbone_name!r}, a TPU lane-layout device the port does not carry; it "
                f"builds its plain form (packed_train None or False)")
        if packed_train is not None and not packs:
            raise ValueError(
                f"packed_train picks the JAX package's W-packed layout, which the port does "
                f"not carry; {backbone_name!r} takes no packed_train")
        if decoder_name not in D.DECODERS:
            raise ValueError(decoder_name)
        bk = dict(os=os, dilated=dilated) if backbone_name.startswith("resnet") else {}
        trunk = get_backbone(backbone_name, dtype=dtype, fused_mlp=fused_mlp,
                             fused_attn=fused_attn, **bk)
        if backbone_name == "vgg16bn-unet":
            self.net = trunk  # upstream vggunet_pop's name for its U-Net
        else:
            self.backbone = trunk
        dm = self.d_model
        self.decoder = D.DECODERS[decoder_name](
            backbone_filters(backbone_name), out_features=dm, dtype=dtype)
        self.base_emb = nn.Parameter(torch.empty(n_base, dm))
        self.classifier = Classifier(dm)
        if is_ft:
            if n_novel <= 0:
                raise ValueError("is_ft needs n_novel > 0")
            self.novel_emb = nn.Parameter(torch.empty(n_novel, dm))
            self.classifier_n = Classifier(dm)
        self.reset_parameters(generator)

    @property
    def backbone(self) -> nn.Module:
        """The trunk, whichever name upstream gives it (``net`` in vggunet_pop)."""
        return self._modules["backbone"] if "backbone" in self._modules else self._modules["net"]

    @property
    def d_model(self) -> int:
        filters = backbone_filters(self.backbone_name)
        if self.decoder_name in ("psp", "pspplus"):
            return 512
        if self.decoder_name == "aspp":
            return 256
        if self.decoder_name == "upernetplus":
            return min(filters)
        if self.decoder_name in ("fpn_ocr", "simple"):
            return 192
        if self.decoder_name == "hrfpn":
            return sum(filters)
        if self.decoder_name == "identity":
            return filters[0]
        raise ValueError(self.decoder_name)

    @property
    def needs_pyramid(self) -> bool:
        return self.decoder_name not in ("psp", "aspp", "identity")

    def reset_parameters(self, generator: torch.Generator | None = None):
        """The JAX package's init, every draw from ``generator``: the
        backbone's and the decoder's (``models/init.py``), torch's Conv2d
        default for the classifiers (the JAX package's ``_torch_conv_init``
        and ``_w3_init``), orthogonal prototypes."""
        self.backbone.reset_parameters(generator)
        self.decoder.reset_parameters(generator)
        heads = [self.classifier] + ([self.classifier_n] if self.is_ft else [])
        for conv in (m for h in heads for m in h if isinstance(m, nn.Conv2d)):
            nn.init.kaiming_uniform_(conv.weight, a=math.sqrt(5), generator=generator)
        nn.init.orthogonal_(self.base_emb, generator=generator)
        if self.is_ft:
            nn.init.orthogonal_(self.novel_emb, generator=generator)

    def extract_features(self, img):
        """backbone + decoder -> [B, h, w, d_model] fp32 (channels-last view).
        The train-only layers follow ``module.training`` (``model.train()``),
        where the JAX package passes ``train``: BatchNorm, and in swin_pop
        each block's DropPath and PSPModuleV2's dropout, whose masks come from
        the step's generator (``backbones/droppath.py``); convnext_pop's
        DropPath rate is 0, as in the JAX package."""
        if self.backbone_name.startswith("resnet"):
            feats = self.backbone(img, return_list=self.needs_pyramid)
            if self.decoder_name == "pspplus":
                feats = [feats[0], feats[2]]  # [x4, x2]: reduce takes 512 channels
        else:
            feats = self.backbone(img)
        return self.decoder(feats).float().permute(0, 2, 3, 1)

    def forward_base(self, img, train: bool = False):
        """[B, 1+n_base, h, w] logits; with ``train`` also the prototypes'
        cosine similarities [n_base, n_base], which the orth loss reads."""
        logits = pop_ops.pop_logits_base(
            self.extract_features(img), self.base_emb,
            *self.classifier.weights()).permute(0, 3, 1, 2)
        if train:
            return logits, pop_ops.proto_similarity(self.base_emb)
        return logits

    def forward_all(self, img):
        """[B, 1+n_base+n_novel, h, w] logits for fine-tuned eval."""
        logits, _ = pop_ops.pop_logits_all(
            self.extract_features(img), self.base_emb, self.novel_emb,
            self.classifier.weights(), self.classifier_n.weights())
        return logits.permute(0, 3, 1, 2)

    def forward_novel(self, img):
        """Fine-tune forward: (logits [B, 1+n_base+n_novel, h, w], the novel
        head's logits [B, 1+n_novel, h, w], the prototypes' cosine
        similarities [n_novel, n_base+n_novel]).  The caller concatenates the
        novel-support and base batches first (reference pspnet_pop.py:197).

        The backbone and decoder are frozen: they run in eval mode (BatchNorm
        on its running statistics, upstream's ``train_mode()``,
        pspnet_pop.py:80-85) and under ``torch.no_grad()``, so only the POP
        head builds a graph and every kernel on the trunk runs forward-only."""
        self.backbone.eval()
        self.decoder.eval()
        with torch.no_grad():
            feats = self.extract_features(img)
        logits, novel_logits = pop_ops.pop_logits_all(
            feats, self.base_emb, self.novel_emb,
            self.classifier.weights(), self.classifier_n.weights())
        sim = pop_ops.proto_similarity(self.novel_emb, self.base_emb)
        return logits.permute(0, 3, 1, 2), novel_logits.permute(0, 3, 1, 2), sim

    def forward(self, img):
        return self.forward_all(img) if self.is_ft else self.forward_base(img)
