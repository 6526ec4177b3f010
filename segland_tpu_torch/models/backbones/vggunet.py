"""VGG16-BN U-Net, the trunk of vggunet_pop, NCHW PyTorch.

Port of segland_tpu/models/backbones/vggunet.py in its plain form, with
upstream SegLand's module names (networks/vggunet_pop.py): the encoder is
torchvision's ``vgg16_bn.features`` cut into ``inc``, ``down1`` .. ``down4``,
slices that keep the features' own indices (``net.down1.7`` is the conv at
features[7]); the decoder ``up1`` .. ``up4`` each a bilinear x2
(align_corners=True), padded to the skip, concatenated after it and run
through ``conv.double_conv`` (two 3x3 conv + BatchNorm + ReLU, at the JAX
package's mid widths).  Returns full-resolution 64-channel features: this
trunk is backbone and decoder in one (the ``identity`` decoder).

The reference's quirk stays (JAX docstring): each slice's trailing ReLU is
the first op of the next slice, and those ReLUs work in place, so the skips
x1..x4 are post-ReLU when the decoder reads them while x5 stays pre-ReLU.

The JAX package W-packs the full-resolution enc1 chain (``ops/packed.py``), a
TPU lane-layout device; the port runs the plain chain it replaces.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.layers import batch_norm, conv2d
from ...ops.pooling import max_pool_2x2
from ...ops.resize import resize_bilinear
from ..init import flax_defaults_

# slice name -> (first conv's index in vgg16_bn.features, conv widths)
_SLICES = {
    "inc": (0, (64, 64)),
    "down1": (7, (128, 128)),
    "down2": (14, (256, 256, 256)),
    "down3": (24, (512, 512, 512)),
    "down4": (34, (512, 512, 512)),
}
# up stage -> (mid width, output width), the JAX package's
_UPS = {"up1": (512, 256), "up2": (256, 128), "up3": (128, 64), "up4": (64, 64)}


class VGGSlice(nn.Module):
    """Conv + BatchNorm pairs under their features indices (three apart:
    conv, BatchNorm, ReLU).  Returns the last BatchNorm's output, before its
    ReLU; a ReLU follows every other pair."""

    def __init__(self, first: int, cin: int, widths):
        super().__init__()
        self.names = []
        for k, cout in enumerate(widths):
            i = first + 3 * k
            self.add_module(str(i), nn.Conv2d(cin, cout, 3, padding=1))
            self.add_module(str(i + 1), nn.BatchNorm2d(cout, eps=1e-5))
            self.names.append((str(i), str(i + 1)))
            cin = cout

    def forward(self, x):
        for k, (conv, bn) in enumerate(self.names):
            x = batch_norm(self._modules[bn], conv2d(self._modules[conv], x))
            if k < len(self.names) - 1:
                x = F.relu(x)
        return x


class DoubleConv(nn.Module):
    def __init__(self, cin: int, mid: int, cout: int):
        super().__init__()
        self.double_conv = nn.Sequential(
            nn.Conv2d(cin, mid, 3, padding=1), nn.BatchNorm2d(mid, eps=1e-5), nn.ReLU(),
            nn.Conv2d(mid, cout, 3, padding=1), nn.BatchNorm2d(cout, eps=1e-5), nn.ReLU())

    def forward(self, x):
        d = self.double_conv
        x = F.relu(batch_norm(d[1], conv2d(d[0], x)))
        return F.relu(batch_norm(d[4], conv2d(d[3], x)))


class Up(nn.Module):
    def __init__(self, cin: int, mid: int, cout: int):
        super().__init__()
        self.conv = DoubleConv(cin, mid, cout)

    def forward(self, deep, skip):
        u = resize_bilinear(deep.permute(0, 2, 3, 1), (deep.shape[-2] * 2, deep.shape[-1] * 2),
                            align_corners=True).permute(0, 3, 1, 2)
        dh, dw = skip.shape[-2] - u.shape[-2], skip.shape[-1] - u.shape[-1]
        if dh or dw:
            u = F.pad(u, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(torch.cat([skip, u], dim=1))


class VGGUNet(nn.Module):
    filters = (64,)

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        cin = 3
        for name, (first, widths) in _SLICES.items():
            self.add_module(name, VGGSlice(first, cin, widths))
            cin = widths[-1]
        skips = {"up1": 512, "up2": 256, "up3": 128, "up4": 64}
        deep = 512
        for name, (mid, cout) in _UPS.items():
            self.add_module(name, Up(skips[name] + deep, mid, cout))
            deep = cout

    def reset_parameters(self, generator=None):
        """The JAX package's init: flax's defaults (``models/init.py``)."""
        flax_defaults_(self, generator)

    def forward(self, x):
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        pool = lambda t: max_pool_2x2(t.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        x1 = F.relu(self.inc(x))
        x2 = F.relu(self.down1(pool(x1)))
        x3 = F.relu(self.down2(pool(x2)))
        x4 = F.relu(self.down3(pool(x3)))
        x5 = self.down4(pool(x4))  # pre-ReLU: the reference's quirk
        out = self.up1(x5, x4)
        out = self.up2(out, x3)
        out = self.up3(out, x2)
        return self.up4(out, x1)
