"""The JAX package's initial weights, drawn in torch: flax's defaults (a
``lecun_normal`` kernel and a zero bias for every conv and dense layer, unit
scale and zero shift for every norm) plus the few explicit initializers of the
JAX models, which the models' ``reset_parameters`` add.  Upstream SegLand
draws other schemes (He-normal ResNet convs, trunc-normal(0.02) transformer
layers, torch's default decoder convs); the port draws the JAX package's, its
reference, so that a fresh port model trains as a fresh JAX model does
(ROADMAP C6)."""

import torch.nn as nn

# the std of a standard normal truncated to [-2, 2] (flax's variance_scaling)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w, generator=None):
    """flax's ``lecun_normal``: a normal truncated at two standard deviations
    with variance 1 / fan_in, where a torch weight [out, in / groups, *k] has
    fan_in = ``w[0].numel()``."""
    std = (1.0 / w[0].numel()) ** 0.5 / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def truncated_normal_(w, stddev: float, generator=None):
    """flax's ``truncated_normal(stddev)``: a standard normal truncated to
    [-2, 2], times ``stddev``."""
    return nn.init.trunc_normal_(w, 0.0, stddev, -2.0 * stddev, 2.0 * stddev,
                                 generator=generator)


def flax_defaults_(module: nn.Module, generator=None):
    """flax's default init of every conv, linear, LayerNorm and BatchNorm
    under ``module``; BatchNorm's running statistics reset too."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
