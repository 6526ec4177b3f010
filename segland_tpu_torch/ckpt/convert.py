"""JAX variable tree -> the port's state_dict, importing only numpy.

The inverse of the convnext_pop rules of segland_tpu/ckpt/torch_convert.py:
flax paths map to upstream SegLand keys, dense kernels are transposed, conv
kernels go HWIO -> OIHW (the depthwise (7,7,1,C) kernel becomes (C,1,7,7)),
LayerNorm ``scale`` becomes ``weight``, and the POP classifier's dense mats
w1/w2/w3 become the 1x1 convs ``classifier.{0,2,4}.weight``.
"""

import re

import numpy as np

# (flax path regex, torch module template); the leaf name is mapped after
_MODULES = [
    (r"backbone/downsample_0_conv", "backbone.downsample_layers.0.0"),
    (r"backbone/downsample_0_norm", "backbone.downsample_layers.0.1"),
    (r"backbone/downsample_([123])_norm", "backbone.downsample_layers.{0}.0"),
    (r"backbone/downsample_([123])_conv", "backbone.downsample_layers.{0}.1"),
    (r"backbone/stages_(\d)_(\d+)/(dwconv|norm|pwconv1|pwconv2)", "backbone.stages.{0}.{1}.{2}"),
    (r"backbone/stages_(\d)_(\d+)", "backbone.stages.{0}.{1}"),
    (r"decoder/(conv|norm)", "decoder.{0}"),
    (r"(classifier(?:_n)?)", "{0}"),
    (r"", ""),
]
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias", "gamma": "gamma",
           "base_emb": "base_emb", "novel_emb": "novel_emb"}
_CLASSIFIER = {"w1": "0.weight", "w2": "2.weight", "w3": "4.weight"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _leaf(module: str, name: str, value: np.ndarray):
    if module.startswith("classifier"):
        w = value.T if name in ("w1", "w2") else value[None, :]
        return f"{module}.{_CLASSIFIER[name]}", w[:, :, None, None]
    if name == "kernel":
        value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
    key = _LEAVES[name]
    return (f"{module}.{key}" if module else key), value


def from_jax_variables(variables) -> dict:
    """{'params': ...[, 'batch_stats': ...]} of numpy arrays -> {key: array}.
    Raises KeyError on a leaf it has no rule for."""
    out = {}
    for path, value in _flatten(dict(variables)):
        if path[0] != "params":
            raise KeyError(f"no port rule for {'/'.join(path)}")
        mod_path, name = "/".join(path[1:-1]), path[-1]
        for pat, tmpl in _MODULES:
            m = re.fullmatch(pat, mod_path)
            if m:
                break
        else:
            raise KeyError(f"no port rule for {'/'.join(path)}")
        key, arr = _leaf(tmpl.format(*m.groups()), name, np.asarray(value))
        out[key] = np.ascontiguousarray(arr)
    return out
