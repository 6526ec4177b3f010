"""JAX variable tree -> the port's state_dict, importing only numpy.

The inverse of the convnext_pop and swin_pop rules of
segland_tpu/ckpt/torch_convert.py: flax paths map to upstream SegLand keys,
dense kernels are transposed, conv kernels go HWIO -> OIHW (the depthwise
(7,7,1,C) kernel becomes (C,1,7,7)), LayerNorm and BatchNorm ``scale``
becomes ``weight``, BatchNorm ``batch_stats`` mean/var become
``running_mean``/``running_var`` (with a zero ``num_batches_tracked``, which
upstream state dicts carry), and the POP classifier's dense mats w1/w2/w3
become the 1x1 convs ``classifier.{0,2,4}.weight``.
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
    # swin backbone
    (r"backbone/patch_embed_(proj|norm)", "backbone.patch_embed.{0}"),
    (r"backbone/layers_(\d)_blocks_(\d+)/(norm1|norm2)", "backbone.layers.{0}.blocks.{1}.{2}"),
    (r"backbone/layers_(\d)_blocks_(\d+)/attn/(qkv|proj)",
     "backbone.layers.{0}.blocks.{1}.attn.{2}"),
    (r"backbone/layers_(\d)_blocks_(\d+)/attn", "backbone.layers.{0}.blocks.{1}.attn"),
    (r"backbone/layers_(\d)_blocks_(\d+)/mlp_(fc1|fc2)", "backbone.layers.{0}.blocks.{1}.mlp.{2}"),
    (r"backbone/layers_(\d)_downsample/(norm|reduction)", "backbone.layers.{0}.downsample.{1}"),
    (r"backbone/out_norm(\d)", "backbone.norm{0}"),
    # UperNet+ decoder: Sequential(conv, bn, relu) blocks; the PSP stages are
    # Sequential(pool, conv, bn); scale-head block r sits at index 2r
    (r"decoder/psp/stages_(\d)_conv", "decoder.psp.stages.{0}.1"),
    (r"decoder/psp/stages_(\d)_bn", "decoder.psp.stages.{0}.2"),
    (r"decoder/psp/bottleneck_conv", "decoder.psp.bottleneck.0"),
    (r"decoder/psp/bottleneck_bn", "decoder.psp.bottleneck.1"),
    (r"decoder/lateral_(\d)_conv", "decoder.lateral_convs.{0}.0"),
    (r"decoder/lateral_(\d)_bn", "decoder.lateral_convs.{0}.1"),
    (r"decoder/fpn_convs_(\d)_(\d)_conv", "decoder.fpn_convs.{0}.{1}*2.0"),
    (r"decoder/fpn_convs_(\d)_(\d)_bn", "decoder.fpn_convs.{0}.{1}*2.1"),
    (r"(classifier(?:_n)?)", "{0}"),
    (r"", ""),
]
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias", "gamma": "gamma",
           "base_emb": "base_emb", "novel_emb": "novel_emb",
           "relative_position_bias_table": "relative_position_bias_table",
           "mean": "running_mean", "var": "running_var"}
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
        stats = path[0] == "batch_stats"
        if path[0] != "params" and not (stats and path[-1] in ("mean", "var")
                                        and path[-2].endswith("_bn")):
            raise KeyError(f"no port rule for {'/'.join(path)}")
        mod_path, name = "/".join(path[1:-1]), path[-1]
        for pat, tmpl in _MODULES:
            m = re.fullmatch(pat, mod_path)
            if m:
                break
        else:
            raise KeyError(f"no port rule for {'/'.join(path)}")
        module = re.sub(r"(\d+)\*2", lambda d: str(2 * int(d[1])), tmpl.format(*m.groups()))
        key, arr = _leaf(module, name, np.asarray(value))
        out[key] = np.ascontiguousarray(arr)
        if stats and name == "mean":
            out[f"{module}.num_batches_tracked"] = np.zeros((), np.int64)
    return out
