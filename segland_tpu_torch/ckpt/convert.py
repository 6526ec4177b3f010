"""JAX variable tree -> the port's state_dict, importing only numpy.

The inverse of segland_tpu/ckpt/torch_convert.py's rules for every model of
the registry (the ResNet backbone, PSPModule, ASPP, ``_HRNET_RULES``,
``_LSK_RULES``, ``_VGG_RULES``, ``_PSPPLUS_RULES``; HRFPN has no parameters),
with the plain pspnet's heads besides: its ``classifier`` and
``classifier_n`` are 1x1 convs, and its aux head, for which the JAX converter
has no rule, takes the port's own names (``models/pspnet_plain.py``).  flax
paths map to upstream SegLand keys, dense kernels are transposed, conv
kernels go HWIO -> OIHW (the depthwise (7,7,1,C) kernel becomes (C,1,7,7)),
LayerNorm and BatchNorm ``scale`` becomes ``weight``, BatchNorm ``batch_stats`` mean/var become
``running_mean``/``running_var`` (with a zero ``num_batches_tracked``, which
upstream state dicts carry), and the POP classifier's dense mats w1/w2/w3
become the 1x1 convs ``classifier.{0,2,4}.weight``.  A tree whose decoder
has a ``reduce_conv`` is pspplus_pop's, whose ``fc`` is a Sequential where
deeplab_pop's holds ``conv`` and ``bn`` (the JAX converter's ``arch="pspplus"``).

The int8 activation scales travel apart from the weights: the ``"quant"``
collection's ``act_amax`` leaves map to ``{module name: scalar}`` with
:func:`quant_from_jax` and back with :func:`quant_to_jax`.
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
    # ResNet backbone: stem, then layerN_i blocks with downsample.{0,1}
    (r"backbone/((?:conv|bn)[123])", "backbone.{0}"),
    (r"backbone/layer([1-4])_(\d+)/((?:conv|bn)[123])", "backbone.layer{0}.{1}.{2}"),
    (r"backbone/layer([1-4])_(\d+)/downsample_conv", "backbone.layer{0}.{1}.downsample.0"),
    (r"backbone/layer([1-4])_(\d+)/downsample_bn", "backbone.layer{0}.{1}.downsample.1"),
    # PSPModule (v1): stages Sequential(pool, conv, bn); bottleneck
    # Sequential(conv3x3, bn, relu, conv1x1)
    (r"decoder/stages_(\d)_conv", "decoder.stages.{0}.1"),
    (r"decoder/stages_(\d)_bn", "decoder.stages.{0}.2"),
    (r"decoder/bottleneck_conv", "decoder.bottleneck.0"),
    (r"decoder/bottleneck_bn", "decoder.bottleneck.1"),
    (r"decoder/bottleneck_out", "decoder.bottleneck.3"),
    # ASPP: stages.cN.{conv,bn}, stages.imagepool.conv.{conv,bn}, fc.{conv,bn}
    (r"decoder/(c\d)_(conv|bn)", "decoder.stages.{0}.{1}"),
    (r"decoder/imagepool_(conv|bn)", "decoder.stages.imagepool.conv.{0}"),
    (r"decoder/fc_(conv|bn)", "decoder.fc.{0}"),
    # HRNet backbone: flat names, {module}_conv and {module}_bn; Sequential(conv, bn[, relu])
    # modules take them at .0 and .1
    (r"backbone/stem([12])_(conv|bn)", "backbone.{1}{0}"),
    (r"backbone/layer1_(\d)_c([123])_(conv|bn)", "backbone.layer1.{0}.{2}{1}"),
    (r"backbone/stage(\d)_(\d)_branches_(\d)_(\d)_c([12])_(conv|bn)",
     "backbone.stage{0}.{1}.branches.{2}.{3}.{5}{4}"),
    *[(rf"backbone/{path}_{kind}", f"backbone.{module}.{i}")
      for path, module in ((r"layer1_(\d)_down", "layer1.{0}.downsample"),
                           (r"transition1_0_0", "transition1.0"),
                           (r"transition([123])_([123])_0", "transition{0}.{1}.0"),
                           (r"stage(\d)_(\d)_fuse_(\d)_(\d)", "stage{0}.{1}.fuse_layers.{2}.{3}"),
                           (r"stage(\d)_(\d)_fuse_(\d)_(\d)_(\d)",
                            "stage{0}.{1}.fuse_layers.{2}.{3}.{4}"))
      for i, kind in enumerate(("conv", "bn"))],
    # LSKNet backbone and the SimpleDecoder's semantic embedding
    (r"backbone/patch_embed(\d)_(proj|norm)", "backbone.patch_embed{0}.{1}"),
    (r"backbone/block(\d)_(\d+)/(norm[12])", "backbone.block{0}.{1}.{2}"),
    (r"backbone/block(\d)_(\d+)/attn/(proj_[12])", "backbone.block{0}.{1}.attn.{2}"),
    (r"backbone/block(\d)_(\d+)/attn/spatial_gating_unit/(\w+)",
     "backbone.block{0}.{1}.attn.spatial_gating_unit.{2}"),
    (r"backbone/block(\d)_(\d+)/mlp_(fc[12])", "backbone.block{0}.{1}.mlp.{2}"),
    (r"backbone/block(\d)_(\d+)/mlp_dwconv", "backbone.block{0}.{1}.mlp.dwconv.dwconv"),
    (r"backbone/block(\d)_(\d+)", "backbone.block{0}.{1}"),
    (r"backbone/norm(\d)", "backbone.norm{0}"),
    (r"decoder/semantic_conv", "decoder.semantic_embedding.1"),
    # VGG U-Net (upstream's ``net``): encoder slices under vgg16_bn.features' indices,
    # decoder DoubleConvs Sequential(conv, bn, relu, conv, bn, relu)
    *[(rf"backbone/enc{b}_{k}_{kind}", f"net.{part}.{first + 3 * k + j}")
      for b, (part, first, n) in enumerate((("inc", 0, 2), ("down1", 7, 2), ("down2", 14, 3),
                                            ("down3", 24, 3), ("down4", 34, 3)), 1)
      for k in range(n) for j, kind in enumerate(("conv", "bn"))],
    *[(rf"backbone/up([1-4])_dc{dc}_{kind}", f"net.up{{0}}.conv.double_conv.{3 * dc + j}")
      for dc in (0, 1) for j, kind in enumerate(("conv", "bn"))],
    # the plain pspnet's aux head (the port's names)
    *[(rf"aux_{kind}", f"aux.{i}") for i, kind in ((0, "conv"), (1, "bn"), (3, "out"))],
    (r"(classifier(?:_n)?)", "{0}"),
    (r"", ""),
]
# pspplus_pop's decoder: ``psp`` is the V1 PSPModule, then reduce and fc Sequentials
_PSPPLUS = [
    (r"decoder/psp/bottleneck_out", "decoder.psp.bottleneck.3"),
    (r"decoder/reduce_(conv|bn)", "decoder.reduce.{0}"),
    (r"decoder/fc_(conv|bn|out)", "decoder.fc.{0}"),
]
_PSPPLUS_INDEX = {"conv": "0", "bn": "1", "out": "3"}
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias", "gamma": "gamma",
           "base_emb": "base_emb", "novel_emb": "novel_emb",
           "relative_position_bias_table": "relative_position_bias_table",
           "layer_scale_1": "layer_scale_1", "layer_scale_2": "layer_scale_2",
           "mean": "running_mean", "var": "running_var"}
_CLASSIFIER = {"w1": "0.weight", "w2": "2.weight", "w3": "4.weight"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _leaf(module: str, name: str, value: np.ndarray):
    if module.startswith("classifier") and name in _CLASSIFIER:
        w = value.T if name in ("w1", "w2") else value[None, :]
        return f"{module}.{_CLASSIFIER[name]}", w[:, :, None, None]
    if name == "kernel":
        value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
    key = _LEAVES[name]
    return (f"{module}.{key}" if module else key), value


def _module_name(mod_path: str, pspplus: bool = False) -> str:
    """flax module path ('backbone/layer1_0/conv1') -> the port's dotted
    module name (``pspplus``: of pspplus_pop's tree); KeyError where no rule
    matches."""
    if pspplus:
        for pat, tmpl in _PSPPLUS:
            m = re.fullmatch(pat, mod_path)
            if m:
                return tmpl.format(*(_PSPPLUS_INDEX.get(g, g) for g in m.groups()))
    for pat, tmpl in _MODULES:
        m = re.fullmatch(pat, mod_path)
        if m:
            return re.sub(r"(\d+)\*2", lambda d: str(2 * int(d[1])), tmpl.format(*m.groups()))
    raise KeyError(f"no port rule for {mod_path}")


def _is_pspplus(tree) -> bool:
    """Whether a params or quant tree is pspplus_pop's: its decoder has a ``reduce_conv``."""
    return "reduce_conv" in dict(tree).get("decoder", {})


# BatchNorms whose names do not end in bn: LSKNet's block and patch-embed norms
_BN_MODULE = re.compile(r"backbone/(block\d_\d+/norm[12]|patch_embed\d_norm)")


def from_jax_variables(variables) -> dict:
    """{'params': ...[, 'batch_stats': ...]} of numpy arrays -> {key: array}.
    A ``"quant"`` collection is left to :func:`quant_from_jax`.  Raises
    KeyError on a leaf it has no rule for."""
    out = {}
    pspplus = _is_pspplus(variables.get("params", {}))
    for path, value in _flatten({k: v for k, v in dict(variables).items() if k != "quant"}):
        stats = path[0] == "batch_stats"
        mod_path = "/".join(path[1:-1])
        is_bn = re.fullmatch(r"(.*_)?bn\d?", path[-2]) or _BN_MODULE.fullmatch(mod_path)
        if path[0] != "params" and not (stats and path[-1] in ("mean", "var") and is_bn):
            raise KeyError(f"no port rule for {'/'.join(path)}")
        name = path[-1]
        module = _module_name(mod_path, pspplus)
        key, arr = _leaf(module, name, np.asarray(value))
        out[key] = np.ascontiguousarray(arr)
        if stats and name == "mean":
            out[f"{module}.num_batches_tracked"] = np.zeros((), np.int64)
    return out


def quant_from_jax(quant) -> dict:
    """The JAX package's ``"quant"`` collection ({... module path: {'act_amax':
    scalar}}) -> {the port's module name: fp32 scalar array}."""
    out = {}
    pspplus = _is_pspplus(quant)
    for path, value in _flatten(dict(quant)):
        if path[-1] != "act_amax":
            raise KeyError(f"no port rule for quant/{'/'.join(path)}")
        out[_module_name("/".join(path[:-1]), pspplus)] = np.asarray(value, np.float32)
    return out


def quant_to_jax(quant: dict, params) -> dict:
    """The inverse: the port's {module name: act_amax} as a ``"quant"``
    collection shaped after ``params`` (the JAX 'params' tree, which names the
    modules); scales of modules that tree lacks raise KeyError."""
    out, used = {}, set()
    pspplus = _is_pspplus(params)
    for path, _ in _flatten(dict(params)):
        if path[-1] != "kernel":
            continue
        name = _module_name("/".join(path[:-1]), pspplus)
        if name in quant:
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node["act_amax"] = np.asarray(quant[name], np.float32)
            used.add(name)
    if used != set(quant):
        raise KeyError(f"no module of the tree for {sorted(set(quant) - used)}")
    return out
