"""Scene prediction of any size (serving entry point).  Port of
segland_tpu/cli/predict.py.

Splits each GeoTIFF scene into overlapping tiles, runs them in batches on
the device and writes a colormapped prediction with the scene's geo tags
(evallib/tiled.py).  Where the (H,W,K) fp32 accumulator fits in 2 GiB the
scene, the accumulator and the stitching stay on the device and only the
uint8 map comes back; otherwise, and with ``--int8``, the logits of each
batch are stitched on the host.

    python -m segland_tpu_torch.cli.predict --data-dir . --input scene.tif --output out/ \\
        --model convnext_pop --restore-from model.pth --dtype bfloat16
"""

import argparse
import os

import numpy as np
import torch

from .common import add_common_args, full_fp32, model_dtype, resolve_fused
from ..ckpt import load_pth
from ..data import augment as A
from ..data.tileio import OEM_COLORMAP, OEM_COLORMAP_FT, read_image, write_pred_tiff
from ..evallib import Evaluator
from ..evallib.tiled import predict_scene, predict_scene_device
from ..models import build_model
from ..utils import get_logger

DEVICE_ACC_BYTES = 2 << 30  # the largest accumulator the device path takes


def get_parser():
    p = argparse.ArgumentParser(description="segland_tpu_torch scene prediction")
    add_common_args(p)
    p.add_argument("--input", required=True, help="scene image (.tif) or directory")
    p.add_argument("--output", required=True, help="output directory")
    p.add_argument("--tile", type=int, default=1024)
    p.add_argument("--overlap", type=int, default=128)
    p.add_argument("--is-ft", action="store_true")
    p.add_argument("--eval-batch", type=int, default=8)
    p.add_argument("--int8", action="store_true",
                   help="int8 PTQ inference (calibrates on the first batches)")
    p.add_argument("--calib-batches", type=int, default=4)
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)
    fused = resolve_fused(args, "eval")
    logger = get_logger()
    device = torch.device(args.device)
    if args.dtype == "float32":
        full_fp32()
    model = build_model(
        args.model, backbone=args.backbone, n_base=args.base_classes,
        n_novel=args.novel_classes if args.is_ft else 0, is_ft=args.is_ft,
        os=args.output_stride, dtype=model_dtype(args), fused_mlp=fused, fused_attn=fused,
        device=device, generator=torch.Generator().manual_seed(0))
    if args.restore_from:
        n, missing, unexpected = load_pth(model, args.restore_from)
        logger.info(f"restored torch ckpt {args.restore_from}: {n} tensors, "
                    f"{len(missing)} missing, {len(unexpected)} unexpected")
    n_classes = 1 + args.base_classes + (args.novel_classes if args.is_ft else 0)
    quant_cfg = None
    if args.int8 and fused:
        from ..quant import QuantConfig

        quant_cfg = QuantConfig(fused_blocks=True, fused_interpret=device.type == "cpu")
    evaluator = Evaluator(model, device, num_classes=n_classes, n_base=args.base_classes,
                          int8=args.int8, calib_batches=args.calib_batches, quant_cfg=quant_cfg)
    tile_hw = (args.tile, args.tile)

    def predict_batch(tiles):  # host tiles -> host logits
        return evaluator.predict_batch(tiles, tile_hw)[0].cpu().numpy()

    def apply_fn(tiles):  # device tiles -> device logits
        return evaluator.predict_batch((tiles, tiles.shape[0]), tile_hw)[0]

    os.makedirs(args.output, exist_ok=True)
    paths = (
        [os.path.join(args.input, f) for f in sorted(os.listdir(args.input)) if f.endswith(".tif")]
        if os.path.isdir(args.input) else [args.input]
    )
    cmap = OEM_COLORMAP_FT if args.is_ft else OEM_COLORMAP
    for path in paths:
        image = A.normalize(read_image(path), A.IMAGENET_MEAN, A.IMAGENET_STD)
        h, w = image.shape[:2]
        acc_bytes = (h + args.tile) * (w + args.tile) * n_classes * 4
        if not args.int8 and acc_bytes <= DEVICE_ACC_BYTES:
            pred = predict_scene_device(apply_fn, image, n_classes, device, tile=args.tile,
                                        overlap=args.overlap, batch=args.eval_batch)
        else:
            _, pred = predict_scene(predict_batch, image, n_classes, tile=args.tile,
                                    overlap=args.overlap, batch=args.eval_batch)
        out = os.path.join(args.output, os.path.basename(path))
        write_pred_tiff(out, pred, cmap, profile_from=path)
        logger.info(f"{path} {image.shape[:2]} -> {out}")
    return len(paths)


if __name__ == "__main__":
    main()
