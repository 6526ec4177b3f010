"""Base-model evaluation/inference entry point (reference eval_base.py).  Port of
segland_tpu/cli/eval_base.py.

With GT labels: 12-class confusion matrix -> base/novel/total mIoU + saved
cmatrix_<seed>.npy.  Without GT: colormapped GTiff predictions + per-tile
probability .mat maps for ensemble fusion.

    python -m segland_tpu_torch.cli.eval_base --data-dir DATA --val-list LIST \\
        --model convnext_pop --restore-from model.pth --dtype bfloat16 --eval-batch 8
    python -m segland_tpu_torch.cli.eval_base --data-dir DATA --val-list LIST \\
        --model deeplab_pop --backbone resnet50 --restore-from model.pth --int8 --fused \\
        --dtype bfloat16 --eval-batch 8 --device-normalize

``--int8`` calibrates on the first ``--calib-batches`` batches and serves
every large conv in int8 (``quant/ptq.py``); with ``--fused`` the stride-1
ResNet bottlenecks without a downsample each run as one kernel launch.
Unlabeled tiles' GTiff and .mat files are written on a pool of 4 threads
while the next batch runs (``Evaluator.run``'s ``export_workers``).
``--is-ft`` (what ``cli.eval_ft`` appends) evaluates a fine-tuned base+novel
model: a run per seed, square-longside logits against ignore-padded labels,
the saturated novel colormap, no .mat export.

Over several processes (``torchrun --nproc_per_node N -m
segland_tpu_torch.cli.eval_base ...``) each process runs its contiguous share
of each --eval-batch tiles, writes the exports of its own tiles, and the
confusion matrices are summed, so every rank reports the same mIoU; rank 0
writes ``cmatrix_<seed>.npy``.  With --int8 each calibration batch is a
global batch: the abs-max (or --calib-percentile's sample) is taken over the
ranks' rows together, so the scales are one process's at --eval-batch.
"""

import argparse
import os

import numpy as np
import torch

from .. import dist
from .common import (add_common_args, add_dist_args, full_fp32, model_dtype, parse_hw,
                     resolve_fused, str2bool)
from ..ckpt import load_pth
from ..data import Loader, OEMValDataset
from ..data import augment as A
from ..data.tileio import OEM_COLORMAP, OEM_COLORMAP_FT
from ..evallib.infer import Evaluator
from ..models import build_model
from ..utils import get_logger


def get_parser():
    p = argparse.ArgumentParser(description="segland_tpu_torch base evaluation")
    add_common_args(p)
    add_dist_args(p)
    p.add_argument("--save-path", type=str, default="output")
    p.add_argument("--is-ft", action="store_true", help="evaluate a fine-tuned (base+novel) model")
    p.add_argument("--eval-batch", type=int, default=None,
                   help="tiles per batch (default: 1)")
    p.add_argument("--save", type=str2bool, default=True,
                   help="write colormapped GTiff predictions for unlabeled tiles")
    p.add_argument("--save-prob", type=str2bool, default=True,
                   help="write per-tile .mat probability maps (for ensemble fusion)")
    p.add_argument("--device-normalize", action="store_true",
                   help="transfer raw uint8 tiles and normalize on device "
                        "(4x less host->device traffic)")
    p.add_argument("--int8", action="store_true",
                   help="int8 PTQ inference (backbone/decoder convs and linears in int8 "
                        "with int32 sums; POP head stays fp32); with --fused, eligible "
                        "resnet bottlenecks run through the fused block kernel")
    p.add_argument("--calib-batches", type=int, default=4,
                   help="batches used for int8 activation calibration")
    p.add_argument("--calib-percentile", type=float, default=None,
                   help="use outlier-robust percentile activation calibration "
                        "(e.g. 99.9) instead of abs-max")
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)
    fused = resolve_fused(args)
    device = dist.init_from_env(args.device, args.dist_backend)
    logger = get_logger(rank=dist.rank())
    if args.dtype == "float32":
        full_fp32()
    crop = parse_hw(args.base_size)
    n_base = args.base_classes
    model = build_model(
        args.model, backbone=args.backbone, n_base=n_base,
        n_novel=args.novel_classes if args.is_ft else 0, is_ft=args.is_ft,
        os=args.output_stride, dtype=model_dtype(args), fused_mlp=fused,
        fused_attn=fused, packed_train=args.packed_train, device=device,
        generator=torch.Generator().manual_seed(0))
    valset = OEMValDataset(args.data_dir, args.val_list, base_size=crop,
                           use_novel=True, use_base=True,
                           device_normalize=args.device_normalize, stats=args.norm_stats)
    loader = Loader(valset, args.eval_batch or 1, shuffle=False, drop_last=False,
                    process_index=dist.rank(), process_count=dist.world(),
                    num_workers=args.num_workers)
    ev_mean, ev_std = A.STATS[args.norm_stats]
    quant_cfg = None
    if args.int8 and (args.calib_percentile is not None or fused):
        from ..quant import QuantConfig

        quant_cfg = QuantConfig(
            act_estimator="percentile" if args.calib_percentile is not None else "absmax",
            percentile=args.calib_percentile or 99.9,
            # --fused + --int8: eligible resnet bottlenecks run through the
            # fused block kernel (ops/fused_bottleneck.py); asked for the CPU,
            # through its plain version
            fused_blocks=fused, fused_interpret=device.type == "cpu")

    results = {}
    for seed_str in args.random_seed.split(","):
        seed = int(seed_str)
        if args.restore_from:
            path = args.restore_from
            if args.is_ft:
                # reference eval_ft.py:154: restore_from[:-4] + '_<seed>.pth' when it exists
                seeded = f"{os.path.splitext(path)[0]}_{seed}.pth"
                if os.path.exists(seeded):
                    path = seeded
            n, missing, unexpected = load_pth(model, path)
            logger.info(f"restored torch ckpt {path}: {n} tensors, "
                        f"{len(missing)} missing, {len(unexpected)} unexpected")
        evaluator = Evaluator(model, device, num_classes=args.num_classes, n_base=n_base,
                              ignore_label=args.ignore_label,
                              normalize_on_device=args.device_normalize,
                              mean=ev_mean, std=ev_std, int8=args.int8,
                              calib_batches=args.calib_batches, quant_cfg=quant_cfg)
        save_path = args.save_path if args.save else None
        prob_path = (os.path.join(args.save_path, "prob")
                     if (args.save_prob and not args.is_ft) else None)
        os.makedirs(args.save_path, exist_ok=True)
        if prob_path:
            os.makedirs(prob_path, exist_ok=True)
        cm, (base, novel, total, iou), tps = evaluator.run(
            loader, save_path=save_path, prob_path=prob_path, data_root=args.data_dir,
            colormap=OEM_COLORMAP_FT if args.is_ft else OEM_COLORMAP,
            square_pad_eval=args.is_ft, logger=logger)
        if dist.is_main():
            np.save(os.path.join(args.save_path, f"cmatrix_{seed}.npy"), cm)
        logger.info(f">>>>>>> Current Seed {seed}: <<<<<<<")
        logger.info(f"meanIoU---base: mIoU {base:.4f}.")
        logger.info(f"meanIoU---novel: mIoU {novel:.4f}.")
        logger.info(f"meanIoU---total: mIoU {total:.4f}.")
        logger.info(f"throughput: {tps:.2f} tiles/sec")
        results[seed] = (base, novel, total, tps)
    return results


if __name__ == "__main__":
    main()
