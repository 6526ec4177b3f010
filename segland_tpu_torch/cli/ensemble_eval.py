"""Ensemble evaluation (the contest configuration as one program).  Port of
segland_tpu/cli/ensemble_eval.py.

The reference's ensemble is a 3-stage host pipeline: eval each model with
prob export (eval_base.py:190-191), average the .mat maps (fusemat.py), and
score or export the result.  Here every member runs on each batch in turn
(evallib/ensemble.py): logits summed by native resolution in fp32, one
upsample + argmax (K2 on CUDA), only uint8 maps leave the device.

    python -m segland_tpu_torch.cli.ensemble_eval --data-dir DATA --val-list LIST \\
        --members convnext_pop:convnext-t:a.pth:bfloat16,swin_pop:swin-s:b.pth:bfloat16,\\
seghr_pop:hr-w32:c.pth:bfloat16 --eval-batch 8

Members: comma-separated ``model:backbone:checkpoint[:dtype]`` specs, dtype
``float32`` (the default) or ``bfloat16``; checkpoints are .pth state dicts.
Each member's ``--fused`` is the eval default of its model and dtype
(``cli/common.py:EVAL_FUSED_DEFAULTS``) unless ``--fused`` / ``--no-fused`` is
given.  ``--base-classes`` sets every member's base classes.  With GT labels:
the confusion matrix (``cmatrix_ensemble.npy``) and mIoU.  Without:
colormapped GTiff predictions.  Over several processes (``torchrun
--nproc_per_node N -m segland_tpu_torch.cli.ensemble_eval ...``) each runs
its share of each batch, as ``cli.eval_base`` does.
"""

import argparse
import os

import numpy as np
import torch

from .. import dist
from .common import add_common_args, add_dist_args, full_fp32, parse_hw, resolve_fused
from ..ckpt import load_pth
from ..data import Loader, OEMValDataset
from ..data.tileio import OEM_COLORMAP, write_pred_tiff
from ..evallib import EnsembleEvaluator
from ..models import build_model
from ..utils import get_logger

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def get_parser():
    p = argparse.ArgumentParser(description="segland_tpu_torch ensemble eval")
    add_common_args(p)
    add_dist_args(p)
    p.add_argument("--members", required=True,
                   help="comma list of model:backbone:ckpt[:dtype] specs")
    p.add_argument("--save-path", type=str, default="output")
    p.add_argument("--eval-batch", type=int, default=None, help="tiles per batch (default: 1)")
    return p


def parse_member(spec: str):
    """'model:backbone:ckpt[:dtype]' -> (model, backbone, ckpt, dtype name)."""
    parts = spec.split(":")
    if len(parts) not in (3, 4):
        raise ValueError(f"member {spec!r}: want model:backbone:ckpt[:dtype]")
    dtype = parts[3] if len(parts) == 4 else "float32"
    if dtype not in DTYPES:
        raise ValueError(f"member {spec!r}: dtype {dtype!r} is not one of {sorted(DTYPES)}")
    return parts[0], parts[1], parts[2], dtype


def _load_member(spec, args, device, logger):
    name, backbone, ckpt, dtype = parse_member(spec)
    fused = resolve_fused(argparse.Namespace(fused=args.fused, dtype=dtype, model=name))
    model = build_model(name, backbone=backbone, n_base=args.base_classes, os=args.output_stride,
                        dtype=DTYPES[dtype], fused_mlp=fused, fused_attn=fused, device=device,
                        generator=torch.Generator().manual_seed(0))
    n, missing, unexpected = load_pth(model, ckpt)
    logger.info(f"member {name}/{backbone} {dtype} fused={fused}: {ckpt} ({n} tensors, "
                f"{len(missing)} missing, {len(unexpected)} unexpected)")
    return model, dtype


def main(argv=None):
    args = get_parser().parse_args(argv)
    device = dist.init_from_env(args.device, args.dist_backend)
    logger = get_logger(rank=dist.rank())
    crop = parse_hw(args.base_size)
    members, dtypes = zip(*(_load_member(s, args, device, logger)
                            for s in args.members.split(",")))
    if "float32" in dtypes:
        full_fp32()
    valset = OEMValDataset(args.data_dir, args.val_list, base_size=crop,
                           use_novel=True, use_base=True, stats=args.norm_stats)
    loader = Loader(valset, args.eval_batch or 1, shuffle=False, drop_last=False,
                    process_index=dist.rank(), process_count=dist.world(),
                    num_workers=args.num_workers)
    ens = EnsembleEvaluator(members, device, num_classes=args.num_classes,
                            n_base=args.base_classes, ignore_label=args.ignore_label)
    os.makedirs(args.save_path, exist_ok=True)
    if valset[0][1] is not None:
        cm, (base, novel, total, iou), tps = ens.run(loader, logger=logger)
        if dist.is_main():
            np.save(os.path.join(args.save_path, "cmatrix_ensemble.npy"), cm)
        logger.info(f"ensemble meanIoU---base: mIoU {base:.4f}.")
        logger.info(f"ensemble meanIoU---novel: mIoU {novel:.4f}.")
        logger.info(f"ensemble meanIoU---total: mIoU {total:.4f}.")
        logger.info(f"throughput: {tps:.2f} tiles/sec")
        return {"base": base, "novel": novel, "total": total, "tps": tps}
    n = 0
    for images, _labels, ids in loader:
        pred = ens.predict_batch(images, np.shape(images)[1:3]).cpu().numpy()
        for i, tid in enumerate(ids):
            write_pred_tiff(os.path.join(args.save_path, f"{tid}.tif"), pred[i], OEM_COLORMAP,
                            os.path.join(args.data_dir, "images", f"{tid}.tif"))
            n += 1
    logger.info(f"wrote {n} ensemble predictions -> {args.save_path}")
    return {"written": n}


if __name__ == "__main__":
    main()
