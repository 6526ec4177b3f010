"""Novel-class fine-tuning entry point (reference ft_pop.py).  Port of
segland_tpu/cli/ft_pop.py on one device.

    python -m segland_tpu_torch.cli.gen_fs_list --data-dir DATA --train-list DATA/list/train.txt
    python -m segland_tpu_torch.cli.ft_pop --data-dir DATA --train-list DATA/list/train.txt \\
        --val-list DATA/list/val.txt --model swin_pop --backbone swin-s --restore-from base.pth \\
        --dtype bfloat16 --input-size 1024,1024 --batch-size 1 --learning-rate 1e-4 \\
        --weight-decay 1e-4 --fix-lr --freeze-backbone --update-base --shot 5 \\
        --random-seed 123,234

One run per seed of --random-seed, each from a fresh model and optimizer: the
model is built with its novel head (``is_ft``) from a seeded generator, the
base ``.pth`` of --restore-from loaded over it non-strictly (``novel_emb`` and
``classifier_n`` keep their init; a shape mismatch raises), then
``classifier_n`` copied from ``classifier``.  Episodes are (novel support,
base sample) pairs of ``OEMFtTrainDataset`` (``all_<shot>shot_seed<seed>.txt``
from ``gen_fs_list`` beside --train-list); SGD trains ``novel_emb`` and
``classifier_n`` only, over the frozen backbone and decoder
(``train/ft.py``).  Every --val-frequency epochs it validates (base, novel
and total mIoU) and writes ``best_<seed>.pth`` (upstream keys) where the base
mIoU improved, which ``cli.eval_ft`` and the JAX package's
``load_torch_checkpoint`` read.  --update-base resamples the base samples every
--update-epoch epochs.  Every POP model of the registry fine-tunes; the
plain ``pspnet`` has no POP head, and raises as the JAX CLI fails on it.
Over several processes (``torchrun --nproc_per_node N -m
segland_tpu_torch.cli.ft_pop ...``, the global --batch-size divisible by N)
each process takes its share of each global batch of episodes, the head's
gradients are averaged, the validation's sums are summed over the ranks and
rank 0 writes ``best_<seed>.pth``.
"""

import argparse
import os

import numpy as np
import torch

from .. import dist
from .common import (add_common_args, add_dist_args, add_train_args, check_global_batch,
                     full_fp32, model_dtype, parse_hw, resolve_fused, str2bool, to_device)
from ..ckpt import load_pth, save_params
from ..data import Loader, OEMFtTrainDataset, OEMValDataset
from ..models import build_model
from ..train import (TrainState, create_optimizer, ft_trainable, init_cls_n, make_eval_step,
                     make_ft_train_step)
from ..utils import format_loss_dict, prep_experiment


def get_parser():
    p = argparse.ArgumentParser(description="segland_tpu_torch novel-class fine-tuning")
    add_common_args(p)
    add_train_args(p)
    add_dist_args(p)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--filter-novel", action="store_true", default=False,
                   help="restrict the base samples to novel-free tiles, lists read from "
                        "<list dir>_filter (reference oem_ft.py filter_intersection)")
    p.add_argument("--shot", type=int, default=5)
    p.add_argument("--update-base", type=str2bool, nargs="?", const=True, default=False)
    p.add_argument("--update-epoch", type=int, default=1)
    p.add_argument("--metrics", action="store_true",
                   help="write train/val scalars to <snapshot-dir>/metrics.jsonl")
    return p


def check_trainable(args):
    """Raise for what the port cannot fine-tune."""
    if "pop" not in args.model:
        # the JAX CLI gets as far as make_ft_train_step, which reads the model class's
        # forward_novel (segland_tpu/train/ft.py:53) and raises AttributeError there
        raise ValueError(f"{args.model} has no POP head and no forward_novel, which the "
                         f"fine-tune step runs: the JAX package's ft_pop fails on it too")


def main(argv=None):
    """Fine-tunes one model a seed; returns {seed: best} with best = {'total',
    'base', 'novel', 'epoch'} of the best validation."""
    args = get_parser().parse_args(argv)
    check_trainable(args)
    fused = resolve_fused(args, "ft")
    device = dist.init_from_env(args.device, args.dist_backend)
    check_global_batch(args.batch_size)
    if args.dtype == "float32":
        full_fp32()
    writer = None
    if args.metrics:
        writer, logger = prep_experiment(args.snapshot_dir, argv, rank=dist.rank(),
                                         need_writer=True)
    else:
        logger = prep_experiment(args.snapshot_dir, argv, rank=dist.rank())
    logger.info(f"device: {device} | processes: {dist.world()} | fused: {fused}")
    results = {}
    for seed_str in args.random_seed.split(","):
        seed = int(seed_str)
        results[seed] = run_seed(args, seed, fused, device, logger, writer)
    if writer is not None:
        writer.close()
    return results


def run_seed(args, seed, fused, device, logger, writer=None):
    n_base, n_novel = args.base_classes, args.novel_classes
    trainset = OEMFtTrainDataset(args.data_dir, args.train_list, shot=args.shot, seed=seed,
                                 crop_size=parse_hw(args.input_size), filter=args.filter_novel,
                                 stats=args.norm_stats)
    valset = OEMValDataset(args.data_dir, args.val_list, base_size=parse_hw(args.base_size),
                           resize_label=True, use_novel=True, use_base=True,
                           stats=args.norm_stats)
    rank, world = dist.rank(), dist.world()
    train_loader = Loader(trainset, args.batch_size, shuffle=True, drop_last=True, seed=seed,
                          process_index=rank, process_count=world, num_workers=args.num_workers)
    val_loader = Loader(valset, args.test_batch_size, shuffle=False, process_index=rank,
                        process_count=world)

    model = build_model(args.model, backbone=args.backbone, n_base=n_base, n_novel=n_novel,
                        is_ft=True, os=args.output_stride, dtype=model_dtype(args),
                        fused_mlp=fused, fused_attn=fused, packed_train=args.packed_train,
                        device=device, generator=torch.Generator().manual_seed(seed))
    if args.restore_from:
        # the base model's keys over the ft model's (graft_base_into_ft in the JAX package)
        n, missing, unexpected = load_pth(model, args.restore_from)
        logger.info(f"restored torch base ckpt {args.restore_from}: {n} tensors, kept "
                    f"their init: {missing}, unexpected: {unexpected}")
    init_cls_n(model)  # classifier_n from classifier (ft_pop.py:198-204)

    steps_per_epoch = max(len(train_loader), 1)
    tx = create_optimizer(model, args.learning_rate, args.num_epoch, steps_per_epoch,
                          weight_decay=args.weight_decay, power=args.power, optimizer="sgd",
                          momentum=args.momentum, freeze_backbone=args.freeze_backbone,
                          fix_lr=args.fix_lr, trainable_fn=ft_trainable)
    state = TrainState(model, tx)
    train_step = make_ft_train_step(model, n_base, skip_nonfinite=True)
    eval_step = make_eval_step(model, args.num_classes, args.ignore_label)

    best = {"total": 0.0, "base": 0.0, "novel": 0.0, "epoch": 0}
    global_it = 0
    for epoch in range(args.start_epoch, args.num_epoch):
        epoch_log = epoch + 1
        trainset.set_seed(seed + epoch)
        train_loader.set_epoch(epoch)
        for i, (img, mask, img_b, mask_b, _) in enumerate(train_loader):
            ld, gn = train_step(state, *(to_device(a, device) for a in (img, mask, img_b, mask_b)))
            global_it += 1
            if i % args.print_frequency == 0:
                lr = tx.lr_fn(global_it - 1)
                logger.info(format_loss_dict(
                    ld, lr, gn, f"Seed{seed} Epoch{epoch_log} Iter{i + 1}/{steps_per_epoch}:"))
                if writer is not None:
                    writer.add_scalars(f"seed{seed}/train",
                                       {**{k: float(v) for k, v in ld.items()}, "lr": lr,
                                        "grad_norm": float(gn)}, global_it)
        if args.update_base and epoch_log % args.update_epoch == 0:
            trainset.update_base_list()  # host-side resample (ft_pop.py:271)

        if epoch_log % args.val_frequency == 0 or epoch_log >= args.num_epoch:
            base_miou, novel_miou, total_miou = validate_ft(
                eval_step, val_loader, device, args.num_classes, n_base)
            logger.info(f"Seed{seed} Epoch{epoch_log}: base {base_miou:.4f} "
                        f"novel {novel_miou:.4f} total {total_miou:.4f}")
            if writer is not None:
                writer.add_scalars(f"seed{seed}/val", {"base_mIoU": base_miou,
                                                        "novel_mIoU": novel_miou,
                                                        "total_mIoU": total_miou}, global_it)
            # the best gated on a base mIoU that improves (ft_pop.py:284-296)
            if base_miou > best["base"]:
                best = {"total": total_miou, "base": base_miou, "novel": novel_miou,
                        "epoch": epoch_log}
                save_params(os.path.join(args.snapshot_dir, f"best_{seed}.pth"), model)
    logger.info(f"Seed{seed} best: {best}")
    return best


def validate_ft(eval_step, val_loader, device, num_classes: int, n_base: int):
    """(base, novel, total) mIoU: summed intersection / max(summed union, 1)
    per class, averaged over classes [0, n_base], (n_base, K) and all
    (segland_tpu/cli/ft_pop.py:151-163).  Unlabelled batches are skipped.
    Under a process group the sums are summed over the ranks."""
    sums = torch.zeros((2, num_classes), dtype=torch.float64, device=device)
    for img, mask, _ in val_loader:
        if mask is None or (isinstance(mask, list) and mask[0] is None):
            continue
        mask = np.stack(mask, 0) if isinstance(mask, list) else np.asarray(mask)
        i, u, _ = eval_step(to_device(img, device), to_device(mask, device))
        sums[0] += i.double()
        sums[1] += u.double()
    inter, union = dist.all_reduce_sum(sums, group=dist.stats_group()).cpu().numpy()
    iou = inter / np.maximum(union, 1)
    return (float(np.mean(iou[: n_base + 1])), float(np.mean(iou[n_base + 1:])),
            float(np.mean(iou)))


if __name__ == "__main__":
    main()
