"""Base-class training entry point (reference train_base.py).  Port of
segland_tpu/cli/train_base.py on one device.

    python -m segland_tpu_torch.cli.train_base --data-dir DATA --model convnext_pop \\
        --dtype bfloat16 --num-epoch 200 --batch-size 4 --input-size 768,768 \\
        --learning-rate 1e-3

Trains every model of the registry: ``convnext_pop`` (K1 in every block's
forward with --fused), ``swin_pop`` (K3 and K1 in every block's forward with
--fused, each differentiable; DropPath and the decoder's dropout drawn from a
generator seeded by --random-seed and the step, as lsk_pop's DropPath and
MLP dropout are), ``pspnet_pop``, ``pspplus_pop``, ``deeplab_pop``,
``lsk_pop``, ``vggunet_pop`` and ``seghr_pop`` (BatchNorm in train mode;
seghr_pop / hr-w32 is the reference's own base-training model,
``scripts/train_oem.sh``) with the orth loss, and the plain ``pspnet`` with
the CE loss and its aux head (the JAX CLI's pick: "pop" in the name or not);
the default of --fused is TRAIN_FUSED_DEFAULTS'.
Snapshots ``epoch_N.pth`` every --snapshot-frequency epochs, validates after
--val-start every --val-frequency epochs through the ``Evaluator`` (K2 on the
card) and keeps the best as ``best.pth``.

More than one process, one a device, as torchrun launches them (the JAX
package's data mesh):

    torchrun --nproc_per_node 4 -m segland_tpu_torch.cli.train_base ... --batch-size 8

The global --batch-size divides by the process count; each process loads its
share of each global batch, DistributedDataParallel averages the gradients,
BatchNorm takes the global batch's statistics, and rank 0 writes the
snapshots, ``best.pth`` and the logs.  --device-augment ships the raw uint8
tiles (each brought to --base-size) and crops, pads, flips, rotates and
normalizes them on the device inside the step (``ops/device_aug.py``).
"""

import argparse
import functools
import inspect
import os

import numpy as np
import torch

from .. import dist
from .common import (add_common_args, add_dist_args, add_train_args, check_global_batch,
                     full_fp32, model_dtype, parse_hw, resolve_fused, to_device)
from ..ckpt import load_checkpoint, load_pth, save_checkpoint, save_params
from ..data import DATASETS, Loader
from ..evallib.infer import Evaluator
from ..models import build_model
from ..ops.device_aug import base_train_augment
from ..train import TrainState, create_optimizer, make_base_train_step
from ..utils import format_loss_dict, prep_experiment


def get_parser():
    p = argparse.ArgumentParser(description="segland_tpu_torch base training")
    add_common_args(p)
    add_train_args(p)
    add_dist_args(p)
    p.add_argument("--resume-from", type=str, default=None,
                   help="epoch_N.pth to resume from (model, optimizer, LR count, epoch)")
    p.add_argument("--skip-nonfinite", action=argparse.BooleanOptionalAction, default=True,
                   help="drop updates with inf/nan gradients (the analog of the "
                        "reference's AMP GradScaler skip)")
    p.add_argument("--double-step", action="store_true",
                   help="replicate the reference's double optimizer.step quirk "
                        "(train_base.py:262-264)")
    p.add_argument("--device-augment", action="store_true",
                   help="crop, pad, flip, rot90 and normalize on the device inside the step: "
                        "uint8 tiles (each brought to --base-size) cross to it, the crop's "
                        "retry is bounded (ops/device_aug.py)")
    p.add_argument("--metrics", action="store_true",
                   help="write train/val scalars to <snapshot-dir>/metrics.jsonl")
    return p


def check_trainable(args):
    """Raise for what train_base does not train."""
    train_ds = DATASETS[args.dataset][0]
    if args.device_augment and "device_augment" not in inspect.signature(train_ds).parameters:
        # as the JAX CLI refuses it (segland_tpu/cli/train_base.py:77-84)
        raise ValueError(f"--device-augment is not supported by dataset {args.dataset!r} (it has "
                         f"no raw-tile path); drop the flag")
    if args.dataset != "oem":  # oem_ft's items are (novel, base) pairs
        raise ValueError(f"dataset {args.dataset!r} is the fine-tune's: train_base reads 'oem', "
                         f"cli.ft_pop fine-tunes (ROADMAP A5)")


def main(argv=None):
    args = get_parser().parse_args(argv)
    check_trainable(args)
    fused = resolve_fused(args, "train")
    device = dist.init_from_env(args.device, args.dist_backend)
    check_global_batch(args.batch_size)
    rank, world = dist.rank(), dist.world()
    if args.dtype == "float32":
        full_fp32()
    writer = None
    if args.metrics:
        writer, logger = prep_experiment(args.snapshot_dir, argv, rank=rank, need_writer=True)
    else:
        logger = prep_experiment(args.snapshot_dir, argv, rank=rank)

    seed = int(args.random_seed.split(",")[0])
    crop = parse_hw(args.input_size)
    n_base = args.base_classes
    TrainDS, ValDS = DATASETS[args.dataset]
    extra = {}
    if args.device_augment:
        extra = dict(device_augment=True, device_tile_size=parse_hw(args.base_size))
    trainset = TrainDS(args.data_dir, args.train_list, crop_size=crop, seed=seed, **extra)
    valset = ValDS(args.data_dir, args.val_list, use_novel=False, use_base=True,
                   stats=args.norm_stats)
    train_loader = Loader(trainset, args.batch_size, shuffle=True, drop_last=True, seed=seed,
                          process_index=rank, process_count=world, num_workers=args.num_workers)
    val_loader = Loader(valset, args.test_batch_size, shuffle=False, process_index=rank,
                        process_count=world)

    model = build_model(args.model, backbone=args.backbone, n_base=n_base,
                        os=args.output_stride, dtype=model_dtype(args), fused_mlp=fused,
                        fused_attn=fused, packed_train=args.packed_train, device=device,
                        generator=torch.Generator().manual_seed(seed))
    if args.restore_from:
        n, missing, unexpected = load_pth(model, args.restore_from, backbone_only=args.finetune)
        logger.info(f"restored torch ckpt: {n} tensors, {len(missing)} missing, "
                    f"{len(unexpected)} unexpected")

    steps_per_epoch = len(train_loader)
    tx = create_optimizer(model, args.learning_rate, args.num_epoch, steps_per_epoch,
                          weight_decay=args.weight_decay, power=args.power, optimizer="adamw",
                          freeze_backbone=args.freeze_backbone, fix_lr=args.fix_lr)
    state = TrainState(model, tx, epoch=args.start_epoch)
    if args.resume_from:
        load_checkpoint(args.resume_from, state)
        logger.info(f"resumed from {args.resume_from} at epoch {state.epoch}")
    loss_name = "orth" if "pop" in args.model else "ce"  # segland_tpu/cli/train_base.py:103
    augment_fn = None
    if args.device_augment:
        augment_fn = functools.partial(base_train_augment, crop_size=crop,
                                       ignore_label=args.ignore_label)
    train_step = make_base_train_step(model, loss_name, double_step=args.double_step,
                                      skip_nonfinite=args.skip_nonfinite, seed=seed,
                                      fix_bn=args.fix_bn, augment_fn=augment_fn)
    evaluator = Evaluator(model, device, num_classes=1 + n_base, n_base=n_base,
                          ignore_label=args.ignore_label)

    logger.info(f"device: {device} | processes: {world} | fused: {fused} | "
                f"steps/epoch: {steps_per_epoch}")
    best_miou, best_epoch = 0.0, 0
    global_it = state.epoch * steps_per_epoch
    for epoch in range(state.epoch, args.num_epoch):
        epoch_log = epoch + 1
        trainset.set_seed(seed + epoch)  # per-epoch reseed (train_base.py:236)
        train_loader.set_epoch(epoch)
        for i, (img, mask, _) in enumerate(train_loader):
            ld, gn = train_step(state, to_device(img, device), to_device(mask, device))
            global_it += 1
            if i % args.print_frequency == 0:
                lr = tx.lr_fn(global_it - 1)
                where = f"Epoch{epoch_log}/Iters{global_it} Iter{i + 1}/{steps_per_epoch}:"
                logger.info(format_loss_dict(ld, lr, gn, where))
                if writer is not None:
                    writer.add_scalars("train", {**{k: float(v) for k, v in ld.items()},
                                                 "lr": lr, "grad_norm": float(gn)}, global_it)
        state.epoch = epoch_log
        if epoch_log % args.snapshot_frequency == 0 or epoch_log >= args.num_epoch:
            save_checkpoint(os.path.join(args.snapshot_dir, f"epoch_{epoch_log}.pth"), state)
            logger.info("taking snapshot ...")
        if epoch_log > args.val_start and (epoch_log % args.val_frequency == 0
                                           or epoch_log >= args.num_epoch):
            miou = validate(model, evaluator, val_loader)
            if miou >= best_miou:
                best_miou, best_epoch = miou, epoch_log
                save_params(os.path.join(args.snapshot_dir, "best.pth"), model)
            logger.info(f"val mIoU {miou:.4f} (best {best_miou:.4f} @ epoch {best_epoch})")
            if writer is not None:
                writer.add_scalar("val/mIoU", miou, global_it)
    if writer is not None:
        writer.close()
    return best_miou


def validate(model, evaluator: Evaluator, val_loader) -> float:
    """The JAX ``validate``'s number: the mean over the 1 + n_base classes of
    summed intersection / max(summed union, 1) (segland_tpu/cli/train_base.py:
    219-230), from the Evaluator's confusion matrix."""
    model.eval()
    cm, _, _ = evaluator.run(val_loader)
    inter = np.diag(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    return float(np.mean(inter / np.maximum(union, 1)))


if __name__ == "__main__":
    main()
