"""Shared CLI flags: the names and defaults of segland_tpu/cli/common.py
(which follow the reference argparse blocks), so the same shell scripts
drive both packages.  The port adds ``--device``."""

import argparse

import torch


def str2bool(v: str) -> bool:
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def add_common_args(p: argparse.ArgumentParser):
    p.add_argument("--data-dir", type=str, required=True)
    p.add_argument("--train-list", type=str, default="dataset/list/oem/train.txt")
    p.add_argument("--val-list", type=str, default="dataset/list/oem/val.txt")
    p.add_argument("--dataset", type=str, default="oem", choices=["oem", "oem_ft"])
    p.add_argument("--model", type=str, default="pspnet_pop")
    p.add_argument("--backbone", type=str, default=None)
    p.add_argument("--restore-from", type=str, default=None)
    p.add_argument("--snapshot-dir", type=str, default="snapshots")
    p.add_argument("--input-size", type=str, default="512,512", help="crop H,W")
    p.add_argument("--base-size", type=str, default="1024,1024")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--num-classes", type=int, default=12)
    p.add_argument("--base-classes", type=int, default=7)
    p.add_argument("--novel-classes", type=int, default=4)
    p.add_argument("--ignore-label", type=int, default=255)
    p.add_argument("--os", type=int, default=8, dest="output_stride")
    p.add_argument("--random-seed", type=str, default="123")
    p.add_argument("--print-frequency", type=int, default=10)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--norm-stats", choices=["imagenet", "train"], default="imagenet",
                   help="val/ft normalization stats ('imagenet' keeps the "
                        "reference's train/val asymmetry)")
    p.add_argument("--fused", action=argparse.BooleanOptionalAction, default=None,
                   help="fused LN+MLP and attention-section kernels in transformer "
                        "backbones; with --int8, the fused int8 bottleneck kernel in "
                        "resnet backbones (default: per model in bfloat16, see "
                        "EVAL_FUSED_DEFAULTS). "
                        "bfloat16 uses tanh-GELU, so "
                        "bf16 fused-vs-unfused is not bit-identical by design")
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"],
                   help="backbone/decoder compute dtype (POP head always fp32)")
    p.add_argument("--packed-train", action=argparse.BooleanOptionalAction, default=None,
                   help="W-packing override of hrnet/lsknet/vggunet backbones "
                        "(errors on other backbones)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on, e.g. cuda, cuda:1, cpu")
    return p


# Eval defaults of --fused, from chip_smoke.py on the card (NVIDIA H100 80GB
# HBM3, 700.00 W; bf16, 2 batches of 8 1024^2 tiles after a warm-up run), which
# runs each model three ways: fused kernels, the kernels' plain versions, and
# unfused (stock torch blocks: cuBLAS products, torch's LayerNorm and softmax).
# With K1 and K3 on WMMA the fused models lost (184.12 against 265.68 tiles/s
# for convnext, 91.35 against 129.76 for swin).  With K1 and K3 on wgmma fed by
# TMA, fused bf16 beat unfused bf16 in three whole runs for both models (PERF.md
# section 5; the first: convnext 282.94 fused, 155.15 plain versions, 263.75
# unfused; swin 141.47, 75.80, 129.01), so both defaults are on for
# --dtype bfloat16 (--no-fused turns them off).  The convnext margins (+7%, +4%,
# +12%) are partly within the 10-20% spread between calls; each run compares the
# two routes in one process.  The defaults cover bf16 only: the fp32 bodies are exact FMA
# loops, 2.6-2.8x slower than the stock-torch section at the shapes measured,
# and no fp32 slice has been timed, so fp32 eval stays unfused unless --fused.
# The swin switches beyond plain --fused (SEGLAND_SWIN_WR=1, 143.76 in that run;
# SEGLAND_SWIN_V3_STAGES=all, 76.47; attn_group=2, 95.45) stay opt-in.
# For the ResNet models --fused acts with --int8 only: the 12 stride-1 bottlenecks without
# a downsample run through the fused int8 block kernel.  Off, see PERF.md section 5.
EVAL_FUSED_DEFAULTS = {"convnext_pop": True, "swin_pop": True, "deeplab_pop": False,
                       "pspnet_pop": False}


def resolve_fused(args) -> bool:
    """Explicit --fused/--no-fused wins; otherwise the eval default, which
    covers --dtype bfloat16 only."""
    if args.fused is not None:
        return bool(args.fused)
    return args.dtype == "bfloat16" and EVAL_FUSED_DEFAULTS.get(args.model, False)


def parse_hw(s: str):
    h, w = s.split(",")
    return int(h), int(w)


def model_dtype(args) -> torch.dtype:
    return torch.bfloat16 if args.dtype == "bfloat16" else torch.float32


def full_fp32():
    """fp32 means fp32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
