"""Shared CLI flags: the names and defaults of segland_tpu/cli/common.py
(which follow the reference argparse blocks), so the same shell scripts
drive both packages.  The port adds ``--device``."""

import argparse

import numpy as np
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
                   help="the JAX package's W-packing switch: the port has no packed layout, "
                        "so --packed-train raises; --no-packed-train builds the plain form of "
                        "hrnet, lsk-t and vgg16bn-unet (other backbones raise on either)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on, e.g. cuda, cuda:1, cpu")
    return p


def add_dist_args(p: argparse.ArgumentParser):
    """The process group's flag.  The group itself comes from the launcher's
    environment (torchrun: WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT; ``dist/process.py``); without WORLD_SIZE the run is one
    process, as before."""
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="the process group's backend under WORLD_SIZE (default: nccl on "
                        "CUDA, gloo on the CPU; two ranks on one card need gloo)")
    return p


def check_global_batch(batch: int, what: str = "--batch-size"):
    """The global batch must split evenly over the processes, as over the
    JAX package's data mesh."""
    from .. import dist

    if batch % dist.world():
        raise ValueError(f"the global {what} {batch} does not divide by the {dist.world()} "
                         f"processes")


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
# seghr_pop runs no kernel on its trunk (HRNet is stock cuDNN convs; its stage-1
# Bottlenecks are not the int8 fused route's, as in the JAX package), so --fused builds the
# same model; off in every mode.
EVAL_FUSED_DEFAULTS = {"convnext_pop": True, "swin_pop": True, "deeplab_pop": False,
                       "pspnet_pop": False, "seghr_pop": False}


# Train defaults of --fused: off.  With --fused, K1 runs every ConvNeXt and Swin
# block's LN+MLP forward and K3 every Swin block's attention section; the backward
# recomputes and differentiates (K1 through its plain version, 3x the stock-torch
# route's forward, PERF.md section 6, B1; the section through the stock-torch route),
# as the JAX package's custom VJPs do.  chip_smoke.py's train phase (NVIDIA H100 80GB
# HBM3, 700.00 W; bf16, batch 4, 768^2 crops, AdamW, median of 12 steps, the routes in
# turns): convnext_pop fused 53.95 ms a step against 32.57 unfused in a run of the phase
# alone, 62.24, 62.77, 66.20 and 69.08 against 34.06, 35.27, 38.32 and 42.36 in four
# whole runs; swin_pop 189.70 and 219.82 against 147.01 and 158.56 in two, with 2.38-2.39
# against 6.45 GiB of peak memory (PERF.md section 5).  Fused takes 0.37-0.48 of the
# memory and 1.3-1.8x the time.
TRAIN_FUSED_DEFAULTS = {"convnext_pop": False, "swin_pop": False, "seghr_pop": False}


# Fine-tune defaults of --fused.  The fine-tune runs the backbone and decoder frozen,
# under torch.no_grad(), so K1 and K3 run forward-only there and a step is about a
# forward of the novel and base tiles plus the POP head's backward.  chip_smoke.py's ft
# phase (NVIDIA H100 80GB HBM3, 700.00 W; bf16, 1 + 1 tiles of 1024^2, SGD, median of 12
# steps after 3 warm-up, the routes in turns, PERF.md section 5), the phase alone and a
# whole run: swin_pop 21.39 and 20.57 ms a step fused against 26.87 and 32.61 unfused,
# convnext_pop 12.58 and 12.22 against 12.97 and 12.64 (ahead in both, by less than the
# spread of host-timed steps, as its eval default is), the same peak memory fused and
# unfused.  So both are on for --dtype bfloat16.
FT_FUSED_DEFAULTS = {"swin_pop": True, "convnext_pop": True, "seghr_pop": False}


def resolve_fused(args, mode: str = "eval") -> bool:
    """Explicit --fused/--no-fused wins; otherwise the default of ``mode``
    ('eval', 'train' or 'ft'), which covers --dtype bfloat16 only."""
    if args.fused is not None:
        return bool(args.fused)
    defaults = {"eval": EVAL_FUSED_DEFAULTS, "train": TRAIN_FUSED_DEFAULTS,
                "ft": FT_FUSED_DEFAULTS}[mode]
    return args.dtype == "bfloat16" and defaults.get(args.model, False)


def add_train_args(p: argparse.ArgumentParser):
    """The training flags of segland_tpu/cli/common.py:add_train_args that
    base training reads.  Not taken: --fp16 (use --dtype bfloat16) and
    --save-pred-every (--snapshot-frequency); --momentum (its SGD) and
    --filter-novel (its dataset) are the fine-tune's, ``cli/ft_pop.py``."""
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--power", type=float, default=0.9)
    p.add_argument("--num-epoch", type=int, default=200)
    p.add_argument("--start-epoch", type=int, default=0)
    p.add_argument("--val-start", type=int, default=35,
                   help="epoch after which validation runs (reference train_base.py:294)")
    p.add_argument("--val-frequency", type=int, default=10)
    p.add_argument("--snapshot-frequency", type=int, default=10)
    p.add_argument("--freeze-backbone", type=str2bool, nargs="?", const=True, default=False)
    p.add_argument("--fix-lr", type=str2bool, nargs="?", const=True, default=False)
    p.add_argument("--finetune", type=str2bool, nargs="?", const=True, default=False,
                   help="restore backbone-only weights (reference train_base.py:198-201)")
    p.add_argument("--test-batch-size", type=int, default=1, help="validation batch size")
    p.add_argument("--fix-bn", action="store_true", default=False,
                   help="freeze BatchNorm running statistics during training (normalization "
                        "still uses the current batch)")
    return p


def parse_hw(s: str):
    h, w = s.split(",")
    return int(h), int(w)


def model_dtype(args) -> torch.dtype:
    return torch.bfloat16 if args.dtype == "bfloat16" else torch.float32


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch on ``device``: pinned and copied without a wait on CUDA."""
    t = torch.from_numpy(a)
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t


def full_fp32():
    """fp32 means fp32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
