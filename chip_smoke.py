#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py          # from the repo root, on a machine with an H100

Phases, each printing its result on its own line; any failure exits non-zero:
  1. device: name, count, and nvidia-smi's name and power limit;
  2. build: nvcc builds the kernels from segland_tpu_torch/kernels/csrc;
  3. K1 ln_mlp vs its plain version on the card, bf16 at the ConvNeXt-T stage
     shapes of a batch of 8 1024^2 tiles plus two ragged M, and fp32 at one
     shape (TF32 off); per bf16 build its registers and local bytes (a spill
     fails) and its functions' HGMMA and UTMALDG counts in the built SASS (a 0
     fails); per shape TFLOP/s, the stock-torch route's time on the same inputs
     (torch_route_ms) and the clock build's phase split;
  4. K2 upsample_argmax vs its plain version at (8,256,256,8) -> (8,1024,1024),
     the same with K = 12 and 255, the CPU tests' ragged shapes, two
     downsampling shapes and vggunet_pop's factor-1 shapes (K = 8 and 12 at
     (8,1024,1024), 5 at (1,1024,1024)) (no pixel may differ where the top-2 gap exceeds
     1e-3; the count that differs at all is printed); per shape its plan
     (tile, class passes, patch, shared memory; the library's must agree),
     its time flushed (a 96 MB write before each launch) and back to back,
     and its bound;
  5. K3 attn_section vs its plain version, bf16 at the four swin-s stage
     shapes of a batch of 8 1024^2 tiles, each with shift 0 and 3, two window
     counts that leave a block part-empty, and fp32 at one shape; the same
     build, SASS, TFLOP/s, torch_route_ms and phase-split lines as K1;
  6. K6 window_attention vs its plain version at the four swin-s stage
     shapes, with a shared bias and with a per-window bias + shift mask, each
     in bf16 and fp32, two ragged window counts, and the fp32 body at one
     shape; per build its registers, local bytes (a spill fails) and shared
     memory; per stage the ring plan (the library's must agree), the time
     beside the bound, the share of it and F.scaled_dot_product_attention's
     time on the same inputs (timed only); the sum over a forward beside its
     bound;
  6a. K4 swin_block vs its plain version at the same shapes and shifts as K3,
     and fp32 at one shape, half by half (the section's output, then the MLP
     over it), beside the two-launch route (K3 then K1) on the same input,
     which it must equal bit for bit; the same build, SASS, TFLOP/s and
     phase-split lines as K3;
  6b. K5 attn_section_v1 vs its plain version for group in 1, 2, 4, 8 at the
     same shapes and shifts, with broadcast and per-window mask rows, with and
     without regions, a window count that no group divides, fp32 at one
     shape, and group = 1 against K3 on the same input; per build and group
     the registers, local bytes and shared memory, the SASS lines of both
     paths (windows, scratch), and per shape and group the path, TFLOP/s and
     phase split;
  7. the convnext slice: convnext_pop / convnext-t in bf16 with the fused
     kernels, random weights from a seeded torch.Generator, through
     Evaluator.run on 2 batches of 8 synthetic 1024^2 tiles; the launch
     counts of that run, its mIoU and tiles/s; the same batches with the
     kernels' plain versions (>= 99% argmax agreement); an fp32 forward on
     the card against the same model on the CPU;
  7a. train: base training of convnext_pop / convnext-t and of swin_pop /
     swin-s (full width and depth, DropPath and the decoder's dropout live)
     through the port's entry point (cli.train_base.main: bf16 --fused, batch
     4, 768^2 crops, AdamW at 1e-3) on 1024^2 GeoTIFF tiles the script writes,
     2 epochs of 4 steps with 2 validation batches in each: the loss dicts
     finite, the seg loss falling, epoch_N.pth and best.pth written, best.pth
     through eval_base, K1 18 (convnext) or K3 24 and K1 24 (swin) a train
     step and a validation batch and K2 1 a validation batch (any other count
     fails); for each model one train step with the kernels against one with
     their plain versions from the same weights, batch and step generator,
     every gradient held to what another correct route does (fp32: twice the
     stock-torch blocks' relative error; bf16: twice the plain route's
     distance from the fp32 gradient), the worst tensor printed, but the
     gradients that are zero in exact arithmetic (shift_invariant: the loss
     does not move when they are shifted), held finite and zero where the
     plain route's is; the swin
     section's and whole block's autograd Functions at 768^2 stage shapes
     (stage 0 and 2, shift 0 and 3, K5's dispatch at group 2): kernel
     forward against the plain version, gradients against autograd through
     the plain version; each model's step ms, 768^2 crops/s fused and
     --no-fused in turns, and max_memory_allocated of each alone;
  7b. ft: few-shot fine-tuning through the port's entry points on 1024^2
     GeoTIFF tiles the script writes (raw classes 0-11 in blocks), support
     lists from cli.gen_fs_list: cli.ft_pop at scripts/ft_oem.sh's config
     (bf16 --fused, 1024^2 crops, batch 1, SGD at 1e-4, --fix-lr
     --freeze-backbone --update-base, 5 shots) for swin_pop / swin-s, and with
     1 shot for convnext_pop, each from a base .pth, cut to 1 epoch and 2
     validation tiles: K3 24 and K1 24 (swin) or K1 18 (convnext) a step and
     a validation batch, K2 1 each (the step's pseudo-labels, the
     validation's argmax), any other count fails; the loss dicts finite and
     none skipped; best_123.pth's frozen tensors bit-equal to the base .pth,
     its novel head moved; eval_ft on it (K = 12).  Then one ft step with the
     kernels against one with their plain versions from the same weights and
     episode (fp32, bf16: the trainable gradients held as the train phase
     holds its own; the pseudo-labels equal on >= 99% of relabelled pixels),
     and the ft step's ms fused and --no-fused for both models, in turns,
     with max_memory_allocated of each alone;
  8. the swin slice: swin_pop / swin-s at full width and depth the same way,
     once as eval_base runs it (K = 8) and once as eval_ft does (4 novel
     classes, K = 12, square_pad_eval), plus the unfused model's tiles/s and
     one batch through the use_pallas route (K6 in every block); then the
     three other fused routes the same way: SEGLAND_SWIN_V3_STAGES=all (K4 in
     every block; also as eval_ft), attn_group = 2 (K5 and K1 in every block)
     and SEGLAND_SWIN_WR=1 (window-resident stages, K3 and K1, K1 over every
     token of the padded windows: the rows it was given are checked).
  8a. swinbl: swin_pop on swin-b and swin-l (phase_swinbl): K1 and K3 at
     their eight stage shapes against the plain versions (the widths they add,
     C = 128, 256, 512, 1024, 1536, also in fp32, with a ragged M and a
     part-empty last block; those builds' registers and spills), each
     forward's kernel ms beside its bound; K4 and K5 the same way
     (swinbl_blocks: K4 against block_reference and bit for bit against K3
     then K1, K5 at every group against its plain version and at group 1
     against K3, the new builds' registers and spills, fp32 at the new widths,
     K4's k3_then_k1_ms); then each model at full width and depth through the
     eval slice as eval_base and as eval_ft run it (K3 24, K1 24, K2 1 a
     batch; the weights drawn so that no class takes 90% of the map; >= 99%
     agreement with the plain versions beyond near-ties, and the kernel route
     as close to the fp32 stock-torch route as the plain versions; tiles/s and
     max_memory_allocated), its --no-fused tiles/s and, for swin-l, one batch
     through the use_pallas route; and one batch of each model through
     SEGLAND_SWIN_V3_STAGES=all (K4 24, K2 1) and attn_group = 2 (K5 24, K1
     24, K2 1), held the same way;
  9. K8 conv3_residual vs its plain version at the conv3 probe's two shapes
     (layer4 and layer3 of resnet50), M = 8*128^2 and 16*128^2 and a ragged M,
     with and without the ReLU, to 1 bf16 ulp (the count of elements that are
     not bit-equal is printed); its builds' registers and local bytes (a spill
     fails), IGMMA and UTMALDG counts in the built SASS (a 0 fails) and plan
     (the library's and conv3_plan's must agree); per shape its time beside
     torch._int_mm and the epilogue in torch, each timed alone, and the clock
     build's phase split; then the probe's own entry point
     (benchmarks/conv3_probe.py), K8's path;
 10. K7 bottleneck_int8 (two kernels: conv1, then conv23) vs its plain version
     at the four layer shapes of resnet50 at output stride 8 for a batch of 8
     1024^2 tiles, both last_relu, and at images no tile divides with d in 1,
     2, 4, the same bar; conv1's h1q against conv1_reference (equal); per
     kernel its registers and local bytes (a spill fails), its IGMMA (int8
     wgmma) and UTMALDG counts in the built SASS (a 0 fails), and per layer shape its
     time, TOP/s and the measurement builds' phase split (consumers'
     clock64() by phase); the plan each shape gets (the library's and
     bottleneck_plan's must agree); beside each shape the same block as a
     Bottleneck module: bf16 unquantized, int8 conv by conv, and int8 through
     K7, the comparison that decides the --fused default;
 11. the int8 slices: deeplab_pop / resnet50 (2 batches) and pspnet_pop /
     resnet50 (1 batch) at full width and depth through Evaluator.run four
     ways: bf16 unquantized, --int8, --int8 --fused (K7 12 and K2 1 a batch,
     any other count fails) and --int8 --fused with the plain versions
     (>= 99% argmax agreement with the K7 route; int8 vs bf16 is printed);
 11a. seghr: seghr_pop / hr-w32 (HRNet, HRFPN; no kernel on its trunk) at
     full width and depth: the eval slice as eval_base and as eval_ft run it
     (K2 1 a batch and nothing else, tiles/s, >= 99% agreement with K2's
     plain version, fp32 card vs CPU); base training through cli.train_base
     at scripts/train_oem.sh's config on the train phase's tiles (2 epochs of
     4 steps, 2 validation batches each: K2 1 a validation batch, none in a
     step; the seg loss falling; best.pth through eval_base), one fp32 step on
     the card against the CPU (losses within 1e-5; the worst gradient
     printed), the step's ms, crops/s and memory; the fine-tune through
     cli.ft_pop from that best.pth (1 shot, 1 epoch: K2 1 a step and a
     validation batch; frozen tensors bit-equal; eval_ft), its step's ms and
     memory; --int8 and --int8 --fused (no K7 launch, the fused request's
     warning, agreement with bf16 printed);
 11c. heads: pspplus_pop / resnet50v2, the plain pspnet / resnet50, lsk_pop / lsk-t
     and vggunet_pop at full width and depth (phase_heads), each through the
     eval slice as eval_base and as eval_ft run it (one batch: K2 1 and
     nothing else; vggunet's logits at full resolution, K2 at factor 1),
     base training through cli.train_base at scripts/train_oem.sh's config cut
     to 1 epoch (K2 1 a validation batch; the plain pspnet's CE step with its
     aux head), one fp32 step card vs CPU, the step's ms and memory, the
     fine-tune of the three POP models from that best.pth (K2 1 a step and a
     validation tile), and int8 (the ResNet pair --int8 --fused: K7 12 and K2
     1 a batch, >= 99% agreement with the plain versions); each model's
     predicted launch counts printed before it runs;
 11b. ensemble: the reference's stage 4 (phase_ensemble): EnsembleEvaluator over
     convnext_pop, swin_pop / swin-s and seghr_pop / hr-w32 at full width and
     depth, bf16, 2 batches of 8 synthetic 1024^2 tiles (K1 42, K3 24, K2 1 a
     batch, any other count fails; tiles/s of the kernels and of their plain
     versions, >= 99% argmax agreement; the map equal to fusemat's order, each
     member upsampled then summed, except at near-ties); cli.predict's device
     path on a 4096^2 GeoTIFF scene with convnext_pop (25 tiles in 4 batches:
     K1 72), equal to the host path except at near-ties, seconds a scene of
     both paths; two members' .mat exports fused by fuse_prob_maps on the
     card, equal to numpy's argmax of the float32 mean;
 11d. dist: training and eval over a process group (phase_dist): one NCCL rank
     (WORLD_SIZE=1) and two ranks on cuda:0 over gloo, each a process of its
     own: cli.train_base on convnext_pop (bf16 --fused, global batch 4 of 768^2
     crops; the two ranks' weights bit-equal after every step; K1 18 a forward,
     K2 1 a validation batch, per rank), one fp32 step of convnext_pop and
     swin_pop over the ranks held to one process's by the step rule, cli.ft_pop
     on swin_pop (global batch 2: K3 24, K1 24 and K2 1 a step), cli.eval_base
     against one process at the ranks' batch (confusion matrices equal but for
     near-ties, >= 99.99% agreement) and --device-augment (a forced draw
     bitwise equal to the host pipeline, aug_fallback printed); ms/step and
     memory per rank printed; cli.eval_base --int8 on deeplab_pop / resnet50
     over both groups (fp32 abs-max and --calib-percentile, bf16; the gloo
     pair also --int8 --fused: K7 12 a forward and K2 1 a batch per rank)
     against one process at the global batch: the ranks' scales equal, the
     fp32 ones within 1e-5 of one process's (bf16: the worst ratio printed),
     the maps at >= 99.9% agreement and equal beyond near-ties;
 11e. exports: convnext_pop / convnext-t bf16 --fused through Evaluator.run
     over 32 unlabeled 1024^2 GeoTIFF tiles in batches of 8, writing GTiffs
     (K1 18, K2 1 a batch) and then GTiffs and .mat logits (K1 18 a batch),
     each at export_workers 4 and 1: the files byte-equal between the two,
     tiles/s of each run beside predict_batch alone on the same batches;
 12. K10 hg2_section (head groups, masks from the window index; K9's body)
     vs its plain version at the four swin-s stage shapes, shift 0 and 3,
     every built hg, wblk = W and 32; its builds' registers and spills (each
     mode) and SASS HGMMA/UTMALDG counts; beside it on the same input K3 and
     K9 at the same hg, and the clock builds' phase split at hg = 1 and the
     default hg; each ablation (ioraw, io, attn, softmax) at those two hg,
     eager and by CUDA graph, and the phase split they give; then the
     head-group probe's entry point (benchmarks/swin_attn_hg.py), the path
     of K9 and K10;
 13. K9 hg_section (head groups, masks shipped in; the wgmma + TMA section
     body with K6's mma.sync core) vs its plain version at the four swin-s
     stage shapes with per-window mask rows (shift 0 without, shift 3 with
     regions), every built hg, fp32 and (hg = 1) bf16 scores, wblk = W and a
     ragged 7, and with broadcast mask rows; its builds' registers and spills
     and SASS HGMMA/UTMALDG counts; per shape and hg its time at wblk = W and
     32 beside K5 at group 1 and K3 on the same input, its share of the bound
     and the clock build's phase split;
 14. K11 section (the variants probe's section, the same body, a kernel a
     mode) vs its plain version in all 8 modes, both score dtypes, shift 0
     and 3, wblk 32 and 7 at C = 96, 192, 384 (one image's windows); its
     builds and SASS; its full mode at a batch of 8 beside its plain version,
     K5 at group 1, K9 at hg = 1 and K3, every mode timed queued and by CUDA
     graph, the phase split; then the
     variants probe's entry point (benchmarks/swin_attn_variants.py) at its
     three stages through chain_time, its launch count checked;
 15. f32: K9, K10 and K11 on fp32 windows (the fp32 body) vs their plain
     versions at C = 96..768 in every mode, and both probes' check on the card;
 16. gates: the trained-model accuracy gates (benchmarks/accuracy_gates.py)
     on the card: convnext_pop / convnext-t, pspnet_pop / resnet10, swin_pop /
     swin-s, deeplab_pop / resnet50 and seghr_pop / hr-w32 trained at full
     width through cli.train_base on the synthetic colour task (bf16, batch
     4, 32^2 crops or, deeplab_pop and seghr_pop, whole 64^2 tiles;
     deterministic algorithms, so every run trains the same weights, whose
     fingerprints it prints), each best.pth scored on the base validation
     tiles by the stock-torch route and by each kernel route that serves the
     model (G1 K1, G3 K3 and K1, G3b K4, G3c K5, G3d K6, G4 and G4p K7; K2 in every
     kernel arm; G2 and G5 the int8 path), bf16 and, where the kernel has an
     fp32 build, fp32: a failed hard gate (|d mIoU| > 0.002 or agreement <
     0.99), a model below 0.30 best val mIoU or 4 predicted classes, or a
     kernel arm's launches other than counted fail; G5 (int8 of deeplab_pop
     and seghr_pop against bf16) is printed.
Every launch count is set to 0 just before a path is driven and read just
after.  The second-to-last line is a JSON object of per-kernel numbers (time,
plain version's time, bound, library call's time) and the last line is
{"ok": true, "device": {...}}.  Without a CUDA device, or without the rest of
the repo beside it, it fails before printing any result.

    python3 chip_smoke.py --phases train    # base training of convnext_pop and swin_pop on the card
    python3 chip_smoke.py --phases ft       # few-shot fine-tuning of swin_pop and convnext_pop
    python3 chip_smoke.py --phases seghr    # seghr_pop / hr-w32: eval, base training, ft, int8
    python3 chip_smoke.py --phases heads    # pspplus_pop, pspnet, lsk_pop, vggunet_pop
    python3 chip_smoke.py --phases ensemble # ensemble serving, scene prediction, .mat fusion
    python3 chip_smoke.py --phases dist     # training and eval over the ranks of a process group
    python3 chip_smoke.py --phases exports  # the eval loop's GTiff and .mat writes on a thread pool
    python3 chip_smoke.py --phases k2,k6    # K2 and K6 at every shape of their phases
    python3 chip_smoke.py --phases k1,k3    # K1 and K3 with their build, SASS and phase lines
    python3 chip_smoke.py --phases swinbl   # swin_pop on swin-b and swin-l, K1, K3, K4 and K5 at their widths
    python3 chip_smoke.py --phases k4,k5    # K4 and K5 with their build, SASS and phase lines
    python3 chip_smoke.py --phases k8,k7    # K8, and K7 with its build, SASS and per-kernel lines
    python3 chip_smoke.py --phases k8,k10,k9  # K8, the head-group kernels and their probe
    python3 chip_smoke.py --phases k11,f32  # the variants probe's kernel, the fp32 body
    python3 chip_smoke.py --phases profile  # torch.profiler over the swin and deeplab_pop slices
    python3 chip_smoke.py --phases dilated  # cuDNN's 3x3 at ASPP's dilations vs nine 1x1 taps
    python3 chip_smoke.py --phases steprule # the fp32 train-step check's rule on correct routes
    python3 chip_smoke.py --phases gates    # the trained-model accuracy gates
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

BATCH, TILE, N_BATCHES = 8, 1024, 2
STAGES = ((3, 96, 256), (3, 192, 128), (9, 384, 64), (3, 768, 32))  # (blocks, C, side)
# swin-s stages of a batch of 8 1024^2 tiles: (blocks, C, heads, side, padded side)
SWIN_STAGES = ((2, 96, 3, 256, 259), (2, 192, 6, 128, 133), (18, 384, 12, 64, 70),
               (2, 768, 24, 32, 35))
# data-sheet peaks of an H100 SXM at its 700 W limit
PEAK_BF16, PEAK_FP32, PEAK_INT8, PEAK_BYTES = 989e12, 67e12, 1979e12, 3.35e12


def bound(flops, nbytes, peak=PEAK_BF16):
    """(least ms the card could take, what bounds it)."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def sum_bounds(items):
    """Bound of a sequence of calls: the sum of theirs, named by the larger share."""
    ms = sum(b for b, _ in items)
    ops = sum(b for b, by in items if by == "operations")
    return ms, "operations" if ops >= ms - ops else "bytes"


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def fail(msg):
    raise RuntimeError(msg)


def cuda_ms(fn, iters=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


SLEEP_CYCLES = 200_000  # a device sleep a queued launch: ~0.1 ms, more than the host takes


def queued_ms(fn, iters=20, flush=None):
    """ms a call of fn with every launch queued behind a device sleep, so the
    host's time to launch stays out of the reading (a call of K2 or K6 can be
    shorter than its Python wrapper).  With ``flush`` (a write of more than the
    50 MB L2 cache), each call is timed on its own after one, so it reads its
    inputs from device memory."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters if flush else 1)]
    torch.cuda._sleep(SLEEP_CYCLES * iters)
    if flush is None:
        pairs[0][0].record()
        for _ in range(iters):
            fn()
        pairs[0][1].record()
        torch.cuda.synchronize()
        return pairs[0][0].elapsed_time(pairs[0][1]) / iters
    for start, end in pairs:
        flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def mlp_inputs(m, c, dtype, dev, seed, with_res=True, with_ls=True):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    h = 4 * c
    rn = lambda *s: torch.randn(*s, device=dev, generator=g)
    return dict(
        x=rn(m, c).to(dtype), gamma=1.0 + 0.1 * rn(c), beta=0.1 * rn(c),
        w1=(rn(c, h) / c ** 0.5).to(dtype), b1=0.1 * rn(h),
        w2=(rn(h, c) / h ** 0.5).to(dtype), b2=0.1 * rn(c),
        res2=rn(m, c).to(dtype) if with_res else None,
        ls=(0.5 + 0.5 * torch.rand(c, device=dev, generator=g)) if with_ls else None)


def torch_mlp(x, gamma, beta, w1, b1, w2, b2, res=None, ls=None, eps=1e-6):
    """The stock-torch route of the same section, as the unfused ConvNeXt
    block runs it in x's dtype: F.layer_norm, two F.linear (cuBLAS) with the
    GELU between, the layer-scale and the residual.  Vectors already in x's
    dtype, weights [in, out] (F.linear reads their transposed view as is)."""
    import torch.nn.functional as F

    y = F.layer_norm(x, (x.shape[-1],), gamma, beta, eps)
    o = F.linear(F.gelu(F.linear(y, w1.t(), b1)), w2.t(), b2)
    if ls is not None:
        o = o * ls
    return (x if res is None else res) + o


def linear_layout(w, dtype):
    """In bf16, w [in, out] as an nn.Linear holds it: [out, in] storage seen
    through .T, the K-major layout that the wgmma bodies of K1, K3, K4 and K5 read
    without a copy (ops/fused_mlp.py:kmajor), as the models hand it over.  The
    fp32 bodies read w input-major, as it comes."""
    import torch

    return w.t().contiguous().t() if dtype == torch.bfloat16 else w


def linear_weights(args, dtype):
    """args with each 2-D tensor (a weight) in linear_layout."""
    import torch

    return tuple(linear_layout(v, dtype) if torch.is_tensor(v) and v.dim() == 2 else v
                 for v in args)


K1_PHASES = ("ln", "wait", "wgmma", "h", "out")
K3_PHASES = ("setup", "wait", "wgmma", "qkv", "attn", "ctx", "out")
K4_PHASES = K3_PHASES + ("ln2", "h", "mlp_out")
K5_PHASES = K3_PHASES  # attn: the super-window's key walk (and, scratch path, its q/k/v loads)


def phase_split(run, names, dev):
    """run(clocks) launches the kernel's clock build once; the share of its
    consumer warpgroups' clock64() time that each phase took."""
    import torch

    clocks = torch.zeros(len(names) + 1, dtype=torch.int64, device=dev)
    run(clocks)
    torch.cuda.synchronize()
    c = clocks.tolist()
    total = sum(c[:-1])
    return "phase_clocks " + " ".join(f"{n}={100 * v / total:.1f}%" for n, v in zip(names, c))


def check_k1(dev, m, c, dtype, atol, rtol, seed, with_res=True, with_ls=True):
    import torch
    from segland_tpu_torch.ops.fused_mlp import ln_mlp, ln_mlp_clocks, ln_mlp_reference

    a = mlp_inputs(m, c, dtype, dev, seed, with_res, with_ls)
    w1, w2 = linear_layout(a["w1"], dtype), linear_layout(a["w2"], dtype)
    args = (a["x"], a["gamma"], a["beta"], w1, a["b1"], w2, a["b2"])
    kw = dict(res=a["res2"], ls=a["ls"], eps=1e-6)
    got = ln_mlp(*args, res2=a["res2"], ls=a["ls"], eps=1e-6).float()
    want = ln_mlp_reference(*args, **kw).float()
    err = (got - want).abs()
    bad = int((err > atol + rtol * want.abs()).sum())
    if not bool(got.isfinite().all()):
        fail(f"K1 {dtype} M={m} C={c}: non-finite output")
    ms = cuda_ms(lambda: ln_mlp(*args, res2=a["res2"], ls=a["ls"], eps=1e-6))
    plain_ms = cuda_ms(lambda: ln_mlp_reference(*args, **kw))
    cast = lambda v: None if v is None else v.to(dtype)
    targs = (a["x"], *(cast(a[k]) for k in ("gamma", "beta")), a["w1"], cast(a["b1"]), a["w2"],
             cast(a["b2"]), a["res2"], cast(a["ls"]))
    torch_ms = cuda_ms(lambda: torch_mlp(*targs))
    tflops = 16 * m * c * c / ms / 1e9
    split = "" if dtype != torch.bfloat16 else " " + phase_split(
        lambda clk: ln_mlp_clocks(clk, *args, res2=a["res2"], ls=a["ls"], eps=1e-6), K1_PHASES,
        dev)
    print(f"K1 {str(dtype)[6:]} M={m} C={c} res={with_res} ls={with_ls}: "
          f"max_abs_err={float(err.max()):.6g} tol=|d|<={atol}+{rtol}*|ref| "
          f"out_of_tol={bad} kernel_ms={ms:.4f} tflops={tflops:.1f} plain_ms={plain_ms:.4f} "
          f"torch_route_ms={torch_ms:.4f}{split}", flush=True)
    if bad:
        fail(f"K1 {dtype} M={m} C={c}: {bad} elements out of tolerance")
    return float(err.max()), ms, plain_ms, torch_ms


def build_attrs(entry, keys, what, names=("C",), kind="bf16"):
    """Registers at launch, local (spill) bytes and shared memory of each
    build (bf16, or K7's int8), by cudaFuncGetAttributes through the kernel's
    C entry (a key: the width, or a tuple of the entry's leading arguments,
    named by ``names``); fails on any local memory."""
    import ctypes
    from segland_tpu_torch import kernels

    fn = getattr(kernels.library(), entry)
    for key in keys:
        key = key if isinstance(key, tuple) else (key,)
        label = " ".join(f"{n}={v}" for n, v in zip(names, key))
        regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        kernels.check(fn(*key, ctypes.byref(regs), ctypes.byref(local), ctypes.byref(smem)), entry)
        print(f"{what} {kind} build {label}: registers={regs.value} local_bytes={local.value} "
              f"smem={smem.value}", flush=True)
        if local.value:
            fail(f"{what} {kind} build {label} spills: {local.value} bytes of local memory")


_SASS = {}


_SASS_OPS = ("HGMMA", "IGMMA", "UTMALDG", "UTMASTG")


def sass_counts(kernel_name, mma="HGMMA"):
    """{mangled function: {op: count}} of every function of the built library
    whose name holds ``kernel_name``, by cuobjdump -sass, for the ops of
    _SASS_OPS (a bf16 wgmma is HGMMA in SASS, an int8 one IGMMA); fails if
    ``mma`` or UTMALDG is missing from one."""
    from torch.utils.cpp_extension import CUDA_HOME
    from segland_tpu_torch import kernels

    if not _SASS:
        out = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass",
                              str(kernels.library_path())], capture_output=True, text=True,
                             check=True).stdout
        fn = None
        for line in out.splitlines():
            if "Function :" in line:
                fn = line.split("Function :", 1)[1].strip()
                _SASS[fn] = dict.fromkeys(_SASS_OPS, 0)
            elif fn is not None:
                for op in _SASS_OPS:
                    _SASS[fn][op] += op in line
    found = {f: n for f, n in _SASS.items() if kernel_name in f}
    if not found:
        fail(f"no function {kernel_name} in the library's SASS")
    for f, n in sorted(found.items()):
        print(f"SASS {f}: " + " ".join(f"{op}={n[op]}" for op in _SASS_OPS
                                       if n[op] or op in (mma, "UTMALDG")), flush=True)
        if not n[mma] or not n["UTMALDG"]:
            fail(f"{f} has {n[mma]} {mma} and {n['UTMALDG']} UTMALDG instructions")
    return found


def phase_k1(dev):
    import torch
    from segland_tpu_torch.ops.fused_mlp import MLP_BUILDS, ln_mlp_plan

    build_attrs("segland_ln_mlp_attrs", MLP_BUILDS, "K1")
    sass_counts("ln_mlp_wgmma_kernel")
    worst, ms, plain_ms, torch_ms, bounds, by_c = 0.0, 0.0, 0.0, 0.0, [], {}
    for i, (blocks, c, side) in enumerate(STAGES):
        m = BATCH * side * side
        plan = ln_mlp_plan(c, 4 * c)
        print(f"K1 plan C={c}: rows {plan['rows']} a tile, warpgroups {plan['rg']} x "
              f"{plan['cg']}, passes {plan['np']}, hidden chunk {plan['hc']}, ring "
              f"{plan['s']} x 8 KB, smem {plan['smem']:,} B, accumulator and fragment "
              f"registers {plan['acc_regs']}", flush=True)
        e, t, tp, tt = check_k1(dev, m, c, torch.bfloat16, 2e-2, 1e-2, i)
        worst = max(worst, e)
        ms += blocks * t
        plain_ms += blocks * tp
        torch_ms += blocks * tt
        by_c[c] = t
        # x, res read and out written once; w1, w2 once; 16*M*C^2 flops
        bounds += [bound(16 * m * c * c, 3 * m * c * 2 + 8 * c * c * 2)] * blocks
    for m, c in ((BATCH * 64 * 64 - 19, 384), (BATCH * 32 * 32 - 19, 768)):  # ragged M
        e, _, _, _ = check_k1(dev, m, c, torch.bfloat16, 2e-2, 1e-2, 7,
                              with_res=False, with_ls=False)
        worst = max(worst, e)
    check_k1(dev, BATCH * 128 * 128, 192, torch.float32, 1e-4, 1e-4, 8)
    b_ms, b_by = sum_bounds(bounds)
    # a swin-s forward: the same M * C^2 a call, 2 / 2 / 18 / 2 calls a stage
    swin_ms = sum(blocks * by_c[c] for blocks, c, _, _, _ in SWIN_STAGES)
    print(f"K1 per forward of {BATCH} tiles (18 blocks): kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} torch_route_ms={torch_ms:.4f} bound_ms={b_ms:.4f} "
          f"({b_by}); swin-s forward (24 blocks, by the stage times above) "
          f"kernel_ms={swin_ms:.4f}", flush=True)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, torch_route_ms=torch_ms)


# K2 at the serving shape (eval_base's K = 8, eval_ft's 12, the uint8 limit 255), the
# CPU tests' shapes (ragged, one with each pixel's own two columns) and downsampling
K2_SHAPES = (((BATCH, TILE // 4, TILE // 4, 8), (TILE, TILE)),
             ((BATCH, TILE // 4, TILE // 4, 12), (TILE, TILE)),
             ((BATCH, TILE // 4, TILE // 4, 255), (TILE, TILE)),
             ((2, 64, 128, 5), (256, 512)), ((1, 32, 128, 12), (256, 1024)),
             ((1, 256, 128, 3), (256, 256)), ((2, 7, 9, 4), (30, 17)),
             ((1, 12, 10, 255), (40, 37)), ((1, 40, 52, 6), (9, 13)),
             ((2, 1024, 1024, 8), (256, 256)),
             # vggunet_pop's full-resolution logits (factor 1): eval, eval_ft, the ft
             # step's pseudo-labels
             ((BATCH, TILE, TILE, 8), (TILE, TILE)), ((BATCH, TILE, TILE, 12), (TILE, TILE)),
             ((1, TILE, TILE, 5), (TILE, TILE)))
FLUSH_BYTES = 96 << 20  # written between flushed launches: more than the 50 MB L2


def k2_plan_line(lib, b, h, w, k, oh, ow):
    """K2's plan from ops/fused_epilogue.py:upsample_plan beside the library's
    layout for it; fails where the two differ."""
    import ctypes
    from segland_tpu_torch import kernels
    from segland_tpu_torch.ops.fused_epilogue import PIXELS, upsample_plan

    plan = upsample_plan(h, w, k, oh, ow)
    got = (ctypes.c_int * 5)()
    kernels.check(lib.segland_upsample_argmax_plan(k, plan["txt"], plan["ty"], plan["groups"],
                                                   plan["kc"], plan["prows"], plan["pcols"], b,
                                                   oh, ow, got),
                  "upsample_argmax_plan")
    if tuple(got)[:3] != (plan["ppitch"], plan["cs"], plan["smem"]):
        fail(f"K2 plan {plan}: the library's ppitch, cs, smem are {tuple(got)[:3]}")
    rows = plan["ty"] * plan["groups"]
    tiles = -(-ow // (PIXELS * plan["txt"])) * -(-oh // rows) * b
    return (f"tile={PIXELS * plan['txt']}x{rows} threads={plan['txt'] * plan['ty']} "
            f"tiles={tiles} blocks_per_sm={got[3]} grid={got[4]} classes_a_pass={plan['kc']} "
            f"passes={plan['passes']} patch={plan['prows']}x{plan['pcols']} "
            f"smem={plan['smem']}")


def phase_k2(dev):
    """K2 at K2_SHAPES against its plain version: no pixel may differ where the
    plain upsample's top-2 gap exceeds 1e-3.  Per shape the plan, the count of
    pixels that differ at all, and the time flushed (each launch after a 96 MB
    write) and back to back (the logits in L2); the plain version's time at the
    serving shapes.  The bound: logits read and classes written once, against
    the operations of K2's order, a row lerp (3) per output row, source column
    and class and a column lerp (3) and a compare per output pixel and class."""
    import torch
    from segland_tpu_torch import kernels
    from segland_tpu_torch.ops.fused_epilogue import upsample_argmax, upsample_argmax_reference
    from segland_tpu_torch.ops.resize import resize_bilinear

    lib = kernels.library()
    scratch = torch.empty(FLUSH_BYTES // 4, device=dev)
    flush = scratch.zero_
    g = torch.Generator(device=dev).manual_seed(11)
    row = None
    for shape, out_hw in K2_SHAPES:
        b, h, w, k = shape
        oh, ow = out_hw
        logits = 3.0 * torch.randn(*shape, device=dev, generator=g)
        plan = k2_plan_line(lib, b, h, w, k, oh, ow)
        got = upsample_argmax(logits, out_hw)
        up = resize_bilinear(logits, out_hw, align_corners=True)
        top2 = up.topk(2, dim=-1).values if k > 1 else torch.cat([up, up - 1], -1)
        gap = top2[..., 0] - top2[..., 1]
        want = up.argmax(-1).to(torch.uint8)
        differ = got != want
        bad = int((differ & (gap > 1e-3)).sum())
        # logit regret of the kernel's class under the plain fp32 upsample
        err = float((top2[..., 0] - up.gather(-1, got.long()[..., None])[..., 0]).max())
        del up, top2, gap, want
        run = lambda: upsample_argmax(logits, out_hw)
        ms, ms_l2 = queued_ms(run, flush=flush), queued_ms(run)
        serving = (h, w, oh, ow) == (TILE // 4, TILE // 4, TILE, TILE)
        plain_ms = cuda_ms(lambda: upsample_argmax_reference(logits, out_hw),
                           iters=3) if serving and k <= 12 else None
        b_ms, b_by = bound(b * oh * k * (3 * w + 4 * ow), logits.numel() * 4 + b * oh * ow,
                           PEAK_FP32)
        print(f"K2 {shape}->{(b,) + out_hw}: {plan} differing_pixels={int(differ.sum())} "
              f"with_gap_gt_1e-3={bad} max_logit_regret={err:.6g} kernel_ms={ms:.4f} "
              f"(flushed) back_to_back_ms={ms_l2:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"share_of_bound={b_ms / ms:.3f}"
              + (f" plain_ms={plain_ms:.4f}" if plain_ms is not None else ""), flush=True)
        if bad:
            fail(f"K2 {shape}->{out_hw}: {bad} pixels differ where the top-2 gap exceeds 1e-3")
        if row is None:  # the serving shape
            row = dict(max_abs_err=err, ms=ms, ms_back_to_back=ms_l2, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
        else:
            row["max_abs_err"] = max(row["max_abs_err"], err)
        del logits, got, differ
    del scratch
    return row


def section_inputs(nw, c, nh, dtype, dev, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, device=dev, generator=g)
    return dict(
        x=rn(nw, 49, c).to(dtype), gamma=1.0 + 0.1 * rn(c), beta=0.1 * rn(c),
        wqkv=(rn(c, 3 * c) / c ** 0.5).to(dtype), bqkv=0.1 * rn(3 * c),
        wproj=(rn(c, c) / c ** 0.5).to(dtype), bproj=0.1 * rn(c),
        bias=rn(1, nh, 49, 49).to(dtype))


def check_k3(dev, b, c, nh, side, pside, shift, dtype, atol, rtol, seed):
    import torch
    from segland_tpu_torch.models.backbones.swin import _pad_token_mask, _shift_regions
    from segland_tpu_torch.ops.fused_attn import (attn_section, attn_section_clocks,
                                                  attn_section_reference)

    nw = b * (pside // 7) ** 2
    geom = (side, side, pside, pside, 7, shift)
    a = section_inputs(nw, c, nh, dtype, dev, seed)
    mask = torch.from_numpy(_pad_token_mask(*geom)).to(dev)
    regions = torch.from_numpy(_shift_regions(pside, pside, 7, shift)).to(dev) if shift else None
    w = (a["gamma"], a["beta"], linear_layout(a["wqkv"], dtype), a["bqkv"],
         linear_layout(a["wproj"], dtype), a["bproj"], a["bias"], nh)
    run = lambda: attn_section(a["x"], geom, *w)
    plain = lambda: attn_section_reference(a["x"], mask, *w, regions=regions)
    got, want = run().float(), plain().float()
    torch.cuda.synchronize()
    if not bool(got.isfinite().all()):
        fail(f"K3 {dtype} NW={nw} C={c} shift={shift}: non-finite output")
    err = (got - want).abs()
    bad = int((err > atol + rtol * want.abs()).sum())
    worst = float(err.max())
    del got, want, err
    ms, plain_ms = cuda_ms(run, iters=5, warmup=1), cuda_ms(plain, iters=3, warmup=1)
    torch_ms = cuda_ms(torch_section_route(a, mask, regions, nh), iters=5, warmup=1)
    tflops = 2 * nw * 49 * c * (4 * c + 2 * 49) / ms / 1e9
    split = "" if dtype != torch.bfloat16 else " " + phase_split(
        lambda clk: attn_section_clocks(clk, a["x"], geom, *w), K3_PHASES, dev)
    print(f"K3 {str(dtype)[6:]} NW={nw} C={c} heads={nh} geom={geom}: max_abs_err={worst:.6g} "
          f"tol=|d|<={atol}+{rtol}*|ref| out_of_tol={bad} kernel_ms={ms:.4f} "
          f"tflops={tflops:.1f} plain_ms={plain_ms:.4f} torch_route_ms={torch_ms:.4f}{split}",
          flush=True)
    if bad:
        fail(f"K3 {dtype} NW={nw} C={c} shift={shift}: {bad} elements out of tolerance")
    return worst, ms, plain_ms, torch_ms


def torch_section_route(a, mask, regions, nh):
    """The stock-torch route of the same section on the same windows
    (ops/fused_attn.py:attn_section_torch, the formulation that the section's
    autograd Function differentiates): F.layer_norm and the pad mask, the qkv
    F.linear, q k^T with the rel-pos bias and the shift penalty, softmax in
    fp32, P V, the projection F.linear and the residual, in x's dtype."""
    from segland_tpu_torch.ops.fused_attn import attn_section_torch

    args = (a["x"], mask, a["gamma"], a["beta"], a["wqkv"], a["bqkv"], a["wproj"], a["bproj"],
            a["bias"], nh)
    return lambda: attn_section_torch(*args, regions=regions)


def phase_k3(dev):
    import torch
    from segland_tpu_torch.ops.fused_attn import SECTION_BUILDS, section_plan

    build_attrs("segland_attn_section_attrs", SECTION_BUILDS, "K3")
    sass_counts("attn_section_wgmma_kernel")
    worst, ms, plain_ms, torch_ms, bounds = 0.0, 0.0, 0.0, 0.0, []
    for i, (blocks, c, nh, side, pside) in enumerate(SWIN_STAGES):
        nw = BATCH * (pside // 7) ** 2
        plan = section_plan(c)
        print(f"K3 plan C={c}: {plan['w']} windows a block ({plan['row_tiles']} m64 row tiles, "
              f"split by {plan['split']}, n{plan['n']}), ring {plan['s']} x 12 KB, smem "
              f"{plan['smem']:,} B, accumulator registers {plan['acc_regs']}", flush=True)
        for shift in (0, 3):  # the blocks of a stage alternate
            e, t, tp, tt = check_k3(dev, BATCH, c, nh, side, pside, shift, torch.bfloat16,
                                    2e-2, 1e-2, 20 + i)
            worst = max(worst, e)
            ms += blocks / 2 * t
            plain_ms += blocks / 2 * tp
            torch_ms += blocks / 2 * tt
        # real tokens: x read and out written once, the weights and bias once
        bounds += [bound(2 * nw * 49 * c * (4 * c + 2 * 49),
                         2 * nw * 49 * c * 2 + 4 * c * c * 2 + nh * 49 * 49 * 4)] * blocks
    # window counts that leave the last block of W windows part-empty (W = 4 and 2)
    check_k3(dev, 1, 96, 3, 45, 49, 3, torch.bfloat16, 2e-2, 1e-2, 27)
    check_k3(dev, 1, 384, 12, 60, 63, 3, torch.bfloat16, 2e-2, 1e-2, 28)
    check_k3(dev, 2, 192, 6, 128, 133, 3, torch.float32, 1e-4, 1e-4, 29)
    b_ms, b_by = sum_bounds(bounds)
    print(f"K3 per forward of {BATCH} tiles (24 blocks): kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} torch_route_ms={torch_ms:.4f} bound_ms={b_ms:.4f} "
          f"({b_by})", flush=True)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, torch_route_ms=torch_ms)


def masks_on(dev, geom):
    """(mask_tok, regions or None) of a padded geometry, as the backbone ships them."""
    import torch
    from segland_tpu_torch.models.backbones.swin import _pad_token_mask, _shift_regions

    _, _, hp, wp, ws, shift = geom
    mask = torch.from_numpy(_pad_token_mask(*geom)).to(dev)
    regions = torch.from_numpy(_shift_regions(hp, wp, ws, shift)).to(dev) if shift else None
    return mask, regions


def compare(tag, got, want, atol, rtol):
    """Max abs error of got against want; fails on a non-finite value and on
    any element outside |d| <= atol + rtol * |ref|."""
    import torch

    got, want = got.float(), want.float()
    torch.cuda.synchronize()
    if not bool(got.isfinite().all()):
        fail(f"{tag}: non-finite output")
    err = (got - want).abs()
    bad = int((err > atol + rtol * want.abs()).sum())
    worst = float(err.max())
    if bad:
        fail(f"{tag}: {bad} elements out of tolerance |d|<={atol}+{rtol}*|ref| "
             f"(max_abs_err={worst:.6g})")
    return worst


K4_OUTLIERS = 1e-6  # bf16: share of the whole block's elements that may lie past the bound


def check_k4(dev, b, c, nh, side, pside, shift, dtype, atol, rtol, seed):
    """K4 against its plain version.  block_reference is ln_mlp_reference over
    attn_section_reference, and in bf16 an element of the section's output
    ``a`` that rounds the other way passes through LN2 and three more rounded
    products, which puts 0 to 3 elements in 10^7 of the whole block just past
    the bound (K3 then K1 shows the same ones).  So K4's whole output is held
    to block_reference with, in bf16, at most K4_OUTLIERS of its elements past
    |d| <= atol + rtol * |ref| and none past twice that; in fp32 with none past.
    Beside it, at the full tolerance with no outlier: K3's section output ``a``
    against attn_section_reference, and K4's output against the plain MLP half
    over K3's ``a``.  K4 runs K3's section body and K1's MLP body in the same
    k order, so K3's ``a`` is K4's on-chip one: K4's output must equal K3 then
    K1 bit for bit, and any element that differs fails the check.  Every kernel
    gets its weights as the models hand them (linear_layout)."""
    import torch
    from segland_tpu_torch.ops.fused_attn import (CLOCK_WIDTHS, attn_section,
                                                  attn_section_reference, block_reference,
                                                  swin_block, swin_block_clocks)
    from segland_tpu_torch.ops.fused_mlp import ln_mlp, ln_mlp_reference

    nw = b * (pside // 7) ** 2
    geom = (side, side, pside, pside, 7, shift)
    a = section_inputs(nw, c, nh, dtype, dev, seed)
    m = mlp_inputs(1, c, dtype, dev, seed + 100, with_res=False, with_ls=False)
    mask, regions = masks_on(dev, geom)
    sec = (a["gamma"], a["beta"], a["wqkv"], a["bqkv"], a["wproj"], a["bproj"], a["bias"])
    mlp = (m["gamma"], m["beta"], m["w1"], m["b1"], m["w2"], m["b2"])
    sec_l, mlp_l = linear_weights(sec, dtype), linear_weights(mlp, dtype)
    run = lambda: swin_block(a["x"], geom, *sec_l, *mlp_l, nh)
    two = lambda: ln_mlp(attn_section(a["x"], geom, *sec_l, nh).view(-1, c), *mlp_l)
    plain = lambda: block_reference(a["x"], mask, *sec, *mlp, nh, regions=regions)
    tag = f"K4 {str(dtype)[6:]} NW={nw} C={c} heads={nh} geom={geom}"
    got = run()
    want = plain().float()
    torch.cuda.synchronize()
    if not bool(got.isfinite().all()):
        fail(f"{tag}: non-finite output")
    d = (got.float() - want).abs()
    lim = atol + rtol * want.abs()
    whole, bad, worse = float(d.max()), int((d > lim).sum()), int((d > 2 * lim).sum())
    allowed = int(K4_OUTLIERS * d.numel()) if dtype == torch.bfloat16 else 0
    a_k = attn_section(a["x"], geom, *sec_l, nh)
    a_ref = attn_section_reference(a["x"], mask, *sec, nh, regions=regions)
    far = ""
    if bad:  # the element farthest past the bound, with the section's value under it
        j = int((d - lim).argmax())
        far = (f" (farthest: d={float(d.view(-1)[j]):.6g} ref={float(want.view(-1)[j]):.6g} "
               f"k3 a={float(a_k.view(-1)[j]):.6g} plain a={float(a_ref.view(-1)[j]):.6g})")
    if bad > allowed or worse:
        fail(f"{tag}: {bad} elements of the whole block past |d|<={atol}+{rtol}*|ref| "
             f"(at most {allowed}), {worse} past twice it (none){far}")
    k3 = compare(f"{tag}: K3 section under the MLP half", a_k, a_ref, atol, rtol)
    mlp_half = compare(tag + " over K3's section", got,
                       ln_mlp_reference(a_k.view(-1, c), *mlp).view_as(got), atol, rtol)
    differ = int((two().view_as(got) != got).sum())
    if differ:
        fail(f"{tag}: K4 is not K3 then K1 bit for bit: {differ} of {got.numel()} elements "
             f"differ")
    del got, a_k, a_ref, want, d, lim
    ms, two_ms = cuda_ms(run, iters=5, warmup=1), cuda_ms(two, iters=5, warmup=1)
    plain_ms = cuda_ms(plain, iters=3, warmup=1)
    tflops = (2 * nw * 49 * c * (4 * c + 2 * 49) + 16 * nw * 49 * c * c) / ms / 1e9
    split = "" if dtype != torch.bfloat16 or c not in CLOCK_WIDTHS else " " + phase_split(
        lambda clk: swin_block_clocks(clk, a["x"], geom, *sec_l, *mlp_l, nh), K4_PHASES, dev)
    print(f"{tag}: whole block vs block_reference max_abs_err={whole:.6g} "
          f"tol=|d|<={atol}+{rtol}*|ref| out_of_tol={bad} (at most {allowed}, none past "
          f"twice){far}; K3 section max_abs_err={k3:.6g} and over it the MLP half "
          f"max_abs_err={mlp_half:.6g} out_of_tol=0; equal_to_k3_then_k1=True "
          f"kernel_ms={ms:.4f} tflops={tflops:.1f} k3_then_k1_ms={two_ms:.4f} "
          f"plain_ms={plain_ms:.4f}{split}", flush=True)
    return whole, ms, two_ms, plain_ms


def phase_k4(dev):
    import torch
    from segland_tpu_torch.ops.fused_attn import BLOCK_BUILDS, block_plan

    build_attrs("segland_swin_block_attrs", BLOCK_BUILDS, "K4")
    sass_counts("swin_block_wgmma_kernel")
    worst, ms, two_ms, plain_ms, bounds = 0.0, 0.0, 0.0, 0.0, []
    for i, (blocks, c, nh, side, pside) in enumerate(SWIN_STAGES):
        nw = BATCH * (pside // 7) ** 2
        plan = block_plan(c)
        print(f"K4 plan C={c}: {plan['w']} windows a block ({plan['row_tiles']} m64 row tiles), "
              f"ring {plan['s']} x 12 KB ({plan['slots_per_block']} slots a block), MLP "
              f"warpgroups {plan['rg']} x {plan['cg']}, passes {plan['np']}, hidden chunk "
              f"{plan['hc']}, {plan['items']} work items, smem {plan['smem']:,} B",
              flush=True)
        for shift in (0, 3):  # the blocks of a stage alternate
            e, t, t2, tp = check_k4(dev, BATCH, c, nh, side, pside, shift, torch.bfloat16,
                                    2e-2, 1e-2, 40 + i)
            worst = max(worst, e)
            ms += blocks / 2 * t
            two_ms += blocks / 2 * t2
            plain_ms += blocks / 2 * tp
        # x read and out written once, the section's and the MLP's weights and the bias once
        bounds += [bound(2 * nw * 49 * c * (4 * c + 2 * 49) + 16 * nw * 49 * c * c,
                         2 * nw * 49 * c * 2 + 24 * c * c + nh * 49 * 49 * 4)] * blocks
    check_k4(dev, 2, 192, 6, 128, 133, 3, torch.float32, 1e-4, 1e-4, 49)
    b_ms, b_by = sum_bounds(bounds)
    print(f"K4 per forward of {BATCH} tiles (24 blocks): kernel_ms={ms:.4f} "
          f"k3_then_k1_ms={two_ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by})",
          flush=True)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, k3_then_k1_ms=two_ms)


K5_GROUPS = (1, 2, 4, 8)
K5_MAIN_GROUP = 2  # the group of the main path's attn_group route


def check_k5(dev, b, c, nh, side, pside, shift, dtype, atol, rtol, seed, groups=K5_GROUPS,
             timed=False, against_k3=False):
    """K5 for every group on one input; returns (worst error, {group: ms}, plain ms).
    Timed, in bf16, each group's line also gives its path (windows or scratch),
    TFLOP/s (the function's operations, K3's count) and the clock build's
    phase split.  The kernels get their weights as the models hand them."""
    import torch
    from segland_tpu_torch.ops.fused_attn import (CLOCK_WIDTHS, attn_section,
                                                  attn_section_reference, attn_section_v1,
                                                  attn_section_v1_clocks, v1_plan)

    nw = b * (pside // 7) ** 2
    geom = (side, side, pside, pside, 7, shift)
    a = section_inputs(nw, c, nh, dtype, dev, seed)
    mask, regions = masks_on(dev, geom)
    w = (a["gamma"], a["beta"], a["wqkv"], a["bqkv"], a["wproj"], a["bproj"], a["bias"], nh)
    w_l = linear_weights(w, dtype)
    plain = lambda: attn_section_reference(a["x"], mask, *w, regions=regions)
    want = plain()
    tag = (f"K5 {str(dtype)[6:]} NW={nw} C={c} heads={nh} mask_rows={mask.shape[0]} "
           f"region_rows={0 if regions is None else regions.shape[0]} shift={shift}")
    worst, times = 0.0, {}
    flops = 2 * nw * 49 * c * (4 * c + 2 * 49)
    for g in groups:
        run = lambda: attn_section_v1(a["x"], mask, *w_l, regions=regions, group=g)
        worst = max(worst, compare(f"{tag} group={g}", run(), want, atol, rtol))
        if timed:
            times[g] = cuda_ms(run, iters=5, warmup=1)
            if dtype == torch.bfloat16:
                split = "" if c not in CLOCK_WIDTHS else " " + phase_split(
                    lambda clk: attn_section_v1_clocks(
                        clk, a["x"], mask, *w_l, regions=regions, group=g), K5_PHASES, dev)
                print(f"{tag} group={g}: path={v1_plan(c, g)['path']} kernel_ms={times[g]:.4f} "
                      f"tflops={flops / times[g] / 1e9:.1f}{split}", flush=True)
    k3 = ""
    if against_k3:
        got = attn_section_v1(a["x"], mask, *w_l, regions=regions, group=1)
        e3 = compare(f"{tag} group=1 vs K3", got, attn_section(a["x"], geom, *w_l), atol, rtol)
        k3 = f" group1_vs_k3_max_abs_err={e3:.6g}"
    plain_ms = cuda_ms(plain, iters=3, warmup=1) if timed else 0.0
    ms = " ".join(f"g{g}_ms={t:.4f}" for g, t in times.items())
    print(f"{tag} groups={groups}: max_abs_err={worst:.6g} tol=|d|<={atol}+{rtol}*|ref|{k3} "
          f"{ms}{f' plain_ms={plain_ms:.4f}' if timed else ''}", flush=True)
    return worst, times, plain_ms


def phase_k5(dev):
    import torch
    from segland_tpu_torch.ops.fused_attn import V1_BUILDS, v1_plan

    build_attrs("segland_attn_section_v1_attrs", [(c, g) for c in V1_BUILDS for g in K5_GROUPS],
                "K5", names=("C", "group"))
    sass_counts("attn_section_v1_windows_kernel")
    sass_counts("attn_section_v1_scratch_kernel")
    bf = torch.bfloat16
    worst, plain_ms, bounds, tiling = 0.0, 0.0, [], []
    per_group = {g: 0.0 for g in K5_GROUPS}
    for i, (blocks, c, nh, side, pside) in enumerate(SWIN_STAGES):
        nw = BATCH * (pside // 7) ** 2
        for g in K5_GROUPS:
            plan = v1_plan(c, g)
            print(f"K5 plan C={c} group={g}: {plan['path']} path, {plan['windows_a_block']} "
                  f"windows a block ({-(-nw // plan['windows_a_block'])} blocks), ring "
                  f"{plan['s']} x 12 KB, smem {plan['smem']:,} B, scratch tensor "
                  f"{'yes' if plan['scratch'] else 'no'}", flush=True)
        for shift in (0, 3):  # per-window mask rows; regions with the shift
            e, times, tp = check_k5(dev, BATCH, c, nh, side, pside, shift, bf, 2e-2, 1e-2,
                                    60 + i, timed=True, against_k3=True)
            worst = max(worst, e)
            plain_ms += blocks / 2 * tp
            for g, t in times.items():
                per_group[g] += blocks / 2 * t
        # the function's work is K3's at every group (a cross-window pair has weight 0):
        # K3's bytes plus the mask and region rows; the tiling's own work is apart
        rows = (pside // 7) ** 2 * 49 * 4
        nbytes = 2 * nw * 49 * c * 2 + 8 * c * c + nh * 49 * 49 * 4 + 2 * rows
        bounds += [bound(2 * nw * 49 * c * (4 * c + 2 * 49), nbytes)] * blocks
        tiling += [bound(2 * nw * 49 * c * (4 * c + 2 * K5_MAIN_GROUP * 49), nbytes)] * blocks
    # a broadcast mask row (no padding), without and with regions
    for shift in (0, 3):
        worst = max(worst, check_k5(dev, 2, 192, 6, 126, 126, shift, bf, 2e-2, 1e-2, 70)[0])
    # 361 windows: no group but 1 divides them
    worst = max(worst, check_k5(dev, 1, 192, 6, 128, 133, 3, bf, 2e-2, 1e-2, 71)[0])
    worst = max(worst, check_k5(dev, 1, 768, 24, 32, 35, 3, bf, 2e-2, 1e-2, 72)[0])
    check_k5(dev, 1, 192, 6, 128, 133, 3, torch.float32, 1e-4, 1e-4, 73)
    b_ms, b_by = sum_bounds(bounds)
    tiling_ms = sum_bounds(tiling)[0]
    groups = " ".join(f"group{g}_ms={t:.4f}" for g, t in per_group.items())
    print(f"K5 per forward of {BATCH} tiles (24 blocks): {groups} plain_ms={plain_ms:.4f} "
          f"bound_ms={b_ms:.4f} ({b_by}) tiling_ops_ms(group={K5_MAIN_GROUP})={tiling_ms:.4f}",
          flush=True)
    if len({round(t, 3) for t in per_group.values()}) != len(per_group):
        fail(f"K5: two groups ran in the same time, {per_group}: is group a no-op?")
    return dict(max_abs_err=worst, ms=per_group[K5_MAIN_GROUP], plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, tiling_ops_ms=tiling_ms,
                ms_by_group={str(g): t for g, t in per_group.items()})


def hg_builds(c, table):
    """{hg: W} of the builds of K9 (HG_SM90_BUILDS) or K10 (HG2_BUILDS) at
    width C (W, the windows a pass, is the wblk that gives each block one
    pass), and the JAX package's production hg."""
    from segland_tpu_torch.ops.hg_attn import V2_HG

    return {hg: b.w for (cc, hg), b in sorted(table.items()) if cc == c}, V2_HG[c // 32]


HG_WBLK = 32  # the JAX probe's default windows a thread block


def section_bound(nw, c, nh, extra_bytes=0):
    """K3's count over real tokens (the head-grouped kernels multiply nothing
    on zeros): x read and out written once, the weights and the bf16 bias once."""
    return bound(2 * nw * 49 * c * (4 * c + 2 * 49),
                 2 * nw * 49 * c * 2 + 4 * c * c * 2 + nh * 49 * 49 * 2 + extra_bytes)


def hg_input(dev, b, c, nh, side, pside, shift, seed):
    """(inputs, weights tuple, geom, mask, regions) of one section call in bf16."""
    import torch

    nw = b * (pside // 7) ** 2
    geom = (side, side, pside, pside, 7, shift)
    a = section_inputs(nw, c, nh, torch.bfloat16, dev, seed)
    w = (a["gamma"], a["beta"], a["wqkv"], a["bqkv"], a["wproj"], a["bproj"], a["bias"], nh)
    mask, regions = masks_on(dev, geom)
    return a, w, geom, mask, regions


def phase_k10(dev):
    """K10 hg2_section at the four swin-s stage shapes, shift 0 and 3, every
    built hg, wblk = W and 32, against its plain version; its builds'
    registers and spills and SASS HGMMA/UTMALDG counts; beside it on the same
    input K3 and K9 at the same hg, and the clock builds' phase split; then
    each ablation at hg = 1 and the default hg (shift 3)."""
    import torch
    from segland_tpu_torch.ops.fused_attn import attn_section
    from segland_tpu_torch.ops.hg_attn import (ABLATIONS, HG2_BUILDS, HG2_MODE_BUILDS,
                                               HG_SM90_BUILDS, hg2_section, hg2_section_clocks,
                                               hg2_section_reference, hg_section)

    keys = [(c, hg, ABLATIONS.index(ab)) for c in (96, 192, 384, 768)
            for hg in hg_builds(c, HG2_BUILDS)[0] for ab in ABLATIONS
            if ab == "none" or (ab != "ioraw" and (c, hg) in HG2_MODE_BUILDS)]
    build_attrs("segland_hg2_section_attrs", keys + [(96, 1, ABLATIONS.index("ioraw"))], "K10",
                names=("C", "hg", "mode"))
    sass_counts("9GeomMasks")  # hg_kernel<HgPlan<...>, GeomMasks, mode>; not the ioraw kernel
    worst, plain_ms, bounds, by_hg, by_hg32, k3_ms, split = 0.0, 0.0, [], {}, {}, 0.0, {}
    main_ms, k9_by_hg = 0.0, {}
    for i, (blocks, c, nh, side, pside) in enumerate(SWIN_STAGES):
        nw = BATCH * (pside // 7) ** 2
        hgs, hg_main = hg_builds(c, HG2_BUILDS)
        stage_t = {hg: 0.0 for hg in hgs}
        for shift in (0, 3):
            a, w, geom, mask, regions = hg_input(dev, BATCH, c, nh, side, pside, shift, 120 + i)
            x = a["x"]
            w_l = linear_weights(w, torch.bfloat16)  # K-major, as a model hands them over
            k3 = attn_section(x, geom, *w_l)
            t3 = cuda_ms(lambda: attn_section(x, geom, *w_l), iters=5, warmup=1)
            k3_ms += blocks / 2 * t3
            for hg, wb in hgs.items():
                key = f"C={c} hg={hg}"
                tag = f"K10 bf16 NW={nw} C={c} heads={nh} geom={geom} hg={hg}"
                want = hg2_section_reference(x, geom, *w, hg=hg)
                e = 0.0
                for blk in (wb, HG_WBLK):
                    got = hg2_section(x, geom, *w_l, hg=hg, wblk=blk)
                    e = max(e, compare(f"{tag} wblk={blk}", got, want, 2e-2, 1e-2))
                worst = max(worst, e)
                d3 = float((got.float() - k3.float()).abs().max())
                del got, want
                t = cuda_ms(lambda: hg2_section(x, geom, *w_l, hg=hg, wblk=wb), iters=5,
                            warmup=1)
                t32 = cuda_ms(lambda: hg2_section(x, geom, *w_l, hg=hg, wblk=HG_WBLK), iters=3,
                              warmup=1)
                tp = cuda_ms(lambda: hg2_section_reference(x, geom, *w, hg=hg), iters=2,
                             warmup=0)
                t9 = None
                if (c, hg) in HG_SM90_BUILDS:
                    t9 = cuda_ms(lambda: hg_section(x, mask, regions, *w_l, hg=hg,
                                                    wblk=HG_SM90_BUILDS[(c, hg)].w),
                                 iters=5, warmup=1)
                    k9_by_hg[key] = k9_by_hg.get(key, 0.0) + blocks / 2 * t9
                by_hg32[key] = by_hg32.get(key, 0.0) + blocks / 2 * t32
                stage_t[hg] += blocks / 2 * t
                by_hg[key] = by_hg.get(key, 0.0) + blocks / 2 * t
                if hg == hg_main:
                    plain_ms += blocks / 2 * tp
                    main_ms += blocks / 2 * t
                sp = ""
                if shift == 0 and (c, hg) in HG2_MODE_BUILDS:
                    sp = " " + phase_split(lambda clk: hg2_section_clocks(
                        clk, x, geom, *w_l, hg=hg, wblk=wb), K3_PHASES, dev)
                    split[f"{key} clocks"] = sp.strip()
                b_ms = section_bound(nw, c, nh)[0]
                print(f"{tag} wblk={wb}: max_abs_err={e:.6g} tol=|d|<=0.02+0.01*|ref| "
                      f"out_of_tol=0 (wblk={wb} and {HG_WBLK}) kernel_ms={t:.4f} "
                      f"wblk{HG_WBLK}_ms={t32:.4f} ({-(-nw // HG_WBLK)} blocks) "
                      f"k9_ms={'-' if t9 is None else f'{t9:.4f}'} "
                      f"plain_ms={tp:.4f} k3_ms={t3:.4f} max_abs_diff_vs_k3={d3:.6g} "
                      f"bound_ms={b_ms:.4f} share_of_bound={b_ms / t:.3f}{sp}", flush=True)
            del k3
        bounds += [section_bound(nw, c, nh)] * blocks
        if len(hgs) > 1 and len({round(t, 3) for t in stage_t.values()}) == 1:
            fail(f"K10 C={c}: every hg ran in the same time, {stage_t}: is hg a no-op?")
        # the ablations at shift 3 (the full path: pad mask and regions)
        a, w, geom, _, _ = hg_input(dev, BATCH, c, nh, side, pside, 3, 130 + i)
        x = a["x"]
        w_l = linear_weights(w, torch.bfloat16)
        for hg in sorted({1, hg_main}):
            times, gtimes, wb = {}, {}, hgs[hg]
            for ab in ABLATIONS:
                tag = f"K10 bf16 NW={nw} C={c} hg={hg} wblk={wb} ablate={ab}"
                sums = []
                want = hg2_section_reference(x, geom, *w, hg=hg, ablate=ab,
                                             sums=sums if ab == "softmax" else None)
                got = hg2_section(x, geom, *w_l, hg=hg, ablate=ab, wblk=wb)
                held = ""
                if ab == "softmax":  # rows whose every per-head sum has |s| > 0.05
                    rows = (sums[0].abs() > 0.05).all(-1)
                    held = f" rows_held={int(rows.sum())}/{rows.numel()}"
                    got, want = got[rows], want[rows]
                worst = max(worst, compare(tag, got, want, 2e-2, 1e-2))
                del got, want, sums
                times[ab] = cuda_ms(lambda: hg2_section(x, geom, *w_l, hg=hg, ablate=ab,
                                                        wblk=wb), iters=5, warmup=1)
                gtimes[ab] = chain_ms(
                    lambda a: hg2_section(a, geom, *w_l, hg=hg, ablate=ab, wblk=wb), x)
                print(f"{tag}: out_of_tol=0{held} kernel_ms={times[ab]:.4f} "
                      f"graph_ms={gtimes[ab]:.4f}", flush=True)
            for how, tt in (("eager", times), ("graph", gtimes)):
                sp = {"ioraw": tt["ioraw"], "io-ioraw": tt["io"] - tt["ioraw"],
                      "attn-io": tt["attn"] - tt["io"], "none-attn": tt["none"] - tt["attn"],
                      "none-softmax (exp, max)": tt["none"] - tt["softmax"]}
                split[f"C={c} hg={hg} {how}"] = sp
                print(f"K10 C={c} hg={hg} phase split, ms a call ({how}): "
                      + " ".join(f"{k}={v:.4f}" for k, v in sp.items()), flush=True)
        del a, x, w, w_l
    b_ms, b_by = sum_bounds(bounds)
    per_fwd = lambda d, hg_of: sum(v for k, v in d.items()
                                   if int(k.split("hg=")[1]) == hg_of(int(k[2:].split()[0])))
    default = lambda c: hg_builds(c, HG2_BUILDS)[1]
    fwd = {what: {"default hg": per_fwd(d, default), "hg=1": per_fwd(d, lambda c: 1)}
           for what, d in (("k10", by_hg), ("k9", k9_by_hg))}
    print(f"K10 per forward of {BATCH} tiles (24 blocks) at the default hg: "
          f"kernel_ms={main_ms:.4f} plain_ms={plain_ms:.4f} k3_ms={k3_ms:.4f} "
          f"bound_ms={b_ms:.4f} ({b_by}) share_of_bound={b_ms / main_ms:.3f}; a forward "
          + "; ".join(f"{what} {k}={v:.4f}" for what, d in fwd.items() for k, v in d.items())
          + "; by hg: " + " ".join(f"{k}={v:.4f}" for k, v in by_hg.items()), flush=True)
    print(f"K10 per forward at wblk={HG_WBLK} by hg: "
          + " ".join(f"{k}={v:.4f}" for k, v in by_hg32.items()), flush=True)
    return dict(max_abs_err=worst, ms=main_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, k3_ms=k3_ms, forward_ms=fwd, ms_by_hg=by_hg,
                k9_ms_by_hg=k9_by_hg, ms_by_hg_wblk32=by_hg32, phase_split=split)


def phase_k9(dev):
    """K9 hg_section at the four swin-s stage shapes (per-window mask rows),
    shift 0 without and shift 3 with regions, every built hg, against its plain
    version (bf16 scores too at hg = 1), at wblk = W and 32, beside K5 at group 1
    and K3 on the same input, with the clock build's phase split; then broadcast
    mask rows."""
    import torch
    from segland_tpu_torch.ops.fused_attn import attn_section, attn_section_v1
    from segland_tpu_torch.ops.hg_attn import (HG_SM90_BUILDS, hg_section, hg_section_clocks,
                                               hg_section_reference)

    build_attrs("segland_hg_section_attrs", sorted(HG_SM90_BUILDS), "K9", names=("C", "hg"))
    sass_counts("12ShippedMasks")  # hg_kernel<HgPlan<...>, ShippedMasks, 0, ...>
    worst, plain_ms, bounds, by_hg, by_hg32, k5_ms, k3_ms, main_ms = 0.0, 0.0, [], {}, {}, 0.0, \
        0.0, 0.0
    split = {}
    cases = [(BATCH,) + s[1:] + (s[0], shift) for s in SWIN_STAGES for shift in (0, 3)]
    cases += [(2, 192, 6, 126, 126, 0, shift) for shift in (0, 3)]  # broadcast mask rows
    for i, (b, c, nh, side, pside, blocks, shift) in enumerate(cases):
        nw = b * (pside // 7) ** 2
        hgs, hg_main = hg_builds(c, HG_SM90_BUILDS)
        a, w, geom, mask, regions = hg_input(dev, b, c, nh, side, pside, shift, 140 + i)
        x = a["x"]
        w_l = linear_weights(w, torch.bfloat16)  # K-major, as a model hands them over
        k5 = attn_section_v1(x, mask, *w_l, regions=regions)
        t5 = cuda_ms(lambda: attn_section_v1(x, mask, *w_l, regions=regions), iters=5, warmup=1)
        t3 = cuda_ms(lambda: attn_section(x, geom, *w_l), iters=5, warmup=1) if blocks else 0.0
        k5_ms += blocks / 2 * t5
        k3_ms += blocks / 2 * t3
        rows_bytes = (mask.numel() + (0 if regions is None else regions.numel())) * 4
        stage_t = {}
        for hg, wb in hgs.items():
            tag = (f"K9 bf16 NW={nw} C={c} heads={nh} mask_rows={mask.shape[0]} "
                   f"region_rows={0 if regions is None else regions.shape[0]} shift={shift} "
                   f"hg={hg} wblk={wb}")
            for sf in (True, False) if hg == 1 else (True,):
                got = hg_section(x, mask, regions, *w_l, hg=hg, wblk=wb, score_f32=sf)
                want = hg_section_reference(x, mask, regions, *w, hg=hg, score_f32=sf)
                e = compare(f"{tag} score_f32={sf}", got, want, 2e-2, 1e-2)
                worst = max(worst, e)
                if sf:
                    d5 = float((got.float() - k5.float()).abs().max())
                del got, want
            # a ragged block and pass: 7 windows a block
            got = hg_section(x, mask, regions, *w_l, hg=hg, wblk=7)
            worst = max(worst, compare(f"{tag} wblk=7", got, hg_section_reference(
                x, mask, regions, *w, hg=hg), 2e-2, 1e-2))
            del got
            t = cuda_ms(lambda: hg_section(x, mask, regions, *w_l, hg=hg, wblk=wb), iters=5,
                        warmup=1)
            t32 = cuda_ms(lambda: hg_section(x, mask, regions, *w_l, hg=hg, wblk=HG_WBLK),
                          iters=3, warmup=1)
            tp = cuda_ms(lambda: hg_section_reference(x, mask, regions, *w, hg=hg), iters=2,
                         warmup=0)
            stage_t[hg] = t
            b_ms = section_bound(nw, c, nh, rows_bytes)[0]
            sp = ""
            if blocks and shift == 0:
                sp = " " + phase_split(lambda clk: hg_section_clocks(
                    clk, x, mask, regions, *w_l, hg=hg, wblk=wb), K3_PHASES, dev)
                split[f"C={c} hg={hg}"] = sp.strip()
            if blocks:
                key = f"C={c} hg={hg}"
                by_hg[key] = by_hg.get(key, 0.0) + blocks / 2 * t
                by_hg32[key] = by_hg32.get(key, 0.0) + blocks / 2 * t32
                if hg == hg_main:
                    plain_ms += blocks / 2 * tp
                    main_ms += blocks / 2 * t
            print(f"{tag}: max_abs_err={e:.6g} tol=|d|<=0.02+0.01*|ref| out_of_tol=0 "
                  f"kernel_ms={t:.4f} wblk{HG_WBLK}_ms={t32:.4f} ({-(-nw // HG_WBLK)} blocks) "
                  f"plain_ms={tp:.4f} k5_group1_ms={t5:.4f} k3_ms={t3:.4f} "
                  f"max_abs_diff_vs_k5={d5:.6g} bound_ms={b_ms:.4f} "
                  f"share_of_bound={b_ms / t:.3f}{sp}", flush=True)
        if blocks:
            bounds += [section_bound(nw, c, nh, rows_bytes)] * (blocks // 2)
        if len(hgs) > 1 and len({round(t, 3) for t in stage_t.values()}) == 1:
            fail(f"K9 C={c}: every hg ran in the same time, {stage_t}: is hg a no-op?")
        del a, x, w, w_l, k5
    b_ms, b_by = sum_bounds(bounds)
    print(f"K9 per forward of {BATCH} tiles (24 blocks) at the default hg: "
          f"kernel_ms={main_ms:.4f} plain_ms={plain_ms:.4f} k5_group1_ms={k5_ms:.4f} "
          f"k3_ms={k3_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) share_of_bound={b_ms / main_ms:.3f}; "
          "by hg: " + " ".join(f"{k}={v:.4f}" for k, v in by_hg.items()), flush=True)
    print(f"K9 per forward at wblk={HG_WBLK} by hg: "
          + " ".join(f"{k}={v:.4f}" for k, v in by_hg32.items()), flush=True)
    return dict(max_abs_err=worst, ms=main_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, k5_group1_ms=k5_ms, k3_ms=k3_ms, ms_by_hg=by_hg,
                ms_by_hg_wblk32=by_hg32, phase_split=split)


HG_PROBE_STAGE, HG_PROBE_ITERS = "stage2", 3


def phase_hg_probe():
    """The probe's path: benchmarks/swin_attn_hg.py's entry point at one stage
    of a batch of 8 with its default specs (two of each version)."""
    from segland_tpu_torch.benchmarks import swin_attn_hg

    rows, seen = counted(lambda: swin_attn_hg.main(
        [HG_PROBE_STAGE, str(BATCH), "--iters", str(HG_PROBE_ITERS)]))
    per_spec = chain_launches(HG_PROBE_ITERS)
    want, ran = {}, {}
    for r in rows:
        key = "hg_section" if r["ver"] == 1 else "hg2_section"
        want[key] = want.get(key, 0) + per_spec
        for k, n in r["launches"].items():
            ran[k] = ran.get(k, 0) + n
    ran = {k: n for k, n in ran.items() if n}
    if ran != want or set(want) != {"hg_section", "hg2_section"} or set(seen) != set(want):
        fail(f"swin_attn_hg probe launch counts {ran} (counters {seen}), want {want} with "
             "both versions")
    return ran


def chain_launches(iters):
    """Launches of one section wrapper that the probes' chain_time runs for a
    variant, two sections a link: the eager chain (warm-up and timed rounds),
    then the graph's eager round before capture and its replays."""
    from segland_tpu_torch.benchmarks.swin_attn_variants import CHAIN, WARMUP

    return 2 * CHAIN * (WARMUP + iters) + 2 * CHAIN * (1 + WARMUP + iters)


def chain_ms(op, x):
    """ms a call of op by the probes' chain_time, CUDA graph minus its baseline."""
    from segland_tpu_torch.benchmarks.swin_attn_variants import baseline, chain_time

    return chain_time(op, x, graph=True)[0] - baseline(x, graph=True)


K11_WBLK = 32  # the JAX probe's default windows a thread block


def phase_k11(dev):
    """K11 section against its plain version in all 8 modes and both score
    dtypes at C = 96, 192, 384 (one image's windows), shift 0 and 3 (with
    regions), wblk 32 and 7; its builds and SASS; then every mode at a batch
    of 8 at the three stage shapes, timed beside its plain version, K5 at
    group 1, K9 at hg = 1 and K3 on the same inputs, with the clock build's
    phase split."""
    import torch
    from segland_tpu_torch.ops.fused_attn import attn_section, attn_section_v1
    from segland_tpu_torch.ops.hg_attn import HG_SM90_BUILDS, hg_section
    from segland_tpu_torch.ops.section_variants import (ABLATIONS, SECTION_BUILDS, section,
                                                        section_clocks, section_reference)

    build_attrs("segland_section_variants_attrs",
                [(c, m) for c in SECTION_BUILDS for m in range(len(ABLATIONS))], "K11",
                names=("C", "mode"))
    # variants_kernel<VarPlan<...>, mode, clocks>; mode io is io_kernel, which runs no product
    sass_counts("7VarPlanI")
    worst = {}
    for i, (blocks, c, nh, side, pside) in enumerate(SWIN_STAGES[:3]):
        for shift in (0, 3):
            a, w, geom, mask, regions = hg_input(dev, 1, c, nh, side, pside, shift, 160 + i)
            x = a["x"]
            w_l = linear_weights(w, torch.bfloat16)
            for ab in ABLATIONS:
                for sf in (True, False):
                    want = section_reference(x, mask, regions, *w, score_f32=sf, ablate=ab)
                    for wb in (K11_WBLK, 7):  # 7: ragged passes and blocks
                        tag = (f"K11 bf16 NW={x.shape[0]} C={c} shift={shift} ablate={ab} "
                               f"score_f32={sf} wblk={wb}")
                        got = section(x, mask, regions, *w_l, wblk=wb, score_f32=sf, ablate=ab)
                        worst[ab] = max(worst.get(ab, 0.0), compare(tag, got, want, 2e-2, 1e-2))
                        del got
                    del want
            del a, x, w, w_l
    print("K11 bf16 largest error by mode (|d|<=0.02+0.01*|ref|, no element outside; 8 modes x "
          "2 score dtypes x shift 0, 3 x wblk 32, 7): "
          + " ".join(f"{k}={v:.6g}" for k, v in worst.items()), flush=True)

    ms = plain_ms = k5_ms = k9_ms = k3_ms = 0.0
    bounds, modes, split = [], {}, {}
    for i, (blocks, c, nh, side, pside) in enumerate(SWIN_STAGES[:3]):
        nw = BATCH * (pside // 7) ** 2
        wb = SECTION_BUILDS[c].w
        for shift in (0, 3):
            a, w, geom, mask, regions = hg_input(dev, BATCH, c, nh, side, pside, shift, 170 + i)
            x = a["x"]
            w_l = linear_weights(w, torch.bfloat16)
            tag = f"K11 bf16 NW={nw} C={c} shift={shift} wblk={wb}"
            compare(tag, section(x, mask, regions, *w_l, wblk=wb),
                    section_reference(x, mask, regions, *w), 2e-2, 1e-2)
            t = cuda_ms(lambda: section(x, mask, regions, *w_l, wblk=wb), iters=5, warmup=1)
            t32 = cuda_ms(lambda: section(x, mask, regions, *w_l, wblk=K11_WBLK), iters=3,
                          warmup=1)
            tp = cuda_ms(lambda: section_reference(x, mask, regions, *w), iters=2, warmup=0)
            t5 = cuda_ms(lambda: attn_section_v1(x, mask, *w_l, regions=regions), iters=5,
                         warmup=1)
            t9 = cuda_ms(lambda: hg_section(x, mask, regions, *w_l, hg=1,
                                            wblk=HG_SM90_BUILDS[(c, 1)].w), iters=5, warmup=1)
            t3 = cuda_ms(lambda: attn_section(x, geom, *w_l), iters=5, warmup=1)
            rows_bytes = (mask.numel() + (0 if regions is None else regions.numel())) * 4
            b_ms, b_by = section_bound(nw, c, nh, rows_bytes)
            sp = ""
            if shift == 0:
                sp = " " + phase_split(lambda clk: section_clocks(
                    clk, x, mask, regions, *w_l, wblk=wb), K3_PHASES, dev)
                split[f"C={c}"] = sp.strip()
            print(f"{tag}: kernel_ms={t:.4f} wblk{K11_WBLK}_ms={t32:.4f} "
                  f"({-(-nw // K11_WBLK)} blocks) plain_ms={tp:.4f} "
                  f"k5_group1_ms={t5:.4f} k9_hg1_ms={t9:.4f} k3_ms={t3:.4f} "
                  f"bound_ms={b_ms:.4f} ({b_by}) share_of_bound={b_ms / t:.3f}{sp}", flush=True)
            if shift:  # every mode: queued (host time out) and by CUDA graph
                modes[c] = {ab: queued_ms(lambda: section(x, mask, regions, *w_l, wblk=wb,
                                                          ablate=ab), iters=10)
                            for ab in ABLATIONS}
                graph = {ab: chain_ms(lambda v: section(v, mask, regions, *w_l, wblk=wb,
                                                        ablate=ab), x) for ab in ABLATIONS}
                print(f"K11 C={c} wblk={wb} by mode, ms a call (queued; CUDA graph): "
                      + " ".join(f"{k}={modes[c][k]:.4f};{graph[k]:.4f}" for k in ABLATIONS),
                      flush=True)
            ms += blocks / 2 * t
            plain_ms += blocks / 2 * tp
            k5_ms += blocks / 2 * t5
            k9_ms += blocks / 2 * t9
            k3_ms += blocks / 2 * t3
            bounds += [(b_ms, b_by)] * (blocks // 2)
            del a, x, w, w_l
    b_ms, b_by = sum_bounds(bounds)
    print(f"K11 per forward of {BATCH} tiles, stages 0-2 (22 blocks): kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} k5_group1_ms={k5_ms:.4f} "
          f"k9_hg1_ms={k9_ms:.4f} k3_ms={k3_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
          f"share_of_bound={b_ms / ms:.3f}", flush=True)
    return dict(max_abs_err=max(worst.values()), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, k5_group1_ms=k5_ms, k9_hg1_ms=k9_ms,
                k3_ms=k3_ms, max_abs_err_by_mode=worst, ms_by_mode=modes, phase_split=split)


def phase_f32(dev):
    """The fp32 body: K9, K10 and K11 on fp32 windows against their plain
    versions (|d| <= 1e-5 + 1e-5 * |ref|; K11's softmax ablation, whose
    output reaches 1e6, at 1e-5 of its largest |ref|; bf16sm, which rounds
    its exponentials to bf16, at the bf16 bar) at C = 96, 192, 384, 768 with
    one image's windows, every mode; then both probes' own check on the card."""
    import torch
    from segland_tpu_torch.benchmarks import swin_attn_hg, swin_attn_variants
    from segland_tpu_torch.ops.hg_attn import (ABLATIONS as HG_ABLATIONS, V2_HG, hg2_section,
                                               hg2_section_reference, hg_section,
                                               hg_section_reference)
    from segland_tpu_torch.ops.section_variants import (ABLATIONS, section, section_reference)

    worst = {"hg_section": 0.0, "hg2_section": 0.0, "section": 0.0}

    def held(key, tag, got, want, ab="none"):
        if ab == "bf16sm":
            e = compare(tag, got, want, 2e-2, 1e-2)
        elif ab == "softmax" and key == "section":
            e = compare(tag, got, want, 1e-5 * float(want.abs().max()), 0.0)
        else:
            e = compare(tag, got, want, 1e-5, 1e-5)
        worst[key] = max(worst[key], e)
        print(f"{tag}: max_abs_err={e:.6g}", flush=True)

    for i, (blocks, c, nh, side, pside) in enumerate(SWIN_STAGES):
        for shift in (0, 3):
            nw = (pside // 7) ** 2
            geom = (side, side, pside, pside, 7, shift)
            a = section_inputs(nw, c, nh, torch.float32, dev, 180 + i)
            w = (a["gamma"], a["beta"], a["wqkv"], a["bqkv"], a["wproj"], a["bproj"], a["bias"],
                 nh)
            mask, regions = masks_on(dev, geom)
            x = a["x"]
            for hg in sorted({1, V2_HG[nh]}):
                tag = f"K9 fp32 NW={nw} C={c} shift={shift} hg={hg}"
                held("hg_section", tag, hg_section(x, mask, regions, *w, hg=hg, wblk=5),
                     hg_section_reference(x, mask, regions, *w, hg=hg))
                for ab in HG_ABLATIONS if shift else ("none",):
                    tag = f"K10 fp32 NW={nw} C={c} shift={shift} hg={hg} ablate={ab}"
                    held("hg2_section", tag, hg2_section(x, geom, *w, hg=hg, wblk=5, ablate=ab),
                         hg2_section_reference(x, geom, *w, hg=hg, ablate=ab))
            if c <= 384 or shift:
                for ab in ABLATIONS:
                    tag = f"K11 fp32 NW={nw} C={c} shift={shift} ablate={ab}"
                    held("section", tag, section(x, mask, regions, *w, wblk=5, ablate=ab),
                         section_reference(x, mask, regions, *w, ablate=ab), ab)
            del a, x, w
    swin_attn_hg.main(["check", "--device", "cuda"])
    swin_attn_variants.main(["check", "--device", "cuda"])
    print("fp32 largest error: " + " ".join(f"{k}={v:.6g}" for k, v in worst.items()),
          flush=True)
    return worst


VARIANTS_ITERS = 3


def phase_variants_probe():
    """The variants probe's path: benchmarks/swin_attn_variants.py's entry
    point at each of its stages for a batch of 8, its 15 variants through
    chain_time (CUDA graph and eager)."""
    import torch
    from segland_tpu_torch.benchmarks import swin_attn_variants

    want, ran = chain_launches(VARIANTS_ITERS), 0
    for stage in swin_attn_variants.STAGES:
        rows, seen = counted(lambda: swin_attn_variants.main(
            [stage, str(BATCH), "--iters", str(VARIANTS_ITERS)]))
        if len(rows) != len(swin_attn_variants.VARIANTS) or set(seen) != {"section"}:
            fail(f"swin_attn_variants {stage}: {len(rows)} variants, counters {seen}")
        for r in rows:
            if r["launches"] != want:
                fail(f"swin_attn_variants {stage} v{r['variant']}: {r['launches']} launches, "
                     f"want {want}")
            ran += r["launches"]
        torch.cuda.empty_cache()
    return {"section": ran}


K6_BIASES = ("shared bf16", "shared fp32", "per-window+mask bf16", "per-window+mask fp32")


def k6_plan_line(lib, nw, c, nh, nw_img, bias_dtype):
    """K6's ring plan from ops/fused_attn.py:window_attention_plan beside the
    library's as launched; fails where the two differ."""
    import ctypes

    import torch
    from segland_tpu_torch import kernels
    from segland_tpu_torch.ops.fused_attn import window_attention_plan

    plan = window_attention_plan(nw, c, nh, nw_img, bias_dtype,
                                 sms=torch.cuda.get_device_properties(0).multi_processor_count)
    got = (ctypes.c_int * 6)()
    kernels.check(lib.segland_window_attention_plan(nw, c, nh, nw_img,
                                                    int(bias_dtype == torch.bfloat16), got),
                  "window_attention_plan")
    want = tuple(plan[k] for k in ("stages", "stage_bytes", "smem", "blocks_per_sm", "grid",
                                   "items"))
    if tuple(got) != want:
        fail(f"K6 plan NW={nw} C={c}: window_attention_plan {want}, the library {tuple(got)}")
    return (f"stages={plan['stages']} stage_bytes={plan['stage_bytes']} smem={plan['smem']} "
            f"blocks_per_sm={plan['blocks_per_sm']} grid={plan['grid']} items={plan['items']}")


def phase_k6(dev):
    """K6 at the four swin-s stage shapes of a batch of 8 1024^2 tiles, with a
    shared bias and a per-window bias + shift mask, each in bf16 and fp32, the
    ring body against the plain version at |d| <= 0.02 + 0.01 * |ref| (none
    past it), plus two ragged window counts at stage 2; the fp32 body on fp32
    windows at stage 3.  Per stage and bias: the time (launches queued behind
    a device sleep), the bound, the share of it and SDPA's time on the same
    inputs; then the sum over a forward (2, 2, 18, 2 blocks, half with each
    bias, in bf16 as the model hands it) beside its bound.  The kernels line
    takes stage 2's bf16 biases."""
    import torch
    import torch.nn.functional as F
    from segland_tpu_torch import kernels
    from segland_tpu_torch.models.backbones.swin import _shift_attn_mask
    from segland_tpu_torch.ops.fused_attn import window_attention, window_attention_reference

    lib = kernels.library()
    build_attrs("segland_window_attention_attrs", [1, 0], "K6", names=("bias_bf16",))
    g = torch.Generator(device=dev).manual_seed(31)
    fwd_ms = fwd_bound = 0.0
    row = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)

    def check(tag, qkv, bias, nh, atol=2e-2, rtol=1e-2):
        got = window_attention(qkv, bias, nh).float()
        want = window_attention_reference(qkv, bias, nh).float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        bad = int((err > atol + rtol * want.abs()).sum())
        if bad or not bool(got.isfinite().all()):
            fail(f"{tag}: {bad} elements out of tolerance |d|<={atol}+{rtol}*|ref| "
                 f"(max_abs_err={float(err.max()):.6g})")
        return float(err.max())

    for si, (blocks, c, nh, _, pside) in enumerate(SWIN_STAGES):
        nw_img = (pside // 7) ** 2
        nw = BATCH * nw_img
        qkv = torch.randn(nw, 49, 3 * c, device=dev, generator=g).to(torch.bfloat16)
        rel = torch.randn(1, nh, 49, 49, device=dev, generator=g)
        mask = torch.from_numpy(_shift_attn_mask(pside, pside, 7, 3)).to(dev)
        biases = {"shared bf16": rel.to(torch.bfloat16), "shared fp32": rel,
                  "per-window+mask bf16": (rel + mask[:, None]).to(torch.bfloat16),
                  "per-window+mask fp32": rel + mask[:, None]}
        q, k, v = (t.reshape(nw, 49, nh, 32).transpose(1, 2) for t in qkv.split(c, dim=-1))
        for dt in (torch.bfloat16, torch.float32):
            print(f"K6 stage {si} NW={nw} C={c} plan bias={str(dt)[6:]}: "
                  f"shared {k6_plan_line(lib, nw, c, nh, 1, dt)}; per-window "
                  f"{k6_plan_line(lib, nw, c, nh, nw_img, dt)}", flush=True)
        times = {}
        for name in K6_BIASES:
            bias = biases[name]
            tag = f"K6 stage {si} NW={nw} C={c} heads={nh} bias={name} {tuple(bias.shape)}"
            err = check(tag, qkv, bias, nh)
            ms = queued_ms(lambda: window_attention(qkv, bias, nh))
            b_ms, b_by = bound(4 * nw * 49 * 49 * c,
                               nw * 49 * 4 * c * 2 + bias.numel() * bias.element_size())
            am = bias.to(torch.bfloat16)
            am = am if am.shape[0] == 1 else am.repeat(BATCH, 1, 1, 1)
            sdpa_ms = queued_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am))
            plain_ms = cuda_ms(lambda: window_attention_reference(qkv, bias, nh), iters=3)
            print(f"{tag}: max_abs_err={err:.6g} tol=|d|<=0.02+0.01*|ref| out_of_tol=0 "
                  f"ms={ms:.4f} bound_ms={b_ms:.4f} ({b_by}) share_of_bound={b_ms / ms:.3f} "
                  f"sdpa_ms={sdpa_ms:.4f} plain_ms={plain_ms:.4f}", flush=True)
            times[name] = (ms, b_ms)
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if si == 2 and name.endswith("bf16"):
                for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                 ("library_ms", sdpa_ms), ("bound_ms", b_ms)):
                    row[key] += val / 2
                row["bound_by"] = b_by
            del am
        for name in ("shared bf16", "per-window+mask bf16"):  # the model's two blocks
            ms, b_ms = times[name]
            fwd_ms += blocks / 2 * ms
            fwd_bound += blocks / 2 * b_ms
        if si == 2:  # ragged: no block total divides the items
            for nwr, nwi in ((803, 1), (3 * nw_img, nw_img)):
                qr = torch.randn(nwr, 49, 3 * c, device=dev, generator=g).to(torch.bfloat16)
                br = biases["shared bf16" if nwi == 1 else "per-window+mask bf16"]
                tag = f"K6 ragged NW={nwr} C={c} nW_img={nwi}"
                err = check(tag, qr, br, nh)
                print(f"{tag}: {k6_plan_line(lib, nwr, c, nh, nwi, torch.bfloat16)} "
                      f"max_abs_err={err:.6g} out_of_tol=0", flush=True)
        if si == 3:  # the fp32 body on fp32 windows
            tag = f"K6 fp32 NW={nw} C={c} heads={nh}"
            err = check(tag, qkv.float(), biases["per-window+mask fp32"], nh, 1e-4, 1e-4)
            print(f"{tag} bias=per-window+mask: max_abs_err={err:.6g} "
                  f"tol=|d|<=1e-4+1e-4*|ref| out_of_tol=0", flush=True)
            row["fp32_max_abs_err"] = err
        del qkv, q, k, v, biases
        torch.cuda.empty_cache()
    print(f"K6 a forward (2, 2, 18, 2 blocks, bf16 biases): {fwd_ms:.4f} ms "
          f"bound {fwd_bound:.4f} ms share_of_bound={fwd_bound / fwd_ms:.3f}", flush=True)
    row["forward_ms"], row["forward_bound_ms"] = fwd_ms, fwd_bound
    return row


def ulp_distance(got, want):
    """Steps between two bf16 tensors along the ordered line of bf16 values."""
    import torch

    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return (ordered(got) - ordered(want)).abs()


def compare_exact(tag, got, want, explain=None):
    """Integer sums are exact and the fp32 steps are the plain version's, so
    the bar is 1 bf16 ulp with no element outside; returns (max abs error,
    elements that are not bit-equal).  ``explain(index)`` adds what it knows
    about the farthest element to the failure."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(got.float().isfinite().all()):
        fail(f"{tag}: shape {tuple(got.shape)} or non-finite output")
    dist = ulp_distance(got, want)
    differ, outside = int((dist > 0).sum()), int((dist > 1).sum())
    err = float((got.float() - want.float()).abs().max())
    if outside:
        j = int(dist.view(-1).argmax())
        idx = [int(i) for i in torch.unravel_index(torch.tensor(j), got.shape)]
        fail(f"{tag}: {outside} elements more than 1 bf16 ulp from the plain version "
             f"({differ} not bit-equal); farthest at {idx}: got {float(got.view(-1)[j])} "
             f"want {float(want.view(-1)[j])}" + (f"; {explain(idx)}" if explain else ""))
    return err, differ


K8_SHAPES = ((512, 2048), (256, 1024))  # (P, C) of layer4 and layer3, as conv3_probe has them


def conv3_inputs(m, p, c, dev, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    ri = lambda *s: torch.randint(-127, 128, s, device=dev, generator=g, dtype=torch.int8)
    return dict(h2q=ri(m, p), res=torch.randn(m, c, device=dev, generator=g).bfloat16(),
                w3=ri(p, c), a3=torch.rand(c, device=dev, generator=g) * 1e-4 + 1e-5,
                b3=torch.randn(c, device=dev, generator=g) * 0.1)


K8_PHASES = ("wait", "wgmma", "res_wait", "epilogue")


def phase_k8(dev):
    """K8 at the probe's two shapes, M = 8*128^2 and 16*128^2, with and
    without the ReLU, and a ragged M; its builds' registers and spills, SASS
    IGMMA/UTMALDG counts and plan (the library's against conv3_plan); per
    shape its time beside the bound, torch._int_mm and the epilogue in torch
    each alone, and the clock build's phase split."""
    import torch
    from segland_tpu_torch.ops.fused_bottleneck import (conv3_plan, conv3_residual,
                                                        conv3_residual_clocks,
                                                        conv3_residual_reference,
                                                        library_conv3_plan)

    build_attrs("segland_conv3_residual_attrs", [(c, p) for p, c in K8_SHAPES], "K8",
                names=("C", "P"), kind="int8")
    sass_counts("conv3_residual_kernel", mma="IGMMA")
    out = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=None, not_bit_equal=0,
               int_mm_ms=0.0, int_mm_rowmajor_b_ms=0.0, epilogue_ms=0.0, by_shape={})
    bounds = []
    for i, (p, c) in enumerate(K8_SHAPES):
        plan, lib = conv3_plan(c, p), library_conv3_plan(c, p)
        print(f"K8 plan C={c} P={p}: {plan}; library {lib}", flush=True)
        if lib is None or any(lib[k] != plan[k] for k in lib):
            fail(f"K8 C={c} P={p}: the library's plan {lib} is not conv3_plan's {plan}")
        for m in (8 * 128 * 128, 16 * 128 * 128, 8 * 128 * 128 - 37):
            a = conv3_inputs(m, p, c, dev, 80 + i)
            args = (a["h2q"], a["res"], a["w3"], a["a3"], a["b3"])
            differ, err = 0, 0.0
            for relu in (True, False):
                e, n = compare_exact(f"K8 M={m} P={p} C={c} relu={relu}",
                                     conv3_residual(*args, last_relu=relu),
                                     conv3_residual_reference(*args, last_relu=relu))
                err = max(err, e)
                differ += n
            out["max_abs_err"] = max(out["max_abs_err"], err)
            out["not_bit_equal"] += differ
            ms = cuda_ms(lambda: conv3_residual(*args), iters=5, warmup=1)
            plain_ms = cuda_ms(lambda: conv3_residual_reference(*args), iters=3, warmup=1)
            w3t = a["w3"].t().contiguous()
            # the library side, one call at a time: cuBLASLt's int8 product with B
            # column-major (w3t.t(), its preferred operand) and row-major (w3 as
            # it is), then the epilogue in torch on its int32 result
            mm_ms = cuda_ms(lambda: torch._int_mm(a["h2q"], w3t.t()), iters=3, warmup=1)
            mm_row_ms = cuda_ms(lambda: torch._int_mm(a["h2q"], a["w3"]), iters=3, warmup=1)
            acc = torch._int_mm(a["h2q"], w3t.t())
            epi_ms = cuda_ms(lambda: torch.relu(acc.float() * a["a3"] + a["b3"]
                                                + a["res"].float()).bfloat16(),
                             iters=3, warmup=1)
            del acc
            # the card's practical stream rate here: a copy of the residual, read and written once
            copy_ms = cuda_ms(lambda: torch.empty_like(a["res"]).copy_(a["res"]), iters=3,
                              warmup=1)
            # h2q and res read and out written once, the weight and the vectors once
            b_ms, b_by = bound(2 * m * p * c, m * p + 2 * m * c * 2 + p * c + 8 * c, PEAK_INT8)
            sp = ""
            if m == 16 * 128 * 128:
                sp = " " + phase_split(lambda clk: conv3_residual_clocks(clk, *args), K8_PHASES,
                                       dev)
            print(f"K8 M={m} P={p} C={c}: max_abs_err={err:.6g} tol=1 bf16 ulp "
                  f"out_of_tol=0 not_bit_equal={differ} kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} int_mm_ms={mm_ms:.4f} "
                  f"int_mm_rowmajor_b_ms={mm_row_ms:.4f} epilogue_ms={epi_ms:.4f} "
                  f"bound_ms={b_ms:.4f} ({b_by}) share_of_bound={b_ms / ms:.3f} "
                  f"res_copy_ms={copy_ms:.4f} ({4 * m * c / copy_ms / 1e9:.2f} TB/s; "
                  f"K8 {(m * p + 4 * m * c) / ms / 1e9:.2f} TB/s){sp}", flush=True)
            out["by_shape"][f"M={m} P={p} C={c}"] = dict(
                ms=ms, bound_ms=b_ms, res_copy_ms=copy_ms, int_mm_ms=mm_ms,
                int_mm_rowmajor_b_ms=mm_row_ms, epilogue_ms=epi_ms, phase_split=sp.strip())
            if m == 16 * 128 * 128:  # the probe's own M: the kernel row sums its two shapes
                for k, v in (("ms", ms), ("plain_ms", plain_ms),
                             ("int_mm_ms", mm_ms), ("int_mm_rowmajor_b_ms", mm_row_ms),
                             ("epilogue_ms", epi_ms)):
                    out[k] += v
                bounds.append((b_ms, b_by))
            del a, args, w3t
            torch.cuda.empty_cache()
    out["bound_ms"], out["bound_by"] = sum_bounds(bounds)
    return out


# the 12 fused-eligible bottlenecks of resnet50 at output stride 8, a batch of 8 1024^2
# tiles: (blocks, side, C, P, dilation)
K7_LAYERS = ((2, 256, 256, 64, 1), (3, 128, 512, 128, 1), (5, 128, 1024, 256, 2),
             (2, 128, 2048, 512, 4))


def bottleneck_inputs(b, h, w, c, p, dev, seed):
    """Random int8 weights and affines sized so that h1 and h2 are of order 1
    and the activation scales 4/127 clip their tails."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    ri = lambda *s: torch.randint(-127, 128, s, device=dev, generator=g, dtype=torch.int8)
    rn = lambda *s: torch.randn(*s, device=dev, generator=g)
    aff = lambda n, k: ((0.5 + torch.rand(n, device=dev, generator=g)) / (k ** 0.5 * 30 * 73),
                        0.1 * rn(n))
    a1, b1 = aff(p, c)
    a2, b2 = aff(p, 9 * p)
    a3, b3 = aff(c, p)
    s = 4.0 / 127.0
    return (rn(b, h, w, c).bfloat16(), ri(c, p), ri(3, 3, p, p), ri(p, c), a1, b1, a2, b2, a3, b3,
            s, s, s)


def requant_margins(args, d, idx):
    """For output element idx = [b, y, x, c] of a bottleneck: how near each of
    the three requantizations that feed it comes to a rounding tie in the
    plain version (the least distance of value / scale from a half-integer,
    clipped values left out).  The step with a margin near 0 is the one a
    kernel can round the other way."""
    import torch

    x, w1, w2, w3, a1, b1, a2, b2, a3, b3, s_x, s_h1, s_h2 = args
    b, y, xx = idx[:3]
    crop = x[b:b + 1, max(0, y - d):y + d + 1, max(0, xx - d):xx + d + 1].float()
    cy, cx = y - max(0, y - d), xx - max(0, xx - d)
    from segland_tpu_torch.ops.int8 import int8_conv2d, quantize_sym

    def margin(t):
        t = t[t.abs() < 127.0]
        return float(((t - t.floor()) - 0.5).abs().min()) if t.numel() else float("inf")

    sc = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)
    t_x = crop / sc(s_x)
    h1 = torch.relu(int8_conv2d(quantize_sym(crop, sc(s_x)), w1.t()[None, None]).float() * a1 + b1)
    acc2 = int8_conv2d(quantize_sym(h1, sc(s_h1)), w2.permute(0, 1, 3, 2), padding=(d, d),
                       dilation=(d, d))
    h2 = torch.relu(acc2[:, cy, cx].float() * a2 + b2)
    return (f"margin to a rounding tie: x/s_x {margin(t_x):.2e}, h1/s_h1 "
            f"{margin(h1 / sc(s_h1)):.2e}, h2/s_h2 {margin(h2 / sc(s_h2)):.2e}")


def block_routes_ms(c, p, d, side, dev, seed):
    """One eligible Bottleneck of these widths as the model runs it, NCHW
    channels-last bf16, He-normal weights: unquantized, int8 conv by conv, and
    int8 through K7 (layout views and weight hand-over included).  Returns
    (bf16 ms, per-conv int8 ms, fused-route ms)."""
    import torch
    import torch.nn as nn
    from segland_tpu_torch.models.backbones.resnet import Bottleneck
    from segland_tpu_torch.quant import QuantConfig, calibrate, quantized_apply

    g = torch.Generator().manual_seed(seed)
    blk = Bottleneck(c, p, 1, d).eval()
    with torch.no_grad():
        for m in blk.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=g)
    blk = blk.to(dev)
    x = torch.randn(BATCH, c, side, side, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed)).bfloat16()
    x = x.contiguous(memory_format=torch.channels_last)
    quant = calibrate(blk, [x])
    per_conv = quantized_apply(blk)
    fused = quantized_apply(blk, QuantConfig(fused_blocks=True))
    with torch.inference_mode():
        return (cuda_ms(lambda: blk(x), iters=3, warmup=1),
                cuda_ms(lambda: per_conv(quant, x), iters=3, warmup=1),
                cuda_ms(lambda: fused(quant, x), iters=3, warmup=1))


def k7_plan_line(c, p, d):
    """K7's plan at these widths, from ops/fused_bottleneck.py:bottleneck_plan; fails
    unless the built library's plan (segland_bottleneck_int8_plan) is the same."""
    from segland_tpu_torch.ops.fused_bottleneck import bottleneck_plan, library_plan

    plan, lib = bottleneck_plan(c, p, d), library_plan(c, p, d)
    for stage, got in (lib or {}).items():
        if any(plan[stage][k] != v for k, v in got.items()):
            lib = None
    if lib is None:
        fail(f"K7 plan C={c} P={p} d={d}: the library's {library_plan(c, p, d)} is not "
             f"bottleneck_plan's {plan}")
    one, two = plan["conv1"], plan["conv23"]
    return (f"conv1 {one['rows']} rows x m64n{one['nw']} x {one['cg']}, ring {one['slots']} x "
            f"{one['slot']:,} B, smem {one['smem']:,}; conv23 tile {two['th']}x{two['tw']}, conv2 "
            f"{two['passes2']} x m64n{two['nw']}, conv3 {two['passes3']} x m64n{two['nw3']}, ring "
            f"{two['slots']} x {two['slot']:,} B, smem {two['smem']:,}")


K7_CONV1_PHASES = ("wait", "quantize", "wgmma", "epilogue")
K7_CONV23_PHASES = ("c2_wait", "c2_wgmma", "c2_epilogue", "c3_wait", "c3_wgmma", "c3_epilogue")
K7_RAGGED = ((37, 53, 256, 64, 1), (21, 19, 512, 128, 2), (9, 30, 1024, 256, 4),
             (13, 11, 2048, 512, 4), (5, 7, 192, 64, 2))


def phase_k7(dev):
    """K7 (conv1, then conv23) at the four layer shapes of resnet50 OS 8, batch 8,
    both last_relu, plus images that no tile divides; each kernel's registers,
    local memory, SASS and time."""
    import torch
    from segland_tpu_torch.ops.fused_bottleneck import (bottleneck_int8,
                                                        bottleneck_int8_reference,
                                                        bottleneck_operands, conv1_reference,
                                                        launch_conv1, launch_conv23)

    keys = sorted({(c, p) for _, _, c, p, _ in K7_LAYERS} | {(c, p) for *_, c, p, _ in K7_RAGGED})
    for stage in ("conv1", "conv23"):
        build_attrs(f"segland_bottleneck_{stage}_attrs", keys, f"K7 {stage}", ("C", "P"),
                    kind="int8")
        sass_counts(f"bottleneck_{stage}_kernel", mma="IGMMA")
    out = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=None, not_bit_equal=0,
               conv1_ms=0.0, conv23_ms=0.0, bf16_block_ms=0.0, per_conv_int8_ms=0.0,
               fused_route_ms=0.0)
    bounds = []
    for i, (blocks, side, c, p, d) in enumerate(K7_LAYERS):
        plan = k7_plan_line(c, p, d)
        args = bottleneck_inputs(BATCH, side, side, c, p, dev, 90 + i)
        differ = 0
        for relu in (True, False):
            e, n = compare_exact(
                f"K7 side={side} C={c} P={p} d={d} relu={relu}",
                bottleneck_int8(*args, dilation=d, last_relu=relu),
                bottleneck_int8_reference(*args, dilation=d, last_relu=relu),
                explain=lambda idx: requant_margins(args, d, idx))
            out["max_abs_err"] = max(out["max_abs_err"], e)
            differ += n
        out["not_bit_equal"] += differ
        ms = cuda_ms(lambda: bottleneck_int8(*args, dilation=d), iters=5, warmup=1)
        plain_ms = cuda_ms(lambda: bottleneck_int8_reference(*args, dilation=d), iters=2, warmup=1)
        # each kernel alone, on operands handed over once
        x, w1, w2, w3, a1, b1, a2, b2, a3, b3, s_x, s_h1, s_h2 = args
        w1t, w2t, w3t, (va1, vb1, va2, vb2, va3, vb3) = bottleneck_operands(
            x, w1, w2, w3, a1, b1, a2, b2, a3, b3, dilation=d)
        h1q = torch.empty(*x.shape[:3], p, dtype=torch.int8, device=dev)
        launch_conv1(x, w1t, va1, vb1, s_x, s_h1, h1q)
        if not torch.equal(h1q, conv1_reference(x, w1, a1, b1, s_x, s_h1)):
            fail(f"K7 conv1 side={side} C={c} P={p}: h1q differs from conv1_reference")
        y = torch.empty_like(x)
        ms1 = cuda_ms(lambda: launch_conv1(x, w1t, va1, vb1, s_x, s_h1, h1q), iters=5, warmup=1)
        ms23 = cuda_ms(lambda: launch_conv23(h1q, x, w2t, w3t, va2, vb2, va3, vb3, s_h2, d, True,
                                             y), iters=5, warmup=1)
        split1 = phase_split(lambda clk: launch_conv1(x, w1t, va1, vb1, s_x, s_h1, h1q, clk),
                             K7_CONV1_PHASES, dev)
        split23 = phase_split(lambda clk: launch_conv23(h1q, x, w2t, w3t, va2, vb2, va3, vb3, s_h2,
                                                        d, True, y, clk), K7_CONV23_PHASES, dev)
        m = BATCH * side * side
        ops1, ops23 = 2 * m * c * p, 2 * m * (9 * p * p + p * c)
        # x read and out written once, the three weights and the vectors once
        b_ms, b_by = bound(ops1 + ops23,
                           2 * m * c * 2 + 2 * c * p + 9 * p * p + 16 * p + 8 * c, PEAK_INT8)
        print(f"K7 {BATCH}x{side}x{side} C={c} P={p} d={d}: {plan}", flush=True)
        print(f"K7 {BATCH}x{side}x{side} C={c} P={p} d={d}: max_abs_err={out['max_abs_err']:.6g} "
              f"tol=1 bf16 ulp out_of_tol=0 not_bit_equal={differ} kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"tops={1e-9 * (ops1 + ops23) / ms:.1f}; conv1_ms={ms1:.4f} "
              f"(tops={1e-9 * ops1 / ms1:.1f}) conv23_ms={ms23:.4f} "
              f"(tops={1e-9 * ops23 / ms23:.1f}) h1q_round_trip_bytes={2 * m * p}", flush=True)
        print(f"K7 {BATCH}x{side}x{side} C={c} P={p} d={d}: conv1 {split1}; conv23 {split23}",
              flush=True)
        out["ms"] += blocks * ms
        out["plain_ms"] += blocks * plain_ms
        out["conv1_ms"] += blocks * ms1
        out["conv23_ms"] += blocks * ms23
        bounds += [(b_ms, b_by)] * blocks
        del args, x, w1t, w2t, w3t, h1q, y
        torch.cuda.empty_cache()
        # the same block as the model runs it: what decides the --fused default
        bf16_ms, conv_ms, route_ms = block_routes_ms(c, p, d, side, dev, 110 + i)
        print(f"K7 {BATCH}x{side}x{side} C={c} P={p} d={d} as a Bottleneck module: "
              f"bf16_unquantized_ms={bf16_ms:.4f} int8_per_conv_ms={conv_ms:.4f} "
              f"int8_fused_route_ms={route_ms:.4f}", flush=True)
        out["bf16_block_ms"] += blocks * bf16_ms
        out["per_conv_int8_ms"] += blocks * conv_ms
        out["fused_route_ms"] += blocks * route_ms
        torch.cuda.empty_cache()
    # tiles on all four borders of an image that no tile divides, every dilation
    for j, (h, w, c, p, d) in enumerate(K7_RAGGED):
        args = bottleneck_inputs(3, h, w, c, p, dev, 100 + j)
        e, n = compare_exact(f"K7 ragged {h}x{w} C={c} P={p} d={d}",
                             bottleneck_int8(*args, dilation=d, last_relu=bool(j % 2)),
                             bottleneck_int8_reference(*args, dilation=d, last_relu=bool(j % 2)))
        out["max_abs_err"] = max(out["max_abs_err"], e)
        out["not_bit_equal"] += n
        print(f"K7 ragged 3x{h}x{w} C={c} P={p} d={d}: max_abs_err={e:.6g} out_of_tol=0 "
              f"not_bit_equal={n}; {k7_plan_line(c, p, d)}", flush=True)
    out["bound_ms"], out["bound_by"] = sum_bounds(bounds)
    print(f"K7 per forward of {BATCH} tiles (12 blocks): kernel_ms={out['ms']:.4f} "
          f"(conv1 {out['conv1_ms']:.4f} + conv23 {out['conv23_ms']:.4f}) "
          f"plain_ms={out['plain_ms']:.4f} bound_ms={out['bound_ms']:.4f} ({out['bound_by']}); "
          f"as Bottleneck modules: bf16_unquantized_ms={out['bf16_block_ms']:.4f} "
          f"int8_per_conv_ms={out['per_conv_int8_ms']:.4f} "
          f"int8_fused_route_ms={out['fused_route_ms']:.4f}", flush=True)
    return out


def synthetic_batches():
    rng = np.random.RandomState(0)
    out = []
    for i in range(N_BATCHES):
        imgs = rng.randint(0, 256, (BATCH, TILE, TILE, 3)).astype(np.uint8)
        labels = rng.randint(0, 12, (BATCH, TILE, TILE)).astype(np.uint8)
        labels[:, :16] = 255
        out.append((imgs, labels, [f"tile_{i}_{j}" for j in range(BATCH)]))
    return out


@contextlib.contextmanager
def environ(**env):
    """The JAX package's route switches (SEGLAND_SWIN_V3_STAGES, read when the
    model is built; SEGLAND_SWIN_WR, read at every forward), set for a while."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def build(name, dtype, seed=0, fused=True, is_ft=False, attn_group=1, backbone=None):
    """convnext_pop/convnext-t, swin_pop/swin-s, seghr_pop/hr-w32 or a model of
    HEADS at its default backbone (or ``backbone``) with seeded random weights, drawn so that
    every block's kernel reaches the output (seghr_pop: so that its branches
    stay O(1); the ResNet pair as build_resnet draws its trunk)."""
    import torch
    import torch.nn as nn
    from segland_tpu_torch.models import build_model
    from segland_tpu_torch.models.backbones.convnext import ConvNeXtBlock
    from segland_tpu_torch.models.backbones.hrnet import (BasicBlock, HighResolutionModule,
                                                          StemBottleneck)
    from segland_tpu_torch.models.backbones.swin import SwinBlock, SwinTransformer
    from segland_tpu_torch.ops import pop as pop_ops

    g = torch.Generator().manual_seed(seed)
    model = build_model(name, backbone, n_base=7, n_novel=4 if is_ft else 0, is_ft=is_ft,
                        fused_mlp=fused, fused_attn=fused, dtype=dtype, generator=g)
    with torch.no_grad():
        for blk in model.modules():
            if isinstance(blk, ConvNeXtBlock):
                # the init's 1e-6 layer-scale would hide every block's MLP from the output
                blk.gamma.copy_(torch.empty_like(blk.gamma).uniform_(0.1, 0.5, generator=g))
            elif isinstance(blk, SwinBlock):
                # the init's 0.02-scale rel-pos table makes every softmax near-uniform;
                # these draws also keep every branch well above the residual's rounding
                for m in blk.modules():
                    if isinstance(m, nn.Linear):
                        m.weight.normal_(0.0, m.in_features ** -0.5, generator=g)
                        m.bias.normal_(0.0, 0.1, generator=g)
                    elif isinstance(m, nn.LayerNorm):
                        m.weight.uniform_(0.5, 1.5, generator=g)
                        m.bias.normal_(0.0, 0.1, generator=g)
                blk.attn.relative_position_bias_table.normal_(0.0, 1.0, generator=g)
            elif isinstance(blk, (BasicBlock, StemBottleneck)):
                # the init's unit BatchNorm lets HRNet's residual and fuse sums grow to ~2e3
                # over its 8 modules (fp32 logits ~40); a residual branch's last BatchNorm
                # at 0.3 and the fuse lattice's at 0.5 keep the branches about 1
                (blk.bn2 if isinstance(blk, BasicBlock) else blk.bn3).weight.mul_(0.3)
            elif isinstance(blk, HighResolutionModule):
                for m in blk.fuse_layers.modules():
                    if isinstance(m, nn.BatchNorm2d):
                        m.weight.mul_(0.5)
        if model.backbone_name.startswith("resnet"):
            tame_resnet(model, g)
        if name in (SEGHR,) + HEADS_POP or backbone in SWIN_BL_STAGES:
            # the classifiers spread as train_step_model spreads them (logits about 1), and
            # the prototypes made orthogonal to the mean feature as build_resnet makes them,
            # so that the classes compete pixel by pixel instead of background taking all
            # (as drawn, swin-b's and swin-l's maps were one class nearly everywhere)
            for conv in model.classifier:
                if isinstance(conv, nn.Conv2d):
                    conv.weight.normal_(0.0, 2.0 * conv.in_channels ** -0.5, generator=g)
            mean = model.extract_features(torch.randn(1, 3, 128, 128, generator=g)).mean(
                dim=(0, 1, 2))
            unit = mean / mean.norm()
            for emb in [model.base_emb] + ([model.novel_emb] if is_ft else []):
                emb.sub_((emb @ unit)[:, None] * unit)
            if float(pop_ops.classifier_apply(mean, *model.classifier.weights())) > 0:
                model.classifier[4].weight.neg_()
            if is_ft and backbone in SWIN_BL_STAGES:
                # forward_all scores the background and the novel classes by classifier_n:
                # left at its init, one class took 97% of swin-b's eval_ft map
                for conv in model.classifier_n:
                    if isinstance(conv, nn.Conv2d):
                        conv.weight.normal_(0.0, 2.0 * conv.in_channels ** -0.5, generator=g)
                if float(pop_ops.classifier_apply(mean, *model.classifier_n.weights())) > 0:
                    model.classifier_n[4].weight.neg_()
    if attn_group != 1:
        # no CLI switch and no registry argument has it, as in the JAX package: the same
        # swin-s (or ``backbone``) backbone and weights through the constructor's own argument
        stages = SWIN_BL_STAGES.get(backbone, SWIN_STAGES)
        grouped = SwinTransformer(
            depths=tuple(s[0] for s in stages), num_heads=tuple(s[2] for s in stages),
            embed_dim=stages[0][1], fused_mlp=fused, fused_attn=fused,
            attn_group=attn_group, dtype=dtype)
        grouped.load_state_dict(model.backbone.state_dict())
        model.backbone = grouped.eval()
    return model


COUNTED = ("ln_mlp", "upsample_argmax", "attn_section", "window_attention", "swin_block",
           "attn_section_v1", "bottleneck_int8", "conv3_residual", "hg_section", "hg2_section",
           "section")


def counters():
    from segland_tpu_torch.ops.fused_attn import (attn_section, attn_section_v1, swin_block,
                                                  window_attention)
    from segland_tpu_torch.ops.fused_bottleneck import bottleneck_int8, conv3_residual
    from segland_tpu_torch.ops.fused_epilogue import upsample_argmax
    from segland_tpu_torch.ops.fused_mlp import ln_mlp
    from segland_tpu_torch.ops.hg_attn import hg2_section, hg_section
    from segland_tpu_torch.ops.section_variants import section

    return dict(zip(COUNTED, (ln_mlp, upsample_argmax, attn_section, window_attention,
                              swin_block, attn_section_v1, bottleneck_int8, conv3_residual,
                              hg_section, hg2_section, section)))


def counted(fn):
    """fn() with every launch count set to 0 just before and read just after."""
    fns = counters()
    for f in fns.values():
        f.launches = 0
    fns["ln_mlp"].rows = 0
    result = fn()
    return result, {k: f.launches for k, f in fns.items() if f.launches}


def counted_run(ev, batches, **kw):
    return counted(lambda: ev.run(batches, **kw))


def phase_slice(dev, name, want_per_batch, is_ft=False, fp32_check=True, route="",
                attn_group=1, k1_rows=None, n_batches=N_BATCHES, backbone=None,
                max_class_share=None, near_tie=None):
    """One model through Evaluator.run over ``n_batches`` batches: the kernel
    path (launch counts, mIoU, tiles/s, max_memory_allocated), the same batches
    with the kernels' plain versions, and an fp32 forward on the card against
    the CPU.  The caller sets the environment switches of ``route``;
    ``attn_group`` goes to the swin backbone, ``backbone`` names a backbone
    other than the model's default.  ``k1_rows``: the rows K1 must have been
    given per batch, which tells a window-resident stage (every token of the
    padded windows) from a spatial one; ``max_class_share``: the most that one
    class may take of the kernel route's map (an agreement over a map of one
    class would say nothing).  With ``near_tie`` the agreement held is over
    the pixels whose top-2 gap in the plain route's logits exceeds it (the
    agreement over all pixels is printed), and one batch through the fp32
    stock-torch route on the card, same weights, is the yardstick of both bf16
    routes: the kernel route may agree with it on at most FP32_ROUTE_MARGIN
    fewer pixels than the plain route does."""
    import torch
    from segland_tpu_torch.evallib import Evaluator

    tag = (f"{name}{' ' + backbone if backbone else ''}{' ft' if is_ft else ''}"
           f"{' ' + route if route else ''}")
    k = 12 if is_ft else 8
    model = build(name, torch.bfloat16, is_ft=is_ft, attn_group=attn_group,
                  backbone=backbone).to(dev)
    batches = synthetic_batches()[:n_batches]
    kw = dict(num_classes=12, n_base=7, normalize_on_device=True)
    run_kw = dict(square_pad_eval=is_ft)
    ev = Evaluator(model, dev, **kw)
    ev.run(batches, **run_kw)  # warm-up: cuDNN plans, device and pinned-host allocators
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (cm, (base, novel, total, _), tps), launches = counted_run(ev, batches, **run_kw)
    peak = torch.cuda.max_memory_allocated()
    rows = counters()["ln_mlp"].rows
    print(f"slice {tag}: bf16 fused, {n_batches}x{BATCH} tiles {TILE}^2: launches={launches} "
          f"k1_rows={rows} mIoU base={base:.4f} total={total:.4f} tiles_per_s={tps:.2f} "
          f"pixels={int(cm.sum())} max_memory_allocated={peak / 2**30:.2f} GiB", flush=True)
    want = {key: n * n_batches for key, n in want_per_batch.items()}
    if launches != want:
        fail(f"slice {tag} launch counts {launches}, want {want}")
    if k1_rows is not None and rows != k1_rows * n_batches:
        fail(f"slice {tag}: K1 was given {rows} rows, want {k1_rows * n_batches}")
    if int(cm.sum()) != n_batches * BATCH * (TILE - 16) * TILE:
        fail("confusion matrix does not count every labelled pixel")

    ev_plain = Evaluator(model, dev, plain_kernels=True, **kw)
    ev_plain.run(batches, **run_kw)
    (cm_p, (base_p, _, total_p, _), tps_p), plain_launches = counted_run(
        ev_plain, batches, **run_kw)
    if plain_launches:
        fail(f"the plain run launched a kernel: {plain_launches}")
    agree = n = 0
    for imgs, _, _ in batches[:1]:
        logits, pred = ev.predict_batch(imgs, (TILE, TILE), want_logits=True)
        if logits.shape != (BATCH, TILE, TILE, k) or not bool(logits.isfinite().all()):
            fail(f"slice {tag} logits {tuple(logits.shape)} not finite (B,{TILE},{TILE},{k})")
        _, pk = ev.predict_batch(imgs, (TILE, TILE), want_logits=False)
        top2 = logits.topk(2, dim=-1).values
        if int(((pk != pred) & (top2[..., 0] - top2[..., 1] > 1e-3)).sum()):
            fail("fused epilogue and the logits path disagree beyond near-ties")
        del logits, top2, pred
    counts = torch.zeros(k, dtype=torch.long)
    agree_far = n_far = 0
    for imgs, _, _ in batches:
        _, pk = ev.predict_batch(imgs, (TILE, TILE), want_logits=False)
        lp, pp = ev_plain.predict_batch(imgs, (TILE, TILE), want_logits=near_tie is not None)
        agree += int((pk == pp).sum())
        n += pp.numel()
        counts += torch.bincount(pk.flatten().long().cpu(), minlength=k)[:k]
        if near_tie is not None:
            top2 = lp.topk(2, dim=-1).values
            far = top2[..., 0] - top2[..., 1] > near_tie
            agree_far += int(((pk == pp) & far).sum())
            n_far += int(far.sum())
            del lp, top2, far
    frac, share = agree / n, float(counts.max()) / n
    held = frac if near_tie is None else agree_far / n_far
    beyond = "" if near_tie is None else (
        f" beyond_near_ties(gap>{near_tie}: {n_far / n:.4f} of pixels)={held:.6f}")
    print(f"slice {tag} plain versions on the card: mIoU base={base_p:.4f} "
          f"total={total_p:.4f} tiles_per_s={tps_p:.2f} argmax_agreement={frac:.6f}{beyond} "
          f"dmIoU_total={abs(total - total_p):.6f} top_class_share={share:.4f}", flush=True)
    if held < 0.99:
        fail(f"slice {tag}: kernel vs plain argmax agreement {held:.4f} < 0.99")
    if max_class_share is not None and share > max_class_share:
        fail(f"slice {tag}: one class takes {share:.4f} of the map (> {max_class_share})")
    if near_tie is not None:
        # the fp32 stock-torch blocks on the card, the same weights, TF32 off
        m32 = build(name, torch.float32, fused=False, is_ft=is_ft, backbone=backbone)
        m32.load_state_dict(model.state_dict())
        ev32 = Evaluator(m32.to(dev), dev, plain_kernels=True, **kw)
        imgs = batches[0][0]
        _, pf = ev32.predict_batch(imgs, (TILE, TILE), want_logits=False)
        _, pk = ev.predict_batch(imgs, (TILE, TILE), want_logits=False)
        _, pp = ev_plain.predict_batch(imgs, (TILE, TILE), want_logits=False)
        kf, pf_ = float((pk == pf).float().mean()), float((pp == pf).float().mean())
        print(f"slice {tag} against the fp32 stock-torch route (1 batch): kernel route "
              f"{kf:.6f}, plain versions {pf_:.6f}", flush=True)
        if kf < pf_ - FP32_ROUTE_MARGIN:
            fail(f"slice {tag}: the kernel route agrees with fp32 on {kf:.6f}, the plain "
                 f"versions on {pf_:.6f}")
        del m32, ev32

    if fp32_check:
        # fp32 on the card (the fp32 kernel builds) vs the CPU's plain versions, small input
        m32 = build(name, torch.float32, seed=1, is_ft=is_ft, attn_group=attn_group,
                    backbone=backbone)
        x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(2))
        with torch.inference_mode():
            want32 = m32(x)
            got32 = m32.to(dev)(x.to(dev)).cpu()
        err = float((got32 - want32).abs().max())
        print(f"slice {tag} fp32 2x64x64 card vs CPU: max_abs_err={err:.6g} tol=1e-3",
              flush=True)
        if not err <= 1e-3:
            fail(f"slice {tag}: fp32 forward on the card disagrees with the CPU")
    return launches, tps, tps_p


TRAIN_BATCH, TRAIN_CROP, TRAIN_TILES, VAL_TILES, TRAIN_EPOCHS = 4, 768, 16, 4, 2
TRAIN_BLOCK = 64  # the side of a tile's blocks of one colour and one class
# the models the train phase trains, and the launches of one forward (a train step's, none
# in its backward, or a validation batch's)
TRAIN_MODELS = {"convnext_pop": {"ln_mlp": 18}, "swin_pop": {"ln_mlp": 24, "attn_section": 24}}
# The fp32 bodies of K1 and K3 sum in order, one FMA a term, where cuBLAS blocks its sums:
# over K1's longest reduction (4C = 3072 terms at C = 768) that rounds a feature by about
# sqrt(3072) * 2^-24 = 3.3e-6 of its terms.  The ft head's gradients are well conditioned (no
# cancellation, unlike base training's deep ones), so the stock-torch blocks (cuBLAS, as the
# plain versions) sit within 1e-6 of the plain route and this rounding sets the kernels'
# distance: three times it is the fp32 bar's floor in the ft step.
FP32_SUM_FLOOR = 3 * math.sqrt(4 * 768) * 2.0 ** -24
# Models whose fp32 step check (hold_steps' ``perturbed``) holds the kernel route to the
# farthest of three correct routes: the stock-torch blocks, and the plain route on the image
# scaled by 1 + FP32_SUM_FLOOR and by 1 - FP32_SUM_FLOOR, a perturbation of the size by which
# the kernels' fp32 bodies round a block's output away from cuBLAS's.  swin_pop's decoder
# follows conv biases and each PSP stage's pooled map (1x1 at the coarsest: BatchNorm over the
# batch's 4 values) with a BatchNorm in train mode, so some of its gradients are sums that
# cancel almost to nothing, and the stock-torch blocks, whose rounding is cuBLAS's as the
# plain route's is, understate how far rounding moves them.
TRAIN_PERTURBED = ("swin_pop",)
PERTURBED = {"plain x(1+e)": 1 + FP32_SUM_FLOOR, "plain x(1-e)": 1 - FP32_SUM_FLOOR}


def write_train_tiles(root):
    """TRAIN_TILES + VAL_TILES uint8 RGB 1024^2 GeoTIFF tiles and their labels,
    written by the port's own TIFF writer (this machine has no PIL).  A tile is
    TRAIN_BLOCK^2 blocks of one random colour each, and a block's label is its
    red channel's octile (0..7), 255 in a band: a class covers 16 x 16 pixels
    of the stride-4 output, so the network can learn it and the loss fall
    (labels of per-pixel noise leave the loss at ln 8 whatever the weights)."""
    from segland_tpu_torch.data.geotiff import write_tiff

    rng = np.random.RandomState(0)
    ids = [f"tile_{i}" for i in range(TRAIN_TILES + VAL_TILES)]
    for d in ("images", "labels", "list"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for tid in ids:
        blocks = rng.randint(0, 256, (TILE // TRAIN_BLOCK, TILE // TRAIN_BLOCK, 3))
        img = blocks.repeat(TRAIN_BLOCK, 0).repeat(TRAIN_BLOCK, 1).astype(np.uint8)
        lab = (img[..., 0] // 32).astype(np.uint8)
        lab[:, :TILE // 16] = 255
        write_tiff(os.path.join(root, "images", tid + ".tif"), img)
        write_tiff(os.path.join(root, "labels", tid + ".tif"), lab)
    with open(os.path.join(root, "list", "train.txt"), "w") as f:
        f.write("\n".join(ids[:TRAIN_TILES]) + "\n")
    with open(os.path.join(root, "list", "val.txt"), "w") as f:
        f.write("\n".join(ids[TRAIN_TILES:]) + "\n")


def loss_of(name):
    """The train step's loss for model ``name``, as cli.train_base picks it:
    the orth loss of the POP heads, CE (with the aux head) otherwise."""
    return "orth" if "pop" in name else "ce"


def train_step_grads(model, img, mask, loss="orth"):
    """One train step of ``make_base_train_step`` at LR 0 and without a clip,
    so the gradients it leaves in .grad are the raw ones and the weights stay:
    (loss dict, {name: grad})."""
    from segland_tpu_torch.train import TrainState, create_optimizer, make_base_train_step

    state = TrainState(model, create_optimizer(model, 0.0, 1, 1, clip=None))
    ld, _ = make_base_train_step(model, loss)(state, img, mask)
    return ld, {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _cos_err(a, b):
    """1 - cosine of two gradients (fp64)."""
    a, b = a.double().flatten(), b.double().flatten()
    return 1.0 - float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))


def _rel_err(a, b):
    """|a - b| / |b| of two gradients (fp64)."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


# shift_invariant's bar: the loss's move, relative, under a shift of a parameter it does not see
SHIFT_INVARIANT_RTOL = 1e-6
_SHIFT_INVARIANT = {}  # name: shift_invariant's set, drawn once a run


def shift_invariant(name, dev):
    """The names of the parameters of POP model ``name`` (train_step_model's
    fp32 draw) whose train-step gradient is zero in exact arithmetic: those the step's
    total loss moves by at most SHIFT_INVARIANT_RTOL of itself when every
    element is shifted by a draw of N(0, (mean |value| + 1)^2), the others
    kept (the plain route, TRAIN_BATCH random crops of TRAIN_CROP / 4, the
    step's mask generator).  In swin_pop these are the decoder's conv biases
    and the last stage's LayerNorm bias (convnext_pop has none): every path
    from them to the loss runs through a conv and a train-mode BatchNorm,
    which takes a per-channel shift away, so what any route leaves in their
    gradient is rounding alone (its direction is noise: 1 - cosine anywhere in
    [0, 2]), and none of those paths runs through a kernel.  Prints the
    largest relative move among them and the smallest among the others."""
    import torch
    from segland_tpu_torch.losses import orth_loss
    from segland_tpu_torch.models.backbones.droppath import dropout_generator, step_seed
    from segland_tpu_torch.ops import plain_versions

    if name in _SHIFT_INVARIANT:
        return _SHIFT_INVARIANT[name]
    model = train_step_model(torch.float32, name=name).to(dev).train()
    g = torch.Generator().manual_seed(7)
    crop = TRAIN_CROP // 4
    img = torch.randn(TRAIN_BATCH, crop, crop, 3, generator=g).to(dev).permute(0, 3, 1, 2)
    mask = torch.randint(0, 8, (TRAIN_BATCH, crop, crop), generator=g).to(dev)

    def loss():
        gen = torch.Generator(device=dev).manual_seed(step_seed(0, 0))
        with torch.no_grad(), plain_versions(), dropout_generator(gen):
            logits, sim = model.forward_base(img, train=True)
            return float(orth_loss(logits.permute(0, 2, 3, 1), mask, sim)["total_loss"])

    base = loss()
    moves = []
    for n, p in model.named_parameters():
        kept = p.detach().clone()
        with torch.no_grad():
            p.add_(torch.randn(p.shape, generator=g).to(dev) * (p.abs().mean() + 1))
        move = abs(loss() - base) / abs(base)
        moves.append((move if math.isfinite(move) else math.inf, n))
        with torch.no_grad():
            p.copy_(kept)
    del model
    torch.cuda.empty_cache()
    zero = frozenset(n for m, n in moves if m <= SHIFT_INVARIANT_RTOL)
    inside = max(((m, n) for m, n in moves if n in zero), default=(0.0, "none"))
    outside = min(((m, n) for m, n in moves if n not in zero), default=(math.inf, "none"))
    print(f"shift-invariant parameters of {name}: {len(zero)} of {len(moves)} "
          f"({', '.join(sorted(zero))}); the loss's largest relative move among them "
          f"{inside[0]:.3g} ({inside[1]}), the smallest among the others {outside[0]:.3g} "
          f"({outside[1]}); bar {SHIFT_INVARIANT_RTOL:g}", flush=True)
    _SHIFT_INVARIANT[name] = zero
    return zero


def hold_zero_grads(tag, zero, grads, plain):
    """The shift_invariant gradients ``zero`` of a route (``grads``) against
    the plain route's (``plain``): finite, and exactly zero where the plain
    route's is (a branch no path reaches: a DropPath mask that drops it for
    every crop)."""
    import torch

    for n in sorted(zero):
        g = grads[n]
        if not bool(torch.isfinite(g).all()):
            fail(f"{tag}: gradient of {n} (shift-invariant) not finite")
        if not bool(plain[n].any()) and bool(g.any()):
            fail(f"{tag}: gradient of {n} (shift-invariant) non-zero where the plain route's is 0")


def train_step_model(dtype, fused=True, name="convnext_pop", is_ft=False):
    """chip_smoke's draw of ``name`` (convnext by default) with the POP
    classifier's three 1x1 convs drawn at 2 / sqrt(fan-in): their init
    (torch's Conv2d default, as the JAX package's) leaves the logits within
    about 0.03 of each other, so the loss sits at ln K whatever the features
    are; at this scale they spread by about 1 and the loss reads the
    network."""
    import torch

    model = build(name, dtype, seed=3, fused=fused, is_ft=is_ft)
    g = torch.Generator().manual_seed(5)
    head = model.classifier  # the plain pspnet's is one linear conv
    with torch.no_grad():
        for conv in head if isinstance(head, torch.nn.Sequential) else [head]:
            if isinstance(conv, torch.nn.Conv2d):
                conv.weight.normal_(0.0, 2.0 * conv.in_channels ** -0.5, generator=g)
    return model


def check_train_steps(dev, name="convnext_pop"):
    """One train step of ``name`` with the kernels and one inside
    ops.plain_versions(), from the same weights (train_step_model) and batch
    (768^2 x 4): the seg loss, and every parameter's gradient.  The step draws
    its DropPath and dropout masks (swin_pop) from the generator of (seed 0,
    step 0) on the card, so every route draws the same masks.  Each route's
    seg loss must stand at least 0.1 above ln 8, its value for flat logits,
    so that the loss check sees the network's output.  A gradient deep in the
    network sums many terms that cancel (the stem's over every pixel of a
    random image), so rounding anywhere above it moves it by far more than the
    rounding itself; each route is held to what another correct route does.
    fp32 (TF32 off): the kernel route's relative error from the plain route,
    per tensor, at most twice the stock-torch blocks' (--no-fused: torch's
    LayerNorm, cuBLAS linears, GELU, softmax) plus 1e-6; for a model of
    TRAIN_PERTURBED twice the farthest of the stock-torch blocks and the
    plain route on the image scaled by 1 + FP32_SUM_FLOOR and 1 -
    FP32_SUM_FLOOR.  bf16: both routes against the fp32 plain route's
    gradient, the kernel route's 1 - cosine at most twice the bf16 plain
    route's plus 1e-4.  Prints the worst tensor of each.  The kernel step
    must launch exactly the model's kernels of one forward (TRAIN_MODELS),
    none in the backward."""
    import torch
    from segland_tpu_torch.ops import plain_versions

    g = torch.Generator().manual_seed(4)
    img = torch.randn(TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 3, generator=g).to(dev)
    mask = torch.randint(0, 8, (TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP), generator=g).to(dev)
    want = TRAIN_MODELS[name]
    runs = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = train_step_model(dtype, name=name).to(dev)
        runs[dtype, "kernels"], launches = counted(lambda: train_step_grads(model, img, mask))
        if launches != want:
            fail(f"train step {name} ({dtype}) launch counts {launches}, want {want}")
        with plain_versions():
            runs[dtype, "plain"] = train_step_grads(model, img, mask)
            if dtype == torch.float32 and name in TRAIN_PERTURBED:
                for route, f in PERTURBED.items():
                    runs[dtype, route] = train_step_grads(model, img * f, mask)
        del model
        if dtype == torch.float32:
            model = train_step_model(dtype, fused=False, name=name).to(dev)
            runs[dtype, "unfused"] = train_step_grads(model, img, mask)
            del model
        torch.cuda.empty_cache()
    tag = f"train step{'' if name == 'convnext_pop' else ' ' + name} {TRAIN_BATCH}x{TRAIN_CROP}^2"
    hold_steps(tag, runs, 8, perturbed=name in TRAIN_PERTURBED, zero=shift_invariant(name, dev))


def hold_steps(tag, runs, k, flat_check=True, fp32_floor=1e-6, perturbed=False,
               zero=frozenset()):
    """check_train_steps' bars over ``runs`` {(dtype, route): (loss dict,
    {name: grad}, ...)}, routes kernels, plain and (fp32) unfused, with
    ``fp32_floor`` the fp32 bar's additive term; ``k`` classes, so that ln k is
    the seg loss of flat logits, which each route's must stand 0.1 above where
    ``flat_check``.  With ``perturbed``, runs also holds the fp32 PERTURBED
    routes, and the fp32 bar of a tensor is twice the largest of the three
    correct routes' relative errors (the stock-torch blocks and the two
    PERTURBED) plus ``fp32_floor``.  The gradients named in ``zero``
    (shift_invariant: zero in exact arithmetic, rounding alone on every route)
    are held by hold_zero_grads instead."""
    import torch

    ref = runs[torch.float32, "plain"][1]
    correct = ["unfused"] + (list(PERTURBED) if perturbed else [])
    errs = {r: {n: _rel_err(runs[torch.float32, r][1][n], ref[n]) for n in ref} for r in correct}
    for dtype in (torch.float32, torch.bfloat16):
        (ld_k, gk), (ld_p, gp) = runs[dtype, "kernels"][:2], runs[dtype, "plain"][:2]
        worst, largest = (-1.0, "", ""), (-1.0, "", "")
        hold_zero_grads(f"{tag} {dtype}", zero, gk, gp)
        for n in gp:
            if n in zero:
                continue
            if dtype == torch.float32:
                ek, eu = _rel_err(gk[n], gp[n]), max(errs[r][n] for r in correct)
                margin = ek - (2 * eu + fp32_floor)
                text = (f"relative error from the plain route: kernels {ek:.3g}, "
                        + ", ".join(f"{r} {errs[r][n]:.3g}" for r in correct)
                        + f" (bar 2 x the largest + {fp32_floor:.3g})")
            else:
                ek, ep = _cos_err(gk[n], ref[n]), _cos_err(gp[n], ref[n])
                margin = ek - (2 * ep + 1e-4)
                text = (f"1-cos vs fp32: kernels {ek:.3g}, plain {ep:.3g} (bar 2 x plain + 1e-4); "
                        f"1-cos kernels vs plain {_cos_err(gk[n], gp[n]):.3g}")
            used = ek / (ek - margin)  # the share of its bar the tensor takes
            worst = max(worst, (used, n, text))
            largest = max(largest, (ek, n, text))
            if not margin <= 0:
                fail(f"{tag} {dtype}: gradient of {n} off its plain version: {text}")
        lk, lp = float(ld_k["seg_loss"]), float(ld_p["seg_loss"])
        print(f"{tag} {str(dtype)[6:]} kernels vs plain versions: seg_loss {lk:.6f} vs "
              f"{lp:.6f} (|d|={abs(lk - lp):.3g}, ln {k} = {math.log(k):.6f}); of "
              f"{len(gp) - len(zero)} gradients ({len(zero)} shift-invariant held finite "
              f"apart) the nearest its bar {worst[1]} ({worst[0]:.2f} of it): "
              f"{worst[2]}; the farthest from the reference {largest[1]}: {largest[2]}",
              flush=True)
        if flat_check and not min(lk, lp) >= math.log(k) + 0.1:
            fail(f"{tag} {dtype}: seg_loss {lk}, {lp} within 0.1 of ln {k}: flat logits")
        if not abs(lk - lp) <= (1e-5 if dtype == torch.float32 else 1e-2) * abs(lp):
            fail(f"{tag} {dtype}: seg_loss {lk} vs {lp}")


def train_setup(dev, fused, name="convnext_pop"):
    """(state, step, (img, mask)): ``name`` bf16 with AdamW at 1e-3 and a
    768^2 x 4 batch already on the card."""
    import torch
    from segland_tpu_torch.models import build_model
    from segland_tpu_torch.train import TrainState, create_optimizer, make_base_train_step

    model = build_model(name, None, n_base=7, dtype=torch.bfloat16, fused_mlp=fused,
                        fused_attn=fused, device=dev, generator=torch.Generator().manual_seed(0))
    state = TrainState(model, create_optimizer(model, 1e-3, 200, 100))
    g = torch.Generator().manual_seed(1)
    img = torch.randn(TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 3, generator=g).to(dev)
    mask = torch.randint(0, 8, (TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP), generator=g).to(dev)
    return state, make_base_train_step(model, loss_of(name), skip_nonfinite=True), (img, mask)


def step_peak(setup):
    """torch.cuda.max_memory_allocated over one step of a route alone on the
    card (weights, optimizer state and gradients included), after 2.
    ``setup()`` gives (state, step, batch): step(state, *batch)."""
    import torch

    torch.cuda.empty_cache()
    state, step, batch = setup()
    for _ in range(2):
        step(state, *batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(state, *batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del state, step, batch
    torch.cuda.empty_cache()
    return peak


def step_ms(setup, rounds=2, steps=6, warmup=3):
    """Median ms of ``rounds`` x ``steps`` steps of ``setup()``'s route
    (batches already on the card) after ``warmup``.  A generator: one round a
    next(), so that the caller can take the routes in turns."""
    import torch

    state, step, batch = setup()
    for _ in range(warmup):
        step(state, *batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        for _ in range(steps):
            t0 = time.perf_counter()
            ld, _ = step(state, *batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if not bool(torch.isfinite(ld["total_loss"])):
                fail("step loss is not finite")
        yield times


def dist_args(backend):
    """The CLIs' --dist-backend, where a backend is asked for."""
    return ("--dist-backend", backend) if backend else ()


def train_cli_run(dev, root, name, per_forward=None, fused=True, fall_from="step",
                  epochs=TRAIN_EPOCHS, extra=(), suffix="", backend=None):
    """cli.train_base.main for ``name`` at bf16 --fused (``fused`` False:
    --no-fused), batch 4, 768^2 crops, ``extra`` arguments appended (into
    the snapshot dir ``<name>_snap<suffix>``; ``backend``: --dist-backend, here
    and to eval_base),
    AdamW at 1e-3, ``epochs`` epochs of 4 steps with validation (2 batches
    of 2) in each, on write_train_tiles' tiles: the loss dicts finite, the seg
    loss (the plain pspnet's main loss) of the last epoch below its first
    step's (``fall_from`` "epoch": below the first epoch's mean; None: printed,
    not held), the snapshots and
    best.pth written and best.pth through eval_base; the launches of one
    forward (``per_forward``, by default TRAIN_MODELS') a train step and a
    validation batch, K2 1 a validation batch, any other count fails.  Returns
    the launch counts."""
    from segland_tpu_torch.cli import eval_base, train_base

    snap = os.path.join(root, f"{name}_snap{suffix}")
    lst = os.path.join(root, "list")
    flag = "--fused" if fused else "--no-fused"
    args = ["--data-dir", root, "--train-list", os.path.join(lst, "train.txt"),
            "--val-list", os.path.join(lst, "val.txt"), "--model", name,
            "--dtype", "bfloat16", flag, "--batch-size", str(TRAIN_BATCH),
            "--input-size", f"{TRAIN_CROP},{TRAIN_CROP}", "--learning-rate", "1e-3",
            "--num-epoch", str(epochs), "--val-start", "0", "--val-frequency", "1",
            "--snapshot-frequency", "1", "--test-batch-size", "2", "--print-frequency", "1",
            "--metrics", "--num-workers", "4", "--snapshot-dir", snap, *extra,
            *dist_args(backend)]
    t0 = time.time()
    best, launches = counted(lambda: train_base.main(args))
    wall = time.time() - t0
    steps = epochs * TRAIN_TILES // TRAIN_BATCH
    val_batches = epochs * VAL_TILES // 2
    per_forward = TRAIN_MODELS[name] if per_forward is None else per_forward
    want = {k: n * (steps + val_batches) for k, n in per_forward.items()}
    want["upsample_argmax"] = val_batches
    rows = [json.loads(line) for line in open(os.path.join(snap, "metrics.jsonl"))]
    losses = [r["value"] for r in rows if r["tag"] == "train/total_loss"]
    seg_tag = "seg_loss" if loss_of(name) == "orth" else "main_loss"
    seg = [r["value"] for r in rows if r["tag"] == f"train/{seg_tag}"]
    print(f"train {name}{suffix} (cli.train_base, bf16 {flag}, {TRAIN_BATCH}x{TRAIN_CROP}^2, "
          f"{epochs} epochs of {steps // epochs} steps + {val_batches} val "
          f"batches): {wall:.1f}s launches={launches} best_val_mIoU={best:.4f} "
          f"total_loss {' '.join(f'{x:.4f}' for x in losses)} {seg_tag} "
          f"{' '.join(f'{x:.4f}' for x in seg)}", flush=True)
    if launches != want:
        fail(f"train {name} launch counts {launches}, want {want}")
    if len(losses) != steps or len(seg) != steps or not all(np.isfinite(r["value"])
                                                             for r in rows):
        fail(f"train {name} loss dicts: {len(losses)} of {steps} steps, or not finite")
    last = float(np.mean(seg[-(steps // epochs):]))
    first = seg[0] if fall_from == "step" else float(np.mean(seg[:steps // epochs]))
    if fall_from is not None and not last < first:
        fail(f"train {name} {seg_tag} did not fall: the last epoch's mean {last} against the "
             f"first {fall_from}'s {first}")
    for f in [f"epoch_{e + 1}.pth" for e in range(epochs)] + ["best.pth"]:
        if not os.path.exists(os.path.join(snap, f)):
            fail(f"train_base ({name}) wrote no {f}")
    res = eval_base.main(["--data-dir", root, "--val-list", os.path.join(lst, "val.txt"),
                          "--model", name, "--dtype", "bfloat16",
                          "--restore-from", os.path.join(snap, "best.pth"),
                          "--eval-batch", "2", "--num-workers", "4", *dist_args(backend),
                          "--save-path", os.path.join(root, f"{name}_eval{suffix}")])
    total = res[123][2]
    print(f"train {name}: eval_base on best.pth: mIoU total={total:.4f}", flush=True)
    if not 0.0 <= total <= 1.0:
        fail(f"eval_base on {name}'s best.pth gave mIoU {total}")
    return launches


# a 768^2 crop's swin-s stages: (C, heads, side, padded side); the op-level checks' shapes
TRAIN_SWIN_STAGES = ((96, 3, 192, 196), (192, 6, 96, 98), (384, 12, 48, 49), (768, 24, 24, 28))
# The Functions' gradients (a stock-torch recompute, ops/fused_attn.py) against autograd
# through the plain version on the same inputs: in fp32 (TF32 off) the same function with
# other rounding points, so the relative error per tensor stays within this bar.
FUNCTION_FP32_BAR = 1e-5


def function_grads(fn, ins, cot):
    """(output, [gradient of sum(output * cot) per input]) of ``fn(*ins)``, the
    inputs detached copies that require grad."""
    import torch

    ins = [a.detach().requires_grad_() for a in ins]
    out = fn(*ins)
    return out.detach(), list(torch.autograd.grad(out, ins, cot))


def check_function_grads(dev, which, stage, shift, group=1, seed=40):
    """The section (``which`` 'section') or whole-block autograd Function at a
    stage shape of a batch of TRAIN_BATCH 768^2 crops, with the kernel
    forward: its output against the plain version's (K3's bars), its launches
    (the kernel once in the forward, nothing in the backward), its gradients
    of a random cotangent for every differentiable input (the rel-pos bias's
    included) against autograd through the plain version: fp32 within
    FUNCTION_FP32_BAR relative, bf16 by the step's rule (1 - cosine to the
    fp32 plain gradient at most twice the bf16 plain autograd's plus 1e-4).
    ``group`` 2: K5's dispatch (no geom).  Returns the worst share of a bar."""
    import torch
    from segland_tpu_torch.ops.fused_attn import (attn_section_reference, block_reference,
                                                  swin_attn_section_fused, swin_block_fused)

    c, nh, side, pside = TRAIN_SWIN_STAGES[stage]
    nw = TRAIN_BATCH * (pside // 7) ** 2
    geom = (side, side, pside, pside, 7, shift)
    mask, regions = masks_on(dev, geom)
    worst, line = 0.0, []
    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        a = section_inputs(nw, c, nh, dtype, dev, seed)
        names = ["x", "gamma", "beta", "wqkv", "bqkv", "wproj", "bproj", "bias"]
        ins = [a[k] for k in names]
        if which == "block":
            m = mlp_inputs(1, c, dtype, dev, seed + 1, with_res=False, with_ls=False)
            names += ["gamma2", "beta2", "w1", "b1", "w2", "b2"]
            ins += [m[k] for k in ("gamma", "beta", "w1", "b1", "w2", "b2")]
            fused = lambda x, *p: swin_block_fused(x, mask, *p, nh, regions=regions, geom=geom)
            plain = lambda x, *p: block_reference(x, mask, *p, nh, regions=regions)
        else:
            kw = dict(regions=regions, group=group, geom=geom if group == 1 else None)
            fused = lambda x, *p: swin_attn_section_fused(x, mask, *p, nh, **kw)
            plain = lambda x, *p: attn_section_reference(x, mask, *p, nh, regions=regions)
        ins = list(linear_weights(ins, dtype))  # the weights as the models hand them over
        cot = torch.randn(nw, 49, c, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(seed + 2)).to(dtype)
        (out, gk), launches = counted(lambda: function_grads(fused, ins, cot))
        want = {("swin_block" if which == "block" else
                 "attn_section" if group == 1 else "attn_section_v1"): 1}
        if launches != want:
            fail(f"{which} Function launches {launches}, want {want} (none in the backward)")
        ref, gp = function_grads(plain, ins, cot)
        grads[dtype] = (gk, gp)
        atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 1e-2)
        tag = f"{which} Function {str(dtype)[6:]} C={c} shift={shift} group={group}"
        if which == "block":  # K4's rule (check_k4): a few bf16 elements just past the bar
            d = (out.float() - ref.float()).abs()
            lim = atol + rtol * ref.float().abs()
            bad, worse = int((d > lim).sum()), int((d > 2 * lim).sum())
            allowed = int(K4_OUTLIERS * d.numel()) if dtype == torch.bfloat16 else 0
            if not bool(out.isfinite().all()) or bad > allowed or worse:
                fail(f"{tag}: {bad} elements past |d|<={atol}+{rtol}*|ref| (at most "
                     f"{allowed}), {worse} past twice it (none), or not finite")
            e = float(d.max())
            del d, lim
        else:
            e = compare(tag, out, ref, atol, rtol)
        line.append(f"{str(dtype)[6:]} out max_abs_err={e:.3g}")
        del out, ref
    (gk32, gp32), (gk16, gp16) = grads[torch.float32], grads[torch.bfloat16]
    for n, k32, p32, k16, p16 in zip(names, gk32, gp32, gk16, gp16):
        e32 = _rel_err(k32, p32)
        ek, ep = _cos_err(k16, p32), _cos_err(p16, p32)
        share = max(e32 / FUNCTION_FP32_BAR, ek / (2 * ep + 1e-4))
        if share > worst:
            worst, wname, wtext = share, n, (f"fp32 rel {e32:.3g} (bar {FUNCTION_FP32_BAR}); "
                                             f"bf16 1-cos {ek:.3g}, plain autograd's {ep:.3g}")
        if not e32 <= FUNCTION_FP32_BAR or not ek <= 2 * ep + 1e-4:
            fail(f"{which} Function C={c} shift={shift} group={group}: gradient of {n}: fp32 "
                 f"relative error {e32:.3g} (bar {FUNCTION_FP32_BAR}), bf16 1-cos {ek:.3g} "
                 f"against the plain autograd's {ep:.3g} (bar 2x + 1e-4)")
    print(f"{which} Function NW={nw} C={c} heads={nh} geom={geom} group={group}: "
          f"{'; '.join(line)}; gradients of {len(names)} inputs, the nearest its bar "
          f"{wname} ({worst:.2f} of it): {wtext}", flush=True)
    del grads
    torch.cuda.empty_cache()
    return worst


def check_swin_functions(dev):
    """check_function_grads at stage 0 and stage 2 of a 768^2 crop (both padded:
    192 -> 196 and 48 -> 49) with shift 0 and 3, the block at stage 2 with
    shift 3, and K5's dispatch at group 2 at stage 2."""
    worst = max(check_function_grads(dev, "section", stage, shift)
                for stage in (0, 2) for shift in (0, 3))
    worst = max(worst, check_function_grads(dev, "block", 2, 3),
                check_function_grads(dev, "section", 2, 3, group=2))
    print(f"train: the Functions' gradients, the worst share of a bar {worst:.2f}", flush=True)


def phase_train(dev):
    """Base training on the card through the port's entry point for each
    model of TRAIN_MODELS (train_cli_run); then check_train_steps for each,
    the swin Functions' op-level gradients (check_swin_functions), and the
    step's time and memory fused and --no-fused, the routes in turns.
    Returns {path: launch counts}."""
    import tempfile

    import torch

    t_phase = time.time()
    paths = {}
    with tempfile.TemporaryDirectory() as root:
        write_train_tiles(root)
        for name in TRAIN_MODELS:
            paths[f"{name} train"] = train_cli_run(dev, root, name)
            torch.cuda.empty_cache()
    for name in TRAIN_MODELS:
        check_train_steps(dev, name)
    check_swin_functions(dev)
    setups = {(name, key): (lambda n=name, f=fused: train_setup(dev, f, n))
              for name in TRAIN_MODELS for key, fused in (("fused", True), ("--no-fused", False))}
    peaks = {route: step_peak(setup) for route, setup in setups.items()}
    routes = {route: step_ms(setup) for route, setup in setups.items()}
    got = {}
    for _ in range(2):  # the routes in turns, a round each
        for route, gen in routes.items():
            got[route] = next(gen)
    smi = card()
    for (name, key), times in got.items():
        peak = peaks[name, key]
        ms = float(np.median(times))
        print(f"train {name} bf16 {TRAIN_BATCH}x{TRAIN_CROP}^2 AdamW {key}: "
              f"ms_per_step={ms:.2f} (median of {len(times)} after 3 warm-up; "
              f"min {min(times):.2f} max {max(times):.2f}) crops_per_s="
              f"{TRAIN_BATCH * 1e3 / ms:.2f} max_memory_allocated={peak / 2**30:.2f} GiB "
              f"({smi})", flush=True)
    print(f"train phase: {time.time() - t_phase:.1f}s", flush=True)
    return paths


# the fine-tune phase: tiles, and per model the support shot of its CLI run and the
# launches of one forward of the frozen trunk (K2 adds one a step and a validation batch)
FT_TILES, FT_VAL_TILES, FT_SEED = 8, 2, 123
FT_MODELS = {"swin_pop": dict(shot=5, per_forward={"ln_mlp": 24, "attn_section": 24}),
             "convnext_pop": dict(shot=1, per_forward={"ln_mlp": 18})}


def write_ft_tiles(root):
    """FT_TILES + FT_VAL_TILES 1024^2 tiles of TRAIN_BLOCK^2 blocks of one
    colour, as write_train_tiles writes them, but a block's label is its red
    value // 22: the raw classes 0..11 (background, base 1-7, novel 8-11) in
    every tile, 255 in a band; a train and a validation list; the support
    lists of FT_MODELS' shots from the port's gen_fs_list."""
    from segland_tpu_torch.cli import gen_fs_list
    from segland_tpu_torch.data.geotiff import write_tiff

    rng = np.random.RandomState(1)
    ids = [f"ft_{i}" for i in range(FT_TILES + FT_VAL_TILES)]
    for d in ("images", "labels", "list"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for tid in ids:
        blocks = rng.randint(0, 256, (TILE // TRAIN_BLOCK, TILE // TRAIN_BLOCK, 3))
        img = blocks.repeat(TRAIN_BLOCK, 0).repeat(TRAIN_BLOCK, 1).astype(np.uint8)
        lab = (img[..., 0] // 22).astype(np.uint8)
        lab[:, :TILE // 16] = 255
        write_tiff(os.path.join(root, "images", tid + ".tif"), img)
        write_tiff(os.path.join(root, "labels", tid + ".tif"), lab)
    lst = os.path.join(root, "list")
    with open(os.path.join(lst, "train.txt"), "w") as f:
        f.write("\n".join(ids[:FT_TILES]) + "\n")
    with open(os.path.join(lst, "val.txt"), "w") as f:
        f.write("\n".join(ids[FT_TILES:]) + "\n")
    for shot in sorted({m["shot"] for m in FT_MODELS.values()}):
        gen_fs_list.main(["--data-dir", root, "--train-list", os.path.join(lst, "train.txt"),
                          "--shot", str(shot), "--seed", str(FT_SEED)])


def ft_cli_run(dev, root, name, cfg=None, base_path=None, fused=True, batch=1, suffix="",
               backend=None):
    """cli.ft_pop.main for ``name`` at scripts/ft_oem.sh's config (bf16 --fused,
    or --no-fused where ``fused`` is False, 1024^2 crops, batch 1 (or
    ``batch``, the validation's too; ``backend``: --dist-backend), SGD at 1e-4,
    weight decay 1e-4, --fix-lr --freeze-backbone --update-base --update-epoch
    1) from ``base_path`` or else a base .pth of train_step_model's draw, with
    ``cfg`` (FT_MODELS' by default), cut to 1 epoch and FT_VAL_TILES validation tiles;
    then eval_ft on its best_123.pth.  Fails on any launch count but the
    trunk's per forward a step and a validation batch and K2 one each, on a
    loss dict that is not finite or skipped a step, on a frozen tensor of
    best_123.pth that differs from the base .pth, and on a novel head that did
    not move.  Returns the launch counts."""
    import torch
    from segland_tpu_torch.ckpt import save_params
    from segland_tpu_torch.cli import eval_ft, ft_pop
    from segland_tpu_torch.models import build_model

    cfg = FT_MODELS[name] if cfg is None else cfg
    if base_path is None:
        base_path = os.path.join(root, f"{name}_base.pth")
        save_params(base_path, train_step_model(torch.bfloat16, name=name))
    snap = os.path.join(root, f"{name}_snap{suffix}")
    lst = os.path.join(root, "list")
    flag = "--fused" if fused else "--no-fused"
    args = ["--data-dir", root, "--train-list", os.path.join(lst, "train.txt"),
            "--val-list", os.path.join(lst, "val.txt"), "--model", name, "--dtype", "bfloat16",
            flag, "--input-size", f"{TILE},{TILE}", "--base-size", f"{TILE},{TILE}",
            "--batch-size", str(batch), "--test-batch-size", str(batch),
            "--learning-rate", "1e-4", "--weight-decay", "1e-4",
            "--fix-lr", "--freeze-backbone", "--update-base", "--update-epoch", "1",
            "--shot", str(cfg["shot"]), "--num-epoch", "1", "--val-frequency", "1",
            "--random-seed", str(FT_SEED), "--restore-from", base_path, "--print-frequency", "1",
            "--metrics", "--num-workers", "4", "--snapshot-dir", snap, *dist_args(backend)]
    t0 = time.time()
    res, launches = counted(lambda: ft_pop.main(args))
    wall = time.time() - t0
    steps = 7 * cfg["shot"] // batch  # a base sample an episode: shot a base class
    n = steps + FT_VAL_TILES // batch  # this process's: with N ranks a tile each
    want = {k: v * n for k, v in cfg["per_forward"].items()}
    want["upsample_argmax"] = n
    rows = [json.loads(line) for line in open(os.path.join(snap, "metrics.jsonl"))]
    tag = f"seed{FT_SEED}/train/"
    losses = [r["value"] for r in rows if r["tag"] == tag + "total_loss"]
    skipped = [r["value"] for r in rows if r["tag"] == tag + "nonfinite_skipped"]
    best = res[FT_SEED]
    print(f"ft {name}{suffix} (cli.ft_pop, bf16 {flag}, {batch}x{TILE}^2 novel + {batch}x{TILE}^2 "
          f"base a step, 1 epoch of {steps} steps + {FT_VAL_TILES} val tiles): {wall:.1f}s "
          f"launches={launches} best={best} total_loss {' '.join(f'{x:.4f}' for x in losses)}",
          flush=True)
    if launches != want:
        fail(f"ft {name} launch counts {launches}, want {want}")
    if len(losses) != steps or not all(np.isfinite(r["value"]) for r in rows) or any(skipped):
        fail(f"ft {name} loss dicts: {len(losses)} of {steps} steps, not finite, or skipped "
             f"({sum(skipped)})")
    path = os.path.join(snap, f"best_{FT_SEED}.pth")
    if not os.path.exists(path):
        fail(f"ft {name} wrote no best_{FT_SEED}.pth (base mIoU {best['base']})")
    base = torch.load(base_path, weights_only=False)
    tuned = torch.load(path, weights_only=False)
    frozen = [k for k in base if not torch.equal(base[k], tuned[k])]
    if frozen or set(tuned) - set(base) != {"novel_emb", "classifier_n.0.weight",
                                             "classifier_n.2.weight", "classifier_n.4.weight"}:
        fail(f"ft {name}: frozen tensors changed {frozen[:5]} ({len(frozen)}), or the keys "
             f"differ")
    init = build_model(name, None, n_base=7, n_novel=4, is_ft=True, dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(FT_SEED)).state_dict()
    moved = {k: float((tuned[k].float() - (base[k.replace("classifier_n", "classifier")]
                                           if "classifier_n" in k else init[k]).float())
                      .abs().max()) for k in set(tuned) - set(base)}
    print(f"ft {name}: {len(base)} frozen tensors of best_{FT_SEED}.pth bit-equal to the base "
          f".pth; the novel head's largest move from its start: {moved}", flush=True)
    if not all(v > 0 for v in moved.values()):
        fail(f"ft {name}: a trainable tensor did not move: {moved}")
    res = eval_ft.main(["--data-dir", root, "--val-list", os.path.join(lst, "val.txt"),
                        "--model", name, "--dtype", "bfloat16",
                        "--restore-from", os.path.join(snap, "best.pth"), "--eval-batch", "2",
                        "--num-workers", "4", *dist_args(backend),
                        "--save-path", os.path.join(root, f"{name}_eval{suffix}")])
    b, nv, tot, _ = res[FT_SEED]
    print(f"ft {name}: eval_ft on best_{FT_SEED}.pth (K = 12): mIoU base={b:.4f} "
          f"novel={nv:.4f} total={tot:.4f}", flush=True)
    if not all(0.0 <= x <= 1.0 for x in (b, tot)):
        fail(f"ft {name}: eval_ft gave mIoU {res[FT_SEED]}")
    return launches


def ft_batch(dev, seed=6):
    """One ft episode on the card, batch 1 + 1 at TILE^2: random images, the
    novel sample's labels TRAIN_BLOCK^2 blocks of 8..11 or ignored, the base
    sample's blocks of 0..7 (background a block in eight: what the
    pseudo-labels fill)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    side = TILE // TRAIN_BLOCK

    def blocks(values):
        idx = torch.randint(0, len(values), (1, side, side), generator=g)
        lab = torch.tensor(values, dtype=torch.int32)[idx]
        return lab.repeat_interleave(TRAIN_BLOCK, 1).repeat_interleave(TRAIN_BLOCK, 2)

    img, img_b = (torch.randn(1, TILE, TILE, 3, generator=g) for _ in range(2))
    batch = (img, blocks([8, 9, 10, 11, 255]), img_b, blocks(list(range(8))))
    return tuple(a.to(dev) for a in batch)


def ft_step_grads(model, batch):
    """One ft step (make_ft_train_step) at LR 0, weight decay 0 and without a
    clip: (loss dict, {name: raw grad} of the trainable tensors, the
    pseudo-labels it trained on)."""
    import segland_tpu_torch.train.ft as ft
    from segland_tpu_torch.train import TrainState, create_optimizer

    labels = []
    plain = ft.pseudo_label

    def recording(*a):
        labels.append(plain(*a))
        return labels[-1]

    state = TrainState(model, create_optimizer(model, 0.0, 1, 1, weight_decay=0.0,
                                               optimizer="sgd", clip=None,
                                               trainable_fn=ft.ft_trainable))
    ft.pseudo_label = recording
    try:
        ld, _ = ft.make_ft_train_step(model, 7)(state, *batch)
    finally:
        ft.pseudo_label = plain
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    return ld, grads, labels[0]


def check_ft_steps(dev, name):
    """One ft step with the kernels and one inside ops.plain_versions(), from
    the same weights (train_step_model's draw with the novel head, classifier_n
    copied from classifier) and episode (ft_batch), fp32 and bf16, and fp32
    through the stock-torch blocks: the trainable gradients held as
    check_train_steps holds base training's (hold_steps; the fp32 floor
    FP32_SUM_FLOOR), the pseudo-labels of
    the two routes equal on >= 99% of the relabelled pixels and of more than
    one class, and the kernel step's launches exactly the trunk's per forward
    and K2 one."""
    import torch
    from segland_tpu_torch.ops import plain_versions
    from segland_tpu_torch.train import init_cls_n

    batch = ft_batch(dev)
    want = dict(FT_MODELS[name]["per_forward"], upsample_argmax=1)
    runs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for fused in (True, False) if dtype == torch.float32 else (True,):
            model = train_step_model(dtype, fused, name=name, is_ft=True).to(dev)
            init_cls_n(model)
            if not fused:
                runs[dtype, "unfused"] = ft_step_grads(model, batch)
                continue
            runs[dtype, "kernels"], launches = counted(lambda: ft_step_grads(model, batch))
            if launches != want:
                fail(f"ft step {name} {dtype} launch counts {launches}, want {want}")
            with plain_versions():
                runs[dtype, "plain"] = ft_step_grads(model, batch)
            del model
        torch.cuda.empty_cache()
    # the pseudo-labels are the argmax of the logits, so the seg loss sits below ln 12 on
    # them and above it elsewhere: the novel head reads the trunk where the pseudo-labels
    # take more than one class
    hold_steps(f"ft step {name} 1+1x{TILE}^2", runs, 12, flat_check=False,
               fp32_floor=FP32_SUM_FLOOR)
    relabelled = batch[3] == 0
    for dtype in (torch.float32, torch.bfloat16):
        lk, lp = runs[dtype, "kernels"][2], runs[dtype, "plain"][2]
        agree = float((lk == lp)[relabelled].float().mean())
        classes = torch.bincount(lk[relabelled].long(), minlength=12).tolist()
        print(f"ft step {name} {str(dtype)[6:]}: pseudo-labels of the kernels and the plain "
              f"versions agree on {agree:.6f} of {int(relabelled.sum())} relabelled pixels; "
              f"the kernels' by class {classes}", flush=True)
        if not agree >= 0.99:
            fail(f"ft step {name} {dtype}: pseudo-labels agree on {agree} < 0.99")
        if sum(c > 0 for c in classes) < 2:
            fail(f"ft step {name} {dtype}: the pseudo-labels take one class: flat logits")


def ft_setup(dev, name, fused):
    """(state, step, episode): ``name`` bf16 as ft_pop builds it (the port's
    init from a seeded generator, classifier_n copied), SGD at 1e-4 with
    weight decay 1e-4 and a fixed LR over the trainable subset, an episode of
    ft_batch already on the card."""
    import torch
    from segland_tpu_torch.models import build_model
    from segland_tpu_torch.train import (TrainState, create_optimizer, ft_trainable, init_cls_n,
                                         make_ft_train_step)

    model = build_model(name, None, n_base=7, n_novel=4, is_ft=True, dtype=torch.bfloat16,
                        fused_mlp=fused, fused_attn=fused, device=dev,
                        generator=torch.Generator().manual_seed(0))
    init_cls_n(model)
    tx = create_optimizer(model, 1e-4, 1, 35, weight_decay=1e-4, optimizer="sgd", fix_lr=True,
                          trainable_fn=ft_trainable)
    return TrainState(model, tx), make_ft_train_step(model, 7, skip_nonfinite=True), ft_batch(dev)


def phase_ft(dev):
    """Few-shot fine-tuning on the card through the port's entry points, for
    each model of FT_MODELS: ft_cli_run (cli.gen_fs_list's support lists,
    cli.ft_pop, eval_ft), check_ft_steps, then the ft step's time and memory
    fused and --no-fused, the four routes in turns.  Returns {path: launch
    counts}."""
    import tempfile

    import torch

    t_phase = time.time()
    paths = {}
    with tempfile.TemporaryDirectory() as root:
        write_ft_tiles(root)
        for name in FT_MODELS:
            paths[f"{name} ft"] = ft_cli_run(dev, root, name)
            torch.cuda.empty_cache()
    for name in FT_MODELS:
        check_ft_steps(dev, name)
    setups = {(name, key): (lambda n=name, f=fused: ft_setup(dev, n, f))
              for name in FT_MODELS for key, fused in (("fused", True), ("--no-fused", False))}
    peaks = {route: step_peak(setup) for route, setup in setups.items()}
    routes = {route: step_ms(setup) for route, setup in setups.items()}
    got = {}
    for _ in range(2):  # the routes in turns, a round each
        for route, gen in routes.items():
            got[route] = next(gen)
    for (name, key), times in got.items():
        ms = float(np.median(times))
        print(f"ft {name} bf16 1+1x{TILE}^2 SGD {key}: ms_per_step={ms:.2f} (median of "
              f"{len(times)} after 3 warm-up; min {min(times):.2f} max {max(times):.2f}) "
              f"max_memory_allocated={peaks[name, key] / 2**30:.2f} GiB", flush=True)
    print(f"ft phase: {time.time() - t_phase:.1f}s", flush=True)
    return paths


# the seghr group: seghr_pop / hr-w32 (the registry's default backbone), the reference's
# base-training model.  HRNet and HRFPN run stock cuDNN and torch ops: K2 is the only kernel
# on its paths, 1 a batch, a validation batch and a fine-tune step.
SEGHR = "seghr_pop"
SEGHR_FT = dict(shot=1, per_forward={})
SEGHR_STEP_CROP = 256  # the fp32 step on the card against the CPU: 4 crops (branch 3 8x8)


class LogRecords:
    """The messages that ``logger`` emits while the context is open."""

    def __init__(self, logger):
        import logging

        self.logger, self.messages = logging.getLogger(logger), []
        self.handler = logging.Handler()
        self.handler.emit = lambda record: self.messages.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self.messages

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        return False


def fp32_step(dev, name=SEGHR, side=SEGHR_STEP_CROP):
    """One fp32 train step of ``name`` (train_step_model's draw: the POP
    classifier spread so the loss reads the network; LR 0 and no clip, so
    the gradients are the raw ones) on the card (TF32 off) and on the CPU from
    the same weights and TRAIN_BATCH x side^2 batch: every loss of the dict
    within 1e-5 of the total loss, relative; no kernel launched.  The worst
    gradient tensor's relative error is printed, not held: under train-mode
    BatchNorm some gradients are sums that cancel and move far under rounding
    (PERF.md section 6).  LSKNet's DropPath and MLP dropout are set to
    0 for this check: a CPU and a CUDA generator draw different masks from
    one seed."""
    import torch
    from segland_tpu_torch.models.backbones.droppath import DropPath
    from segland_tpu_torch.models.backbones.lsknet import Mlp

    g = torch.Generator().manual_seed(7)
    img = torch.randn(TRAIN_BATCH, side, side, 3, generator=g)
    mask = torch.randint(0, 8, (TRAIN_BATCH, side, side), generator=g)
    model = train_step_model(torch.float32, fused=False, name=name)
    for m in model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
        elif isinstance(m, Mlp):
            m.drop = 0.0
    start = {k: v.clone() for k, v in model.state_dict().items()}
    t0 = time.time()
    ld_cpu, g_cpu = train_step_grads(model, img, mask, loss_of(name))
    cpu_s = time.time() - t0
    model.load_state_dict(start)  # the step moved the BatchNorm statistics
    model = model.to(dev)
    (ld_dev, g_dev), launches = counted(lambda: train_step_grads(model, img.to(dev),
                                                                 mask.to(dev), loss_of(name)))
    if launches:
        fail(f"{name} fp32 step launched {launches}")
    total = abs(float(ld_cpu["total_loss"]))
    loss_err = {k: abs(float(ld_dev[k]) - float(v)) / total for k, v in ld_cpu.items()}
    errs = sorted((_rel_err(g_dev[n].cpu(), g_cpu[n]), n) for n in g_cpu)
    print(f"train {name} fp32 step card vs CPU ({TRAIN_BATCH}x{side}^2, TF32 off; the CPU's "
          f"step {cpu_s:.1f}s): losses card "
          f"{ {k: round(float(v), 6) for k, v in ld_dev.items()} } CPU "
          f"{ {k: round(float(v), 6) for k, v in ld_cpu.items()} }, |d| / total_loss "
          f"{ {k: float(f'{v:.3g}') for k, v in loss_err.items()} } (bar 1e-5); of {len(errs)} "
          f"gradients the worst relative error {errs[-1][0]:.3g} ({errs[-1][1]}), the median "
          f"{errs[len(errs) // 2][0]:.3g}", flush=True)
    if not all(e <= 1e-5 for e in loss_err.values()):
        fail(f"{name} fp32 step: the card's losses off the CPU's: {loss_err}")
    del model
    torch.cuda.empty_cache()


def per_conv_int8(dev, name=SEGHR):
    """One batch of the eval slice of ``name`` (a model with no ResNet
    Bottleneck) through Evaluator.run bf16, --int8 and --int8 --fused (one
    calibration batch, taken in the warm-up run): K2 1 a batch and nothing
    else (no K7: HRNet's stage-1 Bottlenecks are not the fused route's, and
    LSKNet and the VGG U-Net have none), the fused request's warning, and the
    argmax agreement of each int8 route with bf16 printed (random weights:
    only a trained model's gate says whether int8 keeps the map).  Returns
    {path: launch counts}."""
    import torch
    from segland_tpu_torch.evallib import Evaluator
    from segland_tpu_torch.quant import QuantConfig

    model = build(name, torch.bfloat16).to(dev)
    batches = synthetic_batches()[:1]
    kw = dict(num_classes=12, n_base=7, normalize_on_device=True)
    q = dict(int8=True, calib_batches=1)
    routes = {"bf16": Evaluator(model, dev, **kw), "int8": Evaluator(model, dev, **q, **kw),
              "int8 fused": Evaluator(model, dev, quant_cfg=QuantConfig(fused_blocks=True),
                                      **q, **kw)}
    launches, preds, tps = {}, {}, {}
    for route, ev in routes.items():
        with LogRecords("segland_tpu_torch.quant.ptq") as warned:
            ev.run(batches)  # warm-up: calibration, cuDNN plans, allocators
        torch.cuda.synchronize()
        (cm, (base, _, total, _), tps[route]), launches[route] = counted_run(ev, batches)
        print(f"slice {name} {route}: 1x{BATCH} tiles {TILE}^2: launches={launches[route]} "
              f"mIoU base={base:.4f} total={total:.4f} tiles_per_s={tps[route]:.2f} "
              f"warnings={warned}", flush=True)
        if launches[route] != {"upsample_argmax": 1}:
            fail(f"slice {name} {route} launch counts {launches[route]}, want K2 1 alone")
        if route == "int8 fused" and not any("no Bottleneck has a fused-eligible" in m
                                             for m in warned):
            fail(f"slice {name} --int8 --fused: no warning that the request cannot take effect")
        preds[route] = ev.predict_batch(batches[0][0], (TILE, TILE), want_logits=False)[1]
    agree = lambda a, b: float((preds[a] == preds[b]).float().mean())
    print(f"slice {name} int8 argmax agreement: int8 vs bf16 {agree('int8', 'bf16'):.6f}, "
          f"int8 fused vs bf16 {agree('int8 fused', 'bf16'):.6f}, int8 fused vs int8 "
          f"{agree('int8 fused', 'int8'):.6f}; tiles/s bf16 {tps['bf16']:.2f}, --int8 "
          f"{tps['int8']:.2f}, --int8 --fused {tps['int8 fused']:.2f}", flush=True)
    del routes, model
    torch.cuda.empty_cache()
    return {f"{name} int8": launches["int8"], f"{name} int8 fused": launches["int8 fused"]}


def phase_seghr(dev):
    """seghr_pop / hr-w32 at full width and depth, weights from a seeded
    torch.Generator: (a) the eval slice as eval_base and as eval_ft run it
    (phase_slice: K2 1 a batch and nothing else, tiles/s, K2's plain version
    >= 99% argmax agreement, fp32 on the card against the CPU); (b) base
    training through cli.train_base at scripts/train_oem.sh's config (bf16,
    --no-fused as there, batch 4, 768^2 crops, AdamW at 1e-3, wd 1e-4) on the
    train phase's tiles, cut to TRAIN_EPOCHS epochs of 4 steps and 2
    validation batches each (K2 1 a validation batch, 0 in a step), one fp32
    step on the card against the CPU, the bf16 step's ms (median of 12 after
    3 warm-up), crops/s and max_memory_allocated; (c) the few-shot fine-tune
    through cli.ft_pop from (b)'s best.pth, 1 shot, 1 epoch, FT_VAL_TILES
    validation tiles (K2 1 a step and a validation batch), eval_ft on it, the
    ft step's ms and memory; (d) --int8 and --int8 --fused (seghr_int8).
    Returns {path: launch counts}."""
    import tempfile

    import torch

    t_phase = time.time()
    paths = {}
    paths[f"{SEGHR} eval_base"], tps, _ = phase_slice(dev, SEGHR, {"upsample_argmax": 1})
    torch.cuda.empty_cache()
    paths[f"{SEGHR} eval_ft"], _, _ = phase_slice(dev, SEGHR, {"upsample_argmax": 1}, is_ft=True,
                                                  fp32_check=False)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        train_root, ft_root = os.path.join(root, "train"), os.path.join(root, "ft")
        write_train_tiles(train_root)
        # the first step's seg loss is ln 8 (the POP classifier's init leaves the logits
        # flat), and AdamW's first steps at 1e-3 overshoot through HRFPN's 480 unnormalised
        # channels (CPU rehearsal at 4 x 192^2: 2.08, 3.55, 193.5, 76.3, then 3.27 ... 4.65),
        # so the loss is held to fall from the first epoch's mean, not from its first step
        paths[f"{SEGHR} train"] = train_cli_run(dev, train_root, SEGHR, per_forward={},
                                                fused=False, fall_from="epoch")
        torch.cuda.empty_cache()
        fp32_step(dev)
        setup = lambda: train_setup(dev, False, SEGHR)
        peak = step_peak(setup)
        times = next(step_ms(setup, rounds=1, steps=12))
        ms = float(np.median(times))
        smi = card()
        print(f"train {SEGHR} bf16 {TRAIN_BATCH}x{TRAIN_CROP}^2 AdamW: ms_per_step={ms:.2f} "
              f"(median of {len(times)} after 3 warm-up; min {min(times):.2f} max "
              f"{max(times):.2f}) crops_per_s={TRAIN_BATCH * 1e3 / ms:.2f} "
              f"max_memory_allocated={peak / 2**30:.2f} GiB ({smi})", flush=True)
        torch.cuda.empty_cache()
        write_ft_tiles(ft_root)
        best = os.path.join(train_root, f"{SEGHR}_snap", "best.pth")
        paths[f"{SEGHR} ft"] = ft_cli_run(dev, ft_root, SEGHR, cfg=SEGHR_FT, base_path=best,
                                          fused=False)
        torch.cuda.empty_cache()
    setup = lambda: ft_setup(dev, SEGHR, False)
    peak = step_peak(setup)
    times = next(step_ms(setup, rounds=1, steps=12))
    ms = float(np.median(times))
    print(f"ft {SEGHR} bf16 1+1x{TILE}^2 SGD: ms_per_step={ms:.2f} (median of {len(times)} "
          f"after 3 warm-up; min {min(times):.2f} max {max(times):.2f}) "
          f"max_memory_allocated={peak / 2**30:.2f} GiB ({smi})", flush=True)
    torch.cuda.empty_cache()
    paths.update(per_conv_int8(dev))
    print(f"{SEGHR} eval: {tps:.2f} tiles/s; seghr group: {time.time() - t_phase:.1f}s",
          flush=True)
    return paths


# the heads group: the last four models of the registry at their default backbones, full
# width and depth.  K2 is the only kernel on their eval, train and fine-tune paths (1 a batch,
# a validation batch and an ft step; vggunet_pop's logits are at full resolution, so K2 runs
# at factor 1 there); the ResNet pair takes K7 in its 12 stride-1 Bottlenecks without a
# downsample under --int8 --fused.
HEADS = ("pspplus_pop", "pspnet", "lsk_pop", "vggunet_pop")
HEADS_POP = ("pspplus_pop", "lsk_pop", "vggunet_pop")  # the plain pspnet has no POP head
RESNET_MODELS = ("deeplab_pop", "pspnet_pop", "pspplus_pop", "pspnet")
HEADS_EPOCHS = 1  # base training cut to one epoch of 4 steps and 2 validation batches
HEADS_STEP_CROP = 192  # the fp32 step on the card against the CPU: 4 crops (stride 8: 24^2)


def phase_heads(dev):
    """The heads group at full width and depth, bf16, weights from a seeded
    torch.Generator (build), each model in turn: (a) the eval slice as
    eval_base and as eval_ft run it, one batch of 8 synthetic 1024^2 tiles
    (phase_slice: K2 1 a batch and nothing else, tiles/s, >= 99% agreement
    with K2's plain version, fp32 card vs CPU); (b) base training through
    cli.train_base at scripts/train_oem.sh's config (bf16 --no-fused, batch 4,
    768^2 crops, AdamW at 1e-3, wd 1e-4) cut to HEADS_EPOCHS epoch of 4 steps
    and 2 validation batches (K2 1 a validation batch, none in a step; the
    loss printed, not held: one epoch from a random draw), best.pth through
    eval_base, one fp32 step on the card against the CPU (the plain pspnet's
    CE step with its aux head), the bf16 step's ms (median of 12 after 3
    warm-up), crops/s and max_memory_allocated; (c) the POP models' fine-tune
    through cli.ft_pop from (b)'s best.pth (1 shot, 1 epoch: K2 1 a step and a
    validation batch; frozen tensors bit-equal; eval_ft on it); (d) int8: the
    ResNet pair through phase_int8_slice (--int8, --int8 --fused with K7 12 and
    K2 1 a batch, its plain versions >= 99% agreement), lsk_pop and
    vggunet_pop through per_conv_int8 (K2 alone; agreement with bf16 printed,
    not held).  Each model's predicted launch counts are printed before it
    runs.  Returns {path: launch counts}."""
    import tempfile

    import torch

    t_phase = time.time()
    smi = card()
    paths = {}
    k2 = {"upsample_argmax": 1}
    with tempfile.TemporaryDirectory() as root:
        train_root, ft_root = os.path.join(root, "train"), os.path.join(root, "ft")
        write_train_tiles(train_root)
        write_ft_tiles(ft_root)
        for name in HEADS:
            t_model = time.time()
            val = HEADS_EPOCHS * VAL_TILES // 2
            ft = 7 * SEGHR_FT["shot"] + FT_VAL_TILES
            int8 = ("K7 12 and K2 1 a batch with --int8 --fused, K2 1 with --int8"
                    if name in RESNET_MODELS else "K2 1 a batch with --int8 and --int8 --fused")
            print(f"heads {name}: predicted launches: eval_base K2 1 a batch, eval_ft K2 1 a "
                  f"batch, train K2 {val} (1 a validation batch, none in a step)"
                  + (f", ft K2 {ft} (1 a step and a validation tile)" if name in HEADS_POP
                     else ", no fine-tune (no POP head)") + f"; {int8}", flush=True)
            paths[f"{name} eval_base"], tps, _ = phase_slice(dev, name, k2, n_batches=1)
            torch.cuda.empty_cache()
            paths[f"{name} eval_ft"], _, _ = phase_slice(dev, name, k2, is_ft=True,
                                                         fp32_check=False, n_batches=1)
            torch.cuda.empty_cache()
            paths[f"{name} train"] = train_cli_run(dev, train_root, name, per_forward={},
                                                   fused=False, fall_from=None,
                                                   epochs=HEADS_EPOCHS)
            torch.cuda.empty_cache()
            fp32_step(dev, name, HEADS_STEP_CROP)
            setup = lambda n=name: train_setup(dev, False, n)
            peak = step_peak(setup)
            times = next(step_ms(setup, rounds=1, steps=12))
            ms = float(np.median(times))
            print(f"train {name} bf16 {TRAIN_BATCH}x{TRAIN_CROP}^2 AdamW: ms_per_step={ms:.2f} "
                  f"(median of {len(times)} after 3 warm-up; min {min(times):.2f} max "
                  f"{max(times):.2f}) crops_per_s={TRAIN_BATCH * 1e3 / ms:.2f} "
                  f"max_memory_allocated={peak / 2**30:.2f} GiB ({smi})", flush=True)
            torch.cuda.empty_cache()
            if name in HEADS_POP:
                best = os.path.join(train_root, f"{name}_snap", "best.pth")
                paths[f"{name} ft"] = ft_cli_run(dev, ft_root, name, cfg=SEGHR_FT,
                                                 base_path=best, fused=False)
                torch.cuda.empty_cache()
            if name in RESNET_MODELS:
                paths[f"{name} int8 fused"] = phase_int8_slice(dev, name, n_batches=1)
            else:
                paths.update(per_conv_int8(dev, name))
            torch.cuda.empty_cache()
            got = {p: n for p, n in paths.items() if p.startswith(name + " ")}
            print(f"heads {name}: launches by path {got}; eval {tps:.2f} tiles/s; "
                  f"{time.time() - t_model:.1f}s ({smi})", flush=True)
    print(f"heads phase: {time.time() - t_phase:.1f}s", flush=True)
    return paths


ENSEMBLE = ("convnext_pop", "swin_pop", SEGHR)  # the reference's winning ensemble
ENSEMBLE_PER_BATCH = {"ln_mlp": 18 + 24, "attn_section": 24, "upsample_argmax": 1}
SCENE, SCENE_OVERLAP = 4096, 128  # 5 x 5 tiles of 1024^2: 4 batches of 8, the last padded
NEAR_TIE = 1e-3  # a class may differ between two summation orders where the top-2 gap is <= it


def differ_beyond_ties(pred, ref, logits):
    """Pixels where pred and ref differ and ref's top-2 logits lie further apart
    than NEAR_TIE (torch tensors on one device, or numpy arrays)."""
    import torch

    logits, pred, ref = (torch.as_tensor(a) for a in (logits, pred, ref))
    top2 = logits.topk(2, dim=-1).values
    return int(((pred.to(ref.device) != ref) & (top2[..., 0] - top2[..., 1] > NEAR_TIE)).sum())


def ensemble_serving(dev, members, batches, kw):
    """(a) of phase_ensemble.  Returns the serving run's launch counts."""
    import torch
    from segland_tpu_torch.evallib import EnsembleEvaluator, Evaluator

    ens = EnsembleEvaluator(members, dev, **kw)
    ens.run(batches)  # warm-up: cuDNN plans, device and pinned-host allocators
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (cm, (base, _, total, _), tps), launches = counted_run(ens, batches)
    print(f"ensemble {'+'.join(ENSEMBLE)}: bf16 fused, {N_BATCHES}x{BATCH} tiles {TILE}^2: "
          f"launches={launches} mIoU base={base:.4f} total={total:.4f} tiles_per_s={tps:.2f} "
          f"pixels={int(cm.sum())} max_memory_allocated="
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the three members' weights "
          f"included)", flush=True)
    want = {key: n * N_BATCHES for key, n in ENSEMBLE_PER_BATCH.items()}
    if launches != want:
        fail(f"ensemble launch counts {launches}, want {want}")
    if int(cm.sum()) != N_BATCHES * BATCH * (TILE - 16) * TILE:
        fail("ensemble confusion matrix does not count every labelled pixel")
    plain = EnsembleEvaluator(members, dev, plain_kernels=True, **kw)
    plain.run(batches)
    (_, (_, _, total_p, _), tps_p), plain_launches = counted_run(plain, batches)
    if plain_launches:
        fail(f"the plain ensemble run launched a kernel: {plain_launches}")
    evs = [Evaluator(m, dev, **kw) for m in members]
    agree = n = beyond = 0
    for imgs, _, _ in batches:
        pk = ens.predict_batch(imgs, (TILE, TILE))
        agree += int((pk == plain.predict_batch(imgs, (TILE, TILE))).sum())
        n += pk.numel()
        # fusemat's order: each member's upsampled fp32 map, summed, argmaxed
        acc = None
        for ev in evs:
            up, _ = ev.predict_batch(imgs, (TILE, TILE), want_logits=True)
            acc = up if acc is None else acc + up
            del up
        if acc.shape != (BATCH, TILE, TILE, 8) or not bool(acc.isfinite().all()):
            fail(f"ensemble logits {tuple(acc.shape)} not finite (B,{TILE},{TILE},8)")
        beyond += differ_beyond_ties(pk, acc.argmax(-1).to(torch.uint8), acc)
        del acc
    frac = agree / n
    print(f"ensemble plain versions on the card: total={total_p:.4f} tiles_per_s={tps_p:.2f} "
          f"argmax_agreement={frac:.6f}; against fusemat's order (members upsampled, summed): "
          f"{beyond} pixels differ beyond near-ties ({NEAR_TIE:g})", flush=True)
    if frac < 0.99:
        fail(f"ensemble: kernel vs plain argmax agreement {frac:.4f} < 0.99")
    if beyond:
        fail(f"ensemble: {beyond} pixels differ from fusemat's order beyond near-ties")
    return launches


def scene_prediction(dev, root, model):
    """(b) of phase_ensemble: cli.predict's device path on a SCENE^2 GeoTIFF
    (``model``'s weights through a .pth), then the two paths of
    evallib.tiled on the same scene and weights, timed; the CLI's map and the
    device path's equal the host path's except at near-ties.  Returns the
    CLI run's launch counts."""
    import torch
    from segland_tpu_torch.ckpt import save_params
    from segland_tpu_torch.cli import predict
    from segland_tpu_torch.data import augment as A
    from segland_tpu_torch.data.geotiff import write_tiff
    from segland_tpu_torch.data.tileio import read_image, read_label
    from segland_tpu_torch.evallib import Evaluator
    from segland_tpu_torch.evallib.tiled import _tile_starts, predict_scene, predict_scene_device

    n_tiles = len(_tile_starts(SCENE, TILE, TILE - SCENE_OVERLAP)) ** 2
    path, pth = os.path.join(root, "scene.tif"), os.path.join(root, "convnext_pop.pth")
    # 64^2 blocks of one colour with noise, so the model's classes are not all one
    rng = np.random.RandomState(5)
    blocks = rng.randint(0, 256, (SCENE // 64, SCENE // 64, 3)).repeat(64, 0).repeat(64, 1)
    write_tiff(path, np.clip(blocks + rng.randint(-20, 21, blocks.shape), 0, 255))
    save_params(pth, model)
    argv = ["--data-dir", root, "--input", path, "--output", os.path.join(root, "pred"),
            "--model", "convnext_pop", "--restore-from", pth, "--dtype", "bfloat16",
            "--tile", str(TILE), "--overlap", str(SCENE_OVERLAP), "--eval-batch", str(BATCH)]
    t0 = time.time()
    n, launches = counted(lambda: predict.main(argv))
    torch.cuda.synchronize()
    cli_s = time.time() - t0
    want = {"ln_mlp": 18 * -(-n_tiles // BATCH)}
    if n != 1 or launches != want:
        fail(f"predict: {n} scenes, launch counts {launches}, want 1 and {want}")
    got_cli = read_label(os.path.join(root, "pred", "scene.tif"))

    ev = Evaluator(model, dev, num_classes=8, n_base=7)
    image = A.normalize(read_image(path), A.IMAGENET_MEAN, A.IMAGENET_STD)
    apply_fn = lambda t: ev.predict_batch((t, t.shape[0]), (TILE, TILE))[0]
    host_fn = lambda t: ev.predict_batch(t, (TILE, TILE))[0].cpu().numpy()
    torch.cuda.synchronize()
    t0 = time.time()
    got_dev = predict_scene_device(apply_fn, image, 8, dev, tile=TILE, overlap=SCENE_OVERLAP,
                                   batch=BATCH)
    dev_s = time.time() - t0
    t0 = time.time()
    logits, want_host = predict_scene(host_fn, image, 8, tile=TILE, overlap=SCENE_OVERLAP,
                                      batch=BATCH)
    host_s = time.time() - t0
    shares = np.bincount(want_host.ravel(), minlength=8) / want_host.size
    bad = {tag: differ_beyond_ties(got, want_host, logits)
           for tag, got in (("cli", got_cli), ("device", got_dev))}
    print(f"scene {SCENE}^2 convnext_pop bf16 fused, tile {TILE} overlap {SCENE_OVERLAP}, "
          f"{n_tiles} tiles in batches of {BATCH}: cli.predict {cli_s:.2f}s "
          f"(launches={launches}; the model's build, the GeoTIFF read and write included), "
          f"device path {dev_s:.3f} s/scene, host path {host_s:.3f} s/scene; pixels off the host "
          f"path beyond near-ties {bad}; class shares {np.round(shares, 3).tolist()} "
          f"({card()})", flush=True)
    if got_cli.shape != (SCENE, SCENE) or any(bad.values()):
        fail(f"scene prediction: the device path differs from the host path: {bad}")
    return launches


def fusion(dev, root, members):
    """(c) of phase_ensemble: two members' .mat maps exported by
    Evaluator.run over 2 unlabelled tiles, fused by fuse_prob_maps on the
    card; equal to numpy's argmax of the float32 mean.  Returns the exports'
    launch counts."""
    import scipy.io
    import torch
    from segland_tpu_torch.evallib import Evaluator, fuse_prob_maps

    imgs, _, ids = synthetic_batches()[0]
    loader = [(imgs[:2], [None, None], ids[:2])]
    dirs, launches = [], {}
    for m in members:
        d = os.path.join(root, f"prob_{len(dirs)}")
        os.makedirs(d)
        ev = Evaluator(m, dev, num_classes=8, n_base=7, normalize_on_device=True)
        _, got = counted(lambda: ev.run(loader, prob_path=d))
        for key, v in got.items():
            launches[key] = launches.get(key, 0) + v
        dirs.append(d)
    torch.cuda.synchronize()
    t0 = time.time()
    fused = fuse_prob_maps(dirs, dev)
    fuse_s = time.time() - t0
    if sorted(fused) != sorted(f"{t}.mat" for t in ids[:2]):
        fail(f"fusion: fused {sorted(fused)}")
    off = 0
    for f, idx in fused.items():
        total = sum(scipy.io.loadmat(os.path.join(d, f))["outputs"][0].astype(np.float64)
                    for d in dirs)
        want = (total / len(dirs)).astype(np.float32).argmax(0)
        off += int((idx != want).sum()) + (idx.shape != (TILE, TILE))
    if launches != {"ln_mlp": 18}:
        fail(f"fusion exports' launch counts {launches}, want K1 18 (convnext_pop's batch)")
    print(f"fusion: 2 members' .mat maps (K=8, {TILE}^2) of 2 tiles, export launches={launches}; "
          f"fuse_prob_maps on the card {fuse_s:.3f}s; pixels off numpy's argmax of the float32 "
          f"mean: {off}", flush=True)
    if off:
        fail(f"fusion: {off} pixels differ from numpy's argmax of the float32 mean")
    return launches


def phase_ensemble(dev):
    """The reference's stage 4 on the card, weights from build(): (a)
    EnsembleEvaluator over convnext_pop / convnext-t, swin_pop / swin-s and
    seghr_pop / hr-w32 (bf16, fused where the eval default is: K1 42, K3 24
    and K2 1 a batch) on N_BATCHES batches of 8 synthetic 1024^2 tiles: tiles/s,
    >= 99% argmax agreement with the kernels' plain versions, and the map equal
    to fusemat's order (each member's upsampled fp32 logits from
    Evaluator.predict_batch, summed, argmaxed) except at near-ties; (b)
    cli.predict's device path on a SCENE^2 scene with convnext_pop (K1 18 a
    batch of 8 tiles), equal to the host path except at near-ties, seconds a
    scene of both paths; (c) fusion of two members' .mat exports on the card.
    Returns {path: launch counts}."""
    import tempfile

    import torch

    t_phase = time.time()
    members = [build(name, torch.bfloat16).to(dev) for name in ENSEMBLE]
    kw = dict(num_classes=12, n_base=7, normalize_on_device=True)
    paths = {"ensemble": ensemble_serving(dev, members, synthetic_batches(), kw)}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        paths["scene (cli.predict)"] = scene_prediction(dev, root, members[0])
        torch.cuda.empty_cache()
        paths["fusion exports"] = fusion(dev, root, [members[0], members[2]])
    del members
    torch.cuda.empty_cache()
    print(f"ensemble phase: {time.time() - t_phase:.1f}s", flush=True)
    return paths


def tame_resnet(model, g):
    """A ResNet-backed model's trunk and decoder redrawn from ``g`` so that
    activations stay in a sane range through the 16 blocks: He-normal conv
    weights (std sqrt(2 / fan_in)) hold the second moment through each conv +
    ReLU; BatchNorm statistics near the identity (mean 0.1 * randn, variance
    in [0.8, 1.2], bias 0.1 * randn); and a bn3 scale in [0.2, 0.4], so that a
    block adds under a tenth of the residual stream's variance and the stream
    grows by about 4x over the backbone, not by 2^16."""
    import torch
    import torch.nn as nn
    from segland_tpu_torch.models.backbones.resnet import Bottleneck

    with torch.no_grad():
        for part in (model.backbone, model.decoder):
            for m in part.modules():
                if isinstance(m, nn.Conv2d):
                    fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                    m.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=g)
                elif isinstance(m, nn.BatchNorm2d):
                    m.running_mean.normal_(0.0, 0.1, generator=g)
                    m.running_var.uniform_(0.8, 1.2, generator=g)
                    m.bias.normal_(0.0, 0.1, generator=g)
        for blk in model.backbone.modules():
            if isinstance(blk, Bottleneck):
                blk.bn3.weight.uniform_(0.2, 0.4, generator=g)


def build_resnet(name, dtype, dev, seed=0):
    """A model of RESNET_MODELS at its default backbone on ``dev``, its trunk
    drawn by tame_resnet.  The POP head then sees features with a large
    common mean, which random prototypes hand to the background logit at
    every pixel.  So the prototypes are made orthogonal to the mean feature of
    one seeded 256^2 tile, and the classifier's last layer takes the sign that
    makes the background logit of that mean negative: the seven base classes
    then compete pixel by pixel.  The plain pspnet's linear classifier keeps
    its draw."""
    import torch
    from segland_tpu_torch.models import build_model
    from segland_tpu_torch.ops import pop as pop_ops

    g = torch.Generator().manual_seed(seed)
    model = build_model(name, None, n_base=7, dtype=dtype, generator=g)
    tame_resnet(model, g)
    model = model.to(dev)
    if not hasattr(model, "base_emb"):
        return model
    with torch.no_grad():
        tile = torch.randn(1, 3, 256, 256, generator=g).to(dev)
        mean = model.extract_features(tile).mean(dim=(0, 1, 2))
        unit = mean / mean.norm()
        model.base_emb.sub_((model.base_emb @ unit)[:, None] * unit)
        if float(pop_ops.classifier_apply(mean, *model.classifier.weights())) > 0:
            model.classifier[4].weight.neg_()
    return model


def phase_int8_slice(dev, name, n_batches=N_BATCHES):
    """A model of RESNET_MODELS at its default backbone (resnet50, pspplus_pop's
    resnet50v2) at output stride 8 through
    Evaluator.run four ways: bf16 unquantized, --int8 (conv by conv), --int8
    --fused (K7 in the 12 eligible bottlenecks), and the last with the
    kernels' plain versions.  One calibration batch, taken in the warm-up run."""
    import torch
    from segland_tpu_torch.evallib import Evaluator
    from segland_tpu_torch.quant import QuantConfig

    model = build_resnet(name, torch.bfloat16, dev)
    batches = synthetic_batches()[:n_batches]
    kw = dict(num_classes=12, n_base=7, normalize_on_device=True)
    q = dict(int8=True, calib_batches=1)
    fused_cfg = QuantConfig(fused_blocks=True)
    routes = {
        "bf16": (Evaluator(model, dev, **kw), {"upsample_argmax": 1}),
        "int8": (Evaluator(model, dev, **q, **kw), {"upsample_argmax": 1}),
        "int8 fused": (Evaluator(model, dev, quant_cfg=fused_cfg, **q, **kw),
                       {"bottleneck_int8": 12, "upsample_argmax": 1}),
        "int8 fused, plain versions": (Evaluator(model, dev, quant_cfg=fused_cfg,
                                                 plain_kernels=True, **q, **kw), {}),
    }
    tps, launches, preds = {}, {}, {}
    for route, (ev, per_batch) in routes.items():
        ev.run(batches)  # warm-up: calibration, cuDNN plans, allocators
        torch.cuda.synchronize()
        (cm, (base, _, total, _), tps[route]), launches[route] = counted_run(ev, batches)
        print(f"slice {name} {route}: {n_batches}x{BATCH} tiles {TILE}^2: "
              f"launches={launches[route]} mIoU base={base:.4f} total={total:.4f} "
              f"tiles_per_s={tps[route]:.2f} pixels={int(cm.sum())}", flush=True)
        want = {key: n * n_batches for key, n in per_batch.items()}
        if launches[route] != want:
            fail(f"slice {name} {route} launch counts {launches[route]}, want {want}")
        if int(cm.sum()) != n_batches * BATCH * (TILE - 16) * TILE:
            fail("confusion matrix does not count every labelled pixel")
        preds[route] = [ev.predict_batch(imgs, (TILE, TILE), want_logits=False)[1]
                        for imgs, _, _ in batches]
    logits, _ = routes["int8 fused"][0].predict_batch(batches[0][0], (TILE, TILE))
    if logits.shape != (BATCH, TILE, TILE, 8) or not bool(logits.isfinite().all()):
        fail(f"slice {name} int8 fused logits {tuple(logits.shape)} not finite")
    classes = int(torch.unique(preds["bf16"][0]).numel())
    del logits
    agree = lambda a, b: float(torch.stack([(x == y).float().mean() for x, y in
                                            zip(preds[a], preds[b])]).mean())
    k_vs_plain = agree("int8 fused", "int8 fused, plain versions")
    ev = routes["int8 fused"][0]
    preds["again"] = [ev.predict_batch(imgs, (TILE, TILE), want_logits=False)[1]
                      for imgs, _, _ in batches]
    print(f"slice {name} argmax agreement: K7 route vs its plain versions {k_vs_plain:.6f} "
          f"(K7 route run twice {agree('int8 fused', 'again'):.6f}); "
          f"int8 vs bf16 {agree('int8', 'bf16'):.6f}; int8 fused vs bf16 "
          f"{agree('int8 fused', 'bf16'):.6f}; int8 fused vs int8 "
          f"{agree('int8 fused', 'int8'):.6f}; classes predicted in bf16: {classes}", flush=True)
    if k_vs_plain < 0.99:
        fail(f"slice {name}: K7 route vs plain versions argmax agreement {k_vs_plain:.4f} < 0.99")
    print(f"{name} eval default: bf16 {tps['bf16']:.2f} tiles/s, --int8 {tps['int8']:.2f}, "
          f"--int8 --fused {tps['int8 fused']:.2f}, with plain versions "
          f"{tps['int8 fused, plain versions']:.2f}", flush=True)
    return launches["int8 fused"]


def phase_conv3_probe():
    """K8's path: the conv3 probe's entry point, at its own shapes."""
    from segland_tpu_torch.benchmarks import conv3_probe

    iters = 3
    rows, launches = counted(lambda: conv3_probe.main(["--iters", str(iters)]))
    # a shape: one launch compared with the per-conv path, a warm-up, the timed ones
    want = {"conv3_residual": len(rows) * (2 + iters)}
    if launches != want:
        fail(f"conv3_probe launch counts {launches}, want {want}")
    return launches


def phase_unfused(dev, name, backbone=None):
    """The unfused model (stock torch blocks, --no-fused): what the eval
    default of --fused is set against.  Returns (model, evaluator, tiles/s)."""
    import torch
    from segland_tpu_torch.evallib import Evaluator

    batches = synthetic_batches()
    model = build(name, torch.bfloat16, fused=False, backbone=backbone).to(dev)
    ev = Evaluator(model, dev, num_classes=12, n_base=7, normalize_on_device=True)
    ev.run(batches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (_, (_, _, total_u, _), tps_u), launches = counted_run(ev, batches)
    peak = torch.cuda.max_memory_allocated()
    print(f"slice {name}{' ' + backbone if backbone else ''} unfused (--no-fused): mIoU "
          f"total={total_u:.4f} tiles_per_s={tps_u:.2f} launches={launches} "
          f"max_memory_allocated={peak / 2**30:.2f} GiB", flush=True)
    if launches != {"upsample_argmax": N_BATCHES}:
        fail(f"unfused {name} launch counts {launches}")
    return model, ev, tps_u


def phase_swin_routes(dev, backbone=None, near_tie=None):
    """The unfused swin_pop model, then one batch of it through the use_pallas
    route, which runs K6 in every block.  With ``near_tie`` the agreement held
    is over the pixels whose top-2 gap in the unfused route's logits exceeds it
    (phase_slice)."""
    from segland_tpu_torch.models.backbones.swin import WindowAttention

    batches = synthetic_batches()
    model, ev, tps_u = phase_unfused(dev, "swin_pop", backbone)
    lu, pu = ev.predict_batch(batches[0][0], (TILE, TILE), want_logits=near_tie is not None)
    for m in model.modules():
        if isinstance(m, WindowAttention):
            m.use_pallas = True
    (_, (_, _, total_p, _), tps_p), launches = counted_run(ev, batches[:1])
    _, pp = ev.predict_batch(batches[0][0], (TILE, TILE), want_logits=False)
    frac = held = float((pu == pp).float().mean())
    beyond = ""
    if near_tie is not None:
        top2 = lu.topk(2, dim=-1).values
        far = top2[..., 0] - top2[..., 1] > near_tie
        held = float(((pu == pp) & far).sum()) / float(far.sum())
        beyond = (f" beyond_near_ties(gap>{near_tie}: {float(far.float().mean()):.4f} of "
                  f"pixels)={held:.6f}")
        del lu, top2, far
    print(f"slice swin_pop{' ' + backbone if backbone else ''} use_pallas: "
          f"launches={launches} mIoU total={total_p:.4f} tiles_per_s={tps_p:.2f} "
          f"argmax_agreement_with_unfused={frac:.6f}{beyond}", flush=True)
    if launches != {"window_attention": 24, "upsample_argmax": 1}:
        fail(f"use_pallas launch counts {launches}, want window_attention=24")
    if held < 0.99:
        fail(f"use_pallas vs unfused argmax agreement {held:.4f} < 0.99")
    return launches, tps_u


# swin-b's and swin-l's stages of a batch of 8 1024^2 tiles, as SWIN_STAGES
SWIN_BL_STAGES = {
    "swin-b": ((2, 128, 4, 256, 259), (2, 256, 8, 128, 133), (18, 512, 16, 64, 70),
               (2, 1024, 32, 32, 35)),
    "swin-l": ((2, 192, 6, 256, 259), (2, 384, 12, 128, 133), (18, 768, 24, 64, 70),
               (2, 1536, 48, 32, 35))}
SWIN_BL_WIDTHS = (128, 256, 512, 1024, 1536)  # the widths whose K1 and K3 builds they add
SWIN_BL_CLASS_SHARE = 0.9  # the most of a swinbl slice's map that one class may take
# bf16 rounding through 24 random blocks moves the logits by 0.007 on average (0.3 at most)
# on both bf16 routes alike, so their maps part where two classes nearly tie (PERF.md,
# section 6): the agreement held is over pixels whose top-2 gap exceeds SWIN_BL_NEAR_TIE,
# and fp32 judges both routes
SWIN_BL_NEAR_TIE = 0.01
FP32_ROUTE_MARGIN = 1e-3  # of pixels: the kernel route's agreement with fp32 below the plain


def swinbl_kernels(dev):
    """K1 and K3 at swin-b's and swin-l's stage shapes: the new builds'
    registers and spills (a spill fails), each stage shape in bf16 (K3 with
    shift 0 and 3) against the plain version with the bound, the plain and the
    stock-torch route's ms and the clock build's phase split; the new widths
    also in fp32, a ragged M (K1) and a part-empty last block (K3); each
    forward's sum (24 blocks).  Returns {kernel: {"C=..": numbers}}."""
    import torch
    from segland_tpu_torch.ops.fused_attn import section_plan
    from segland_tpu_torch.ops.fused_mlp import ln_mlp_plan

    build_attrs("segland_ln_mlp_attrs", SWIN_BL_WIDTHS, "K1")
    build_attrs("segland_attn_section_attrs", SWIN_BL_WIDTHS, "K3")
    rows = {"ln_mlp": {}, "attn_section": {}}
    for bb, stages in SWIN_BL_STAGES.items():
        sums = {name: [0.0, 0.0, 0.0] for name in ("K1", "K3")}  # kernel, plain, torch route
        k1_bounds, k3_bounds = [], []
        for i, (blocks, c, nh, side, pside) in enumerate(stages):
            m, nw = BATCH * side * side, BATCH * (pside // 7) ** 2
            plan = ln_mlp_plan(c, 4 * c)
            print(f"K1 plan C={c}: rows {plan['rows']} a tile, warpgroups {plan['rg']} x "
                  f"{plan['cg']}, passes {plan['np']}, hidden chunk {plan['hc']}, ring "
                  f"{plan['s']} x {plan['slot_bytes'] // 1024} KB, y "
                  f"{'streamed' if plan['stream_y'] else 'resident'}, smem {plan['smem']:,} B, "
                  f"accumulator and fragment registers {plan['acc_regs']}", flush=True)
            e, t, tp, tt = check_k1(dev, m, c, torch.bfloat16, 2e-2, 1e-2, 40 + i)
            b = bound(16 * m * c * c, 3 * m * c * 2 + 8 * c * c * 2)
            print(f"K1 {bb} stage {i} M={m} C={c}: kernel_ms={t:.4f} bound_ms={b[0]:.4f} "
                  f"({b[1]}) share={b[0] / t:.3f}", flush=True)
            rows["ln_mlp"][f"C={c} M={m}"] = dict(max_abs_err=e, ms=t, plain_ms=tp,
                                                  torch_route_ms=tt, bound_ms=b[0],
                                                  bound_by=b[1])
            sums["K1"] = [a + blocks * v for a, v in zip(sums["K1"], (t, tp, tt))]
            k1_bounds += [b] * blocks
            plan = section_plan(c)
            print(f"K3 plan C={c}: {plan['w']} windows a block ({plan['row_tiles']} m64 row tiles, "
                  f"split by {plan['split']}, n{plan['n']}, last pass {plan['last_pass']} "
                  f"columns), ring {plan['s']} x {plan['slot_bytes'] // 1024} KB, y "
                  f"{'streamed' if plan['stream_y'] else 'resident'}, smem {plan['smem']:,} B, "
                  f"accumulator registers {plan['acc_regs']}", flush=True)
            t3 = tp3 = tt3 = e3 = 0.0
            for shift in (0, 3):  # the blocks of a stage alternate
                e, t, tp, tt = check_k3(dev, BATCH, c, nh, side, pside, shift, torch.bfloat16,
                                        2e-2, 1e-2, 50 + i)
                e3, t3, tp3, tt3 = max(e3, e), t3 + t / 2, tp3 + tp / 2, tt3 + tt / 2
            b = bound(2 * nw * 49 * c * (4 * c + 2 * 49),
                      2 * nw * 49 * c * 2 + 4 * c * c * 2 + nh * 49 * 49 * 4)
            print(f"K3 {bb} stage {i} NW={nw} C={c}: kernel_ms={t3:.4f} (shift 0 and 3) "
                  f"bound_ms={b[0]:.4f} ({b[1]}) share={b[0] / t3:.3f}", flush=True)
            rows["attn_section"][f"C={c} NW={nw}"] = dict(max_abs_err=e3, ms=t3, plain_ms=tp3,
                                                          torch_route_ms=tt3, bound_ms=b[0],
                                                          bound_by=b[1])
            sums["K3"] = [a + blocks * v for a, v in zip(sums["K3"], (t3, tp3, tt3))]
            k3_bounds += [b] * blocks
            if c in SWIN_BL_WIDTHS:  # the new builds in fp32 too (TF32 off)
                check_k1(dev, 2 * side * side, c, torch.float32, 1e-4, 1e-4, 60 + i)
                check_k3(dev, 1, c, nh, side, pside, 3, torch.float32, 1e-4, 1e-4, 70 + i)
        for name, bounds in (("K1", k1_bounds), ("K3", k3_bounds)):
            b_ms, b_by = sum_bounds(bounds)
            ms, plain_ms, torch_ms = sums[name]
            print(f"{name} per {bb} forward of {BATCH} tiles (24 blocks): kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} torch_route_ms={torch_ms:.4f} bound_ms={b_ms:.4f} "
                  f"({b_by})", flush=True)
    # a ragged M (K1: y's last 64-row box zero-filled by TMA where y streams) and a
    # part-empty last block (K3: 49 windows at 4 and 81 at 2 a block)
    for m, c in ((BATCH * 32 * 32 - 19, 1536), (BATCH * 64 * 64 - 19, 512)):
        check_k1(dev, m, c, torch.bfloat16, 2e-2, 1e-2, 80, with_res=False, with_ls=False)
    check_k3(dev, 1, 128, 4, 45, 49, 3, torch.bfloat16, 2e-2, 1e-2, 81)
    check_k3(dev, 1, 256, 8, 60, 63, 3, torch.bfloat16, 2e-2, 1e-2, 82)
    return rows


def swinbl_blocks(dev):
    """K4 and K5 at swin-b's and swin-l's stage shapes: the new builds'
    registers and spills (a spill fails; K5 every group, so both paths), each
    stage shape in bf16 with shift 0 and 3, K4 against block_reference and
    bit for bit against K3 then K1 (check_k4), K5 at every group against
    attn_section_reference and at group 1 against K3 (check_k5), with the
    kernel, plain and (K4) K3-then-K1 ms and the bound; the new widths also in
    fp32 (TF32 off, 1e-4); each forward's sum (24 blocks; K5 at the main
    path's group).  Returns {kernel: {"C=..": numbers}}."""
    import torch
    from segland_tpu_torch.ops.fused_attn import block_plan, v1_plan

    build_attrs("segland_swin_block_attrs", SWIN_BL_WIDTHS, "K4")
    build_attrs("segland_attn_section_v1_attrs",
                [(c, g) for c in SWIN_BL_WIDTHS for g in K5_GROUPS], "K5", names=("C", "group"))
    bf = torch.bfloat16
    rows = {"swin_block": {}, "attn_section_v1": {}}
    for bb, stages in SWIN_BL_STAGES.items():
        sums = {"K4": [0.0, 0.0, 0.0], "K5": [0.0, 0.0]}  # kernel, plain (K4: K3 then K1)
        k4_bounds, k5_bounds = [], []
        for i, (blocks, c, nh, side, pside) in enumerate(stages):
            nw = BATCH * (pside // 7) ** 2
            plan = block_plan(c)
            print(f"K4 plan C={c}: {plan['w']} windows a block ({plan['row_tiles']} m64 row "
                  f"tiles, last pass {plan['last_pass']} columns), ring {plan['s']} x "
                  f"{plan['slot_bytes'] // 1024} KB ({plan['slots_per_block']} slots a block), y "
                  f"{'streamed' if plan['stream_y'] else 'resident'}, MLP warpgroups "
                  f"{plan['rg']} x {plan['cg']}, passes {plan['np']}, hidden chunk {plan['hc']}, "
                  f"{plan['items']} work items, smem {plan['smem']:,} B", flush=True)
            e4 = t4 = t2 = tp4 = 0.0
            for shift in (0, 3):  # the blocks of a stage alternate
                e, t, tt, tp = check_k4(dev, BATCH, c, nh, side, pside, shift, bf, 2e-2, 1e-2,
                                        90 + i)
                e4, t4, t2, tp4 = max(e4, e), t4 + t / 2, t2 + tt / 2, tp4 + tp / 2
            b = bound(2 * nw * 49 * c * (4 * c + 2 * 49) + 16 * nw * 49 * c * c,
                      2 * nw * 49 * c * 2 + 24 * c * c + nh * 49 * 49 * 4)
            print(f"K4 {bb} stage {i} NW={nw} C={c}: kernel_ms={t4:.4f} (shift 0 and 3) "
                  f"k3_then_k1_ms={t2:.4f} bound_ms={b[0]:.4f} ({b[1]}) share={b[0] / t4:.3f}",
                  flush=True)
            rows["swin_block"][f"C={c} NW={nw}"] = dict(max_abs_err=e4, ms=t4, plain_ms=tp4,
                                                        k3_then_k1_ms=t2, bound_ms=b[0],
                                                        bound_by=b[1])
            sums["K4"] = [a + blocks * v for a, v in zip(sums["K4"], (t4, tp4, t2))]
            k4_bounds += [b] * blocks
            for g in K5_GROUPS:
                plan = v1_plan(c, g)
                print(f"K5 plan C={c} group={g}: {plan['path']} path, {plan['windows_a_block']} "
                      f"windows a block, ring {plan['s']} x {plan['slot_bytes'] // 1024} KB, y "
                      f"{'streamed' if plan['stream_y'] else 'resident'}, smem {plan['smem']:,} "
                      f"B, scratch tensor {'yes' if plan['scratch'] else 'no'}", flush=True)
            e5, by_group, tp5 = 0.0, {g: 0.0 for g in K5_GROUPS}, 0.0
            for shift in (0, 3):  # per-window mask rows; regions with the shift
                e, times, tp = check_k5(dev, BATCH, c, nh, side, pside, shift, bf, 2e-2, 1e-2,
                                        100 + i, timed=True, against_k3=True)
                e5, tp5 = max(e5, e), tp5 + tp / 2
                for g, t in times.items():
                    by_group[g] += t / 2
            nbytes = (2 * nw * 49 * c * 2 + 8 * c * c + nh * 49 * 49 * 4
                      + 2 * (pside // 7) ** 2 * 49 * 4)
            b = bound(2 * nw * 49 * c * (4 * c + 2 * 49), nbytes)
            t5 = by_group[K5_MAIN_GROUP]
            print(f"K5 {bb} stage {i} NW={nw} C={c}: "
                  + " ".join(f"g{g}_ms={t:.4f}" for g, t in by_group.items())
                  + f" (shift 0 and 3) plain_ms={tp5:.4f} bound_ms={b[0]:.4f} ({b[1]}) "
                  f"share(group={K5_MAIN_GROUP})={b[0] / t5:.3f}", flush=True)
            rows["attn_section_v1"][f"C={c} NW={nw}"] = dict(
                max_abs_err=e5, ms=t5, plain_ms=tp5, bound_ms=b[0], bound_by=b[1],
                ms_by_group={str(g): t for g, t in by_group.items()})
            sums["K5"] = [a + blocks * v for a, v in zip(sums["K5"], (t5, tp5))]
            k5_bounds += [b] * blocks
            if c in SWIN_BL_WIDTHS:  # the new builds in fp32 too (TF32 off)
                check_k4(dev, 1, c, nh, side, pside, 3, torch.float32, 1e-4, 1e-4, 110 + i)
                check_k5(dev, 1, c, nh, side, pside, 3, torch.float32, 1e-4, 1e-4, 120 + i)
        for name, bounds in (("K4", k4_bounds), ("K5", k5_bounds)):
            b_ms, b_by = sum_bounds(bounds)
            extra = (f" k3_then_k1_ms={sums['K4'][2]:.4f}" if name == "K4"
                     else f" (group={K5_MAIN_GROUP})")
            print(f"{name} per {bb} forward of {BATCH} tiles (24 blocks): "
                  f"kernel_ms={sums[name][0]:.4f}{extra} plain_ms={sums[name][1]:.4f} "
                  f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
    # a part-empty last block (K5's windows path at two windows a block: 81 windows)
    check_k5(dev, 1, 256, 8, 60, 63, 3, bf, 2e-2, 1e-2, 130)
    return rows


def phase_swinbl(dev):
    """swin_pop on swin-b and swin-l (the fused route, K3 then K1 in every
    block): the kernels at their shapes (swinbl_kernels, swinbl_blocks), then
    each model at full width and depth through the eval slice as eval_base and
    as eval_ft run it (K3 24, K1 24, K2 1 a batch; >= 99% agreement with the
    plain versions; tiles/s and max_memory_allocated; fp32 card vs CPU), the
    unfused model's tiles/s and, for swin-l, one batch through the use_pallas
    route (K6); then one batch of each model by the whole-block route (K4 24)
    and by attn_group = 2 (K5 24, K1 24), each held to its plain versions and
    to the fp32 stock-torch route as the fused route is.  Returns (the
    kernels' numbers by width, launches by path)."""
    import torch

    rows = swinbl_kernels(dev)
    rows.update(swinbl_blocks(dev))
    torch.cuda.empty_cache()
    per_batch = {"ln_mlp": 24, "upsample_argmax": 1, "attn_section": 24}
    paths = {}
    for bb, stages in SWIN_BL_STAGES.items():
        spatial = sum(blocks * BATCH * side * side for blocks, _, _, side, _ in stages)
        paths[f"swin_pop {bb} eval_base"], tps_f, tps_p = phase_slice(
            dev, "swin_pop", per_batch, k1_rows=spatial, backbone=bb,
            max_class_share=SWIN_BL_CLASS_SHARE, near_tie=SWIN_BL_NEAR_TIE)
        torch.cuda.empty_cache()
        paths[f"swin_pop {bb} eval_ft"], _, _ = phase_slice(
            dev, "swin_pop", per_batch, is_ft=True, fp32_check=False, backbone=bb,
            max_class_share=SWIN_BL_CLASS_SHARE, near_tie=SWIN_BL_NEAR_TIE)
        torch.cuda.empty_cache()
        if bb == "swin-l":
            paths[f"swin_pop {bb} use_pallas"], tps_u = phase_swin_routes(dev, bb,
                                                                          SWIN_BL_NEAR_TIE)
        else:
            _, _, tps_u = phase_unfused(dev, "swin_pop", bb)
        torch.cuda.empty_cache()
        # the whole-block kernel in every block, and super-window groups (K5 then K1)
        with environ(SEGLAND_SWIN_V3_STAGES="all"):
            paths[f"swin_pop {bb} whole-block"], tps_b, _ = phase_slice(
                dev, "swin_pop", {"swin_block": 24, "upsample_argmax": 1}, fp32_check=False,
                route="SEGLAND_SWIN_V3_STAGES=all", n_batches=1, backbone=bb,
                max_class_share=SWIN_BL_CLASS_SHARE, near_tie=SWIN_BL_NEAR_TIE)
        torch.cuda.empty_cache()
        paths[f"swin_pop {bb} attn_group"], tps_g, _ = phase_slice(
            dev, "swin_pop", {"attn_section_v1": 24, "ln_mlp": 24, "upsample_argmax": 1},
            fp32_check=False, route=f"attn_group={K5_MAIN_GROUP}", attn_group=K5_MAIN_GROUP,
            k1_rows=spatial, n_batches=1, backbone=bb, max_class_share=SWIN_BL_CLASS_SHARE,
            near_tie=SWIN_BL_NEAR_TIE)
        torch.cuda.empty_cache()
        print(f"swin_pop {bb} eval default: fused {tps_f:.2f} tiles/s, whole-block "
              f"{tps_b:.2f}, attn_group={K5_MAIN_GROUP} {tps_g:.2f}, plain versions "
              f"{tps_p:.2f}, unfused {tps_u:.2f}", flush=True)
    return rows, paths


GROUPS = (("K7 bottleneck_int8", ("bottleneck_conv1_kernel", "bottleneck_conv23_kernel")),
          ("K8 conv3_residual", ("conv3_residual_kernel",)),
          ("K4 swin_block", ("swin_block",)), ("K5 attn_section_v1", ("attn_section_v1",)),
          ("K3 attn_section", ("attn_section",)), ("K1 ln_mlp", ("ln_mlp",)),
          ("K6 window_attention", ("window_attention",)),
          ("K2 upsample_argmax", ("upsample_argmax",)),
          ("conv, cuDNN", ("conv", "cudnn", "implicit", "wgrad", "dgrad")),
          ("gemm, cuBLAS", ("gemm", "cutlass", "cublas", "xmma", "nvjet")),
          ("layer_norm / batch_norm", ("layer_norm", "batch_norm", "LayerNorm", "bn_fw")),
          ("softmax", ("softmax",)), ("interpolate", ("upsample", "interpolate", "bilinear")),
          ("roll / pad / copy / cast", ("copy", "roll", "pad", "Memcpy DtoD", "CatArray")),
          ("H2D memcpy", ("Memcpy HtoD",)), ("bincount", ("bincount", "histogram", "Histogram")))


def profiled_run(ev, batches, label):
    """torch.profiler over one Evaluator.run: device time per batch grouped by
    kernel name, and the idle share of the traced wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ev.run(batches)  # warm-up (and the calibration of an int8 route)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ev.run(batches)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    sums = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us <= 0 or evt.device_type != DeviceType.CUDA:
            continue  # kernels only: an operator's entry repeats its kernels' time
        group = next((g for g, keys in GROUPS if any(k in evt.key for k in keys)),
                     "elementwise / other")
        sums[group] = sums.get(group, 0.0) + dev_us / 1e3
    busy = sum(sums.values())
    if busy <= 0:
        fail("the profiler recorded no device time")
    print(f"profile {label}: traced wall {wall_ms:.2f} ms for {len(batches)} batches, "
          f"device busy {busy:.2f} ms, idle share {1 - busy / wall_ms:.3f}", flush=True)
    for group, ms in sorted(sums.items(), key=lambda kv: -kv[1]):
        print(f"  {group}: {ms / len(batches):.3f} ms per batch", flush=True)


def phase_profile(dev):
    """The swin slice fused and unfused, then the deeplab_pop slice in bf16,
    --int8 and --int8 --fused, each through :func:`profiled_run`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from segland_tpu_torch.evallib import Evaluator
    from segland_tpu_torch.quant import QuantConfig

    batches = synthetic_batches()
    kw = dict(num_classes=12, n_base=7, normalize_on_device=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device=dev)  # the tracer's start-up, outside the timed windows
    for fused in (True, False):
        model = build("swin_pop", torch.bfloat16, fused=fused).to(dev)
        profiled_run(Evaluator(model, dev, **kw), batches,
                     f"swin_pop {'fused' if fused else 'unfused'}")
        del model
        torch.cuda.empty_cache()
    model = build_resnet("deeplab_pop", torch.bfloat16, dev)
    q = dict(int8=True, calib_batches=1)
    profiled_run(Evaluator(model, dev, **kw), batches, "deeplab_pop bf16")
    profiled_run(Evaluator(model, dev, **q, **kw), batches, "deeplab_pop --int8")
    profiled_run(Evaluator(model, dev, quant_cfg=QuantConfig(fused_blocks=True), **q, **kw),
                 batches, "deeplab_pop --int8 --fused")


def phase_dilated(dev):
    """A 3x3 convolution [8,2048,128,128] -> 256 in bf16, channels-last, at
    ASPP's dilations: cuDNN (F.conv2d) beside the nine-tap form that
    ops/layers.py takes above TAPS_ABOVE_DILATION.  One run each, after one
    warm-up at the small dilation only: cuDNN takes seconds at 12 and 18."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as F
    from segland_tpu_torch.ops.layers import TAPS_ABOVE_DILATION, _conv_by_taps

    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(BATCH, 2048, 128, 128, device=dev, generator=g).bfloat16()
    x = x.contiguous(memory_format=torch.channels_last)
    for d in (6, 12, 18):
        conv = nn.Conv2d(2048, 256, 3, padding=d, dilation=d, bias=False).to(dev)
        conv.requires_grad_(False)
        w = conv.weight.bfloat16()
        iters = 5 if d <= TAPS_ABOVE_DILATION else 1
        cudnn_ms = cuda_ms(lambda: F.conv2d(x, w, None, 1, d, d), iters=iters, warmup=iters - 1)
        taps_ms = cuda_ms(lambda: _conv_by_taps(conv, x), iters=5, warmup=1)
        err = float((F.conv2d(x, w, None, 1, d, d).float() - _conv_by_taps(conv, x).float())
                    .abs().max())
        print(f"dilated 3x3 d={d}: cudnn_ms={cudnn_ms:.2f} nine_taps_ms={taps_ms:.2f} "
              f"max_abs_diff={err:.4f} taps_taken_by_the_port={d > TAPS_ABOVE_DILATION}",
              flush=True)


def phase_steprule(dev):
    """What the fp32 step check's rule does with routes that are correct by
    construction: for each model of TRAIN_MODELS and batch seeds 4 (the train
    phase's), 5 and 6, the fp32 step's gradients (train_step_model's weights)
    by the kernel route, the stock-torch blocks and the plain route on the
    image scaled by 1 +- 2^-20 and by 1 +- FP32_SUM_FLOOR, each route's
    relative error from the plain route; printed, per route, the largest share
    of "2 x the stock-torch blocks' error + 1e-6" over the tensors, and the
    kernel route's largest share of "2 x the farthest of the stock-torch blocks
    and the 1 +- FP32_SUM_FLOOR routes + 1e-6" (TRAIN_PERTURBED's rule)."""
    import torch
    from segland_tpu_torch.ops import plain_versions

    scales = {"x(1+2^-20)": 1 + 2 ** -20, "x(1-2^-20)": 1 - 2 ** -20}
    scales.update({k[len("plain "):]: f for k, f in PERTURBED.items()})
    for name in TRAIN_MODELS:
        for seed in (4, 5, 6):
            g = torch.Generator().manual_seed(seed)
            img = torch.randn(TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 3, generator=g).to(dev)
            mask = torch.randint(0, 8, (TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP), generator=g).to(dev)
            model = train_step_model(torch.float32, name=name).to(dev)
            grads = {"kernels": train_step_grads(model, img, mask)[1]}
            with plain_versions():
                ref = train_step_grads(model, img, mask)[1]
                for key, f in scales.items():
                    grads["plain " + key] = train_step_grads(model, img * f, mask)[1]
            del model
            model = train_step_model(torch.float32, fused=False, name=name).to(dev)
            grads["unfused"] = train_step_grads(model, img, mask)[1]
            del model
            torch.cuda.empty_cache()
            err = {r: {n: _rel_err(x[n], ref[n]) for n in ref} for r, x in grads.items()}
            share = lambda r, refs: max(
                (err[r][n] / (2 * max(err[o][n] for o in refs) + 1e-6), n) for n in ref)
            old = [f"{r} {v:.3f} ({n})" for r in grads if r != "unfused"
                   for v, n in [share(r, ["unfused"])]]
            v, n = share("kernels", ["unfused", "plain x(1+e)", "plain x(1-e)"])
            print(f"steprule {name} fp32 batch seed {seed}: the largest share of 2 x stock + 1e-6: "
                  f"{'; '.join(old)}; kernels against 2 x the farthest of stock and plain "
                  f"x(1+-e) + 1e-6: {v:.3f} ({n})", flush=True)


# the dist phase: ranks of a process group, each a process of its own on cuda:0
DIST_TIME_LIMIT = 480  # s the parent waits for a group of ranks before it kills them
DIST_EVAL_TILES = 5  # eval_base's tiles in batches of 2: the last batch leaves rank 1 none
DIST_STEP_MODELS = ("convnext_pop", "swin_pop")  # the fp32 step over the ranks (swin: BN)
DIST_GROUPS = {"nccl": (1, ("train", "fp32", "int8")),  # backend: (world, the jobs its ranks run)
               "gloo": (2, ("train", "fp32", "ft", "eval", "devaug", "int8"))}
# eval_base --int8 on deeplab_pop / resnet50 over DIST_EVAL_TILES tiles: tag: (flags, labelled);
# the unlabelled runs export GTiffs and .mat logits, whose maps are compared with one process's
DIST_INT8 = {"fp32": (("--dtype", "float32", "--int8"), False),
             "fp32 percentile": (("--dtype", "float32", "--int8", "--calib-percentile", "99.9"),
                                 True),
             "bf16": (("--dtype", "bfloat16", "--int8"), False),
             "bf16 fused": (("--dtype", "bfloat16", "--int8", "--fused"), True)}
DIST_INT8_RUNS = {"nccl": ("fp32", "fp32 percentile", "bf16"), "gloo": tuple(DIST_INT8)}
DIST_INT8_SCALE_RTOL = 1e-5  # fp32 scales over the ranks against one process at the global batch
DIST_INT8_AGREEMENT = 0.999  # int8 maps over the ranks against one process's


def weights_digest(model):
    """A digest of every parameter's and buffer's bytes."""
    import hashlib

    import torch

    h = hashlib.blake2b(digest_size=16)
    for v in model.state_dict().values():
        h.update(v.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def recorded_steps(module):
    """``module.make_base_train_step``'s steps, each timed alone (synchronized)
    and followed by a digest of the model's weights: yields {"ms": [...],
    "digests": [...]}."""
    import torch

    rec = {"ms": [], "digests": []}
    make = module.make_base_train_step

    def wrapped(*args, **kwargs):
        step = make(*args, **kwargs)

        def timed(state, *batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, *batch)
            torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["digests"].append(weights_digest(state.model))
            return out

        return timed

    module.make_base_train_step = wrapped
    try:
        yield rec
    finally:
        module.make_base_train_step = make


@contextlib.contextmanager
def bn_reductions():
    """Counts the all-reduces of BatchNorm's statistics (ops/layers.py)."""
    from segland_tpu_torch.ops import layers

    n, reduce = [0], layers.all_reduce_autograd

    def count(*args, **kwargs):
        n[0] += 1
        return reduce(*args, **kwargs)

    layers.all_reduce_autograd = count
    try:
        yield n
    finally:
        layers.all_reduce_autograd = reduce


def dist_batch(dev):
    """The fp32 step's global batch (TRAIN_BATCH x TRAIN_CROP^2): rank 0's rows
    half ignored, so that the CE's global normalisation is exercised."""
    import torch

    g = torch.Generator().manual_seed(7)
    img = torch.randn(TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 3, generator=g)
    mask = torch.randint(0, 8, (TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP), generator=g)
    mask[:TRAIN_BATCH // 2, :, :TRAIN_CROP // 2] = 255
    return img.to(dev), mask.to(dev)


def dist_job_train(dev, root, backend):
    from segland_tpu_torch.cli import train_base

    import torch

    torch.cuda.reset_peak_memory_stats()
    with bn_reductions() as n_bn, recorded_steps(train_base) as rec:
        launches = train_cli_run(dev, os.path.join(root, "train"), "convnext_pop",
                                 suffix=f"_{backend}", backend=backend)
    return dict(launches=launches, ms=rec["ms"], digests=rec["digests"], bn=n_bn[0],
                peak=torch.cuda.max_memory_allocated())


def dist_job_fp32(dev, root, backend):
    """One fp32 step of each of DIST_STEP_MODELS on this rank's rows of
    dist_batch at LR 0: rank 0 saves the (all-reduced) gradients and the loss
    dict for the parent, which holds them to one process's."""
    import torch

    from segland_tpu_torch import dist

    img, mask = dist_batch(dev)
    lo, hi = dist.shard_rows(TRAIN_BATCH // dist.world())
    out = {}
    for name in DIST_STEP_MODELS:
        model = train_step_model(torch.float32, name=name).to(dev)
        with bn_reductions() as n_bn:
            (ld, grads), launches = counted(lambda: train_step_grads(model, img[lo:hi],
                                                                     mask[lo:hi]))
        if dist.is_main():
            torch.save(({k: float(v) for k, v in ld.items()}, {k: g.cpu() for k, g in
                                                               grads.items()}),
                       os.path.join(root, f"fp32_{name}_{backend}.pt"))
        out[name] = dict(launches=launches, bn=n_bn[0], digest=weights_digest(model))
        del model, grads
        torch.cuda.empty_cache()
    return out


def dist_job_ft(dev, root, backend):
    import torch

    torch.cuda.reset_peak_memory_stats()
    cfg = dict(shot=1, per_forward=FT_MODELS["swin_pop"]["per_forward"])
    launches = ft_cli_run(dev, os.path.join(root, "ft"), "swin_pop", cfg=cfg, batch=2,
                          suffix=f"_{backend}", backend=backend)
    return dict(launches=launches, peak=torch.cuda.max_memory_allocated())


def dist_job_eval(dev, root, backend):
    """eval_base over the ranks on DIST_EVAL_TILES labelled tiles (the
    confusion matrix) and on the same tiles unlabelled (each rank's GTiff and
    .mat exports)."""
    ev = os.path.join(root, "eval")
    _, launches = counted(lambda: eval_base_run(ev, "ranks", dist_args(backend)))
    eval_base_run(ev, "ranks_nl", dist_args(backend), labelled=False)
    return dict(launches=launches)


def eval_base_run(ev, out, extra=(), labelled=True, batch=2,
                  model=("--model", "convnext_pop", "--dtype", "bfloat16"), ckpt="model.pth"):
    from segland_tpu_torch.cli import eval_base

    return eval_base.main(["--data-dir", os.path.join(ev, "data" if labelled else "nolabel"),
                           "--val-list", os.path.join(ev, "val.txt"), *model, "--restore-from",
                           os.path.join(ev, ckpt), "--eval-batch", str(batch),
                           "--num-workers", "4", "--save-path", os.path.join(ev, out), *extra])


@contextlib.contextmanager
def made_evaluators():
    """The Evaluators cli.eval_base makes while open (a list)."""
    from segland_tpu_torch.cli import eval_base

    made, plain = [], eval_base.Evaluator

    class Recorded(plain):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    eval_base.Evaluator = Recorded
    try:
        yield made
    finally:
        eval_base.Evaluator = plain


def int8_eval_run(ev, tag, out, extra=(), batch=2):
    """cli.eval_base with DIST_INT8[tag] on deeplab_pop / resnet50 (int8.pth):
    (its launches, its Evaluator's scales as floats)."""
    flags, labelled = DIST_INT8[tag]
    with made_evaluators() as made:
        _, launches = counted(lambda: eval_base_run(
            ev, out, extra, labelled, batch, ("--model", "deeplab_pop", "--backbone", "resnet50",
                                              *flags), "int8.pth"))
    return launches, {k: float(v) for k, v in made[-1]._quant.items()}


def dist_job_int8(dev, root, backend):
    """eval_base --int8 over the ranks, each of DIST_INT8_RUNS[backend] (the
    outputs to eval/int8_<tag>_<backend>): its launches and scales."""
    ev = os.path.join(root, "eval")
    out = {}
    for tag in DIST_INT8_RUNS[backend]:
        launches, scales = int8_eval_run(ev, tag, int8_dir(tag, backend), dist_args(backend))
        out[tag] = dict(launches=launches, scales=scales)
    return out


def int8_dir(tag, who):
    return f"int8_{tag.replace(' ', '_')}_{who}"


def eval_agreement(ev, ids, ranks, one):
    """(cm equal, agreement of the confusion matrices, pixels of the exports
    that differ, of them beyond near-ties of ``one``'s logits) of the eval
    outputs ``ranks`` and ``one`` (their unlabelled runs under ``<name>_nl``)."""
    cm2 = np.load(os.path.join(ev, ranks, "cmatrix_123.npy"))
    cm1 = np.load(os.path.join(ev, one, "cmatrix_123.npy"))
    _, differ, beyond = map_agreement(os.path.join(ev, ranks + "_nl"),
                                      os.path.join(ev, one + "_nl"), ids)
    return (bool(np.array_equal(cm2, cm1)), 1.0 - np.abs(cm2 - cm1).sum() / 2 / cm1.sum(),
            differ, beyond)


def dist_job_devaug(dev, root, backend):
    """train_base --device-augment, one epoch over the ranks; the loss dicts'
    aug_fallback."""
    suffix = f"_aug_{backend}"
    launches = train_cli_run(dev, os.path.join(root, "train"), "convnext_pop", epochs=1,
                             extra=("--device-augment",), suffix=suffix, backend=backend,
                             fall_from=None)
    rows = [json.loads(line) for line in open(os.path.join(
        root, "train", f"convnext_pop_snap{suffix}", "metrics.jsonl"))]
    return dict(launches=launches,
                aug_fallback=[r["value"] for r in rows if r["tag"] == "train/aug_fallback"])


DIST_JOBS = {"train": dist_job_train, "fp32": dist_job_fp32, "ft": dist_job_ft,
             "eval": dist_job_eval, "devaug": dist_job_devaug, "int8": dist_job_int8}


def dist_worker(backend, root, jobs):
    """One rank (chip_smoke.py --dist-worker BACKEND ROOT JOBS, torchrun's
    environment set by the parent): the group on cuda:0, the jobs in turn,
    what they saw into ROOT/<backend>_rank<r>.json."""
    import torch

    from segland_tpu_torch import dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = dist.init_from_env("cuda:0", backend)
    import torch.distributed as tdist

    out = {"backend": tdist.get_backend(), "world": dist.world(), "rank": dist.rank(),
           "device": str(dev)}
    if dev.type != "cuda" or out["backend"] != backend:
        fail(f"rank {dist.rank()}: {dev} over {out['backend']}, want cuda over {backend}")
    for job in jobs.split(","):
        out[job] = DIST_JOBS[job](dev, root, backend)
    with open(os.path.join(root, f"{backend}_rank{dist.rank()}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy()
    return 0


def dist_spawn(root, backend):
    """The ranks of DIST_GROUPS[backend] as processes of their own on cuda:0;
    waits for them within DIST_TIME_LIMIT (then kills them), fails with a
    failed rank's output.  Returns each rank's results and the seconds."""
    import socket

    world, jobs = DIST_GROUPS[backend]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs, logs = [], []
    t0 = time.time()
    for r in range(world):
        logs.append(os.path.join(root, f"{backend}_rank{r}.log"))
        env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), GLOO_SOCKET_IFNAME="lo")
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dist-worker", backend, root,
                 ",".join(jobs)], env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=max(1.0, t0 + DIST_TIME_LIMIT - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        text = open(logs[r]).read()
        for line in text.splitlines():
            if line.startswith(("train ", "ft ")):
                print(f"  {backend} rank {r}/{world}: {line}", flush=True)
        if p.returncode != 0:
            fail(f"dist: rank {r} of {world} over {backend} ended with {p.returncode} "
                 f"(limit {DIST_TIME_LIMIT} s):\n{text[-6000:]}")
    res = [json.load(open(os.path.join(root, f"{backend}_rank{r}.json"))) for r in range(world)]
    return res, time.time() - t0


def write_eval_tiles(ev, dev):
    """DIST_EVAL_TILES random 1024^2 tiles with labels in data/ and the same
    images without labels in nolabel/, a convnext_pop draw (build) as
    model.pth and a deeplab_pop / resnet50 draw (build_resnet) as int8.pth."""
    import torch

    from segland_tpu_torch.ckpt import save_params
    from segland_tpu_torch.data.geotiff import write_tiff

    rng = np.random.RandomState(2)
    for d in ("data/images", "data/labels", "nolabel"):
        os.makedirs(os.path.join(ev, d), exist_ok=True)
    os.symlink(os.path.join(ev, "data", "images"), os.path.join(ev, "nolabel", "images"))
    ids = [f"e{i}" for i in range(DIST_EVAL_TILES)]
    for tid in ids:
        write_tiff(os.path.join(ev, "data", "images", tid + ".tif"),
                   rng.randint(0, 256, (TILE, TILE, 3)).astype(np.uint8))
        lab = rng.randint(0, 12, (TILE // 64, TILE // 64)).repeat(64, 0).repeat(64, 1)
        write_tiff(os.path.join(ev, "data", "labels", tid + ".tif"), lab.astype(np.uint8))
    with open(os.path.join(ev, "val.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    save_params(os.path.join(ev, "model.pth"), build("convnext_pop", torch.bfloat16))
    save_params(os.path.join(ev, "int8.pth"), build_resnet("deeplab_pop", torch.float32, dev))
    return ids


def dist_hold_step(name, backend, root, ref, perturbed, zero):
    """The fp32 step over ``backend``'s ranks against one process (``ref``:
    loss dict, grads), by the step rule of hold_steps with ``perturbed``: each
    gradient's relative error at most twice the farthest of the plain route
    on the image scaled by 1 +- FP32_SUM_FLOOR, plus FP32_SUM_FLOOR; the seg
    loss within 1e-5; the shift_invariant gradients ``zero`` by
    hold_zero_grads."""
    import torch

    ld, grads = torch.load(os.path.join(root, f"fp32_{name}_{backend}.pt"), weights_only=False)
    hold_zero_grads(f"dist {name} fp32 step over {backend}", zero, grads, ref[1])
    worst = (-1.0, "", 0.0, 0.0)
    for n, g in ref[1].items():
        if n in zero:
            continue
        err = _rel_err(grads[n].to(g.device), g)
        bar = 2 * max(_rel_err(p[1][n], g) for p in perturbed) + FP32_SUM_FLOOR
        worst = max(worst, (err / bar, n, err, bar))
        if not err <= bar:
            fail(f"dist {name} fp32 step over {backend}: gradient of {n} {err:.3g} from one "
                 f"process's, bar {bar:.3g}")
    lk, lp = ld["seg_loss"], float(ref[0]["seg_loss"])
    print(f"dist {name} fp32 step ({backend}, {TRAIN_BATCH}x{TRAIN_CROP}^2 over the ranks) vs "
          f"one process: seg_loss {lk:.6f} vs {lp:.6f}; of {len(grads) - len(zero)} gradients "
          f"({len(zero)} shift-invariant held finite apart) the nearest "
          f"its bar {worst[1]} ({worst[0]:.2f} of it: {worst[2]:.3g} against {worst[3]:.3g})",
          flush=True)
    if not abs(lk - lp) <= 1e-5 * abs(lp):
        fail(f"dist {name} fp32 step over {backend}: seg_loss {lk} vs {lp}")


def map_agreement(ranks_dir, one_dir, ids):
    """(agreement, pixels that differ, of them beyond near-ties of one_dir's
    .mat logits) of the GTiffs of two unlabelled eval runs."""
    from scipy.io import loadmat

    from segland_tpu_torch.data.tileio import read_label

    differ = beyond = total = 0
    for tid in ids:
        p2 = read_label(os.path.join(ranks_dir, tid + ".tif"))
        p1 = read_label(os.path.join(one_dir, tid + ".tif"))
        logits = loadmat(os.path.join(one_dir, "prob", tid + ".mat"))["outputs"][0]
        differ += int((p2 != p1).sum())
        beyond += differ_beyond_ties(p2, p1, np.ascontiguousarray(logits.transpose(1, 2, 0)))
        total += p1.size
    return 1.0 - differ / total, differ, beyond


def rank_batches(world, rank, n=DIST_EVAL_TILES, batch=2):
    """The batches of the Loader's shares of ``n`` tiles in global batches of
    ``batch`` that give ``rank`` of ``world`` rows."""
    local = -(-batch // world)
    return sum(1 for b in range(0, n, batch) if rank * local < min(batch, n - b))


def int8_launches(tag, n_batches):
    """DIST_INT8[tag]'s launches over ``n_batches`` batches: K2 1 a labelled
    batch, K7 12 a forward with --fused (none in a calibration forward)."""
    flags, labelled = DIST_INT8[tag]
    per_batch = dict(({"upsample_argmax": 1} if labelled else {}),
                     **({"bottleneck_int8": 12} if "--fused" in flags else {}))
    return {k: v * n_batches for k, v in per_batch.items()}


def check_dist_int8(ev, ids, groups):
    """eval_base --int8 over each group's ranks against one process at the
    global batch (--eval-batch 2), run here: the ranks hold the same scales;
    in fp32 (TF32 off) each within DIST_INT8_SCALE_RTOL of one process's (a
    rank runs a tile a forward, one process two: the convs round otherwise),
    in bf16 the worst ratio printed; the maps (GTiffs, or the confusion
    matrix of a labelled run) at DIST_INT8_AGREEMENT or more, with the pixels
    that differ beyond near-ties of one process's logits; K7 12 a forward and
    K2 1 a labelled batch on every rank."""
    one = {tag: int8_eval_run(ev, tag, int8_dir(tag, "one")) for tag in DIST_INT8}
    for tag, (launches, _) in one.items():
        if launches != int8_launches(tag, rank_batches(1, 0)):
            fail(f"int8 {tag} in one process: launches {launches}")
    for backend, (res, _) in groups.items():
        key = f"{backend} x{len(res)}"
        for tag in DIST_INT8_RUNS[backend]:
            flags, labelled = DIST_INT8[tag]
            got = [r["int8"][tag] for r in res]
            if any(g["scales"] != got[0]["scales"] for g in got):
                fail(f"dist int8 {tag} ({key}): the ranks' scales differ")
            want = one[tag][1]
            if set(got[0]["scales"]) != set(want):
                fail(f"dist int8 {tag} ({key}): scales of {sorted(got[0]['scales'])} against "
                     f"one process's {sorted(want)}")
            # a percentile may be 0 (a layer's input at least 99.9% zeros): 0 against 0 agrees
            ratio, worst = max((0.0 if got[0]["scales"][k] == want[k] else
                                abs(got[0]["scales"][k] / want[k] - 1.0) if want[k] else math.inf,
                                k) for k in want)
            held = tag.startswith("fp32")
            for r, g in enumerate(got):
                want_l = int8_launches(tag, rank_batches(len(res), r))
                if g["launches"] != want_l:
                    fail(f"dist int8 {tag} ({key}) rank {r}: launches {g['launches']}, "
                         f"want {want_l}")
            if labelled:
                cm2 = np.load(os.path.join(ev, int8_dir(tag, backend), "cmatrix_123.npy"))
                cm1 = np.load(os.path.join(ev, int8_dir(tag, "one"), "cmatrix_123.npy"))
                differ = int(np.abs(cm2 - cm1).sum() / 2)
                agree, beyond = 1.0 - differ / cm1.sum(), None
            else:
                agree, differ, beyond = map_agreement(os.path.join(ev, int8_dir(tag, backend)),
                                                      os.path.join(ev, int8_dir(tag, "one")),
                                                      ids)
            print(f"dist int8 {tag} (deeplab_pop / resnet50, {key}, {DIST_EVAL_TILES} {TILE}^2 "
                  f"tiles in global batches of 2) vs one process at --eval-batch 2: "
                  f"{len(want)} scales, worst ratio |s/s_one - 1| {ratio:.3g} ({worst})"
                  f"{' held' if held else ' printed'}; maps: agreement {100 * agree:.4f}%, "
                  f"{differ} pixels differ"
                  + ("" if beyond is None else f", {beyond} beyond near-ties")
                  + f"; launches a rank {[g['launches'] for g in got]}", flush=True)
            if held and not ratio <= DIST_INT8_SCALE_RTOL:
                fail(f"dist int8 {tag} ({key}): scale {worst} {ratio:.3g} from one process's")
            if not agree >= DIST_INT8_AGREEMENT or beyond:
                fail(f"dist int8 {tag} ({key}): agreement {agree}, {beyond} pixels beyond "
                     f"near-ties")


def phase_dist(dev):
    """Training and eval over the ranks of a process group (dist/process.py):
    one NCCL rank (WORLD_SIZE=1) and two ranks on cuda:0 over gloo (NCCL
    refuses two ranks on one card), each a process of its own (chip_smoke.py
    --dist-worker), after the parent built the kernels and the TIFF decoder.
    The ranks run cli.train_base on convnext_pop / convnext-t (bf16 --fused,
    train_oem.sh's global batch 4 of 768^2 crops, AdamW at 1e-3, train_cli_run's
    cut; the two ranks' weights bit-equal after every step; K1 18 a forward and
    K2 1 a validation batch, per rank), one fp32 step of convnext_pop and of
    swin_pop (DropPath live, BatchNorm in its decoder) held to one process's by
    the step rule, and the gloo pair cli.ft_pop on swin_pop / swin-s --fused
    (global batch 2: K3 24 and K1 24 a step and K2 1), cli.eval_base against
    one process on DIST_EVAL_TILES tiles (at the ranks' per-process batch: the
    confusion matrices equal but for argmax near-ties, agreement >= 99.99%; at
    the global batch printed), train_base --device-augment (aug_fallback
    printed; a forced draw bitwise equal to the host pipeline on the card),
    and eval_base --int8 on deeplab_pop / resnet50 (check_dist_int8).  The NCCL rank's group is initialised and its BatchNorm goes
    through the all-reduce.  ms/step and max_memory_allocated per rank are
    printed, not held: the ranks share one card.  Returns {path: launches}."""
    import tempfile

    import torch

    from segland_tpu_torch import native
    from segland_tpu_torch.data import augment as A
    from segland_tpu_torch.data.tileio import read_image, read_label
    from segland_tpu_torch.ops.device_aug import augment_forced

    t_phase = time.time()
    if native.get_lib() is None:
        fail("dist: no native TIFF decoder")  # built here, before the ranks start
    paths = {}
    with tempfile.TemporaryDirectory() as root:
        write_train_tiles(os.path.join(root, "train"))
        write_ft_tiles(os.path.join(root, "ft"))
        ev = os.path.join(root, "eval")
        ids = write_eval_tiles(ev, dev)
        # a forced --device-augment draw on the card against the host pipeline, bit for bit
        img = read_image(os.path.join(root, "train", "images", "tile_0.tif"))
        lab = read_label(os.path.join(root, "train", "labels", "tile_0.tif")).astype(np.int32)
        draws = [(0, 0, False, 0), (131, 7, True, 1), (256, 256, False, 2), (9, 200, True, 3)]
        c = TRAIN_CROP
        got_i, got_l = augment_forced(
            torch.from_numpy(np.stack([img] * 4)).to(dev),
            torch.from_numpy(np.stack([lab] * 4)).to(dev), (c, c), [d[:2] for d in draws],
            [d[2] for d in draws], [d[3] for d in draws])
        for i, (oy, ox, flip, k) in enumerate(draws):
            hi, hl = img[oy:oy + c, ox:ox + c], lab[oy:oy + c, ox:ox + c]
            if flip:
                hi, hl = np.flip(hi, 1), np.flip(hl, 1)
            hi, hl = np.rot90(hi, k, (0, 1)), np.rot90(hl, k, (0, 1))
            hi = A.normalize(hi, A.OEM_TRAIN_MEAN, A.OEM_TRAIN_STD)
            gi, gl = got_i[i].cpu().numpy(), got_l[i].cpu().numpy()
            if not (np.array_equal(gi, hi) and np.array_equal(gl, hl)):
                fail(f"dist: the device augmentation's draw {draws[i]} differs from the host "
                     f"pipeline: {int((gi != hi).sum())} image values (largest "
                     f"{float(np.abs(gi - hi).max()):.3g}), {int((gl != hl).sum())} labels")
        print(f"dist: --device-augment's chain on the card equals the host pipeline bit for "
              f"bit on {len(draws)} forced draws ({c}^2 crops of a {TILE}^2 tile)", flush=True)
        del got_i, got_l
        torch.cuda.empty_cache()

        groups = {}
        for backend in DIST_GROUPS:
            groups[backend] = dist_spawn(root, backend)
            torch.cuda.empty_cache()
        smi = card()
        (one,), t_one = groups["nccl"]
        ranks, t_two = groups["gloo"]
        if one["world"] != 1 or [r["world"] for r in ranks] != [2, 2]:
            fail(f"dist: worlds {one['world']}, {[r['world'] for r in ranks]}")
        # the NCCL rank's BatchNorm went through the all-reduce (swin_pop's decoder)
        if not one["fp32"]["swin_pop"]["bn"] > 0 or not all(
                r["fp32"]["swin_pop"]["bn"] > 0 for r in ranks):
            fail(f"dist: BatchNorm's statistics were not all-reduced: "
                 f"{[g['fp32']['swin_pop']['bn'] for g in [one] + ranks]}")
        if ranks[0]["train"]["digests"] != ranks[1]["train"]["digests"]:
            fail("dist: the two ranks' weights differ after a train step")
        for name in DIST_STEP_MODELS:
            if ranks[0]["fp32"][name]["digest"] != ranks[1]["fp32"][name]["digest"]:
                fail(f"dist: the two ranks' {name} weights differ after the fp32 step")
            got = [r["fp32"][name]["launches"] for r in [one] + ranks]
            if any(g != TRAIN_MODELS[name] for g in got):
                fail(f"dist {name} fp32 step launches {got}, want {TRAIN_MODELS[name]} a rank")
        for job in ("train", "ft", "devaug"):
            if ranks[0][job]["launches"] != ranks[1][job]["launches"]:
                fail(f"dist {job}: the ranks' launches differ: "
                     f"{[r[job]['launches'] for r in ranks]}")
        want = {"ln_mlp": 18 * 3, "upsample_argmax": 3}, {"ln_mlp": 18 * 2, "upsample_argmax": 2}
        if [r["eval"]["launches"] for r in ranks] != list(want):
            fail(f"dist eval launches {[r['eval']['launches'] for r in ranks]}, want {want}")
        for key, res, secs in (("nccl x1", [one], t_one), ("gloo x2", ranks, t_two)):
            for r, rr in enumerate(res):
                ms = rr["train"]["ms"][1:]  # the first step builds DDP's buckets
                print(f"dist train convnext_pop ({key}, rank {r}): ms_per_step="
                      f"{float(np.median(ms)):.2f} (median of {len(ms)}; min {min(ms):.2f} "
                      f"max {max(ms):.2f}) max_memory_allocated="
                      f"{rr['train']['peak'] / 2**30:.2f} GiB"
                      + (f", ft swin_pop {rr['ft']['peak'] / 2**30:.2f} GiB" if "ft" in rr
                         else "") + f" ({smi}; the ranks share the card)", flush=True)
            print(f"dist {key}: the ranks' processes took {secs:.1f}s", flush=True)
        print(f"dist --device-augment: aug_fallback a step {ranks[0]['devaug']['aug_fallback']}",
              flush=True)
        paths["convnext_pop train dist nccl x1"] = one["train"]["launches"]
        paths["deeplab_pop eval_base --int8 --fused dist gloo x2"] = {
            k: sum(r["int8"]["bf16 fused"]["launches"].get(k, 0) for r in ranks)
            for k in ranks[0]["int8"]["bf16 fused"]["launches"]}
        for job, path in (("train", "convnext_pop train dist gloo x2"),
                          ("ft", "swin_pop ft dist gloo x2"),
                          ("eval", "convnext_pop eval_base dist gloo x2"),
                          ("devaug", "convnext_pop train --device-augment dist gloo x2")):
            paths[path] = {k: sum(r[job]["launches"].get(k, 0) for r in ranks)
                           for k in ranks[0][job]["launches"]}

        # eval: the ranks' confusion matrix and exports against one process's, held where the
        # process runs the ranks' shapes (a tile a forward: each rank's share of a batch of 2),
        # printed against one process at the global batch (bf16 rounds otherwise at batch 2)
        for out, batch in (("one", 1), ("one_b2", 2)):
            eval_base_run(ev, out, batch=batch)
            eval_base_run(ev, out + "_nl", labelled=False, batch=batch)
        for one, held in (("one", True), ("one_b2", False)):
            same, agree, differ, beyond = eval_agreement(ev, ids, "ranks", one)
            batch = 1 if held else 2
            print(f"dist eval_base (gloo x2, {DIST_EVAL_TILES} {TILE}^2 tiles in global batches "
                  f"of 2) vs one process at --eval-batch {batch}: confusion matrices "
                  f"{'equal' if same else 'differ'}, agreement {100 * agree:.4f}%; exports: "
                  f"{differ} pixels differ, {beyond} beyond near-ties"
                  + ("" if held else " (printed, not held)"), flush=True)
            if held and (beyond or agree < 0.9999):
                fail(f"dist eval: {beyond} pixels differ beyond near-ties, agreement {agree}")

        check_dist_int8(ev, ids, groups)

        # the fp32 steps: each group's against one process's, by the step rule
        img, mask = dist_batch(dev)
        for name in DIST_STEP_MODELS:
            model = train_step_model(torch.float32, name=name).to(dev)
            ref = train_step_grads(model, img, mask)
            perturbed = [train_step_grads(model, img * f, mask) for f in PERTURBED.values()]
            zero = shift_invariant(name, dev)
            for backend in DIST_GROUPS:
                dist_hold_step(name, backend, root, ref, perturbed, zero)
            del model, ref, perturbed
            torch.cuda.empty_cache()
    print(f"dist phase: {time.time() - t_phase:.1f}s", flush=True)
    return paths


EXPORT_TILES = 32  # unlabeled 1024^2 tiles through Evaluator.run, in batches of BATCH
EXPORT_WORKERS = (4, 1)  # export_workers: the default pool, and one thread


def export_digests(out, ids, mats):
    """{file: digest} of a run's GTiffs and .mat files (a .mat's header text
    without its date: scipy writes the time of the call there)."""
    import hashlib

    out_files = {}
    for tid in ids:
        names = [f"{tid}.tif"] + ([os.path.join("prob", f"{tid}.mat")] if mats else [])
        for name in names:
            data = open(os.path.join(out, name), "rb").read()
            if name.endswith(".mat"):
                data = data[:116].split(b", Created on:")[0] + data[116:]
            out_files[name] = hashlib.blake2b(data, digest_size=16).hexdigest()
    return out_files


def phase_exports(dev):
    """The eval loop's exports on a pool of threads (Evaluator.run's
    export_workers): convnext_pop / convnext-t bf16 --fused with
    normalize_on_device through Evaluator.run over EXPORT_TILES unlabeled
    1024^2 GeoTIFF tiles in batches of BATCH, read by the Loader (4 decode
    threads), writing the colormapped GTiffs alone (K1 18 and K2 1 a batch)
    and then with the .mat logits (K1 18 a batch, no K2: the upsampled fp32
    logits are written), each at export_workers 4 and 1: the files byte-equal
    between the two, tiles/s of each run and of the same batches'
    predict_batch with its device-to-host copies and no write.  Each run's
    folder is removed before the next (32 .mat files are 1 GiB).  Returns
    {path: launches}."""
    import shutil
    import tempfile

    import torch
    from segland_tpu_torch.data import Loader, OEMValDataset
    from segland_tpu_torch.data.geotiff import write_tiff
    from segland_tpu_torch.evallib import Evaluator

    t_phase = time.time()
    model = build("convnext_pop", torch.bfloat16).to(dev)
    ev = Evaluator(model, dev, num_classes=12, n_base=7, normalize_on_device=True)
    n_batches = EXPORT_TILES // BATCH
    paths = {}
    with tempfile.TemporaryDirectory() as root:
        os.makedirs(os.path.join(root, "images"))
        rng = np.random.RandomState(5)
        ids = [f"x{i}" for i in range(EXPORT_TILES)]
        for tid in ids:
            write_tiff(os.path.join(root, "images", tid + ".tif"),
                       rng.randint(0, 256, (TILE, TILE, 3)).astype(np.uint8))
        with open(os.path.join(root, "list.txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
        ds = OEMValDataset(root, os.path.join(root, "list.txt"), base_size=(TILE, TILE),
                           device_normalize=True)
        loader = lambda: Loader(ds, BATCH, num_workers=4)
        host = [images for images, _, _ in loader()]
        ev.predict_batch(host[0], (TILE, TILE), want_logits=False)  # warm-up: cuDNN plans
        alone = {}
        for mats in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for images in host:
                logits, pred = ev.predict_batch(images, (TILE, TILE), want_logits=mats)
                pred.cpu()
                if mats:
                    logits.cpu()
            torch.cuda.synchronize()
            alone[mats] = EXPORT_TILES / (time.perf_counter() - t0)
            del logits, pred
        smi = card()
        for mats in (False, True):
            kind = "GTiff + .mat" if mats else "GTiff"
            digests = {}
            for workers in EXPORT_WORKERS:
                out = os.path.join(root, "out")
                os.makedirs(os.path.join(out, "prob"))
                torch.cuda.synchronize()
                (_, _, tps), launches = counted(lambda: ev.run(
                    loader(), save_path=out,
                    prob_path=os.path.join(out, "prob") if mats else None, data_root=root,
                    export_workers=workers))
                want = {"ln_mlp": 18 * n_batches, **({} if mats else
                                                    {"upsample_argmax": n_batches})}
                print(f"exports {kind} (export_workers={workers}): {EXPORT_TILES} {TILE}^2 "
                      f"tiles in {n_batches} batches of {BATCH}: tiles_per_s={tps:.2f}, "
                      f"predict_batch alone {alone[mats]:.2f}; launches={launches} ({smi})",
                      flush=True)
                if launches != want:
                    fail(f"exports {kind} (export_workers={workers}): launches {launches}, "
                         f"want {want}")
                digests[workers] = export_digests(out, ids, mats)
                shutil.rmtree(out)
                paths[f"convnext_pop eval_base exports {kind} x{workers}"] = launches
            a, b = (digests[w] for w in EXPORT_WORKERS)
            if a != b or len(a) != EXPORT_TILES * (2 if mats else 1):
                fail(f"exports {kind}: {sum(a[k] != b.get(k) for k in a)} of {len(a)} files "
                     f"differ between export_workers {EXPORT_WORKERS}")
            print(f"exports {kind}: the {len(a)} files byte-equal at export_workers "
                  f"{EXPORT_WORKERS[0]} and {EXPORT_WORKERS[1]}", flush=True)
    print(f"exports phase: {time.time() - t_phase:.1f}s", flush=True)
    return paths


def phase_gates(dev):
    """benchmarks/accuracy_gates.py on the card: five models trained through
    cli.train_base with deterministic algorithms, a process a model, every
    gate in bf16 and (K1, K3-K6) fp32.  Fails on a
    degenerate model, a failed hard gate or a kernel arm's launches other than
    counted (each arm's counts set to 0 just before it runs and read just
    after).  Returns {path: launches} of the kernel arms."""
    from segland_tpu_torch.benchmarks import accuracy_gates as AG

    t_phase = time.time()
    trained, records = AG.run_gates(dev, jobs=len(AG.MODELS))
    print(f"gates phase: {time.time() - t_phase:.1f}s, {len(records)} gates, "
          f"{sum(r['ok'] for r in records)} within the bars ({card()})", flush=True)
    print("gates " + json.dumps(dict(trained=trained, gates=records)), flush=True)
    for msg in AG.faults(trained, records, dev):
        fail(msg)
    return {f"gates {r['gate']} {r['dtype']} {r['arm_b']}": r["launches_b"]
            for r in records if r["launches_b"]}


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--phases",
                    default="k1,k2,k3,k6,k4,k5,k8,k7,k10,k9,k11,f32,convnext,train,ft,swin,"
                            "swinbl,deeplab,pspnet,seghr,heads,ensemble,dist,exports,gates",
                    help="comma list of k1,k2,k3,k6,k4,k5,k8,k7,k10,k9,k11,f32,convnext,train,ft,"
                         "swin,swinbl,deeplab,pspnet,seghr,heads,ensemble,dist,exports,gates "
                         "(default: all twenty-five); "
                         "profile: a "
                         "torch.profiler "
                         "breakdown of the swin and deeplab_pop slices; dilated: cuDNN vs the "
                         "nine-tap 3x3 at large dilations; steprule: the fp32 train-step "
                         "check's rule on routes correct by construction")
    phases = set(ap.parse_args(argv).phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from segland_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = card()
    print(f"device: {name} count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda}; nvidia-smi: {smi}", flush=True)

    info = kernels.build()
    kernels.library()
    entry = spills = ""
    for line in info["log"].splitlines():  # a line a kernel: mangled name, registers, spills
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            print(f"  ptxas {entry}: {line.split(':', 1)[1].strip()}; {spills}")
        elif "warning" in line or "error" in line or "(C75" in line:
            print(f"  ptxas: {line.strip()[:160]}")
    print(f"build: {info['seconds']:.1f}s built={info['built']} {info['path']}", flush=True)
    if info["units"]:  # the nvcc processes that ended last, with their ends
        last = sorted(info["units"].items(), key=lambda kv: -kv[1])[:8]
        print("build: last nvcc processes to end (s from the start): "
              + ", ".join(f"{u} {t:.1f}" for u, t in last), flush=True)

    csrc = "segland_tpu_torch/kernels/csrc/"
    kern = {
        "ln_mlp": dict(source=csrc + "ln_mlp.cu", replaces="segland_tpu/ops/pallas_mlp.py:148"),
        "upsample_argmax": dict(source=csrc + "upsample_argmax.cu",
                                replaces="segland_tpu/ops/fused_epilogue.py:143"),
        "attn_section": dict(source=csrc + "attn_section.cu",
                             replaces="segland_tpu/ops/pallas_attn.py:524"),
        "window_attention": dict(source=csrc + "window_attention.cu",
                                 replaces="segland_tpu/ops/pallas_attn.py:65"),
        "swin_block": dict(source=csrc + "swin_block.cu",
                           replaces="segland_tpu/ops/pallas_attn.py:773"),
        "attn_section_v1": dict(source=csrc + "attn_section_v1.cu",
                                replaces="segland_tpu/ops/pallas_attn.py:200"),
        "bottleneck_int8": dict(source=csrc + "bottleneck_int8.cu",
                                replaces="segland_tpu/ops/pallas_bottleneck.py:155"),
        "conv3_residual": dict(source=csrc + "bottleneck_int8.cu",
                               replaces="segland_tpu/ops/pallas_bottleneck.py:269"),
        "hg_section": dict(source=csrc + "attn_section_hg_sm90.cu",
                           replaces="benchmarks/swin_attn_hg.py:125"),
        "hg2_section": dict(source=csrc + "attn_section_hg2_sm90.cu",
                            replaces="benchmarks/swin_attn_hg.py:354"),
        "section": dict(source=csrc + "attn_section_variants.cu",
                        replaces="benchmarks/swin_attn_variants.py:135"),
    }
    for key, tag, phase in (("ln_mlp", "k1", phase_k1), ("upsample_argmax", "k2", phase_k2),
                            ("attn_section", "k3", phase_k3),
                            ("window_attention", "k6", phase_k6),
                            ("swin_block", "k4", phase_k4), ("attn_section_v1", "k5", phase_k5),
                            ("conv3_residual", "k8", phase_k8),
                            ("bottleneck_int8", "k7", phase_k7),
                            ("hg2_section", "k10", phase_k10), ("hg_section", "k9", phase_k9),
                            ("section", "k11", phase_k11)):
        if tag in phases:
            kern[key].update(phase(dev))
            torch.cuda.empty_cache()
    if "f32" in phases:
        for key, err in phase_f32(dev).items():
            kern[key]["fp32_max_abs_err"] = err
        torch.cuda.empty_cache()

    paths = {}
    if "convnext" in phases:
        paths["convnext_pop"], tps_f, tps_p = phase_slice(
            dev, "convnext_pop", {"ln_mlp": 18, "upsample_argmax": 1})
        torch.cuda.empty_cache()
        _, _, tps_u = phase_unfused(dev, "convnext_pop")
        print(f"convnext_pop eval default: fused {tps_f:.2f} tiles/s, plain versions "
              f"{tps_p:.2f}, unfused {tps_u:.2f}", flush=True)
        torch.cuda.empty_cache()
    if "train" in phases:
        paths.update(phase_train(dev))
        torch.cuda.empty_cache()
    if "ft" in phases:
        paths.update(phase_ft(dev))
        torch.cuda.empty_cache()
    if "swin" in phases:
        per_batch = {"ln_mlp": 24, "upsample_argmax": 1, "attn_section": 24}
        # K1's rows a batch: the map's tokens, or with window-resident stages the padded map's
        spatial = sum(blocks * BATCH * side * side for blocks, _, _, side, _ in SWIN_STAGES)
        resident = sum(blocks * BATCH * pside * pside for blocks, _, _, _, pside in SWIN_STAGES)
        paths["swin_pop eval_base"], tps_f, tps_p = phase_slice(dev, "swin_pop", per_batch,
                                                                k1_rows=spatial)
        torch.cuda.empty_cache()
        paths["swin_pop eval_ft"], _, _ = phase_slice(dev, "swin_pop", per_batch, is_ft=True,
                                                      fp32_check=False)
        torch.cuda.empty_cache()
        paths["swin_pop use_pallas"], tps_u = phase_swin_routes(dev)
        torch.cuda.empty_cache()
        # the other fused routes: the whole-block kernel, super-window groups, window-resident
        block = {"swin_block": 24, "upsample_argmax": 1}
        with environ(SEGLAND_SWIN_V3_STAGES="all"):
            paths["swin_pop whole-block"], tps_b, _ = phase_slice(
                dev, "swin_pop", block, route="SEGLAND_SWIN_V3_STAGES=all")
            torch.cuda.empty_cache()
            paths["swin_pop whole-block eval_ft"], _, _ = phase_slice(
                dev, "swin_pop", block, is_ft=True, fp32_check=False,
                route="SEGLAND_SWIN_V3_STAGES=all")
        torch.cuda.empty_cache()
        paths["swin_pop attn_group"], tps_g, _ = phase_slice(
            dev, "swin_pop", {"attn_section_v1": 24, "ln_mlp": 24, "upsample_argmax": 1},
            route=f"attn_group={K5_MAIN_GROUP}", attn_group=K5_MAIN_GROUP, k1_rows=spatial)
        torch.cuda.empty_cache()
        with environ(SEGLAND_SWIN_WR="1"):
            paths["swin_pop window-resident"], tps_w, _ = phase_slice(
                dev, "swin_pop", per_batch, fp32_check=False, route="SEGLAND_SWIN_WR=1",
                k1_rows=resident)
        print(f"swin_pop eval default: fused {tps_f:.2f} tiles/s, whole-block {tps_b:.2f}, "
              f"attn_group={K5_MAIN_GROUP} {tps_g:.2f}, window-resident {tps_w:.2f}, "
              f"plain versions {tps_p:.2f}, unfused {tps_u:.2f}", flush=True)

    if "swinbl" in phases:
        by_width, p = phase_swinbl(dev)
        paths.update(p)
        for key, widths in by_width.items():
            kern[key]["by_swin_bl_stage"] = widths
            kern[key]["max_abs_err"] = max([kern[key].get("max_abs_err", 0.0)]
                                           + [w["max_abs_err"] for w in widths.values()])
        torch.cuda.empty_cache()
    if "k8" in phases:
        paths["conv3_probe"] = phase_conv3_probe()
        torch.cuda.empty_cache()
    if "k10" in phases:
        paths["swin_attn_hg probe"] = phase_hg_probe()
        torch.cuda.empty_cache()
    if "k11" in phases:
        paths["swin_attn_variants probe"] = phase_variants_probe()
        torch.cuda.empty_cache()
    if "deeplab" in phases:
        paths["deeplab_pop int8 fused"] = phase_int8_slice(dev, "deeplab_pop")
        torch.cuda.empty_cache()
    if "pspnet" in phases:
        paths["pspnet_pop int8 fused"] = phase_int8_slice(dev, "pspnet_pop", n_batches=1)
        torch.cuda.empty_cache()
    if "seghr" in phases:
        paths.update(phase_seghr(dev))
        torch.cuda.empty_cache()
    if "heads" in phases:
        paths.update(phase_heads(dev))
        torch.cuda.empty_cache()
    if "ensemble" in phases:
        paths.update(phase_ensemble(dev))
        torch.cuda.empty_cache()
    if "dist" in phases:
        paths.update(phase_dist(dev))
        torch.cuda.empty_cache()
    if "exports" in phases:
        paths.update(phase_exports(dev))
        torch.cuda.empty_cache()
    if "gates" in phases:
        paths.update(phase_gates(dev))
        torch.cuda.empty_cache()

    if "profile" in phases:
        phase_profile(dev)
    if "dilated" in phases:
        phase_dilated(dev)
    if "steprule" in phases:
        phase_steprule(dev)
    if phases != set(ap.get_default("phases").split(",")):
        print(f"chip_smoke: phases {sorted(phases)} only; no result line", file=sys.stderr)
        return 3
    rows = []
    for key, row in kern.items():
        by_path = {p: n[key] for p, n in paths.items() if key in n}
        if not by_path:
            fail(f"no driven path launched {key}")
        rows.append(dict(name=key, route="cuda", launches=sum(by_path.values()),
                         launches_by_path=by_path, **row))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:  # a rank of phase_dist, started by the script
        sys.exit(dist_worker(*sys.argv[2:]))
    t0 = time.time()
    rc = main()
    print(f"chip_smoke: {time.time() - t0:.1f}s", file=sys.stderr)
    sys.exit(rc)
