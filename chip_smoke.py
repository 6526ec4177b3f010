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
     the same with K = 12 and 255, the CPU tests' ragged shapes and two
     downsampling shapes (no pixel may differ where the top-2 gap exceeds
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
  8. the swin slice: swin_pop / swin-s at full width and depth the same way,
     once as eval_base runs it (K = 8) and once as eval_ft does (4 novel
     classes, K = 12, square_pad_eval), plus the unfused model's tiles/s and
     one batch through the use_pallas route (K6 in every block); then the
     three other fused routes the same way: SEGLAND_SWIN_V3_STAGES=all (K4 in
     every block; also as eval_ft), attn_group = 2 (K5 and K1 in every block)
     and SEGLAND_SWIN_WR=1 (window-resident stages, K3 and K1, K1 over every
     token of the padded windows: the rows it was given are checked).
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
     versions at C = 96..768 in every mode, and both probes' check on the card.
Every launch count is set to 0 just before a path is driven and read just
after.  The second-to-last line is a JSON object of per-kernel numbers (time,
plain version's time, bound, library call's time) and the last line is
{"ok": true, "device": {...}}.  Without a CUDA device, or without the rest of
the repo beside it, it fails before printing any result.

    python3 chip_smoke.py --phases k2,k6    # K2 and K6 at every shape of their phases
    python3 chip_smoke.py --phases k1,k3    # K1 and K3 with their build, SASS and phase lines
    python3 chip_smoke.py --phases k4,k5    # K4 and K5 with their build, SASS and phase lines
    python3 chip_smoke.py --phases k8,k7    # K8, and K7 with its build, SASS and per-kernel lines
    python3 chip_smoke.py --phases k8,k10,k9  # K8, the head-group kernels and their probe
    python3 chip_smoke.py --phases k11,f32  # the variants probe's kernel, the fp32 body
    python3 chip_smoke.py --phases profile  # torch.profiler over the swin and deeplab_pop slices
    python3 chip_smoke.py --phases dilated  # cuDNN's 3x3 at ASPP's dilations vs nine 1x1 taps
"""

import contextlib
import json
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
             ((2, 1024, 1024, 8), (256, 256)))
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
    """The stock-torch route of the same section on the same windows, as the
    unfused swin block runs it in x's dtype: F.layer_norm and the pad mask,
    the qkv F.linear, q k^T with the rel-pos bias and the shift mask, softmax
    in fp32, P V, the projection F.linear and the residual."""
    import torch
    import torch.nn.functional as F

    x = a["x"]
    dt = x.dtype
    nw, n, c = x.shape
    hd = c // nh
    gamma, beta = a["gamma"].to(dt), a["beta"].to(dt)
    bqkv, bproj = a["bqkv"].to(dt), a["bproj"].to(dt)
    m = mask.to(dt)[None, :, :, None] if mask.shape[0] > 1 else mask.to(dt)[0][None, :, None]
    bias = a["bias"].to(dt)
    if regions is not None:
        pen = torch.where(regions[:, :, None] != regions[:, None, :], -100.0, 0.0).to(dt)
        bias = bias + pen[:, None]  # [nW_img, nh, N, N]
    nw_img = bias.shape[0]

    def route():
        y = F.layer_norm(x, (c,), gamma, beta, 1e-5)
        y = (y.reshape(nw // m.shape[1], m.shape[1], n, c) * m).reshape(nw, n, c) \
            if m.dim() == 4 else y * m
        q, k, v = F.linear(y, a["wqkv"].t(), bqkv).reshape(nw, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        s = (q * hd ** -0.5) @ k.transpose(-1, -2)
        s = (s.reshape(nw // nw_img, nw_img, nh, n, n) + bias).reshape(nw, nh, n, n)
        p = torch.softmax(s.float(), dim=-1).to(dt)
        ctx = (p @ v).permute(0, 2, 1, 3).reshape(nw, n, c)
        return x + F.linear(ctx, a["wproj"].t(), bproj)

    return route


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
    from segland_tpu_torch.ops.fused_attn import (attn_section, attn_section_reference,
                                                  block_reference, swin_block,
                                                  swin_block_clocks)
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
    split = "" if dtype != torch.bfloat16 else " " + phase_split(
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
    from segland_tpu_torch.ops.fused_attn import (attn_section, attn_section_reference,
                                                  attn_section_v1, attn_section_v1_clocks,
                                                  v1_plan)

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
                split = phase_split(lambda clk: attn_section_v1_clocks(
                    clk, a["x"], mask, *w_l, regions=regions, group=g), K5_PHASES, dev)
                print(f"{tag} group={g}: path={v1_plan(c, g)['path']} kernel_ms={times[g]:.4f} "
                      f"tflops={flops / times[g] / 1e9:.1f} {split}", flush=True)
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


def build(name, dtype, seed=0, fused=True, is_ft=False, attn_group=1):
    """convnext_pop/convnext-t or swin_pop/swin-s with seeded random weights,
    drawn so that every block's kernel reaches the output."""
    import torch
    import torch.nn as nn
    from segland_tpu_torch.models import build_model
    from segland_tpu_torch.models.backbones.convnext import ConvNeXtBlock
    from segland_tpu_torch.models.backbones.swin import SwinBlock, SwinTransformer

    g = torch.Generator().manual_seed(seed)
    model = build_model(name, None, n_base=7, n_novel=4 if is_ft else 0, is_ft=is_ft,
                        fused_mlp=fused, fused_attn=fused, dtype=dtype, generator=g)
    with torch.no_grad():
        for blk in model.modules():
            if isinstance(blk, ConvNeXtBlock):
                # upstream's 1e-6 layer-scale would hide every block's MLP from the output
                blk.gamma.copy_(torch.empty_like(blk.gamma).uniform_(0.1, 0.5, generator=g))
            elif isinstance(blk, SwinBlock):
                # upstream's 0.02-scale weights and rel-pos table make every softmax
                # near-uniform and every branch small beside the residual
                for m in blk.modules():
                    if isinstance(m, nn.Linear):
                        m.weight.normal_(0.0, m.in_features ** -0.5, generator=g)
                        m.bias.normal_(0.0, 0.1, generator=g)
                    elif isinstance(m, nn.LayerNorm):
                        m.weight.uniform_(0.5, 1.5, generator=g)
                        m.bias.normal_(0.0, 0.1, generator=g)
                blk.attn.relative_position_bias_table.normal_(0.0, 1.0, generator=g)
    if attn_group != 1:
        # no CLI switch and no registry argument has it, as in the JAX package: the same
        # swin-s backbone and weights through the constructor's own argument
        grouped = SwinTransformer(
            depths=tuple(s[0] for s in SWIN_STAGES), num_heads=tuple(s[2] for s in SWIN_STAGES),
            embed_dim=SWIN_STAGES[0][1], fused_mlp=fused, fused_attn=fused,
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
                attn_group=1, k1_rows=None):
    """One model through Evaluator.run: the kernel path (launch counts, mIoU,
    tiles/s), the same batches with the kernels' plain versions, and an fp32
    forward on the card against the CPU.  The caller sets the environment
    switches of ``route``; ``attn_group`` goes to the swin backbone.  ``k1_rows``:
    the rows K1 must have been given per batch, which tells a window-resident
    stage (every token of the padded windows) from a spatial one."""
    import torch
    from segland_tpu_torch.evallib import Evaluator

    tag = f"{name}{' ft' if is_ft else ''}{' ' + route if route else ''}"
    k = 12 if is_ft else 8
    model = build(name, torch.bfloat16, is_ft=is_ft, attn_group=attn_group).to(dev)
    batches = synthetic_batches()
    kw = dict(num_classes=12, n_base=7, normalize_on_device=True)
    run_kw = dict(square_pad_eval=is_ft)
    ev = Evaluator(model, dev, **kw)
    ev.run(batches, **run_kw)  # warm-up: cuDNN plans, device and pinned-host allocators
    torch.cuda.synchronize()
    (cm, (base, novel, total, _), tps), launches = counted_run(ev, batches, **run_kw)
    rows = counters()["ln_mlp"].rows
    print(f"slice {tag}: bf16 fused, {N_BATCHES}x{BATCH} tiles {TILE}^2: launches={launches} "
          f"k1_rows={rows} mIoU base={base:.4f} total={total:.4f} tiles_per_s={tps:.2f} "
          f"pixels={int(cm.sum())}", flush=True)
    want = {key: n * N_BATCHES for key, n in want_per_batch.items()}
    if launches != want:
        fail(f"slice {tag} launch counts {launches}, want {want}")
    if k1_rows is not None and rows != k1_rows * N_BATCHES:
        fail(f"slice {tag}: K1 was given {rows} rows, want {k1_rows * N_BATCHES}")
    if int(cm.sum()) != N_BATCHES * BATCH * (TILE - 16) * TILE:
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
    for imgs, _, _ in batches:
        _, pk = ev.predict_batch(imgs, (TILE, TILE), want_logits=False)
        _, pp = ev_plain.predict_batch(imgs, (TILE, TILE), want_logits=False)
        agree += int((pk == pp).sum())
        n += pp.numel()
    frac = agree / n
    print(f"slice {tag} plain versions on the card: mIoU base={base_p:.4f} "
          f"total={total_p:.4f} tiles_per_s={tps_p:.2f} argmax_agreement={frac:.6f} "
          f"dmIoU_total={abs(total - total_p):.6f}", flush=True)
    if frac < 0.99:
        fail(f"slice {tag}: kernel vs plain argmax agreement {frac:.4f} < 0.99")

    if fp32_check:
        # fp32 on the card (the fp32 kernel builds) vs the CPU's plain versions, small input
        m32 = build(name, torch.float32, seed=1, is_ft=is_ft, attn_group=attn_group)
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


def build_resnet(name, dtype, dev, seed=0):
    """deeplab_pop or pspnet_pop over resnet50 on ``dev`` with seeded random
    weights that keep activations in a sane range through the 16 blocks:
    He-normal conv weights (std sqrt(2 / fan_in)) hold the second moment
    through each conv + ReLU; BatchNorm statistics near the identity (mean
    0.1 * randn, variance in [0.8, 1.2], bias 0.1 * randn); and a bn3 scale in
    [0.2, 0.4], so that a block adds under a tenth of the residual stream's
    variance and the stream grows by about 4x over the backbone, not by 2^16.

    The POP head then sees features with a large common mean, which random
    prototypes hand to the background logit at every pixel.  So the prototypes
    are made orthogonal to the mean feature of one seeded 256^2 tile, and the
    classifier's last layer takes the sign that makes the background logit of
    that mean negative: the seven base classes then compete pixel by pixel."""
    import torch
    import torch.nn as nn
    from segland_tpu_torch.models import build_model
    from segland_tpu_torch.models.backbones.resnet import Bottleneck
    from segland_tpu_torch.ops import pop as pop_ops

    g = torch.Generator().manual_seed(seed)
    model = build_model(name, None, n_base=7, dtype=dtype, generator=g)
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
        model = model.to(dev)
        tile = torch.randn(1, 3, 256, 256, generator=g).to(dev)
        mean = model.extract_features(tile).mean(dim=(0, 1, 2))
        unit = mean / mean.norm()
        model.base_emb.sub_((model.base_emb @ unit)[:, None] * unit)
        if float(pop_ops.classifier_apply(mean, *model.classifier.weights())) > 0:
            model.classifier[4].weight.neg_()
    return model


def phase_int8_slice(dev, name, n_batches=N_BATCHES):
    """deeplab_pop or pspnet_pop / resnet50 at output stride 8 through
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


def phase_unfused(dev, name):
    """The unfused model (stock torch blocks, --no-fused): what the eval
    default of --fused is set against.  Returns (model, evaluator, tiles/s)."""
    import torch
    from segland_tpu_torch.evallib import Evaluator

    batches = synthetic_batches()
    model = build(name, torch.bfloat16, fused=False).to(dev)
    ev = Evaluator(model, dev, num_classes=12, n_base=7, normalize_on_device=True)
    ev.run(batches)
    (_, (_, _, total_u, _), tps_u), launches = counted_run(ev, batches)
    print(f"slice {name} unfused (--no-fused): mIoU total={total_u:.4f} "
          f"tiles_per_s={tps_u:.2f} launches={launches}", flush=True)
    if launches != {"upsample_argmax": N_BATCHES}:
        fail(f"unfused {name} launch counts {launches}")
    return model, ev, tps_u


def phase_swin_routes(dev):
    """The unfused swin_pop model, then one batch of it through the use_pallas
    route, which runs K6 in every block."""
    from segland_tpu_torch.models.backbones.swin import WindowAttention

    batches = synthetic_batches()
    model, ev, tps_u = phase_unfused(dev, "swin_pop")
    _, pu = ev.predict_batch(batches[0][0], (TILE, TILE), want_logits=False)
    for m in model.modules():
        if isinstance(m, WindowAttention):
            m.use_pallas = True
    (_, (_, _, total_p, _), tps_p), launches = counted_run(ev, batches[:1])
    _, pp = ev.predict_batch(batches[0][0], (TILE, TILE), want_logits=False)
    frac = float((pu == pp).float().mean())
    print(f"slice swin_pop use_pallas: launches={launches} mIoU total={total_p:.4f} "
          f"tiles_per_s={tps_p:.2f} argmax_agreement_with_unfused={frac:.6f}", flush=True)
    if launches != {"window_attention": 24, "upsample_argmax": 1}:
        fail(f"use_pallas launch counts {launches}, want window_attention=24")
    if frac < 0.99:
        fail(f"use_pallas vs unfused argmax agreement {frac:.4f} < 0.99")
    return launches, tps_u


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


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--phases",
                    default="k1,k2,k3,k6,k4,k5,k8,k7,k10,k9,k11,f32,convnext,swin,deeplab,"
                            "pspnet",
                    help="comma list of k1,k2,k3,k6,k4,k5,k8,k7,k10,k9,k11,f32,convnext,swin,"
                         "deeplab,pspnet (default: all sixteen); profile: a torch.profiler "
                         "breakdown of the swin and deeplab_pop slices; dilated: cuDNN vs the "
                         "nine-tap 3x3 at large dilations")
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"device: {name} count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)

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

    if "profile" in phases:
        phase_profile(dev)
    if "dilated" in phases:
        phase_dilated(dev)
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
    t0 = time.time()
    rc = main()
    print(f"chip_smoke: {time.time() - t0:.1f}s", file=sys.stderr)
    sys.exit(rc)
