#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py          # from the repo root, on a machine with an H100

Phases, each printing its result on its own line; any failure exits non-zero:
  1. device: name, count, and nvidia-smi's name and power limit;
  2. build: nvcc builds the kernels from segland_tpu_torch/kernels/csrc;
  3. K1 ln_mlp vs its plain version on the card, bf16 at the ConvNeXt-T stage
     shapes of a batch of 8 1024^2 tiles plus two ragged M, and fp32 at one
     shape (TF32 off);
  4. K2 upsample_argmax vs its plain version at (8,256,256,8) -> (8,1024,1024);
  5. the slice: convnext_pop / convnext-t in bf16 with the fused kernels,
     random weights from a seeded torch.Generator, through Evaluator.run on
     3 batches of 8 synthetic 1024^2 tiles; the launch counts of that run,
     its mIoU and tiles/s; the same batches with the kernels' plain versions
     (>= 99% argmax agreement); an fp32 forward on the card against the same
     model on the CPU.
The second-to-last line is a JSON object of per-kernel numbers and the last
line is {"ok": true, "device": {...}}.  Without a CUDA device, or without the
rest of the repo beside it, it fails before printing any result.
"""

import json
import subprocess
import sys
import time

import numpy as np

BATCH, TILE, N_BATCHES = 8, 1024, 3
STAGES = ((3, 96, 256), (3, 192, 128), (9, 384, 64), (3, 768, 32))  # (blocks, C, side)


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


def check_k1(dev, m, c, dtype, atol, rtol, seed, with_res=True, with_ls=True):
    from segland_tpu_torch.ops.fused_mlp import ln_mlp, ln_mlp_reference

    a = mlp_inputs(m, c, dtype, dev, seed, with_res, with_ls)
    args = (a["x"], a["gamma"], a["beta"], a["w1"], a["b1"], a["w2"], a["b2"])
    kw = dict(res=a["res2"], ls=a["ls"], eps=1e-6)
    got = ln_mlp(*args, res2=a["res2"], ls=a["ls"], eps=1e-6).float()
    want = ln_mlp_reference(*args, **kw).float()
    err = (got - want).abs()
    bad = int((err > atol + rtol * want.abs()).sum())
    if not bool(got.isfinite().all()):
        fail(f"K1 {dtype} M={m} C={c}: non-finite output")
    ms = cuda_ms(lambda: ln_mlp(*args, res2=a["res2"], ls=a["ls"], eps=1e-6))
    plain_ms = cuda_ms(lambda: ln_mlp_reference(*args, **kw))
    print(f"K1 {str(dtype)[6:]} M={m} C={c} res={with_res} ls={with_ls}: "
          f"max_abs_err={float(err.max()):.6g} tol=|d|<={atol}+{rtol}*|ref| "
          f"out_of_tol={bad} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}", flush=True)
    if bad:
        fail(f"K1 {dtype} M={m} C={c}: {bad} elements out of tolerance")
    return float(err.max()), ms, plain_ms


def phase_k1(dev):
    import torch

    worst, ms, plain_ms = 0.0, 0.0, 0.0
    for i, (blocks, c, side) in enumerate(STAGES):
        e, t, tp = check_k1(dev, BATCH * side * side, c, torch.bfloat16, 2e-2, 1e-2, i)
        worst = max(worst, e)
        ms += blocks * t
        plain_ms += blocks * tp
    for m, c in ((BATCH * 64 * 64 - 19, 384), (BATCH * 32 * 32 - 19, 768)):  # ragged M
        e, _, _ = check_k1(dev, m, c, torch.bfloat16, 2e-2, 1e-2, 7,
                           with_res=False, with_ls=False)
        worst = max(worst, e)
    check_k1(dev, BATCH * 128 * 128, 192, torch.float32, 1e-4, 1e-4, 8)
    print(f"K1 per forward of {BATCH} tiles (18 blocks): kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f}", flush=True)
    return worst, ms, plain_ms


def phase_k2(dev):
    import torch
    from segland_tpu_torch.ops.fused_epilogue import upsample_argmax, upsample_argmax_reference
    from segland_tpu_torch.ops.resize import resize_bilinear

    g = torch.Generator(device=dev).manual_seed(11)
    logits = 3.0 * torch.randn(BATCH, TILE // 4, TILE // 4, 8, device=dev, generator=g)
    out_hw = (TILE, TILE)
    got = upsample_argmax(logits, out_hw)
    up = resize_bilinear(logits, out_hw, align_corners=True)
    top2 = up.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    want = up.argmax(-1).to(torch.uint8)
    differ = got != want
    bad = int((differ & (gap > 1e-3)).sum())
    # logit regret of the kernel's class under the plain fp32 upsample
    regret = top2[..., 0] - up.gather(-1, got.long()[..., None])[..., 0]
    err = float(regret.max())
    ms = cuda_ms(lambda: upsample_argmax(logits, out_hw))
    plain_ms = cuda_ms(lambda: upsample_argmax_reference(logits, out_hw))
    print(f"K2 {tuple(logits.shape)}->{(BATCH,) + out_hw}: differing_pixels="
          f"{int(differ.sum())} with_gap_gt_1e-3={bad} max_logit_regret={err:.6g} "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}", flush=True)
    if bad:
        fail(f"K2: {bad} pixels differ where the top-2 gap exceeds 1e-3")
    return err, ms, plain_ms


def synthetic_batches():
    rng = np.random.RandomState(0)
    out = []
    for i in range(N_BATCHES):
        imgs = rng.randint(0, 256, (BATCH, TILE, TILE, 3)).astype(np.uint8)
        labels = rng.randint(0, 12, (BATCH, TILE, TILE)).astype(np.uint8)
        labels[:, :16] = 255
        out.append((imgs, labels, [f"tile_{i}_{j}" for j in range(BATCH)]))
    return out


def build(dtype, seed=0):
    import torch
    from segland_tpu_torch.models import build_model
    from segland_tpu_torch.models.backbones.convnext import ConvNeXtBlock

    g = torch.Generator().manual_seed(seed)
    model = build_model("convnext_pop", "convnext-t", n_base=7, fused_mlp=True,
                        dtype=dtype, generator=g)
    # upstream's 1e-6 layer-scale would hide every block's MLP from the output
    with torch.no_grad():
        for blk in model.modules():
            if isinstance(blk, ConvNeXtBlock):
                blk.gamma.copy_(torch.empty_like(blk.gamma).uniform_(0.1, 0.5, generator=g))
    return model


def phase_slice(dev):
    import torch
    from segland_tpu_torch.evallib import Evaluator
    from segland_tpu_torch.ops.fused_epilogue import upsample_argmax
    from segland_tpu_torch.ops.fused_mlp import ln_mlp

    model = build(torch.bfloat16).to(dev)
    batches = synthetic_batches()
    ev = Evaluator(model, dev, num_classes=12, n_base=7, normalize_on_device=True)
    ev.run(batches)  # warm-up: cuDNN plans, device and pinned-host allocators
    torch.cuda.synchronize()
    ln_mlp.launches = 0
    upsample_argmax.launches = 0
    cm, (base, novel, total, _), tps = ev.run(batches)
    launches = {"ln_mlp": ln_mlp.launches, "upsample_argmax": upsample_argmax.launches}
    print(f"slice: convnext_pop/convnext-t bf16 fused, {N_BATCHES}x{BATCH} tiles "
          f"{TILE}^2: launches={launches} mIoU base={base:.4f} total={total:.4f} "
          f"tiles_per_s={tps:.2f} pixels={int(cm.sum())}", flush=True)
    if launches != {"ln_mlp": 18 * N_BATCHES, "upsample_argmax": N_BATCHES}:
        fail(f"slice launch counts {launches}, want ln_mlp={18 * N_BATCHES} "
             f"upsample_argmax={N_BATCHES}")
    if int(cm.sum()) != N_BATCHES * BATCH * (TILE - 16) * TILE:
        fail("confusion matrix does not count every labelled pixel")

    ev_plain = Evaluator(model, dev, num_classes=12, n_base=7, normalize_on_device=True,
                         plain_kernels=True)
    cm_p, (base_p, _, total_p, _), tps_p = ev_plain.run(batches)
    if (ln_mlp.launches, upsample_argmax.launches) != tuple(launches.values()):
        fail("the plain run launched a kernel")
    agree = n = 0
    for imgs, _, _ in batches:
        logits, pred = ev.predict_batch(imgs, (TILE, TILE), want_logits=True)
        if logits.shape != (BATCH, TILE, TILE, 8) or not bool(logits.isfinite().all()):
            fail(f"slice logits {tuple(logits.shape)} not finite (B,{TILE},{TILE},8)")
        _, pk = ev.predict_batch(imgs, (TILE, TILE), want_logits=False)
        _, pp = ev_plain.predict_batch(imgs, (TILE, TILE), want_logits=False)
        top2 = logits.topk(2, dim=-1).values
        if int(((pk != pred) & (top2[..., 0] - top2[..., 1] > 1e-3)).sum()):
            fail("fused epilogue and the logits path disagree beyond near-ties")
        agree += int((pk == pp).sum())
        n += pp.numel()
    frac = agree / n
    print(f"slice plain versions on the card: mIoU base={base_p:.4f} total={total_p:.4f} "
          f"tiles_per_s={tps_p:.2f} argmax_agreement={frac:.6f} "
          f"dmIoU_total={abs(total - total_p):.6f}", flush=True)
    if frac < 0.99:
        fail(f"kernel vs plain argmax agreement {frac:.4f} < 0.99")

    # fp32 on the card (the fp32 K1 build) vs the CPU's plain versions, small input
    m32 = build(torch.float32, seed=1)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        want = m32(x)
        got = m32.to(dev)(x.to(dev)).cpu()
    err = float((got - want).abs().max())
    print(f"slice fp32 2x64x64 card vs CPU: max_abs_err={err:.6g} tol=1e-3", flush=True)
    if err > 1e-3:
        fail("fp32 forward on the card disagrees with the CPU")
    return launches, tps


def main():
    import torch

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
    ptxas = [l.strip() for l in info["log"].splitlines() if "registers" in l or "spill" in l]
    print(f"build: {info['seconds']:.1f}s built={info['built']} {info['path']}", flush=True)
    for line in ptxas:
        print(f"  ptxas: {line}")

    k1_err, k1_ms, k1_plain = phase_k1(dev)
    k2_err, k2_ms, k2_plain = phase_k2(dev)
    launches, _ = phase_slice(dev)

    kern = [
        {"name": "ln_mlp", "route": "cuda",
         "source": "segland_tpu_torch/kernels/csrc/ln_mlp.cu",
         "replaces": "segland_tpu/ops/pallas_mlp.py:148",
         "launches": launches["ln_mlp"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "upsample_argmax", "route": "cuda",
         "source": "segland_tpu_torch/kernels/csrc/upsample_argmax.cu",
         "replaces": "segland_tpu/ops/fused_epilogue.py:143",
         "launches": launches["upsample_argmax"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain},
    ]
    print(smi)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.time()
    rc = main()
    print(f"chip_smoke: {time.time() - t0:.1f}s", file=sys.stderr)
    sys.exit(rc)
