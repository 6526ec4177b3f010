"""Micro A/B of the conv3 + residual int8 kernel (K8) against the per-conv
equivalent: an int8 product that writes its int32 result, then a dequant +
residual + ReLU pass over it.  Port of benchmarks/conv3_probe.py.

Shapes: resnet50 layer4 at 16 1024^2 tiles, output stride 8 (M = 16 * 128^2 =
262144, P = 512, C = 2048) and layer3 (P = 256, C = 1024).

    python -m segland_tpu_torch.benchmarks.conv3_probe [--m 262144] [--iters 5]

Prints one line a shape with both times in ms (CUDA events on the card, the
host clock with ``--device cpu``, where both sides run the plain version) and
returns them as a list of dicts.
"""

import argparse
import time

import torch

from ..ops.fused_bottleneck import conv3_residual_int8
from ..ops.int8 import int_matmul

SHAPES = ((512, 2048), (256, 1024))  # (P, C)


def _ms(fn, iters: int, dev: torch.device) -> float:
    fn()  # warm-up
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e3 * (time.perf_counter() - t0) / iters


def main(argv=None):
    ap = argparse.ArgumentParser(description="conv3 + residual int8 kernel vs the per-conv path")
    ap.add_argument("--m", type=int, default=262144, help="rows: pixels of the batch")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    rows = []
    for p, c in SHAPES:
        ri = lambda *s: torch.randint(-127, 128, s, device=dev, generator=g, dtype=torch.int8)
        h2q, w3 = ri(args.m, p), ri(p, c)
        res = torch.randn(args.m, c, device=dev, generator=g).bfloat16()
        a3 = torch.rand(c, device=dev, generator=g) * 1e-4
        b3 = torch.zeros(c, device=dev)

        def per_conv():
            acc = int_matmul(h2q, w3)
            return torch.relu(acc.float() * a3 + b3 + res.float()).to(res.dtype)

        def fused():
            return conv3_residual_int8(h2q, res, w3, a3, b3, last_relu=True)

        if not torch.equal(fused(), per_conv()):
            raise RuntimeError(f"P={p} C={c}: the kernel and the per-conv path disagree")
        row = dict(p=p, c=c, m=args.m, per_conv_ms=_ms(per_conv, args.iters, dev),
                   fused_ms=_ms(fused, args.iters, dev))
        print(f"P={p} C={c} M={args.m} int8 product + epilogue: {row['per_conv_ms']:7.3f} ms   "
              f"conv3_residual_int8: {row['fused_ms']:7.3f} ms", flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
