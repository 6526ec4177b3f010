"""A fingerprint of the fused kernels' arithmetic: the outputs of K1, K3 and K4
at the swin-s / convnext-t stage widths (C = 96, 192, 384, 768), bf16 and fp32
(K4 in bf16), on inputs drawn from fixed seeds, saved to one file; and two such
files compared tensor by tensor.  Run ``save`` on the card in two checkouts (a
change and its parent) and ``compare`` the files to see whether a change to the
kernels' sources left those builds computing bit for bit as before.

    python -m segland_tpu_torch.benchmarks.kernel_outputs save OUT.pt
    python -m segland_tpu_torch.benchmarks.kernel_outputs compare A.pt B.pt

``compare`` prints a line a tensor and exits 1 if any tensor differs.
"""

import argparse
import sys

import torch

from ..ops.fused_attn import attn_section, swin_block
from ..ops.fused_mlp import ln_mlp

# swin-s's stages of one 1024^2 tile: (C, heads, side, padded side)
STAGES = ((96, 3, 256, 259), (192, 6, 128, 133), (384, 12, 64, 70), (768, 24, 32, 35))
K1_ROWS = 8192


def _draw(gen, dev):
    return lambda *shape: torch.randn(*shape, device=dev, generator=gen)


def _mlp(c, dtype, dev, seed):
    rn = _draw(torch.Generator(device=dev).manual_seed(seed), dev)
    return dict(gamma=1.0 + 0.1 * rn(c), beta=0.1 * rn(c), w1=(rn(c, 4 * c) / c ** 0.5).to(dtype),
                b1=0.1 * rn(4 * c), w2=(rn(4 * c, c) / (4 * c) ** 0.5).to(dtype), b2=0.1 * rn(c))


def _section(nw, c, nh, dtype, dev, seed):
    rn = _draw(torch.Generator(device=dev).manual_seed(seed), dev)
    return (rn(nw, 49, c).to(dtype), 1.0 + 0.1 * rn(c), 0.1 * rn(c),
            (rn(c, 3 * c) / c ** 0.5).to(dtype), 0.1 * rn(3 * c),
            (rn(c, c) / c ** 0.5).to(dtype), 0.1 * rn(c), rn(1, nh, 49, 49))


def outputs(dev) -> dict:
    """{name: CPU tensor} of every kernel call, in a fixed order."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype)[6:]
        for i, (c, nh, side, pside) in enumerate(STAGES):
            m = _mlp(c, dtype, dev, 100 + i)
            x = _draw(torch.Generator(device=dev).manual_seed(110 + i), dev)(K1_ROWS, c)
            out[f"K1 {tag} C={c}"] = ln_mlp(x.to(dtype), m["gamma"], m["beta"], m["w1"], m["b1"],
                                           m["w2"], m["b2"], res2=None, ls=None).cpu()
            for shift in (0, 3):
                geom = (side, side, pside, pside, 7, shift)
                sec = _section((pside // 7) ** 2, c, nh, dtype, dev, 200 + i)
                out[f"K3 {tag} C={c} shift={shift}"] = attn_section(sec[0], geom, *sec[1:],
                                                                    nh).cpu()
                if dtype == torch.bfloat16:
                    out[f"K4 {tag} C={c} shift={shift}"] = swin_block(
                        sec[0], geom, *sec[1:], m["gamma"], m["beta"], m["w1"], m["b1"],
                        m["w2"], m["b2"], nh).cpu()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    save = sub.add_parser("save")
    save.add_argument("out")
    save.add_argument("--device", default="cuda")
    cmp = sub.add_parser("compare")
    cmp.add_argument("a")
    cmp.add_argument("b")
    args = ap.parse_args(argv)
    if args.cmd == "save":
        dev = torch.device(args.device)
        if dev.type != "cuda":
            print("kernel_outputs: the kernels run on a CUDA device only", file=sys.stderr)
            return 2
        out = outputs(dev)
        torch.save(out, args.out)
        print(f"kernel_outputs: {len(out)} tensors to {args.out} "
              f"({torch.cuda.get_device_name(dev)})")
        return 0
    a, b = torch.load(args.a), torch.load(args.b)
    if a.keys() != b.keys():
        print(f"kernel_outputs: the files hold other tensors: {sorted(a.keys() ^ b.keys())}")
        return 1
    differ = 0
    for k in a:
        n = int((a[k] != b[k]).sum()) if a[k].shape == b[k].shape else -1
        differ += n != 0
        print(f"{k}: " + ("bit-equal" if n == 0 else "shapes differ" if n < 0 else
                          f"{n} elements differ, largest by "
                          f"{float((a[k].float() - b[k].float()).abs().max()):.3g}"))
    print(f"kernel_outputs: {differ} of {len(a)} tensors differ")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
