"""Head-grouped attention-section probe: the two sections of the head-group
kernels (K9 ``hg_section``, masks shipped in; K10 ``hg2_section``, masks from
the window index, with timing ablations) at a swin-s stage shape, timed as the
pair of a stage's blocks (shift 0, then shift 3).  Port of
benchmarks/swin_attn_hg.py.

    python -m segland_tpu_torch.benchmarks.swin_attn_hg [stage] [batch] [specs]
    python -m segland_tpu_torch.benchmarks.swin_attn_hg check     # exactness, on the CPU
    python -m segland_tpu_torch.benchmarks.swin_attn_hg stage1 2 1-1-8,2-6-8 --device cpu

stage is stage0..stage3 (C = 96, 192, 384, 768), batch defaults to 16, and a
spec is ``<ver>-<hg>-<wblk>[-bf16][-ab<mode>]``: ver 1 (K9) or 2 (K10), hg
heads a pass, wblk windows a thread block, bf16 scores instead of fp32, and
for ver 2 an ablation (ioraw, io, attn, softmax).  The default specs take the
JAX package's production head group for the stage's head count (``V2_HG``).

Times are CUDA events around ``--iters`` pairs after one warm-up pair (the
host clock with ``--device cpu``, where the plain versions run).  The JAX
script's ``chain_time`` and its baseline subtraction exist to hide the TPU's
dispatch behind a ``lax.scan``; a CUDA launch needs neither.  The TPU layout
devices of the JAX script raise ValueError: the tokens ``par`` and ``vm<N>``,
``flat``, ``prepad`` with the stages ``stage0p`` / ``stage1p``, and the
ablation ``build``.  Errors propagate: nothing is reported as FAILED and
skipped.
"""

import argparse
import time

import numpy as np
import torch

from ..models.backbones.swin import _pad_token_mask, _rel_pos_index, _shift_regions
from ..ops.fused_attn import attn_section_reference
from ..ops.hg_attn import V2_HG, check_ablate, hg2_section, hg_section

WS = 7
# stage -> (side of the feature map at 1024^2 tiles, C, heads)
STAGES = {"stage0": (256, 96, 3), "stage1": (128, 192, 6), "stage2": (64, 384, 12),
          "stage3": (32, 768, 24)}
TPU_ONLY = {
    "par": "a TPU compiler parameter (grid dimension semantics); CUDA blocks are parallel",
    "vm": "a TPU compiler parameter (the VMEM limit); shared memory is sized by the build",
    "flat": "the port's windows already are one flat [W*49, C] row matrix in every build",
    "prepad": "128-lane tile widths: C = 128 and 256 have no build, and pre-padded windows "
              "would change the numerics",
}


def make_inputs(stage, batch, dtype=torch.bfloat16, h_override=None, device="cpu", seed=0):
    """The probe's inputs at a stage: 0.02-scale weights, zero biases, a
    0.02-scale rel-pos table, standard-normal windows, from one seeded
    torch.Generator (the JAX script draws them with jax.random)."""
    if stage in ("stage0p", "stage1p"):
        raise ValueError(f"{stage}: {TPU_ONLY['prepad']}")
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; one of {sorted(STAGES)}")
    h, c, nh = STAGES[stage]
    if h_override is not None:
        h = h_override
    hp = -(-h // WS) * WS
    nw = (hp // WS) ** 2
    n = WS * WS
    shift = WS // 2
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g)
    wqkv, wproj = (rn(c, 3 * c) * 0.02).to(dtype), (rn(c, c) * 0.02).to(dtype)
    table = rn((2 * WS - 1) ** 2, nh) * 0.02
    bias = table[torch.from_numpy(_rel_pos_index(WS).reshape(-1))].reshape(n, n, nh)
    wins = rn(batch * nw, n, c).to(dtype)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    out = dict(c=c, nh=nh, g_ln=torch.ones(c), b_ln=torch.zeros(c), wqkv=wqkv,
               bqkv=torch.zeros(3 * c, dtype=dtype), wproj=wproj,
               bproj=torch.zeros(c, dtype=dtype), bias=bias.permute(2, 0, 1)[None].to(dtype),
               regions=t(_shift_regions(hp, hp, WS, shift)),
               mask0=t(_pad_token_mask(h, h, hp, hp, WS, 0)),
               mask1=t(_pad_token_mask(h, h, hp, hp, WS, shift)), wins=wins,
               geom=(h, h, hp, hp, WS))
    return {k: v.to(device) if torch.is_tensor(v) else v for k, v in out.items()}


def _weights(inp):
    return (inp["g_ln"], inp["b_ln"], inp["wqkv"], inp["bqkv"], inp["wproj"], inp["bproj"],
            inp["bias"], inp["nh"])


def check(bar=2e-5):
    """Both sections' plain versions against attn_section_reference in fp32 on
    the CPU (the JAX script's check, which runs its kernels in interpret mode)."""
    for stage, hgs in (("stage0", (1, 3)), ("stage2", (2, 4, 6))):
        inp = make_inputs(stage, 1, dtype=torch.float32, h_override=26)
        x, w = inp["wins"], _weights(inp)
        for shifted in (False, True):
            mask = inp["mask1"] if shifted else inp["mask0"]
            reg = inp["regions"] if shifted else None
            ref = attn_section_reference(x, mask, *w, regions=reg)
            geom = inp["geom"] + ((WS // 2) if shifted else 0,)
            for hg in hgs:
                for ver, got in ((1, hg_section(x, mask, reg, *w, wblk=4, hg=hg)),
                                 (2, hg2_section(x, geom, *w, wblk=4, hg=hg))):
                    d = float((got - ref).abs().max())
                    print(f"{stage} shifted={shifted} hg={hg} v{ver}: max|d|={d:.2e}", flush=True)
                    if not d < bar:
                        raise AssertionError(f"{stage} shifted={shifted} hg={hg} v{ver}: "
                                             f"max|d| {d:.3g} >= {bar}")
    print("CHECK OK", flush=True)


def parse_spec(spec):
    """``<ver>-<hg>-<wblk>[-bf16][-ab<mode>]`` -> dict(ver, hg, wblk, score_f32, ablate)."""
    parts = spec.split("-")
    if len(parts) < 3:
        raise ValueError(f"spec {spec!r}: want <ver>-<hg>-<wblk>[-bf16][-ab<mode>]")
    ver, hg, wblk = int(parts[0]), int(parts[1]), int(parts[2])
    out = dict(ver=ver, hg=hg, wblk=wblk, score_f32=True, ablate="none")
    for p in parts[3:]:
        if p == "bf16":
            out["score_f32"] = False
        elif p.startswith("ab"):
            out["ablate"] = p[2:]
        elif p in ("par", "flat") or (p.startswith("vm") and p[2:].isdigit()):
            why = TPU_ONLY["vm" if p.startswith("vm") else p]
            raise ValueError(f"spec {spec!r}: {p!r} is {why}")
        else:
            raise ValueError(f"spec {spec!r}: unknown token {p!r}")
    if ver not in (1, 2):
        raise ValueError(f"spec {spec!r}: ver is 1 (hg_section) or 2 (hg2_section)")
    try:
        check_ablate(out["ablate"])
    except ValueError as e:
        raise ValueError(f"spec {spec!r}: {e}") from None
    if ver == 1 and out["ablate"] != "none":
        raise ValueError(f"spec {spec!r}: hg_section has no ablations")
    return out


def _ms(fn, iters, dev):
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
    ap = argparse.ArgumentParser(description="head-grouped attention-section probe")
    ap.add_argument("stage", nargs="?", default="stage0", help="stage0..stage3, or check")
    ap.add_argument("batch", nargs="?", type=int, default=16)
    ap.add_argument("specs", nargs="?", default=None, help="comma list of specs")
    ap.add_argument("layout", nargs="?", default=None, help="prepad (TPU only: raises)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.stage == "check":
        check()
        return []
    if args.layout is not None:
        raise ValueError(f"{args.layout!r}: {TPU_ONLY.get(args.layout, 'unknown layout')}")
    dev = torch.device(args.device)
    inp = make_inputs(args.stage, args.batch, device=dev, seed=args.seed)
    nh, nw = inp["nh"], inp["wins"].shape[0]
    hg = V2_HG[nh]
    specs = (args.specs.split(",") if args.specs
             else ["1-1-32", f"1-{hg}-32", f"2-{hg}-32", f"2-{hg}-64"])
    parsed = [(spec, parse_spec(spec)) for spec in specs]  # every spec is checked first
    w = _weights(inp)
    rows = []
    for spec, s in parsed:
        kw = dict(wblk=s["wblk"], hg=s["hg"], score_f32=s["score_f32"])
        if s["ver"] == 1:
            def pair(kw=kw):
                y = hg_section(inp["wins"], inp["mask0"], None, *w, **kw)
                return hg_section(y, inp["mask1"], inp["regions"], *w, **kw)
        else:
            kw["ablate"] = s["ablate"]

            def pair(kw=kw):
                y = hg2_section(inp["wins"], inp["geom"] + (0,), *w, **kw)
                return hg2_section(y, inp["geom"] + (WS // 2,), *w, **kw)
        ms = _ms(pair, args.iters, dev)
        name = (f"v{s['ver']} hg={s['hg']} wblk={s['wblk']} "
                f"{'f32' if s['score_f32'] else 'bf16'} scores"
                + (f" ablate={s['ablate']}" if s["ablate"] != "none" else ""))
        print(f"{args.stage} b{args.batch} {name}: {ms:8.3f} ms a pair ({nw} windows, "
              f"{-(-nw // s['wblk'])} blocks, {dev.type})", flush=True)
        rows.append(dict(spec=spec, stage=args.stage, batch=args.batch, ms=ms, **s))
    return rows


if __name__ == "__main__":
    main()
