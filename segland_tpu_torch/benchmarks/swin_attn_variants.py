"""Attention-section variants probe: the v1 section with its knobs (``wblk``
windows a thread block, fp32 or bf16 scores) and ablation modes (K11,
``ops/section_variants.py``) at a swin-s stage shape, timed as the pair of a
stage's blocks (shift 0, then shift 3 with regions).  Port of
benchmarks/swin_attn_variants.py.

    python -m segland_tpu_torch.benchmarks.swin_attn_variants [stage] [batch] [only]
    python -m segland_tpu_torch.benchmarks.swin_attn_variants check [--device cuda]
    python -m segland_tpu_torch.benchmarks.swin_attn_variants stage1 2 0,5 --device cpu

stage is stage0..stage2 (C = 96, 192, 384), batch defaults to 16, and
``only`` is a comma list of variant numbers (all 15 by default).

Times come from :func:`chain_time`, the counterpart of the JAX script's: a
chain of 6 links, each ``op(x + i)`` reduced to its mean, captured once in a
CUDA graph and replayed (the JAX script puts the chain behind one jitted
``lax.scan``), minus the same chain of a baseline op that only slices.  The
same chain run eagerly is printed beside it: the gap is the launchers' host
cost.  With ``--device cpu`` only the eager chain runs, on the host clock,
through the plain versions.  Errors propagate: the JAX script's catch-all
that prints FAILED and goes on has no counterpart.
"""

import argparse
import time

import torch

from .swin_attn_hg import make_inputs
from ..ops.fused_attn import attn_section_reference
from ..ops.section_variants import section

CHAIN, ITERS, WARMUP = 6, 3, 2
STAGES = ("stage0", "stage1", "stage2")
# (name, wblk, fp32 scores, ablate): the JAX script's 15 variants, in its order
VARIANTS = (
    ("current  wblk=32 fp32-scores", 32, True, "none"),
    ("bf16 scores       wblk=32   ", 32, False, "none"),
    ("wblk=64  fp32                ", 64, True, "none"),
    ("wblk=64  bf16 scores         ", 64, False, "none"),
    ("wblk=128 bf16 scores         ", 128, False, "none"),
    ("ablate softmax  wblk=32 bf16 ", 32, False, "softmax"),
    ("ablate LN       wblk=32 bf16 ", 32, False, "ln"),
    ("ablate attn-core wblk=32     ", 32, False, "attn"),
    ("proj1 assembled wblk=32 bf16 ", 32, False, "proj1"),
    ("io-floor  wblk=32            ", 32, False, "io"),
    ("io-floor  wblk=16            ", 16, False, "io"),
    ("io-floor  wblk=8             ", 8, False, "io"),
    ("wblk=16  fp32 (grid slope)   ", 16, True, "none"),
    ("softmax no-max  wblk=32      ", 32, True, "nomax"),
    ("softmax bf16exp wblk=32      ", 32, True, "bf16sm"),
)


def chain_time(op, x, chain=CHAIN, iters=ITERS, graph=True, counted=()):
    """ms a link of a chain of ``chain`` links, link i running ``op(x + i)``
    and taking its mean in fp32 (one read of the output, which the baseline
    chain does not subtract): ``WARMUP`` rounds, then ``iters`` rounds timed
    by CUDA events (the host clock on the CPU).  With ``graph`` the chain is
    captured once in a CUDA graph and replayed; a capture that fails raises.
    Returns (ms, launches): ``launches`` maps each wrapper in ``counted`` (a
    function with a ``launches`` counter) to the launches the device ran,
    replays included, since a counter sees a graph's launches once, at
    capture."""
    dev = x.device
    if graph and dev.type != "cuda":
        raise ValueError(f"a CUDA graph needs a CUDA tensor, got one on {dev}")

    def run():
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(chain):
            total = total + op(x + i).mean(dtype=torch.float32)  # no fp32 copy of the output
        return total

    count = lambda: [f.launches for f in counted]
    c0 = count()
    if dev.type != "cuda":
        for _ in range(WARMUP):
            run()
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        ms = 1e3 * (time.perf_counter() - t0) / (iters * chain)
        return ms, {f.__name__: b - a for f, a, b in zip(counted, c0, count())}
    cur = torch.cuda.current_stream(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if not graph:
        for _ in range(WARMUP):
            run()
        start.record(cur)
        for _ in range(iters):
            run()
        end.record(cur)
        torch.cuda.synchronize(dev)
        ms = start.elapsed_time(end) / (iters * chain)
        return ms, {f.__name__: b - a for f, a, b in zip(counted, c0, count())}
    side = torch.cuda.Stream(dev)  # one eager round on a side stream before capture
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        run()
    cur.wait_stream(side)
    c1 = count()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        run()
    c2 = count()
    for _ in range(WARMUP):
        g.replay()
    start.record(cur)
    for _ in range(iters):
        g.replay()
    end.record(cur)
    torch.cuda.synchronize(dev)
    ms = start.elapsed_time(end) / (iters * chain)
    launches = {f.__name__: (b - a) + (d - b) * (WARMUP + iters)
                for f, a, b, d in zip(counted, c0, c1, c2)}
    del g
    return ms, launches


def baseline(x, graph):
    """chain_time of the op that only slices: what a link costs besides the op."""
    return chain_time(lambda a: a[..., :1, :1], x, graph=graph)[0]


def _weights(inp):
    return (inp["g_ln"], inp["b_ln"], inp["wqkv"], inp["bqkv"], inp["wproj"], inp["bproj"],
            inp["bias"], inp["nh"])


def check(bar=2e-5, device="cpu"):
    """The section in fp32 against attn_section_reference, in the modes that
    compute the same function (none, nomax and proj1: the same sums in another
    order), at a 26x26 map of stages 0 and 2, shift 0 and 3.  On a CUDA device
    the fp32 kernel runs; on the CPU the plain version."""
    dev = torch.device(device)
    for stage in ("stage0", "stage2"):
        inp = make_inputs(stage, 1, dtype=torch.float32, h_override=26, device=dev)
        x, w = inp["wins"], _weights(inp)
        for shifted in (False, True):
            mask = inp["mask1"] if shifted else inp["mask0"]
            reg = inp["regions"] if shifted else None
            ref = attn_section_reference(x, mask, *w, regions=reg)
            for ablate in ("none", "nomax", "proj1"):
                got = section(x, mask, reg, *w, wblk=4, ablate=ablate)
                d = float((got - ref).abs().max())
                print(f"{stage} shifted={shifted} ablate={ablate} ({dev.type}): max|d|={d:.2e}",
                      flush=True)
                if not d < bar:
                    raise AssertionError(f"{stage} shifted={shifted} ablate={ablate}: "
                                         f"max|d| {d:.3g} >= {bar}")
    print("CHECK OK", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description="attention-section variants probe")
    ap.add_argument("stage", nargs="?", default="stage0", help="stage0..stage2, or check")
    ap.add_argument("batch", nargs="?", type=int, default=16)
    ap.add_argument("only", nargs="?", default=None, help="comma list of variant numbers")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.stage == "check":
        check(device=args.device)
        return []
    if args.stage not in STAGES:
        raise ValueError(f"unknown stage {args.stage!r}; one of {STAGES}")
    picked = range(len(VARIANTS))
    if args.only is not None:
        picked = [int(v) for v in args.only.split(",")]
        bad = [v for v in picked if not 0 <= v < len(VARIANTS)]
        if bad:
            raise ValueError(f"no variant {bad}: 0..{len(VARIANTS) - 1}")
    dev = torch.device(args.device)
    inp = make_inputs(args.stage, args.batch, device=dev, seed=args.seed)
    w = _weights(inp)
    wins = inp["wins"]
    nw = wins.shape[0]
    graph = dev.type == "cuda"

    def pair(wblk, score_f32, ablate):
        kw = dict(wblk=wblk, score_f32=score_f32, ablate=ablate)

        def op(x):
            y = section(x, inp["mask0"], None, *w, **kw)
            return section(y, inp["mask1"], inp["regions"], *w, **kw)
        return op

    base_e = baseline(wins, graph=False)
    base_g = baseline(wins, graph=True) if graph else None
    print(f"{args.stage} b{args.batch} baseline: eager {base_e:.4f} ms/link"
          + (f", graph {base_g:.4f}" if graph else ""), flush=True)
    rows = []
    for vi in picked:
        name, wblk, score_f32, ablate = VARIANTS[vi]
        op = pair(wblk, score_f32, ablate)
        eager, launches = chain_time(op, wins, iters=args.iters, graph=False, counted=(section,))
        row = dict(variant=vi, name=name.strip(), stage=args.stage, batch=args.batch, wblk=wblk,
                   score_f32=score_f32, ablate=ablate, eager_ms=eager - base_e,
                   launches=launches["section"])
        if graph:
            ms, launches = chain_time(op, wins, iters=args.iters, graph=True, counted=(section,))
            row.update(graph_ms=ms - base_g, launches=row["launches"] + launches["section"])
        rows.append(row)
        times = (f"graph {row['graph_ms']:8.4f} ms, eager {row['eager_ms']:8.4f}" if graph
                 else f"eager {row['eager_ms']:8.4f} ms (host clock, plain versions)")
        print(f"{args.stage} b{args.batch} v{vi} {name}: {times} a link "
              f"({nw} windows, {-(-nw // wblk)} blocks, {row['launches']} launches)", flush=True)
    return rows


if __name__ == "__main__":
    main()
