"""Ensemble probability fusion CLI (reference fusemat.py, with flags instead
of hard-coded paths).  Port of segland_tpu/cli/fuse.py; the argmax runs on
``--device``.

    python -m segland_tpu_torch.cli.fuse --inputs a/prob b/prob c/prob --output fused/
"""

import argparse

from ..evallib.fuse import fuse_prob_dirs


def main(argv=None):
    p = argparse.ArgumentParser(description="fuse per-model .mat probability maps")
    p.add_argument("--inputs", nargs="+", required=True, help="dirs of per-tile .mat maps")
    p.add_argument("--output", required=True)
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the argmax, e.g. cuda, cpu")
    args = p.parse_args(argv)
    done = fuse_prob_dirs(args.inputs, args.output, out_size=(args.size, args.size),
                          device=args.device)
    print(f"fused {len(done)} tiles -> {args.output}")
    return done


if __name__ == "__main__":
    main()
