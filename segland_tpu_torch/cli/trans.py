"""Contest-format export CLI (reference trans.py): .tif predictions ->
1024x1024 NEAREST .png.  Port of segland_tpu/cli/trans.py.

    python -m segland_tpu_torch.cli.trans --input preds/ --output contest/
"""

import argparse

from ..evallib.fuse import resize_preds_to_png


def main(argv=None):
    p = argparse.ArgumentParser(description="resize .tif predictions to contest .png")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--size", type=int, default=1024)
    args = p.parse_args(argv)
    done = resize_preds_to_png(args.input, args.output, (args.size, args.size))
    print(f"exported {len(done)} tiles -> {args.output}")
    return done


if __name__ == "__main__":
    main()
