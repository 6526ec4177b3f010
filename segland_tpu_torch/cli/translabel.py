"""Label colorizer CLI (reference translabel.py).  Port of
segland_tpu/cli/translabel.py.

    python -m segland_tpu_torch.cli.translabel --input labels/ --output colored/
"""

import argparse

from ..evallib.fuse import colorize_labels


def main(argv=None):
    p = argparse.ArgumentParser(description="write colormapped copies of label tiles")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)
    colorize_labels(args.input, args.output)


if __name__ == "__main__":
    main()
