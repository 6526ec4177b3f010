"""80/20 train/test split lister (reference get_list.py, with flags).  Own
copy of segland_tpu/cli/get_list.py.

    python -m segland_tpu_torch.cli.get_list --input images/ --seed 0
"""

import argparse
import os
import random


def main(argv=None):
    p = argparse.ArgumentParser(description="random 80/20 file split lists")
    p.add_argument("--input", required=True, help="images directory")
    p.add_argument("--train-out", default="file_train.txt")
    p.add_argument("--test-out", default="file_test.txt")
    p.add_argument("--ratio", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)
    rng = random.Random(args.seed)
    with open(args.train_out, "w") as ftr, open(args.test_out, "w") as fte:
        for root, _, files in os.walk(args.input):
            for f in sorted(files):
                (ftr if rng.random() < args.ratio else fte).write(f + "\n")


if __name__ == "__main__":
    main()
