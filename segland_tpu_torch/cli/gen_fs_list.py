"""k-shot support-list sampler (reference utils/gen_fs_list.py, OEM-adapted).
Port of segland_tpu/cli/gen_fs_list.py on the port's own tile reader.

    python -m segland_tpu_torch.cli.gen_fs_list --data-dir DATA \\
        --train-list DATA/list/train.txt --shot 5 --seed 123

Samples `shot` images per novel class from labeled tiles and writes
``all_<shot>shot_seed<seed>.txt`` (the file ft_pop consumes) — 4 novel
classes x shot ids, grouped by class in novel-class order.
"""

import argparse
import os
import random

import numpy as np

from ..data.oem import NOVEL_CLASSES
from ..data.tileio import read_label


def main(argv=None):
    p = argparse.ArgumentParser(description="generate k-shot novel support lists")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--train-list", required=True)
    p.add_argument("--shot", type=int, default=5)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--min-pixels", type=int, default=1,
                   help="minimum novel-class pixels for a tile to qualify")
    args = p.parse_args(argv)

    with open(args.train_list) as f:
        ids = f.read().splitlines()
    cls_to_ids = {c: [] for c in NOVEL_CLASSES}
    for tid in ids:
        path = os.path.join(args.data_dir, "labels", f"{tid}.tif")
        if not os.path.exists(path):
            continue
        label = read_label(path)
        for c in NOVEL_CLASSES:
            if int(np.sum(label == c)) >= args.min_pixels:
                cls_to_ids[c].append(tid)

    rng = random.Random(args.seed)
    out = []
    for c in NOVEL_CLASSES:
        pool = cls_to_ids[c]
        if len(pool) < args.shot:
            picks = pool + [rng.choice(pool) for _ in range(args.shot - len(pool))]
        else:
            picks = rng.sample(pool, args.shot)
        out.extend(picks)
    out_path = os.path.join(os.path.dirname(args.train_list),
                            f"all_{args.shot}shot_seed{args.seed}.txt")
    with open(out_path, "w") as f:
        f.writelines(x + "\n" for x in out)
    print(f"wrote {len(out)} support ids -> {out_path}")


if __name__ == "__main__":
    main()
