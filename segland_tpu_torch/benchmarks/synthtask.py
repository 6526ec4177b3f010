"""The learnable synthetic GFSS task (colour segmentation), written without PIL.

Own copy of the JAX package's test task (its ``tests/synthtask.py``): the same
palette, noise, tile layout, draw order, tile ids and list files, so that the
two write the same pixels and labels.  Every class c has a distinct RGB
colour; an image is palette[label] + N(0, sigma) noise; a tile is a 2x2 grid
of 32x32 blocks.  The novel classes {8..11} never appear in base training.
The tiles are baseline TIFFs from ``data/geotiff.py:write_tiff`` (uint8), which
the port's readers decode natively, so a machine without PIL builds and reads
the task.

    python -m segland_tpu_torch.benchmarks.synthtask DIR
"""

import sys
from pathlib import Path

import numpy as np

from ..data.geotiff import write_tiff

# distinct, well-separated colours per class (0 = background)
PALETTE = np.array(
    [
        (0, 0, 0),        # 0 bg
        (220, 40, 40),    # 1
        (40, 220, 40),    # 2
        (40, 40, 220),    # 3
        (220, 220, 40),   # 4
        (220, 40, 220),   # 5
        (40, 220, 220),   # 6
        (240, 140, 40),   # 7
        (245, 245, 245),  # 8 novel
        (130, 70, 190),   # 9 novel
        (100, 160, 100),  # 10 novel
        (70, 130, 160),   # 11 novel
    ],
    np.uint8,
)
SIZE = 64
NOISE = 10.0


def make_tile(rng, block_classes):
    """2x2 grid of 32x32 blocks; image = class colour + gaussian noise."""
    lab = np.zeros((SIZE, SIZE), np.uint8)
    half = SIZE // 2
    for i, c in enumerate(block_classes):
        y, x = (i // 2) * half, (i % 2) * half
        lab[y: y + half, x: x + half] = c
    img = PALETTE[lab].astype(np.float32)
    img = img + rng.randn(SIZE, SIZE, 3) * NOISE
    return np.clip(img, 0, 255).astype(np.uint8), lab


def build_task(root):
    """Write the task under ``root`` (a ``Path`` or str, made if missing;
    ``images/``, ``labels/`` and ``list/`` must not exist yet): 16 base-train tiles
    (``train.txt``), 5 support tiles a novel class in class order
    (``all_5shot_seed123.txt``), 4 mixed base + novel validation tiles
    (``val.txt``) and 4 base-only ones (``val_base.txt``).  Returns ``root``
    as a ``Path``."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    for d in ("images", "labels", "list"):
        (root / d).mkdir()
    rng = np.random.RandomState(0)

    def save(tid, img, lab):
        write_tiff(str(root / "images" / f"{tid}.tif"), img)
        write_tiff(str(root / "labels" / f"{tid}.tif"), lab)

    train_ids = []
    for i in range(16):
        cs = [1 + (i + j) % 7 for j in range(3)] + [0]
        rng.shuffle(cs)
        tid = f"base_{i}"
        save(tid, *make_tile(rng, cs))
        train_ids.append(tid)

    # the support list is indexed cls_idx * shot + k (reference oem_ft.py:222-260)
    supp_ids = []
    for c in (8, 9, 10, 11):
        for k in range(5):
            tid = f"novel{c}_{k}"
            save(tid, *make_tile(rng, [c, c, 0, c]))
            supp_ids.append(tid)

    val_ids = []
    for i in range(4):
        cs = [1 + (2 * i) % 7, 2 + (2 * i + 3) % 7, 8 + i, 8 + (i + 1) % 4]
        tid = f"val_{i}"
        save(tid, *make_tile(rng, cs))
        val_ids.append(tid)

    val_base_ids = []
    for i in range(4):
        cs = [1 + (2 * i) % 7, 2 + (2 * i + 1) % 7, 3 + (2 * i) % 7, 0]
        tid = f"valb_{i}"
        save(tid, *make_tile(rng, cs))
        val_base_ids.append(tid)

    (root / "list" / "train.txt").write_text("\n".join(train_ids) + "\n")
    (root / "list" / "val.txt").write_text("\n".join(val_ids) + "\n")
    (root / "list" / "val_base.txt").write_text("\n".join(val_base_ids) + "\n")
    (root / "list" / "all_5shot_seed123.txt").write_text("\n".join(supp_ids) + "\n")
    return root


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit("usage: python -m segland_tpu_torch.benchmarks.synthtask DIR")
    print(build_task(sys.argv[1]))
