"""Ensemble probability fusion and contest export (reference fusemat.py,
trans.py, translabel.py).  Port of segland_tpu/evallib/fuse.py.

fuse_prob_maps reads N directories of per-tile .mat probability maps (key
'outputs', NCHW), sums each tile's maps over the models in float64 on the
host, divides by the number of directories and takes the argmax of that
mean, cast to float32, on the device (reference fusemat.py:26-53).
fuse_prob_dirs writes the maps as palette PNGs at 1024x1024 NEAREST.  PIL
is imported only by the PNG writers.
"""

import os
from typing import Sequence

import numpy as np
import torch

from ..data.tileio import OEM_COLORMAP, read_label, read_prob_mat, write_pred_tiff

# fusemat's 8-color palette (base classes only, fusemat.py:19-27)
FUSE_PALETTE = np.array(
    [
        [147, 147, 147], [49, 139, 87], [0, 255, 0], [128, 0, 0],
        [75, 181, 73], [245, 245, 245], [35, 91, 200], [247, 142, 82],
    ],
    dtype=np.uint8,
)


def _write_palette_png(path: str, idx_map: np.ndarray, palette: np.ndarray,
                       out_size=(1024, 1024)):
    from PIL import Image

    img = Image.fromarray(idx_map.astype(np.uint8), "P")
    img = img.resize(out_size, Image.NEAREST)
    img.putpalette(palette.flatten().tolist())
    img.save(path)


def fuse_prob_maps(fusion_dirs: Sequence[str], device) -> dict:
    """{tile file name: uint8 [H,W] argmax of the mean 'outputs' map}.  A tile
    missing from some directories is still divided by their number, as the
    reference divides."""
    sums = {}
    for d in fusion_dirs:
        for root, _, files in os.walk(d):
            for f in files:
                if not f.endswith(".mat"):
                    continue
                prob = read_prob_mat(os.path.join(root, f))[0]  # [K,H,W]
                sums[f] = sums[f] + prob if f in sums else prob.astype(np.float64)
    out = {}
    for f, total in sums.items():
        mean = torch.from_numpy((total / len(fusion_dirs)).astype(np.float32)).to(device)
        out[f] = mean.argmax(0).to(torch.uint8).cpu().numpy()
    return out


def fuse_prob_dirs(fusion_dirs: Sequence[str], output_path: str,
                   palette: np.ndarray | None = None, out_size=(1024, 1024), device="cuda"):
    """Average 'outputs' prob maps across model dirs, argmax on ``device``,
    export palette PNGs.  Returns the sorted list of tile file names fused."""
    palette = FUSE_PALETTE if palette is None else palette
    os.makedirs(output_path, exist_ok=True)
    maps = fuse_prob_maps(fusion_dirs, device)
    for f, idx in maps.items():
        _write_palette_png(os.path.join(output_path, f.split(".")[0] + ".png"), idx, palette,
                           out_size)
    return sorted(maps)


def resize_preds_to_png(input_dir: str, output_dir: str, out_size=(1024, 1024)):
    """Contest-format export: every .tif prediction resized NEAREST to
    1024x1024 and saved as .png (reference trans.py:12-22)."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    done = []
    for f in sorted(os.listdir(input_dir)):
        if not f.endswith(".tif"):
            continue
        img = Image.open(os.path.join(input_dir, f))
        img = img.resize(out_size, Image.NEAREST)
        out = os.path.splitext(f)[0] + ".png"
        img.save(os.path.join(output_dir, out))
        done.append(out)
    return done


def colorize_labels(label_dir: str, save_dir: str, colormap=None):
    """Write colormapped copies of label tiles (reference translabel.py)."""
    colormap = colormap or OEM_COLORMAP
    os.makedirs(save_dir, exist_ok=True)
    for f in sorted(os.listdir(label_dir)):
        if not f.endswith(".tif"):
            continue
        label = read_label(os.path.join(label_dir, f))
        write_pred_tiff(
            os.path.join(save_dir, f), label.astype(np.uint8), colormap,
            profile_from=os.path.join(label_dir, f),
        )
