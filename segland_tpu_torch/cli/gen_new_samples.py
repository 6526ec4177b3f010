"""Cut-mix novel-sample importer (reference gen_new_samples_for_new_class.py).
Own copy of segland_tpu/cli/gen_new_samples.py.

Renames externally cut-mixed samples to ``<id>_new`` (de-duplicated with 'a'
suffixes), remaps the sentinel label value 30 to the novel class index,
copies images, and emits a train.txt list.  Paths are flags instead of
hard-coded.  Labels are written with rasterio where it is installed (the
source's profile copied), else as baseline TIFFs without PIL.

    python -m segland_tpu_torch.cli.gen_new_samples --cutmix-root cutmix/ --output-root new/
"""

import argparse
import os
from shutil import copyfile

import numpy as np

from ..data.geotiff import write_tiff
from ..data.tileio import _rasterio, read_label

DEFAULT_CLASSES = ["Vehicle & cargo-trailer", "Parking space", "Sports field", "Building type 2"]
DEFAULT_INDEXES = [8, 9, 10, 11]
SENTINEL = 30  # cut-mix pipelines mark pasted novel pixels with 30


def _write_label(path: str, data: np.ndarray, profile_from: str):
    rio = _rasterio()
    if rio is None:
        write_tiff(path, data.astype(np.uint8))
        return
    with rio.open(profile_from) as f:
        profile = f.profile.copy()
    profile.update(driver="GTiff", dtype="uint8")
    with rio.open(path, "w", **profile) as g:
        g.write(data.astype(np.uint8), 1)


def main(argv=None):
    p = argparse.ArgumentParser(description="import cut-mix novel samples")
    p.add_argument("--cutmix-root", required=True,
                   help="dir containing <class>/<class>_image and <class>_mask subdirs")
    p.add_argument("--output-root", required=True)
    p.add_argument("--class-names", nargs="+", default=DEFAULT_CLASSES)
    p.add_argument("--indexes", nargs="+", type=int, default=DEFAULT_INDEXES)
    args = p.parse_args(argv)

    dis_img = os.path.join(args.output_root, "image")
    dis_lbl = os.path.join(args.output_root, "label")
    os.makedirs(dis_img, exist_ok=True)
    os.makedirs(dis_lbl, exist_ok=True)

    all_list = []
    for class_name, index in zip(args.class_names, args.indexes):
        ori_img = os.path.join(args.cutmix_root, class_name, f"{class_name}_image")
        ori_lbl = os.path.join(args.cutmix_root, class_name, f"{class_name}_mask")
        if not os.path.isdir(ori_lbl):
            continue
        for f in sorted(os.listdir(ori_lbl)):
            stem = f.split(".")[0][:-2]  # reference strips the 2-char suffix
            out = stem + "_new"
            while out in all_list:
                out += "a"
            data = read_label(os.path.join(ori_lbl, f))
            data = np.where(data == SENTINEL, index, data)
            _write_label(os.path.join(dis_lbl, out + ".tif"), data, os.path.join(ori_lbl, f))
            src_img = os.path.join(ori_img, stem + ".tif")
            if os.path.exists(src_img):
                copyfile(src_img, os.path.join(dis_img, out + ".tif"))
            all_list.append(out)

    with open(os.path.join(args.output_root, "train.txt"), "w") as fh:
        fh.writelines(x + "\n" for x in all_list)
    # existence audit (reference gen_new_samples_for_new_class.py:52-58)
    for x in all_list:
        for sub in ("image", "label"):
            if not os.path.exists(os.path.join(args.output_root, sub, x + ".tif")):
                print(f"{x}.tif not exist in {sub}!")
    print(f"imported {len(all_list)} samples")
    return all_list


if __name__ == "__main__":
    main()
