"""Host-side GeoTIFF tile I/O.  Own copy of segland_tpu/data/tileio.py.

rasterio (GDAL) is used when available, matching the reference's geo-profile
copy + colormap export (eval_base.py:180-191).  Without rasterio, reads go
through the native C++ decoder (segland_tpu_torch/native) with PIL as the
last resort, and prediction exports use the in-repo GeoTIFF writer
(data/geotiff.py), which copies the source tile's geo tags so outputs stay
georeferenced.  rasterio, PIL and scipy are imported at the call that needs
them: a machine without them still reads natively decodable tiles.
"""

import functools
import os

import numpy as np

from .. import native as _native

# 12-class OEM colormap (reference eval_base.py:32-45)
OEM_COLORMAP = {
    0: (147, 147, 147),
    1: (49, 139, 87),
    2: (0, 255, 0),
    3: (128, 0, 0),
    4: (75, 181, 73),
    5: (245, 245, 245),
    6: (35, 91, 200),
    7: (247, 142, 82),
    8: (166, 166, 171),
    9: (3, 7, 255),
    10: (255, 242, 0),
    11: (170, 255, 0),
}

# eval_ft saturates novel-class colors (reference eval_ft.py:44-47)
OEM_COLORMAP_FT = dict(OEM_COLORMAP)
OEM_COLORMAP_FT.update({8: (255, 0, 255), 9: (0, 0, 255), 10: (255, 255, 0), 11: (0, 255, 255)})


@functools.cache
def _rasterio():
    """The rasterio module, or None.  An import stub without ``open`` does
    not count."""
    try:
        import rasterio  # type: ignore
    except ImportError:
        return None
    return rasterio if hasattr(rasterio, "open") else None


def _decode(path: str) -> np.ndarray:
    """Native decoder first, PIL when it declines."""
    arr = _native.decode(path)
    if arr is None:
        from PIL import Image

        arr = np.asarray(Image.open(path))
    return arr


def read_image(path: str) -> np.ndarray:
    """Read an image tile -> [H,W,C] uint8 (RGB band order as stored)."""
    rio = _rasterio()
    if rio is not None:
        return np.rollaxis(rio.open(path).read(), 0, 3)  # [C,H,W] -> [H,W,C]
    arr = _decode(path)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr[:, :, :3] if arr.shape[2] > 3 else arr


def read_label(path: str) -> np.ndarray:
    """Read a label tile -> [H,W] int."""
    rio = _rasterio()
    if rio is not None:
        return rio.open(path).read()[0]
    arr = _decode(path)
    if arr.ndim == 3:
        arr = arr[:, :, 0]
    return arr


def write_pred_tiff(path: str, pred: np.ndarray, colormap=None, profile_from: str | None = None):
    """Write a uint8 class-index prediction as colormapped GTiff
    (reference eval_base.py:180-189).  Without rasterio, the in-repo
    GeoTIFF writer copies the source tile's geo tags (pixel scale,
    tiepoints, geokeys) so outputs stay georeferenced."""
    pred = np.asarray(pred, dtype=np.uint8)
    colormap = colormap or OEM_COLORMAP
    rio = _rasterio()
    if rio is not None and profile_from and os.path.exists(profile_from):
        # the source tile is a GTiff, so its profile already names that format
        profile = rio.open(profile_from).profile.copy()
        profile.update(dtype="uint8", count=1, nodata=0)
        with rio.open(path, "w", **profile) as f:
            f.write(pred, 1)
            f.write_colormap(1, colormap)
        return
    from .geotiff import read_geo_tags, write_palette_geotiff

    geo = read_geo_tags(profile_from) if profile_from and os.path.exists(profile_from) else {}
    write_palette_geotiff(path, pred, colormap, geo)


def write_prob_mat(path: str, probs_nchw: np.ndarray):
    """Per-tile probability map as .mat with key 'outputs'
    (reference eval_base.py:190-191; NCHW layout preserved for fusemat
    byte-compatibility)."""
    import scipy.io

    scipy.io.savemat(path, {"outputs": np.asarray(probs_nchw)})


def read_prob_mat(path: str) -> np.ndarray:
    import scipy.io

    return scipy.io.loadmat(path)["outputs"]
