"""Minimal GeoTIFF writing + geo-tag copying (no GDAL).

The reference exports predictions as colormapped GTiffs carrying the source
tile's geo-profile (eval_base.py:180-189 copies the rasterio profile).  This
module reproduces that without rasterio: ``read_geo_tags`` extracts the
GeoTIFF tags from the source tile and ``write_palette_geotiff`` writes a
single-band palette TIFF (deflate strips) with those tags attached, so the
outputs land correctly georeferenced in GIS tools.

Pure Python (struct + zlib): the write path is cold (one small tile per
export) — the hot decode path is the C++ reader in segland_tpu_torch/native.
"""

import struct
import zlib

import numpy as np

# GeoTIFF + georeferencing tags to preserve (TIFF 6.0 / GeoTIFF 1.1)
GEO_TAGS = (
    33550,  # ModelPixelScaleTag (DOUBLE)
    33922,  # ModelTiepointTag (DOUBLE)
    34264,  # ModelTransformationTag (DOUBLE)
    34735,  # GeoKeyDirectoryTag (SHORT)
    34736,  # GeoDoubleParamsTag (DOUBLE)
    34737,  # GeoAsciiParamsTag (ASCII)
    42112,  # GDAL_METADATA (ASCII)
    42113,  # GDAL_NODATA (ASCII)
)

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 12: 8}
_TYPE_FMT = {3: "H", 4: "I", 12: "d"}


def read_geo_tags(path: str):
    """Extract GEO_TAGS from a TIFF -> {tag: (type, values bytes)} (empty on
    any parse problem — geo copying is best-effort)."""
    out = {}
    try:
        with open(path, "rb") as f:
            data = f.read()
        if len(data) < 8 or data[:2] not in (b"II", b"MM"):
            return out
        e = "<" if data[:2] == b"II" else ">"
        if struct.unpack(e + "H", data[2:4])[0] != 42:
            return out
        (ifd,) = struct.unpack(e + "I", data[4:8])
        (n,) = struct.unpack(e + "H", data[ifd:ifd + 2])
        for k in range(n):
            off = ifd + 2 + k * 12
            tag, typ, cnt = struct.unpack(e + "HHI", data[off:off + 8])
            if tag not in GEO_TAGS or typ not in _TYPE_SIZE:
                continue
            size = _TYPE_SIZE[typ] * cnt
            if size <= 4:
                raw = data[off + 8:off + 8 + size]
            else:
                (voff,) = struct.unpack(e + "I", data[off + 8:off + 12])
                raw = data[voff:voff + size]
            if len(raw) != size:
                continue
            if e == ">" and typ in _TYPE_FMT:  # normalize to little-endian
                w = _TYPE_SIZE[typ]
                vals = struct.unpack(f">{cnt}{_TYPE_FMT[typ]}", raw)
                raw = struct.pack(f"<{cnt}{_TYPE_FMT[typ]}", *vals)
            out[tag] = (typ, raw)
    except Exception:
        return {}
    return out


def write_palette_geotiff(path: str, pred: np.ndarray, colormap: dict,
                          geo_tags: dict | None = None):
    """Write a uint8 [H,W] class map as a palette GeoTIFF (deflate, one
    strip) with optional geo tags from :func:`read_geo_tags`."""
    pred = np.ascontiguousarray(pred, np.uint8)
    h, w = pred.shape
    payload = zlib.compress(pred.tobytes(), 6)

    # 256-entry RGB palette, 16-bit per channel (value * 257), planar R,G,B
    pal = np.zeros((3, 256), np.uint16)
    for idx, rgb in colormap.items():
        for c in range(3):
            pal[c, idx] = rgb[c] * 257

    entries = []  # (tag, type, count, packed_values)

    def add(tag, typ, cnt, raw):
        entries.append((tag, typ, cnt, raw))

    short = lambda v: struct.pack("<H", v) + b"\0\0"
    long_ = lambda v: struct.pack("<I", v)
    add(256, 3, 1, short(w))
    add(257, 3, 1, short(h))
    add(258, 3, 1, short(8))
    add(259, 3, 1, short(8))          # deflate
    add(262, 3, 1, short(3))          # palette
    add(273, 4, 1, b"STRIP_OFF")      # placeholder
    add(277, 3, 1, short(1))
    add(278, 3, 1, short(h))
    add(279, 4, 1, long_(len(payload)))
    add(320, 3, 768, pal.tobytes())   # ColorMap
    for tag, (typ, raw) in sorted((geo_tags or {}).items()):
        add(tag, typ, len(raw) // _TYPE_SIZE[typ], raw)
    entries.sort(key=lambda x: x[0])

    ifd_off = 8
    data_off = ifd_off + 2 + len(entries) * 12 + 4
    blobs = []
    packed = []
    for tag, typ, cnt, raw in entries:
        if raw == b"STRIP_OFF":
            packed.append((tag, typ, cnt, None))  # patched below
            continue
        if len(raw) <= 4:
            packed.append((tag, typ, cnt, struct.unpack("<I", raw.ljust(4, b"\0"))[0]))
        else:
            packed.append((tag, typ, cnt, data_off))
            blobs.append(raw)
            data_off += len(raw)
    strip_off = data_off

    out = bytearray(b"II*\0" + struct.pack("<I", ifd_off))
    out += struct.pack("<H", len(packed))
    for tag, typ, cnt, val in packed:
        out += struct.pack("<HHI", tag, typ, cnt)
        out += struct.pack("<I", strip_off if val is None else val)
    out += struct.pack("<I", 0)
    for raw in blobs:
        out += raw
    out += payload
    with open(path, "wb") as f:
        f.write(bytes(out))


def write_tiff(path: str, arr: np.ndarray):
    """Write a uint8 [H,W] (grey) or [H,W,3] (RGB) array as a baseline TIFF:
    one uncompressed strip, chunky samples, no geo tags.  What the readers
    (``tileio``, the native decoder) take, written without PIL; for synthetic
    tiles."""
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w = arr.shape[:2]
    spp = 1 if arr.ndim == 2 else arr.shape[2]
    if spp not in (1, 3):
        raise ValueError(f"write_tiff takes [H,W] or [H,W,3], got {arr.shape}")
    n_tags = 9
    ifd_end = 8 + 2 + n_tags * 12 + 4
    bits_off = ifd_end  # BitsPerSample's 3 shorts do not fit in the entry
    data_off = ifd_end + (6 if spp == 3 else 0)
    tags = [(256, 3, 1, w), (257, 3, 1, h),
            (258, 3, spp, 8 if spp == 1 else bits_off), (259, 3, 1, 1),
            (262, 3, 1, 1 if spp == 1 else 2), (273, 4, 1, data_off), (277, 3, 1, spp),
            (278, 3, 1, h), (279, 4, 1, arr.nbytes)]
    out = bytearray(b"II*\0" + struct.pack("<I", 8) + struct.pack("<H", n_tags))
    for tag, typ, cnt, val in tags:
        out += struct.pack("<HHI", tag, typ, cnt)
        out += struct.pack("<HH", val, 0) if typ == 3 and cnt == 1 else struct.pack("<I", val)
    out += struct.pack("<I", 0)
    if spp == 3:
        out += struct.pack("<3H", 8, 8, 8)
    out += arr.tobytes()
    with open(path, "wb") as f:
        f.write(bytes(out))
