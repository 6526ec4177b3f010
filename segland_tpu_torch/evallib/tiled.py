"""Tiled inference for scenes larger than the training tile.  Port of
segland_tpu/evallib/tiled.py.

The reference evaluates whole 1024x1024 tiles (eval_base.py:162-168); real
deployments have GeoTIFF scenes of any size.  A scene is split into
overlapping tiles, the tiles run in batches, and the per-pixel logits are
stitched back with overlap averaging.  ``predict_scene`` stitches on the
host; ``predict_scene_device`` keeps the scene, the accumulator and the
stitching on the device and returns only the uint8 class map.
"""

import numpy as np
import torch


def _tile_starts(size: int, tile: int, stride: int):
    if size <= tile:
        return [0]
    starts = list(range(0, size - tile + 1, stride))
    if starts[-1] != size - tile:
        starts.append(size - tile)
    return starts


def _padded_coords(image, tile: int, overlap: int):
    """(image zero-padded to at least tile x tile, [(y, x) of each tile])."""
    h, w = image.shape[:2]
    pad_h, pad_w = max(0, tile - h), max(0, tile - w)
    if pad_h or pad_w:
        image = np.pad(image, ((0, pad_h), (0, pad_w), (0, 0)))
    ph, pw = image.shape[:2]
    stride = tile - overlap
    return image, [(y, x) for y in _tile_starts(ph, tile, stride)
                   for x in _tile_starts(pw, tile, stride)]


def predict_scene(predict_batch, image: np.ndarray, num_classes: int,
                  tile: int = 1024, overlap: int = 128, batch: int = 8):
    """image [H,W,3] float32 (normalized) -> (logits [H,W,K] fp32 on the host,
    pred [H,W] uint8).

    predict_batch(images [B,tile,tile,3] on the host) -> logits
    [B,tile,tile,K] as a host array (e.g. Evaluator.predict_batch with
    out_hw=(tile, tile), fetched).  The last batch is zero-padded to
    ``batch`` tiles, so every call has one shape.
    """
    h, w = image.shape[:2]
    image, coords = _padded_coords(image, tile, overlap)
    ph, pw = image.shape[:2]
    acc = np.zeros((ph, pw, num_classes), np.float32)
    cnt = np.zeros((ph, pw, 1), np.float32)
    for i in range(0, len(coords), batch):
        chunk = coords[i : i + batch]
        tiles = np.stack([image[y : y + tile, x : x + tile] for y, x in chunk], 0)
        if len(chunk) < batch:
            tiles = np.concatenate(
                [tiles, np.zeros((batch - len(chunk),) + tiles.shape[1:], tiles.dtype)], 0)
        logits = np.asarray(predict_batch(tiles))[: len(chunk)]
        for (y, x), lg in zip(chunk, logits):
            acc[y : y + tile, x : x + tile] += lg
            cnt[y : y + tile, x : x + tile] += 1.0
    acc /= np.maximum(cnt, 1.0)
    acc = acc[:h, :w]
    return acc, np.argmax(acc, axis=-1).astype(np.uint8)


@torch.inference_mode()
def predict_scene_device(apply_fn, image: np.ndarray, num_classes: int, device,
                         tile: int = 1024, overlap: int = 128, batch: int = 8):
    """The whole scene, the (H,W,K) fp32 accumulator and the count live on
    ``device``; only the uint8 class map returns to the host.  The host path
    fetches [B,tile,tile,K] fp32 logits a batch (32 MB a tile at K = 8);
    here the cost is the scene plus the accumulator on the device (537 MB at
    4096^2, K = 8).

    apply_fn(tiles [B,tile,tile,3] fp32 on the device) -> logits
    [B,tile,tile,K] on the device, already upsampled to the tile.  The
    coordinate list is padded to a multiple of ``batch`` with repeats of the
    last tile, so every call has one shape; the repeats' logits are not
    added (the JAX version adds them, which weighs the last tile more where
    it overlaps others), so the average is the host path's.  Each batch's
    logits are added in coordinate order and dropped before the next batch
    runs.  Returns pred [H,W] uint8 on the host.
    """
    h, w = image.shape[:2]
    image, coords = _padded_coords(np.asarray(image, np.float32), tile, overlap)
    ph, pw = image.shape[:2]
    n_real = len(coords)
    coords += [coords[-1]] * (-n_real % batch)
    scene = torch.from_numpy(np.ascontiguousarray(image)).to(device)
    acc = torch.zeros((ph, pw, num_classes), dtype=torch.float32, device=scene.device)
    cnt = torch.zeros((ph, pw, 1), dtype=torch.float32, device=scene.device)
    for i in range(0, len(coords), batch):
        chunk = coords[i : i + batch]
        tiles = torch.stack([scene[y : y + tile, x : x + tile] for y, x in chunk], 0)
        logits = apply_fn(tiles).float()
        for (y, x), lg in zip(chunk[: n_real - i], logits):
            acc[y : y + tile, x : x + tile] += lg
            cnt[y : y + tile, x : x + tile] += 1.0
        del logits
    acc /= cnt.clamp_min_(1.0)
    return acc.argmax(-1).to(torch.uint8)[:h, :w].cpu().numpy()
