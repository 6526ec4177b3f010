"""ctypes bindings for the native TIFF decoder (tiffdec.cpp).

Own copy of segland_tpu/native.  Build is lazy and cached
(~/.cache/segland_tpu_torch/native); any failure — no compiler, unsupported
TIFF feature, corrupt file — degrades silently to the PIL path in
data/tileio.py, so the native layer is a pure accelerator, never
a requirement.  Set SEGLAND_NO_NATIVE=1 to disable it entirely.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "tiffdec.cpp")
_lock = threading.Lock()
_lib = None
_lib_failed = False


def _cache_dir():
    return os.environ.get(
        "SEGLAND_CACHE", os.path.join(os.path.expanduser("~"), ".cache", "segland_tpu_torch")
    )


def _build():
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out_dir = os.path.join(_cache_dir(), "native")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"tiffdec-{tag}.so")
    if not os.path.exists(so):
        tmp = so + f".tmp{os.getpid()}"
        subprocess.run(
            ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", _SRC, "-lz", "-o", tmp],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    lib.tiff_info.argtypes = [ctypes.c_char_p] + [ctypes.POINTER(ctypes.c_int)] * 3
    lib.tiff_decode.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
    lib.tiff_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)]
    lib.tiff_decode_normalize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)]
    for fn in (lib.tiff_info, lib.tiff_decode, lib.tiff_decode_batch,
               lib.tiff_decode_normalize_batch):
        fn.restype = ctypes.c_int
    lib.tiffdec_set_threads.argtypes = [ctypes.c_int]
    lib.tiffdec_set_threads.restype = None
    # libgomp defaults to the ONLINE cpu count, which badly overcounts in
    # cgroup-limited containers (spin-wait oversubscription) — pin to the
    # scheduler affinity count instead
    try:
        n = len(os.sched_getaffinity(0))
    except AttributeError:
        n = os.cpu_count() or 1
    lib.tiffdec_set_threads(int(os.environ.get("SEGLAND_DECODE_THREADS", n)))
    return lib


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is None and not _lib_failed:
            if os.environ.get("SEGLAND_NO_NATIVE"):
                _lib_failed = True
                return None
            try:
                _lib = _build()
            except Exception:
                _lib_failed = True
    return _lib


def _paths_arr(paths):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [os.fspath(p).encode() for p in paths]
    return arr


def decode(path):
    """Decode one TIFF -> uint8 [h,w] or [h,w,c] array, or None on any
    unsupported/invalid input (caller falls back to PIL)."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        w = ctypes.c_int()
        h = ctypes.c_int()
        c = ctypes.c_int()
        if lib.tiff_info(os.fspath(path).encode(), w, h, c) != 0:
            return None
        if not (0 < w.value and 0 < h.value and 0 < c.value <= 4):
            return None
        out = np.empty((h.value, w.value, c.value), np.uint8)
        rc = lib.tiff_decode(
            os.fspath(path).encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size)
    except Exception:  # never break the PIL fallback contract
        return None
    if rc != 0:
        return None
    return out[..., 0] if c.value == 1 else out


def _out_buffer(out, shape, dtype):
    """Validate a caller-supplied reuse buffer or allocate a fresh one.

    Reuse matters: on hosts where first-touch page faults on fresh >128MB
    mmaps are slow, reusing one batch buffer across loader steps is far
    cheaper than reallocating.
    """
    if out is not None:
        if out.shape != shape or out.dtype != np.dtype(dtype) or not out.flags.c_contiguous:
            raise ValueError(f"out buffer must be C-contiguous {shape} {dtype}")
        return out
    return np.empty(shape, dtype)


def decode_batch(paths, h, w, c, out=None):
    """Decode n same-shaped TIFFs in parallel -> uint8 [n,h,w,c], or None."""
    lib = get_lib()
    if lib is None or not paths:
        return None
    out = _out_buffer(out, (len(paths), h, w, c), np.uint8)
    errs = np.zeros(len(paths), np.int32)
    rc = lib.tiff_decode_batch(
        _paths_arr(paths), len(paths), h, w, c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        errs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out if rc == 0 else None


def decode_normalize_batch(paths, h, w, mean, std, bgr_flip=True, out=None):
    """Decode n RGB TIFFs fused with eval normalization -> float32 [n,h,w,3]
    matching data/augment.py::normalize, or None."""
    lib = get_lib()
    if lib is None or not paths:
        return None
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    out = _out_buffer(out, (len(paths), h, w, 3), np.float32)
    errs = np.zeros(len(paths), np.int32)
    rc = lib.tiff_decode_normalize_batch(
        _paths_arr(paths), len(paths), h, w,
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        1 if bgr_flip else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        errs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out if rc == 0 else None
