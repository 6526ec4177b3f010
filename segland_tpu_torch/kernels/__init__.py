"""Builds and loads the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one ``nvcc``
a source, all started together; ``csrc/*.cuh`` are shared headers; a source
with a line ``// segland-parts: N`` is compiled N times, with
``-DSEGLAND_PART=0..N-1``, each part instantiating its share) and
linked into one shared library with a plain C interface, loaded with
``ctypes``.  The build happens at the first
CUDA call, never at import, so the package imports on a machine without
``nvcc``.  The library is cached under ``build/`` by a hash
of the sources and flags; a changed source builds a new library.

Each C entry returns a ``cudaError_t``; :func:`check` raises on a non-zero
one.  Pointers and the stream are passed as ``ctypes.c_void_p`` (a bare
Python int would be cut to 32 bits).
"""

import ctypes
import functools
import hashlib
import os
import re
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_ENTRIES = {
    # dtype, x, res, gamma, beta, w1, b1, w2, b2, ls, out, M, C, H, eps, device, stream
    "segland_ln_mlp": [_I] + [_P] * 10 + [ctypes.c_longlong, _I, _I, ctypes.c_float,
                                          _I, _P],
    # logits, rlo, rhi, rw, clo, chi, cw, out, B, h, w, K, oh, ow, device, stream
    "segland_upsample_argmax": [_P] * 8 + [_I] * 7 + [_P],
    # dtype, x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, out, NW, C, nh,
    # h, w, hp, wp, ws, shift, eps, device, stream
    "segland_attn_section": [_I] + [_P] * 9 + [ctypes.c_longlong] + [_I] * 8
                            + [ctypes.c_float, _I, _P],
    # dtype, qkv, bias, out, NW, C, nh, nw_img, device, stream
    "segland_window_attention": [_I] + [_P] * 3 + [ctypes.c_longlong] + [_I] * 4 + [_P],
    # dtype, x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, gamma2, beta2, w1, b1, w2, b2,
    # out, NW, C, nh, H, h, w, hp, wp, ws, shift, eps, device, stream
    "segland_swin_block": [_I] + [_P] * 15 + [ctypes.c_longlong] + [_I] * 9
                          + [ctypes.c_float, _I, _P],
    # dtype, x, mask_tok, rows_m, regions, rows_r, gamma, beta, wqkv, bqkv, wproj, bproj,
    # bias, scratch, out, NW, C, nh, group, eps, device, stream
    "segland_attn_section_v1": [_I, _P, _P, _I, _P, _I] + [_P] * 9 + [ctypes.c_longlong]
                               + [_I] * 3 + [ctypes.c_float, _I, _P],
    # x, w1t, w2t, w3t, a1, b1, a2, b2, a3, b3, out, B, H, W, C, P, d, relu,
    # s_x, s_h1, s_h2, device, stream
    "segland_bottleneck_int8": [_P] * 11 + [_I] * 7 + [ctypes.c_float] * 3 + [_I, _P],
    # x, mask_tok, rows_m, regions, rows_r, gamma, beta, wqkv, bqkv, wproj, bproj, bias, out,
    # NW, C, nh, hg, wblk, h, w, hp, wp, ws, shift, eps, ablate, score_f32, device, stream
    **{name: [_P, _P, _I, _P, _I] + [_P] * 8 + [ctypes.c_longlong] + [_I] * 10
       + [ctypes.c_float] + [_I] * 3 + [_P]
       for name in ("segland_hg_section", "segland_hg2_section")},
    # h2q, res, w3t, a3, b3, out, M, P, C, relu, device, stream
    "segland_conv3_residual_int8": [_P] * 6 + [ctypes.c_longlong] + [_I] * 4 + [_P],
}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME to build the kernels")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def sources():
    return sorted(CSRC.glob("*.cu"))


def compile_units():
    """(source, extra nvcc flags) of each nvcc process: one a source, or one a
    part of a source that declares ``// segland-parts: N``."""
    units = []
    for src in sources():
        m = re.search(r"^// segland-parts: (\d+)$", src.read_text(), re.M)
        units += ([(src, (f"-DSEGLAND_PART={i}",)) for i in range(int(m.group(1)))] if m
                  else [(src, ())])
    return units


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the headers too
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"libsegland_kernels_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the kernels if this source hash has no library yet.  Returns
    {"path", "seconds", "built", "log"}; ``log`` holds nvcc's ptxas report
    (registers, shared memory, spills per kernel) when it built."""
    so = library_path()
    if so.exists():
        return {"path": str(so), "seconds": 0.0, "built": False, "log": ""}
    BUILD.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    units = compile_units()
    objs = [BUILD / f"{tag}.{src.stem}.{i}.o" for i, (src, _) in enumerate(units)]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *flags, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for (src, flags), obj in zip(units, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    try:
        for (src, flags), proc, out in zip(units, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} {' '.join(flags)} "
                                   f"({proc.returncode}):\n{out}")
        tmp = BUILD / f"{tag}.tmp"
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent build never sees a partial file
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    log = "".join(logs)
    (BUILD / "build.log").write_text(log)
    return {"path": str(so), "seconds": time.perf_counter() - t0, "built": True,
            "log": log}


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    # C, P, d -> th, tw, smem bytes; returns 0 when no tile fits
    lib.segland_bottleneck_int8_tile.argtypes = [_I] * 3 + [ctypes.POINTER(_I)] * 3
    lib.segland_bottleneck_int8_tile.restype = ctypes.c_int
    lib.segland_error_string.argtypes = [ctypes.c_int]
    lib.segland_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str):
    if err != 0:
        msg = library().segland_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor, or NULL for None."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """The current PyTorch stream on ``t``'s device."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
