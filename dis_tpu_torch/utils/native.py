"""ctypes bindings for the native host-side I/O library; counterpart of
``dis_tpu/utils/native.py``.

``tools/native_io/native_io.cpp`` provides PNG-gray decode, the .flo
codec, the KITTI 16-bit flow codec and colour-wheel rasterization in C++
(the reference's host runtime is native too: OpenCV and its own .flo
code).  The port compiles that source itself, with one ``g++`` command,
into ``dis_tpu_torch/_build/`` under a name keyed by a hash of the source
and flags (as ``dis_tpu_torch/_build.py`` does for the CUDA kernels), so
it never writes into the JAX package's tree.  The build runs at the first
use, never at import.  Where it cannot build, every call site falls back
to its NumPy version; :func:`require` raises instead, for callers that
must have it (the CLI on a CUDA device).  The library is built from the
source in the checkout, so every entry point the source exports is
there (the JAX package's stale-library check has no counterpart).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PKG_DIR / "_build"
SOURCE = PKG_DIR.parent / "tools" / "native_io" / "native_io.cpp"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

# Upper bound on pixel count accepted from an untrusted PNG IHDR before
# allocating; rejects corrupt/hostile headers that would trigger multi-GB
# np.empty calls (the native codec re-validates after decode).
_MAX_PIXELS = 100_000_000


def _dims_ok(w: int, h: int) -> bool:
    return 0 < w and 0 < h and w * h <= _MAX_PIXELS


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libnative_io_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the current one exists; returns its
    path.  Raises RuntimeError when the source or a compiler is missing
    or the compile fails."""
    if not SOURCE.is_file():
        raise RuntimeError(f"native I/O source {SOURCE} not found")
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++ or c++ on PATH, or $CXX)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lz"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"native I/O build failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)   # atomic: a concurrent build never loads a partial file
    finally:
        tmp.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=None)
def _load() -> Tuple[Optional[ctypes.CDLL], str]:
    """(the loaded library, "") or (None, why it is unavailable)."""
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
        return None, str(e)
    lib.png_decode_gray.restype = ctypes.c_int
    lib.png_decode_gray.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.flo_write.restype = ctypes.c_int
    lib.flo_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.flo_peek.restype = ctypes.c_int
    lib.flo_peek.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_int)]
    lib.flo_read.restype = ctypes.c_int
    lib.flo_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long,
                             ctypes.c_int]
    lib.flow_to_bgr.restype = None
    lib.flow_to_bgr.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_float, ctypes.c_void_p]
    lib.kitti_flow_read.restype = ctypes.c_int
    lib.kitti_flow_read.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.kitti_flow_write.restype = ctypes.c_int
    lib.kitti_flow_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_int]
    lib.png_peek.restype = ctypes.c_int
    lib.png_peek.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_int)]
    return lib, ""


def available() -> bool:
    return _load()[0] is not None


def require() -> None:
    """Raise RuntimeError, with the build's error, unless the library is
    available."""
    lib, why = _load()
    if lib is None:
        raise RuntimeError(f"the native I/O library is unavailable: {why}")


def png_decode_gray(data: bytes) -> Optional[np.ndarray]:
    """Decode PNG bytes to uint8 gray; None if unsupported/unavailable."""
    lib = _load()[0]
    if lib is None:
        return None
    cap = len(data) * 64 + (1 << 20)  # generous: decompressed gray bound
    out = np.empty(cap, np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.png_decode_gray(
        data, len(data), out.ctypes.data_as(ctypes.c_char_p), cap,
        ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    return out[: w.value * h.value].reshape(h.value, w.value).copy()


def flo_write(path: str, data: np.ndarray) -> bool:
    lib = _load()[0]
    if lib is None:
        return False
    arr = np.ascontiguousarray(data, dtype="<f4")
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    return lib.flo_write(path.encode(), arr.ctypes.data, w, h, c) == 0


def flo_read(path: str, channels: int = 2) -> Optional[np.ndarray]:
    """Native .flo decode -> [H, W, channels] float32, or None when the
    library is unavailable or the file unsupported."""
    lib = _load()[0]
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.flo_peek(path.encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    if not _dims_ok(w.value, h.value):  # untrusted header: bound before alloc
        return None
    out = np.empty((h.value, w.value, channels), "<f4")
    rc = lib.flo_read(path.encode(), out.ctypes.data, out.size, channels)
    return out if rc == 0 else None


def kitti_flow_read(path: str):
    """Native KITTI GT decode -> (flow [H,W,2] f32, valid [H,W] bool),
    or None when the library is unavailable or the file unsupported."""
    lib = _load()[0]
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.png_peek(path.encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    if not _dims_ok(w.value, h.value):  # untrusted IHDR: bound before alloc
        return None
    flow = np.empty((h.value, w.value, 2), np.float32)
    valid = np.empty((h.value, w.value), np.uint8)
    rc = lib.kitti_flow_read(path.encode(), flow.ctypes.data, flow.size,
                             valid.ctypes.data, valid.size,
                             ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    return flow, valid.astype(bool)


def kitti_flow_write(path: str, flow: np.ndarray,
                     valid: Optional[np.ndarray] = None) -> bool:
    """Native KITTI GT encode of flow [H, W, 2] (and valid [H, W], all
    valid when None); False when the library is unavailable or the write
    fails.  Other shapes raise ValueError before any pointer is passed."""
    lib = _load()[0]
    if lib is None:
        return False
    arr = np.ascontiguousarray(flow, np.float32)
    if arr.ndim != 3 or arr.shape[2] != 2:
        raise ValueError(f"flow must be [H, W, 2], got {arr.shape}")
    h, w = arr.shape[:2]
    vptr = None
    if valid is not None:
        varr = np.ascontiguousarray(valid, np.uint8)
        if varr.shape != (h, w):
            raise ValueError(f"valid must be [{h}, {w}], got {varr.shape}")
        vptr = varr.ctypes.data
    return lib.kitti_flow_write(path.encode(), arr.ctypes.data,
                                vptr, w, h) == 0


def flow_to_bgr(flow: np.ndarray, maxmotion: float = -1.0) -> Optional[np.ndarray]:
    lib = _load()[0]
    if lib is None:
        return None
    arr = np.ascontiguousarray(flow, dtype=np.float32)
    h, w = arr.shape[:2]
    out = np.empty((h, w, 3), np.uint8)
    lib.flow_to_bgr(arr.ctypes.data, w, h, ctypes.c_float(maxmotion),
                    out.ctypes.data)
    return out
