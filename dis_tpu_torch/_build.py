"""Builds the port's CUDA kernels and loads them with ``ctypes``.

``dis_tpu_torch/csrc/*.cu`` compile with plain ``nvcc`` into one shared
library with a C interface (no PyTorch headers, so a build takes
seconds).  The library lands in ``dis_tpu_torch/_build/`` under a name
keyed by a hash of the sources and flags, so the first use after a
change rebuilds and later uses load the cached file.  Nothing here runs
at import time: the wrappers call :func:`launch` only for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# -fmad=false: the kernels must not contract a*b + c into an FMA, because
# their plain PyTorch versions compute each product and sum separately
# (K3's Sobel magnitude is held to them bitwise, and K1's policing test
# makes discrete freeze decisions on such sums).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: argument types, the trailing stream included.
SIGNATURES = {
    "dis_pyramid_level": [_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "dis_extract_regions": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P],
    "dis_iclk_search": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                        _P, _P, _P, _P],
}


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``).  Raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file() and os.access(cand, os.X_OK):
        return str(cand)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the "
        "CUDA kernels of dis_tpu_torch are built from dis_tpu_torch/csrc "
        "at first use on a CUDA tensor")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdis_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the library unless the current one exists; returns its path.
    ``verbose`` also prints ``ptxas`` register and shared-memory use."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *(str(s) for s in _sources() if s.suffix == ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, out)   # atomic: concurrent builders never load a partial file
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dis_error_string.argtypes = [ctypes.c_int]
    lib.dis_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on ``device``'s current stream and raise
    if the launch reports an error."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err} "
                           f"({lib.dis_error_string(err).decode()})")
