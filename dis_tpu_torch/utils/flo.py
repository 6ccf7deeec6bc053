"""Middlebury .flo flow-file I/O (IO_flow.cpp:10-98); a copy of
``dis_tpu/utils/flo.py`` (NumPy only), held equal by
``tests/test_torch_utils.py``.

Format (http://vision.middlebury.edu/flow/code/flow-code/README.txt):
4-byte "PIEH" tag (== float 202021.25 little-endian), int32 width,
int32 height, then row-major float32 data.  Like the reference, 1-, 2-
and 4-channel payloads are supported (depth / optical flow / scene
flow, IO_flow.cpp:33-46).
"""

from __future__ import annotations

import struct

import numpy as np

TAG_FLOAT = 202021.25
TAG_BYTES = b"PIEH"


def save_flo(path: str, data: np.ndarray) -> None:
    """Write a [H, W] or [H, W, C] float array (C in {1, 2, 4})."""
    arr = np.asarray(data, dtype=np.float32)
    if arr.ndim == 3 and arr.shape[-1] in (1, 2, 4):
        from . import native

        if native.available() and native.flo_write(path, arr):
            return
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    if c not in (1, 2, 4):
        raise ValueError(f"unsupported channel count {c}")
    with open(path, "wb") as f:
        f.write(TAG_BYTES)
        f.write(struct.pack("<ii", w, h))
        f.write(arr.astype("<f4").tobytes(order="C"))


def load_flo(path: str, channels: int = 2) -> np.ndarray:
    """Read a .flo file; returns [H, W, channels] float32."""
    with open(path, "rb") as f:
        tag = f.read(4)
        if tag != TAG_BYTES:
            raise ValueError(f"{path}: bad .flo magic {tag!r}")
        w, h = struct.unpack("<ii", f.read(8))
        if not (0 < w < 100000 and 0 < h < 100000):
            raise ValueError(f"{path}: implausible dims {w}x{h}")
        payload = f.read(4 * w * h * channels)
        if len(payload) != 4 * w * h * channels:
            raise ValueError(f"{path}: file too short")
        extra = f.read(1)
        if extra:
            raise ValueError(f"{path}: file too long")
    return np.frombuffer(payload, dtype="<f4").reshape(h, w, channels).copy()
