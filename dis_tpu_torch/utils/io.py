"""Image loading with the reference's grayscale semantics, and image
writing; counterpart of ``dis_tpu/utils/io.py`` (NumPy only).

``cv::imread(..., CV_LOAD_IMAGE_GRAYSCALE)`` (main.cpp:115-116) decodes
to BGR then converts with OpenCV's fixed-point BT.601 weights; every
decoder here applies the same conversion, so pixel values match the
reference bit for bit on 8-bit inputs.  Decoders, in order: the native
library (``utils/native.py``), PIL, imageio, and last the NumPy PNG
decoder of ``utils/kitti.py`` (8-bit gray, gray+alpha, RGB and RGBA).
The writer writes every PNG itself (``kitti.write_png``: Up-filtered rows
at zlib level 1), so a machine with neither PIL nor imageio still reads
and writes every frame of a sequence.
"""

from __future__ import annotations

import numpy as np


def rgb_to_gray_u8(rgb: np.ndarray) -> np.ndarray:
    """OpenCV-exact BT.601 fixed-point gray: ``(R*4899 + G*9617 +
    B*1868 + 2^13) >> 14`` (cv::cvtColor semantics used by grayscale
    imread)."""
    r = rgb[..., 0].astype(np.int64)
    g = rgb[..., 1].astype(np.int64)
    b = rgb[..., 2].astype(np.int64)
    return ((r * 4899 + g * 9617 + b * 1868 + (1 << 13)) >> 14).astype(np.uint8)


def _png_gray(path: str) -> np.ndarray:
    """The NumPy decoder: an 8-bit PNG to uint8 gray."""
    from .kitti import read_png

    arr = read_png(path, depth_wanted=8)
    if arr.shape[-1] <= 2:            # gray, gray + alpha
        return arr[..., 0].copy()
    return rgb_to_gray_u8(arr[..., :3])


def imread_gray(path: str) -> np.ndarray:
    """Load an image as uint8 grayscale with OpenCV-matching conversion."""
    png = path.lower().endswith(".png")
    if png:
        from . import native

        if native.available():
            with open(path, "rb") as f:
                out = native.png_decode_gray(f.read())
            if out is not None:
                return out
    try:
        from PIL import Image
    except ImportError:
        pass
    else:
        with Image.open(path) as img:
            if img.mode in ("L", "I;16"):
                arr = np.asarray(img.convert("L"))
                return arr.astype(np.uint8)
            arr = np.asarray(img.convert("RGB"))
            return rgb_to_gray_u8(arr)
    try:
        import imageio.v3 as iio
    except ImportError:
        if not png:
            raise
        return _png_gray(path)
    arr = iio.imread(path)
    if arr.ndim == 2:
        return arr.astype(np.uint8)
    return rgb_to_gray_u8(arr[..., :3])


def imwrite(path: str, img: np.ndarray) -> None:
    """Write a uint8 image (BGR [H,W,3] like the colorizer output, or
    grayscale) as a PNG: Up-filtered rows at zlib level 1, the default
    of OpenCV's PNG writer, which the reference writes its frames with
    (main.cpp:202)."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"imwrite writes PNG only, got {path!r}")
    from .kitti import write_png

    out = img
    if img.ndim == 3 and img.shape[-1] == 3:
        out = img[..., ::-1]  # BGR -> RGB
    write_png(path, np.asarray(out, np.uint8), filter_type=2, level=1)
