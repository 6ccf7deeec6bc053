"""KITTI optical-flow ground-truth codec (16-bit RGB PNG) and the
package's PNG layer; counterpart of ``dis_tpu/utils/kitti.py`` (NumPy
only), held equal by ``tests/test_torch_utils.py``.

KITTI 2012/2015 store flow GT as 3-channel uint16 PNGs (devkit
``flow_read.m`` / ``flow_write.m``):

    u = (ch0 - 2**15) / 64.0
    v = (ch1 - 2**15) / 64.0
    valid = ch2 > 0         (invalid pixels are written as all-zero)

so ``--gt-dir`` scores EPE on KITTI as well as on ``.flo`` (Sintel) GT.

The PNG layer is self-contained (zlib + paletteless, non-interlaced
truecolor or gray, 8 or 16 bits): no OpenCV/PIL dependency.
:func:`read_png` handles every scanline filter type (real KITTI files
are OpenCV-written with adaptive filters; its Paeth rows run a Python
loop over bytes, seconds for a 1080p frame, which is why the native
decoder comes first wherever it is built); :func:`write_png` emits rows
of one filter type, 0 (None) or 2 (Up, vectorized both ways).
``utils/io.py`` writes every 8-bit frame through it, and reads through
it where neither the native library nor PIL nor imageio is there.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}          # PNG color type -> channels
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa = abs(p - a)
    pb = abs(p - b)
    pc = abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    if pb <= pc:
        return b
    return c


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG scanline filtering.  ``raw`` is the decompressed stream
    ([h * (1 + stride)] bytes); returns [h, stride] uint8."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        row = raw[pos + 1:pos + 1 + stride].copy()
        pos += 1 + stride
        if ftype == 0:
            rec = row
        elif ftype == 1:   # Sub: recon[i] = row[i] + recon[i - bpp]
            rec = row
            # prefix dependency along each byte lane modulo bpp:
            # cumulative sum with uint8 wraparound == mod-256 arithmetic
            for lane in range(bpp):
                rec[lane::bpp] = np.cumsum(rec[lane::bpp],
                                           dtype=np.uint32).astype(np.uint8)
        elif ftype == 2:   # Up
            rec = (row.astype(np.uint16) + prev).astype(np.uint8)
        elif ftype == 3:   # Average
            rec = row
            left = np.zeros(bpp, np.uint16)
            for i in range(0, stride, bpp):
                seg = ((rec[i:i + bpp].astype(np.uint16)
                        + ((left + prev[i:i + bpp]) >> 1)) & 0xFF)
                rec[i:i + bpp] = seg.astype(np.uint8)
                left = seg
        elif ftype == 4:   # Paeth (sequential left dependency)
            rec = row.astype(np.int32)
            pr = prev.astype(np.int32)
            for i in range(stride):
                a = rec[i - bpp] if i >= bpp else 0
                b = pr[i]
                c = pr[i - bpp] if i >= bpp else 0
                rec[i] = (rec[i] + _paeth(a, b, c)) & 0xFF
            rec = rec.astype(np.uint8)
        else:
            raise ValueError(f"unsupported PNG filter type {ftype}")
        out[y] = rec
        prev = rec
    return out


def read_png(path: str, depth_wanted: Optional[int] = None) -> np.ndarray:
    """Decode a non-interlaced 8- or 16-bit gray, gray+alpha, RGB or RGBA
    PNG to [H, W, C], uint8 or uint16 by its bit depth.  With
    ``depth_wanted``, any other depth raises ValueError."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    width = height = depth = ctype = None
    idat = []
    while pos + 8 <= len(buf):
        length, tag = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            width, height, depth, ctype, comp, filt, ilace = struct.unpack(
                ">IIBBBBB", data)
            if ilace:
                raise ValueError(f"{path}: interlaced PNG unsupported")
            if comp or filt:
                raise ValueError(f"{path}: nonstandard compression/filter")
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if width is None:
        raise ValueError(f"{path}: missing IHDR")
    if not (0 < width and 0 < height and width * height <= 100_000_000):
        # untrusted header: bound dims before any dim-sized allocation
        raise ValueError(f"{path}: implausible PNG dims {width}x{height}")
    channels = _CHANNELS.get(ctype)
    if channels is None:
        raise ValueError(f"{path}: unsupported PNG color type {ctype}")
    if depth_wanted is not None and depth != depth_wanted:
        raise ValueError(f"{path}: expected {depth_wanted}-bit PNG, got {depth}-bit")
    if depth not in (8, 16):
        raise ValueError(f"{path}: unsupported PNG bit depth {depth}")
    bpp = channels * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (1 + stride):
        raise ValueError(f"{path}: PNG payload size mismatch")
    rows = _unfilter(raw, height, stride, bpp)
    if depth == 8:
        return rows.reshape(height, width, channels)
    # 16-bit PNG samples are big-endian
    return rows.reshape(height, width, channels, 2).astype(np.uint16)[
        ..., 0] * 256 + rows.reshape(height, width, channels, 2)[..., 1]


def write_png(path: str, img: np.ndarray, filter_type: int = 0,
              level: int = 6) -> None:
    """Write a uint8 or uint16 image [H, W] or [H, W, C] (C in 1..4: gray,
    gray+alpha, RGB, RGBA) as a PNG whose rows all take ``filter_type``
    0 (None) or 2 (Up), at zlib ``level``."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE or filter_type not in (0, 2):
        raise ValueError(f"write_png: {c} channels, filter {filter_type}")
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img, img.dtype.newbyteorder(">")).view(np.uint8)
    rows = rows.reshape(h, w * c * img.dtype.itemsize)
    if filter_type == 2:
        rows = rows.copy()
        rows[1:] -= rows[:-1].copy()    # uint8 wraparound == mod-256
    body = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(body.tobytes(), level)))
        f.write(chunk(b"IEND", b""))


def read_png16_rgb(path: str) -> np.ndarray:
    """Decode a 16-bit truecolor (or 16-bit gray) non-interlaced PNG to
    uint16 [H, W, C]."""
    return read_png(path, depth_wanted=16)


def write_png16_rgb(path: str, img: np.ndarray) -> None:
    """Write uint16 [H, W, 3] as a 16-bit truecolor PNG (filter 0)."""
    img = np.ascontiguousarray(img, np.uint16)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError("write_png16_rgb expects [H, W, 3]")
    write_png(path, img, filter_type=0)


def load_kitti_flow(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read KITTI flow GT: returns (flow [H, W, 2] float32,
    valid [H, W] bool).  Decoded natively where the library is built
    (the same values; real KITTI files take Paeth rows)."""
    from . import native

    got = native.kitti_flow_read(path) if native.available() else None
    if got is not None:
        return got
    img = read_png16_rgb(path)
    if img.shape[-1] != 3:
        raise ValueError(f"{path}: KITTI flow GT must have 3 channels")
    u = (img[..., 0].astype(np.float32) - 32768.0) / 64.0
    v = (img[..., 1].astype(np.float32) - 32768.0) / 64.0
    valid = img[..., 2] > 0
    flow = np.stack([u, v], axis=-1)
    flow[~valid] = 0.0
    return flow, valid


def save_kitti_flow(path: str, flow: np.ndarray,
                    valid: Optional[np.ndarray] = None) -> None:
    """Write flow [H, W, 2] (+ optional validity mask) in KITTI GT
    format.  Values are clamped to the format's representable range
    [-512, 511.984] px at 1/64 px quantization.

    Quantization rounds half UP (floor(q + 0.5)), following the Matlab
    devkit's flow_write rounding and the native writer.  The C++ devkit
    (io_flow.h FlowImage::write) instead TRUNCATES on its uint16 cast,
    so files it writes can differ by 1/64 px on exact-half values."""
    flow = np.asarray(flow, np.float32)
    h, w = flow.shape[:2]
    if valid is None:
        valid = np.ones((h, w), bool)
    q = np.clip(flow * 64.0 + 32768.0, 0.0, 65535.0)
    img = np.zeros((h, w, 3), np.uint16)
    # round half UP (devkit's uint16 cast convention; matches the
    # native writer's +0.5 truncation — q is non-negative here)
    img[..., 0] = np.floor(q[..., 0] + 0.5).astype(np.uint16)
    img[..., 1] = np.floor(q[..., 1] + 0.5).astype(np.uint16)
    img[..., 2] = valid.astype(np.uint16)
    img[~valid] = 0
    write_png16_rgb(path, img)


def load_gt_any(path_base: str) -> Tuple[Optional[np.ndarray],
                                         Optional[np.ndarray]]:
    """Load ground-truth flow for a frame from whichever dataset format
    exists: ``<base>.flo`` (Middlebury/Sintel) or ``<base>.png`` (KITTI
    16-bit).  Returns (flow, valid) or (None, None) when neither file
    is present.  ``.flo`` GT has no validity channel; Sintel-style
    sentinel values (|flow| > 1e9 / NaN) are masked invalid, matching
    the reference's is_flow_correct (color_coding.cpp:8-11)."""
    flo_path = path_base + ".flo"
    png_path = path_base + ".png"
    if os.path.exists(flo_path):
        from .flo import load_flo

        flow = load_flo(flo_path)
        valid = np.isfinite(flow).all(axis=-1) & (
            np.abs(flow) < 1e9).all(axis=-1)
        return flow, valid
    if os.path.exists(png_path):
        return load_kitti_flow(png_path)
    return None, None
