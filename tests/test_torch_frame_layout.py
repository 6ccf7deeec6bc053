"""The thread layouts of kernels F2 and F3 (``csrc/frame_glue.cu``),
emulated on the CPU in NumPy float32 and held bitwise to their plain
versions (``ops/pyramid.py::intensity_levels_plain``,
``ops/image.py::frame_finish_plain``), every output written exactly once.

- F2: a block of four warps on a 16 x 128 tile of level 1, lane ``l`` on
  the input float4s at ``4l`` and ``128 + 4l`` of two rows for each of
  four level-1 rows; level 2 from a thread's own level-1 pixels, level 3
  across the lane pair ``l``, ``l ^ 1`` (even lanes columns 0-15, odd
  16-31), levels 4 and 5 from the tile's level 3 in shared memory; the
  vector path (rows of a multiple of 4 floats) and the scalar one, ragged
  tiles, a batch, levels 1 to 5.
- F3: the runs of ``2**finest`` output columns that share their taps,
  four a lane 32 apart, a warp a row; pairs stored at once where aligned;
  crops that start inside a run, odd and even left edges and widths.

The kernels themselves run on the card (``chip_smoke.py`` phase 1g,
``tests/test_torch_kernels_cuda.py``).
"""

import numpy as np
import pytest
import torch

from dis_tpu_torch.ops.image import frame_finish_plain
from dis_tpu_torch.ops.pyramid import intensity_levels_plain

F32 = np.float32
QUARTER = F32(0.25)
LANES = np.arange(32)


class _Out:
    """An output plane set that counts the stores to each element."""

    def __init__(self, shape):
        self.v = np.full(shape, np.nan, F32)
        self.n = np.zeros(shape, np.int64)

    def store(self, idx, vals, ok):
        idx = tuple(np.broadcast_to(i, ok.shape)[ok] for i in idx)
        self.v[idx] = np.broadcast_to(vals, ok.shape)[ok]
        np.add.at(self.n, idx, 1)


def _box(t, b):
    """The two level-1 pixels of a thread's float4 pair (rows first)."""
    return ((t[0] + b[0]) + (t[1] + b[1])) * QUARTER, ((t[2] + b[2]) + (t[3] + b[3])) * QUARTER


def _emulate_levels(src1, src2, levels, vec):
    nb, h0, w0 = src1.shape
    dims = [(h0 >> s, w0 >> s) for s in range(1, levels + 1)]
    outs = [_Out((2, nb) + d) for d in dims]
    (h1, w1) = dims[0]
    for z in range(2 * nb):
        img, zi = (src1 if z < nb else src2)[z % nb], (z // nb, z % nb)
        for by in range(-(-h1 // 16)):
            for bx in range(-(-w1 // 128)):
                t3 = np.zeros((4, 32), F32)
                for wy in range(4):
                    y1 = by * 16 + 4 * wy
                    v1 = np.zeros((4, 4, 32), F32)
                    for i in range(4):
                        row = y1 + i
                        for half in range(2):
                            c = bx * 256 + half * 128 + 4 * LANES

                            def load(r):
                                vals = np.zeros((4, 32), F32)
                                if row < h1:
                                    for k in range(4):
                                        ok = c < w0 if vec else c + k < w0
                                        vals[k, ok] = img[r, (c + k)[ok]]
                                return vals

                            v1[i, 2 * half], v1[i, 2 * half + 1] = _box(load(2 * row),
                                                                        load(2 * row + 1))
                            x = bx * 128 + half * 64 + 2 * LANES
                            for q in range(2):
                                ok = (x < w1 if vec else x + q < w1) & (row < h1)
                                outs[0].store((*zi, row, x + q), v1[i, 2 * half + q], ok)
                    if levels < 2:
                        continue
                    v2 = np.zeros((2, 2, 32), F32)
                    h2, w2 = dims[1]
                    for j in range(2):
                        for half in range(2):
                            v2[j, half] = ((v1[2 * j, 2 * half] + v1[2 * j + 1, 2 * half])
                                           + (v1[2 * j, 2 * half + 1]
                                              + v1[2 * j + 1, 2 * half + 1])) * QUARTER
                        y, x = by * 8 + 2 * wy + j, bx * 64 + LANES
                        outs[1].store((*zi, y, x), v2[j, 0], (y < h2) & (x < w2))
                        outs[1].store((*zi, y, x + 32), v2[j, 1], (y < h2) & (x + 32 < w2))
                    if levels < 3:
                        continue
                    h3, w3 = dims[2]
                    s0, s1 = v2[0, 0] + v2[1, 0], v2[0, 1] + v2[1, 1]
                    odd = (LANES & 1) == 1
                    v3 = np.where(odd, s1[LANES ^ 1] + s1, s0 + s0[LANES ^ 1]) * QUARTER
                    c3 = np.where(odd, 16 + (LANES >> 1), LANES >> 1)
                    y, x = by * 4 + wy, bx * 32 + c3
                    outs[2].store((*zi, y, x), v3, (y < h3) & (x < w3))
                    t3[wy, c3] = v3
                prev = t3
                for s, (rows, cols) in ((3, (2, 16)), (4, (1, 8))):
                    if levels <= s:
                        break
                    hs, ws = dims[s]
                    t = np.arange(rows * cols)
                    r, c = t // cols, t % cols
                    v = ((prev[2 * r, 2 * c] + prev[2 * r + 1, 2 * c])
                         + (prev[2 * r, 2 * c + 1] + prev[2 * r + 1, 2 * c + 1])) * QUARTER
                    y, x = by * (16 >> s) + r, bx * (128 >> s) + c
                    outs[s].store((*zi, y, x), v, (y < hs) & (x < ws))
                    prev = np.zeros((rows, cols), F32)
                    prev[r, c] = v
    return outs


@pytest.mark.parametrize("nb,h,w,levels", [(1, 64, 320, 5), (2, 32, 200, 3), (1, 16, 66, 1),
                                           (2, 8, 64, 3), (1, 48, 272, 4), (1, 32, 96, 2)])
def test_intensity_levels_layout_is_the_plain_version(nb, h, w, levels):
    rng = np.random.default_rng(h * w + levels)
    a, b = ((rng.random((nb, h, w)) * 255).astype(F32) for _ in range(2))
    outs = _emulate_levels(a, b, levels, vec=w % 4 == 0)
    l1, l2 = intensity_levels_plain(torch.from_numpy(a), torch.from_numpy(b), levels)
    for s, out in enumerate(outs, start=1):
        assert (out.n == 1).all(), f"level {s}: stores per element {np.unique(out.n)}"
        np.testing.assert_array_equal(out.v[0], l1[s].numpy())
        np.testing.assert_array_equal(out.v[1], l2[s].numpy())


def _emulate_finish(flow, finest, top, left, height, width):
    nb, fh, fw, _ = flow.shape
    f = 1 << finest
    scale, step = F32(f), F32(1.0 / f)
    out = _Out((nb, height, width, 2))
    j0 = (left + f // 2) // f
    runs = (left + width - 1 + f // 2) // f - j0 + 1
    for b in range(nb):
        for y in range(height):
            ys = (F32(y + top) + F32(0.5)) * step - F32(0.5)
            y0f = np.floor(ys)
            ay = F32(0.0) if int(y0f) < 0 else ys - y0f
            by_ = F32(1.0) - ay
            y0c, y1c = min(max(int(y0f), 0), fh - 1), min(max(int(y0f) + 1, 0), fh - 1)
            for bx in range(-(-runs // 128)):
                for i in range(4):
                    r = bx * 128 + 32 * i + LANES
                    r = r[r < runs]
                    j = j0 + r
                    x0c, x1c = np.clip(j - 1, 0, fw - 1), np.clip(j, 0, fw - 1)
                    a0, a1 = flow[b, y0c, x0c], flow[b, y0c, x1c]
                    c0, c1 = flow[b, y1c, x0c], flow[b, y1c, x1c]
                    for m in range(f):
                        X = f * j - f // 2 + m
                        xs = (X.astype(F32) + F32(0.5)) * step - F32(0.5)
                        x0f = np.floor(xs)
                        ax = np.where(x0f < 0, F32(0.0), xs - x0f)[:, None]
                        bx_ = F32(1.0) - ax
                        top_ = (a0 * scale) * bx_ + (a1 * scale) * ax
                        bot = (c0 * scale) * bx_ + (c1 * scale) * ax
                        x = X - left
                        ok = (x >= 0) & (x < width)
                        out.store((b, y, x[:, None], np.arange(2)), top_ * by_ + bot * ay,
                                  np.broadcast_to(ok[:, None], (len(x), 2)))
    return out


@pytest.mark.parametrize("nb,fh,fw,finest,top,left,height,width", [
    (2, 12, 40, 1, 1, 3, 21, 73), (1, 10, 24, 2, 3, 5, 30, 81), (1, 6, 9, 3, 2, 7, 40, 60),
    (2, 12, 40, 1, 0, 2, 24, 76), (1, 8, 16, 1, 0, 0, 16, 32)])
def test_frame_finish_layout_is_the_plain_version(nb, fh, fw, finest, top, left, height,
                                                  width):
    rng = np.random.default_rng(fh * fw + finest)
    flow = ((rng.random((nb, fh, fw, 2)) - 0.5) * 16).astype(F32)
    out = _emulate_finish(flow, finest, top, left, height, width)
    want = frame_finish_plain(torch.from_numpy(flow), finest, 2 * left, 2 * top, width,
                              height).numpy()
    assert (out.n == 1).all(), np.unique(out.n)
    np.testing.assert_array_equal(out.v, want)
