"""The block decomposition and index math of the region extraction
kernels K2/K2b and K2c (``dis_tpu_torch/csrc/extract_group.cuh``),
emulated in NumPy on the CPU.

A persistent block takes groups of up to ``PATCHES_PER_GROUP`` patches
of one grid column, a column's groups of one size (``group_layout``: its
share rounded up to 4 patches, the last group ragged); K2 without a
column length takes the pair's patches as one column, so a group may
straddle two columns.  Per group, one thread per patch
computes the bases, a min/max reduction gives the bounding box, whose
left edge is aligned down to 16 bytes, pitch up to 4 floats and rows cut
to the ``STAGE_FLOATS`` cap; the threads stage it slot by slot (16-byte
copies, or 4-byte ones where the plane rows are not 16-byte aligned),
walking (row, slot) by carries.  The group's
regions are one span: a ragged head and tail of at most 3 floats, and a
float4 body whose floats are found through the per-block table (entry q:
patch, row and col of floats 4q..4q+3 of a quad of four patches), each
thread walking (entry, quad) by carries; a float4 whose floats lie in one
staged window reads that window's tile offset once.  A window not wholly
in the staged rows is read from the plane ("device memory").

Every case is held bitwise to ``ops/iclk.py::extract_regions_plain`` and
to the JAX package's XLA extraction.  The constants come from the
wrapper, which passes the same ones to the launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_tpu.ops import iclk as jiclk
from dis_tpu_torch.ops.cuda import extract_kernel as ek
from dis_tpu_torch.ops.iclk import extract_regions_plain, region_size

T = ek.THREADS
G = ek.PATCHES_PER_GROUP


def table(rc):
    """[rc^2, 4] fields patch << 12 | row << 6 | col of float 4q + k."""
    rc2 = rc * rc
    e = 4 * np.arange(rc2)[:, None] + np.arange(4)
    t, rem = e // rc2, e % rc2
    return t << 12 | (rem // rc) << 6 | rem % rc


def ceil_coord(v):
    c = np.ceil(v.astype(np.float32) + np.float32(1e-5))
    return np.clip(c, -1e6, 1e6).astype(np.int64)


def emulate(img, pos0, ps, pad, row0, num_w, num_h):
    """The kernel on planes img [nb, th, tw] and pos0 [nb, n, 2]: returns
    (regions [nb, n, rc, rc], base_y, base_x, windows from the plane,
    16-byte copies, 4-byte copies, float4s of one staged window)."""
    nb, th, tw = img.shape
    n = pos0.shape[1]
    rc = region_size(ps)
    rc2 = rc * rc
    vec = tw % 4 == 0
    tab = table(rc)
    size = nb * n * rc2
    buf = np.full(-(-size // 4) * 4, np.nan, np.float32)
    flat, out4 = buf[:size], buf.reshape(-1, 4)   # views: float and float4 stores
    base_y = np.full(nb * n, -1, np.int64)
    base_x = np.full(nb * n, -1, np.int64)
    pos = pos0.reshape(-1, 2)
    outside = copies16 = copies4 = fast = 0
    per_col, size_ = ek.group_layout(num_h)
    tid = np.arange(T)
    patch_of = (tid & 31) * (T // 32) + (tid >> 5)   # lane * WARPS + warp
    assert sorted(patch_of) == list(range(T))
    for g in range(nb * num_w * per_col):
        pair, rem = divmod(g, num_w * per_col)
        col, k = divmod(rem, per_col)
        first = k * size_
        cnt = min(size_, num_h - first)
        assert 0 < cnt <= G
        p0 = (pair * num_w + col) * num_h + first
        plane = img[pair]
        # prepare: bases by the patch threads, the box by min/max.
        t = patch_of[patch_of < cnt]
        by = np.clip(ceil_coord(pos[p0 + t, 1]) + pad - row0 - ps - 2, 0, th - rc)
        bx = np.clip(ceil_coord(pos[p0 + t, 0]) + pad - ps - 2, 0, tw - rc)
        base_y[p0 + t], base_x[p0 + t] = by, bx
        y0 = int(by.min())
        xa = int(bx.min()) & ~3 if vec else int(bx.min())
        pitch = (int(bx.max()) + rc - xa + 3) & ~3 if vec else int(bx.max()) + rc - xa
        rows = min(int(by.max()) + rc - y0, ek.STAGE_FLOATS // pitch)
        rows = 0 if rows < rc else rows
        inside = by - y0 + rc <= rows
        sb = np.full(G, -1)
        gb = np.zeros(G, np.int64)
        sb[t] = np.where(inside, (by - y0) * pitch + bx - xa, -1)
        gb[t] = by * tw + bx
        outside += int((~inside).sum())
        # Stage: slot (r, c) of w a row, each thread from (tid / w, tid % w)
        # on by carries.
        tile = np.full(ek.STAGE_FLOATS, np.nan, np.float32)
        w = pitch >> 2 if vec else pitch
        total = rows * w
        r, c = tid // w, tid % w
        dr, dc = divmod(T, w)
        s = tid.copy()
        while (s < total).any():
            for i in np.nonzero(s < total)[0]:
                src = plane[y0 + r[i], xa:]
                dst = r[i] * pitch
                if vec:
                    assert xa + 4 * c[i] + 4 <= tw
                    tile[dst + 4 * c[i]:dst + 4 * c[i] + 4] = src[4 * c[i]:4 * c[i] + 4]
                    copies16 += 1
                else:
                    tile[dst + c[i]] = src[c[i]]
                    copies4 += 1
            s += T
            c += dc
            r += dr
            wrap = c >= w
            c[wrap] -= w
            r[wrap] += 1

        def value(t, rr, cc):
            t, rr, cc = np.broadcast_arrays(t, rr, cc)
            s_ = sb[t]
            from_plane = plane.reshape(-1)[np.where(s_ < 0, gb[t] + rr * tw + cc, 0)]
            from_tile = tile[np.where(s_ >= 0, s_ + rr * pitch + cc, 0)]
            return np.where(s_ >= 0, from_tile, from_plane)

        # write: the ragged head and tail, then the float4 body.
        f0, f1 = p0 * rc2, (p0 + cnt) * rc2
        m0, m1 = (f0 + 3) >> 2, f1 >> 2
        ragged = [f for f in range(f0, 4 * m0)] + [f for f in range(4 * m1, f1)]
        assert len(ragged) <= 6
        for f in ragged:
            lf = f - f0
            tt, e = divmod(lf, rc2)
            flat[f] = value(tt, e // rc, e % rc)
        m = m0 + tid
        q = m % rc2
        lq = 4 * (m // rc2) - p0
        dquad, dq = divmod(T, rc2)
        while (m < m1).any():
            live = m < m1
            fields = tab[q[live]]                                    # [live, 4]
            t_, r_, c_ = lq[live, None] + (fields >> 12), fields >> 6 & 63, fields & 63
            v = value(t_, r_, c_)
            one = (t_[:, 0] == t_[:, 3]) & (sb[t_[:, 0]] >= 0)   # one staged window
            w_ = sb[t_[one, :1]] + r_[one] * pitch + c_[one]
            assert np.array_equal(tile[w_], v[one])
            fast += int(one.sum())
            out4[m[live]] = v
            m += T
            q += dq
            lq += 4 * dquad
            wrap = q >= rc2
            q[wrap] -= rc2
            lq[wrap] += 4
    regions = flat.reshape(nb, n, rc, rc)
    return (regions, base_y.reshape(nb, n).astype(np.int32),
            base_x.reshape(nb, n).astype(np.int32), outside, copies16, copies4, fast)


def _grid(num_w, num_h, steps, off):
    xs = np.arange(num_w) * steps + off
    ys = np.arange(num_h) * steps + off
    cx, cy = np.meshgrid(xs, ys, indexing="ij")
    return np.stack([cx.ravel(), cy.ravel()], -1).astype(np.float32)


def _case(ps, nb, row0, seed, num_w=None, num_h=None, steps=None, bound=3.0, tw_extra=0):
    """Planes and start positions of an x-outer grid over a small frame,
    with init flows in [-bound, bound]."""
    r = np.random.default_rng(seed)
    steps = steps or max(1, ps // 2)
    num_w = num_w or 6
    num_h = num_h or 75             # two groups a column: 40 and a ragged 35
    h = num_h * steps + ps
    w = num_w * steps + ps + tw_extra
    th, tw = h + 2 * ps - row0, w + 2 * ps
    img = (r.random((nb, th, tw)) * 255).astype(np.float32)
    centers = _grid(num_w, num_h, steps, ps // 2)
    init = r.uniform(-bound, bound, (nb,) + centers.shape).astype(np.float32)
    return img, centers + init, num_w, num_h


def _check(img, pos0, ps, row0, num_w, num_h):
    got = emulate(img, pos0, ps, ps, row0, num_w, num_h)
    want = extract_regions_plain(torch.from_numpy(img), torch.from_numpy(pos0), ps, ps, row0)
    for g_, w_ in zip(got[:3], want):
        assert np.array_equal(g_, w_.numpy())
    for i in range(img.shape[0]):
        jw = jiclk.extract_regions(jnp.asarray(img[i]), jnp.asarray(pos0[i]), ps, ps, row0=row0)
        for g_, w_ in zip(got[:3], jw):
            assert np.array_equal(g_[i], np.asarray(w_))
    return got


@pytest.mark.parametrize("ps", [8, 10, 12, 16])
@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("row0", [0, 6])
def test_column_groups_bitwise(ps, nb, row0):
    """Groups follow the columns (75 patches: 40 and a ragged 35) at stride
    ps / 2, the plane rows 16-byte aligned.  At ps 8 and 10 every window
    lies in its staged box and all but a few float4s read one window; at
    ps 16 a group's box outgrows the stage and its last windows come from
    the plane."""
    img, pos0, num_w, num_h = _case(ps, nb, row0, seed=ps * 10 + nb + row0)
    if img.shape[-1] % 4:
        img = np.ascontiguousarray(np.pad(img, ((0, 0), (0, 0), (0, 4 - img.shape[-1] % 4))))
    _, _, _, outside, c16, c4, fast = _check(img, pos0, ps, row0, num_w, num_h)
    assert c16 > 0 and c4 == 0
    if ps <= 10:
        assert outside == 0 and fast > 0.99 * pos0.size * region_size(ps) ** 2 / 8
    if ps == 16:
        assert outside > 0


@pytest.mark.parametrize("ps", [8, 12])
@pytest.mark.parametrize("nb", [1, 2])
def test_straddling_groups_bitwise(ps, nb):
    """K2 without a column length: groups of the pair's patches straddle
    two columns, their boxes span the column's height and are staged in
    part; the rest comes from the plane."""
    img, pos0, num_w, num_h = _case(ps, nb, 0, seed=ps + nb, num_w=7, num_h=150, steps=3)
    assert num_h % G and (num_w * num_h) % G
    _, _, _, outside, _, _, _ = _check(img, pos0, ps, 0, 1, num_w * num_h)
    assert outside > 0


@pytest.mark.parametrize("ps", [8, 16])
def test_init_beyond_the_cap_bitwise(ps):
    """Init flows far past any margin: boxes wider than the stage are not
    staged at all, taller ones in part; both windows come from the plane."""
    img, pos0, num_w, num_h = _case(ps, 1, 0, seed=40 + ps, num_w=5, num_h=40, bound=60.0)
    img = np.ascontiguousarray(np.pad(img, ((0, 0), (60, 60), (60, 60 + (4 - img.shape[-1] % 4) % 4))))
    pos0 = pos0 + 60
    _, _, _, outside, _, _, _ = _check(img, pos0, ps, 0, num_w, num_h)
    assert outside > pos0.shape[1] // 2


@pytest.mark.parametrize("tw_extra", [1, 2, 3])
def test_unaligned_rows_take_4_byte_copies(tw_extra):
    """tw % 4 != 0: every staging copy is 4 bytes, the result the same."""
    img, pos0, num_w, num_h = _case(8, 2, 0, seed=70 + tw_extra, tw_extra=tw_extra)
    if img.shape[-1] % 4 == 0:
        img = np.ascontiguousarray(img[..., :-1])
    _, _, _, _, c16, c4, _ = _check(img, pos0, 8, 0, num_w, num_h)
    assert c16 == 0 and c4 > 0


def test_right_edge_stays_in_the_plane():
    """Windows clipped to the plane's right edge: with tw % 4 == 0 the
    aligned box never passes tw, so every copy is 16 bytes."""
    img, pos0, num_w, num_h = _case(8, 1, 0, seed=81, bound=0.0)
    img = np.ascontiguousarray(img[..., :(img.shape[-1] // 4) * 4])
    pos0 = pos0.copy()
    pos0[:, -num_h:, 0] += 20.0              # the last column past the edge
    got = _check(img, pos0, 8, 0, num_w, num_h)
    assert got[2].max() == img.shape[-1] - region_size(8)
    assert got[4] > 0 and got[5] == 0


@pytest.mark.parametrize("nb", [1, 2])
def test_single_patch(nb):
    """N = 1: one group of one patch, an unaligned span when nb = 2."""
    img, pos0, _, _ = _case(8, nb, 0, seed=90 + nb, num_w=1, num_h=1)
    _check(img, pos0, 8, 0, 1, 1)


@pytest.mark.parametrize("num_h", [1, 3, 4, 5, 31, 32, 33, 45, 75, 216, 432, 630])
def test_group_layout(num_h):
    """A column's groups: as many as ``PATCHES_PER_GROUP`` asks, of one
    size that is a multiple of 4 and at most the group, none empty (75
    patches, KITTI's finest column: 40 and 35; 1080p: 216 = 4 x 44 + 40;
    4K: 432 = 9 x 48)."""
    groups, size = ek.group_layout(num_h)
    assert groups == -(-num_h // G) and size % 4 == 0 and size <= G
    assert (groups - 1) * size < num_h <= groups * size


@pytest.mark.parametrize("ps", range(1, 31))
def test_table_fields(ps):
    """Entry q's fields are floats 4q..4q+3 of a quad, in 16 bits."""
    rc = region_size(ps)
    tab = table(rc)
    t, r, c = tab >> 12, tab >> 6 & 63, tab & 63
    assert np.array_equal(t * rc * rc + r * rc + c, 4 * np.arange(rc * rc)[:, None] + np.arange(4))
    assert tab.max() < 1 << 16 and (r < rc).all() and (c < rc).all() and t.max() == 3


def test_cap_arithmetic():
    """The fixed cap stages a whole 48-patch group at the 4K finest scale
    (ps 8, stride 5) with 16 px of flow spread in y and 8 in x, and leaves
    2 blocks of 256 threads on an SM at ps 8-16 (smaller groups at 3-7
    blocks an SM ran slower on the H100: PERF.md); the table fits 16 bits
    up to ps 30."""
    assert (T, G, ek.STAGES, ek.STAGE_FLOATS) == (256, 48, 2, 9216)
    assert ek.shared_bytes(8) == 2 * 9216 * 4 + 361 * 8 + 2 * (1 + 2 * 48 + 4 * 8) * 4
    assert all(ek.blocks_per_sm(ps) == ek.MIN_BLOCKS_PER_SM == 2 for ps in (8, 10, 12, 16))
    assert ek.shared_bytes(30) <= 232_448
    steps, rc = 5, region_size(8)      # the compat bench config's stride
    rows = (G - 1) * steps + rc + 16
    pitch = (3 + rc + 8 + 3) & ~3
    assert rows * pitch <= ek.STAGE_FLOATS
    assert region_size(30) <= ek.MAX_REGION < region_size(31)
    with pytest.raises(ValueError, match="patch_size"):
        ek.check_patch_size(31)
