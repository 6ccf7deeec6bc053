"""The port's native I/O bindings of the .flo reader and the KITTI writer
(``dis_tpu_torch/utils/native.py``) against the port's NumPy codecs and
the JAX package's bindings of the same library source."""

import numpy as np
import pytest

from dis_tpu.utils import native as jnative
from dis_tpu_torch.utils import flo, kitti, native


@pytest.fixture(scope="module", autouse=True)
def require_native():
    if not native.available():
        pytest.skip(f"native_io library unavailable: {native._load()[1]}")


def _rand_flow(h, w, seed=0, scale=30.0):
    r = np.random.default_rng(seed)
    flow = ((r.random((h, w, 2)) - 0.5) * 2 * scale).astype(np.float32)
    valid = r.random((h, w)) > 0.15
    return flow, valid


def test_flo_roundtrip_native(tmp_path, rng):
    flow = (rng.random((11, 7, 2)) * 8 - 4).astype(np.float32)
    p = str(tmp_path / "n.flo")
    assert native.flo_write(p, flow)
    # cross-read with the NumPy codec and vice versa
    np.testing.assert_array_equal(flo.load_flo(p), flow)
    np.testing.assert_array_equal(native.flo_read(p), flow)
    p2 = str(tmp_path / "p.flo")
    flo.save_flo(p2, flow)
    np.testing.assert_array_equal(native.flo_read(p2), flow)
    if jnative.available():
        np.testing.assert_array_equal(native.flo_read(p2), jnative.flo_read(p2))


@pytest.mark.parametrize("channels", [1, 4])
def test_flo_read_channels(tmp_path, rng, channels):
    data = rng.random((5, 9, channels)).astype(np.float32)
    p = str(tmp_path / "c.flo")
    flo.save_flo(p, data)
    np.testing.assert_array_equal(native.flo_read(p, channels),
                                  flo.load_flo(p, channels))


@pytest.mark.parametrize("header", [b"XXXX" + bytes(8),
                                    b"PIEH" + np.array([1 << 20, 1 << 20], "<i4").tobytes(),
                                    b"PIEH" + np.array([-3, 4], "<i4").tobytes()])
def test_flo_read_refuses_bad_headers(tmp_path, header):
    p = tmp_path / "bad.flo"
    p.write_bytes(header)
    assert native.flo_read(str(p)) is None
    assert native.flo_read(str(tmp_path / "missing.flo")) is None


@pytest.mark.parametrize("with_valid", [True, False])
def test_native_writer_matches_python(tmp_path, with_valid):
    flow, valid = _rand_flow(19, 27, seed=5)
    if not with_valid:
        valid = np.ones_like(valid)
    p1 = str(tmp_path / "py.png")
    p2 = str(tmp_path / "native.png")
    kitti.save_kitti_flow(p1, flow, valid)
    assert native.kitti_flow_write(p2, flow, valid.astype(np.uint8) if with_valid else None)
    a, av = kitti.load_kitti_flow(p1)
    b, bv = kitti.load_kitti_flow(p2)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(av, bv)
    nf, nv = native.kitti_flow_read(p2)
    np.testing.assert_array_equal(nf, a)
    np.testing.assert_array_equal(nv, av)
    if jnative.available():
        p3 = str(tmp_path / "jax.png")
        assert jnative.kitti_flow_write(p3, flow, valid.astype(np.uint8) if with_valid else None)
        assert open(p3, "rb").read() == open(p2, "rb").read()


def test_kitti_writer_refuses_other_shapes(tmp_path):
    flow, valid = _rand_flow(6, 8)
    p = str(tmp_path / "k.png")
    with pytest.raises(ValueError, match=r"\[H, W, 2\]"):
        native.kitti_flow_write(p, flow[..., :1])
    with pytest.raises(ValueError, match="valid"):
        native.kitti_flow_write(p, flow, valid[:-1])
