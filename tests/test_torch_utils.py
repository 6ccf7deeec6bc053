"""The port's host utilities (``dis_tpu_torch/utils``) against their
originals in ``dis_tpu/utils``: the NumPy copies (flo, color, kitti,
overlay, metrics, checkpoint) give equal bytes or arrays on the same
numpy-seeded inputs; ``io`` decodes PNGs as ``dis_tpu`` does through
every decoder it has, and writes every PNG itself, with or without PIL
and imageio; the native library builds into ``dis_tpu_torch/_build/``; the profiling hooks."""

import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dis_tpu.config as jconfig
import dis_tpu_torch.config as tconfig
from dis_tpu.utils import checkpoint as jckpt
from dis_tpu.utils import color as jcolor
from dis_tpu.utils import flo as jflo
from dis_tpu.utils import io as jio
from dis_tpu.utils import kitti as jkitti
from dis_tpu.utils import metrics as jmetrics
from dis_tpu.utils import native as jnative
from dis_tpu.utils import overlay as joverlay
from dis_tpu_torch.utils import checkpoint as tckpt
from dis_tpu_torch.utils import color as tcolor
from dis_tpu_torch.utils import flo as tflo
from dis_tpu_torch.utils import io as tio
from dis_tpu_torch.utils import kitti as tkitti
from dis_tpu_torch.utils import metrics as tmetrics
from dis_tpu_torch.utils import native as tnative
from dis_tpu_torch.utils import overlay as toverlay
from dis_tpu_torch.utils import profiling


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _flow(h, w, seed, scale=6.0):
    r = np.random.default_rng(seed)
    return ((r.random((h, w, 2)) - 0.5) * 2 * scale).astype(np.float32)


def _no_native(monkeypatch):
    monkeypatch.setattr(tnative, "_load", lambda: (None, "disabled by the test"))
    monkeypatch.setattr(jnative, "available", lambda: False)


def _no_pil(monkeypatch):
    """Make ``import PIL`` and ``import imageio`` fail, as on a machine
    that has neither."""
    for mod in ("PIL", "PIL.Image", "imageio", "imageio.v3"):
        monkeypatch.setitem(sys.modules, mod, None)


def test_native_builds_into_the_port(tmp_path):
    assert tnative.available(), tnative._load()[1]
    path = tnative.library_path()
    assert path.parent == tnative.BUILD_DIR and path.is_file()
    assert tnative.BUILD_DIR.parent.name == "dis_tpu_torch"
    tnative.require()


@pytest.mark.parametrize("shape", [(13, 17, 2), (5, 7, 1), (6, 9, 4), (8, 11)])
@pytest.mark.parametrize("native", [True, False])
def test_flo_bytes_equal(tmp_path, monkeypatch, shape, native):
    if not native:
        _no_native(monkeypatch)
    data = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    tflo.save_flo(str(tmp_path / "t.flo"), data)
    jflo.save_flo(str(tmp_path / "j.flo"), data)
    assert _read(tmp_path / "t.flo") == _read(tmp_path / "j.flo")
    ch = 1 if len(shape) == 2 else shape[-1]
    np.testing.assert_array_equal(tflo.load_flo(str(tmp_path / "t.flo"), ch),
                                  jflo.load_flo(str(tmp_path / "j.flo"), ch))
    with open(tmp_path / "bad.flo", "wb") as f:
        f.write(b"XXXX" + b"\0" * 16)
    with pytest.raises(ValueError):
        tflo.load_flo(str(tmp_path / "bad.flo"))


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("maxmotion", [-1.0, 4.0])
def test_color_image_equal(monkeypatch, native, maxmotion):
    if not native:
        _no_native(monkeypatch)
    flow = _flow(21, 34, 2)
    flow[0, 0] = (np.nan, 1.0)
    flow[1, 1] = (2e9, 0.0)
    got = tcolor.draw_optical_flow(flow, maxmotion)
    want = jcolor.draw_optical_flow(flow, maxmotion)
    assert got.dtype == np.uint8 and got.shape == (21, 34, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tcolor.make_color_wheel(), jcolor.make_color_wheel())


def test_kitti_codec_bytes_and_gt(tmp_path, monkeypatch):
    flow = _flow(19, 27, 3, scale=30.0)
    valid = np.random.default_rng(4).random((19, 27)) > 0.2
    tkitti.save_kitti_flow(str(tmp_path / "t.png"), flow, valid)
    jkitti.save_kitti_flow(str(tmp_path / "j.png"), flow, valid)
    assert _read(tmp_path / "t.png") == _read(tmp_path / "j.png")
    img = (np.random.default_rng(5).random((9, 14, 3)) * 65535).astype(np.uint16)
    tkitti.write_png16_rgb(str(tmp_path / "t16.png"), img)
    jkitti.write_png16_rgb(str(tmp_path / "j16.png"), img)
    assert _read(tmp_path / "t16.png") == _read(tmp_path / "j16.png")
    np.testing.assert_array_equal(tkitti.read_png16_rgb(str(tmp_path / "j16.png")), img)

    # load_gt_any on KITTI (native and NumPy decoders) and on .flo GT.
    gt_dir = tmp_path / "gt"
    gt_dir.mkdir()
    os.replace(tmp_path / "t.png", gt_dir / "frame_0001.png")
    sentinel = flow.copy()
    sentinel[2, 3] = (1e10, 0.0)
    jflo.save_flo(str(gt_dir / "frame_0002.flo"), sentinel)
    for use_native in (True, False):
        if not use_native:
            _no_native(monkeypatch)
        for base in ("frame_0001", "frame_0002", "frame_0003"):
            got = tkitti.load_gt_any(str(gt_dir / base))
            want = jkitti.load_gt_any(str(gt_dir / base))
            for g, w in zip(got, want):
                if w is None:
                    assert g is None
                else:
                    np.testing.assert_array_equal(g, w)


def test_png_reader_every_filter_type(tmp_path):
    """OpenCV writes adaptive scanline filters (Sub, Up, Average, Paeth):
    the NumPy reader decodes them as OpenCV does, at 8 and 16 bits."""
    cv2 = pytest.importorskip("cv2")
    r = np.random.default_rng(6)
    x = np.cumsum(r.integers(0, 9, size=(12, 40, 3)), axis=1)
    for dtype in (np.uint8, np.uint16):
        img = (x * (1 if dtype == np.uint8 else 257) % np.iinfo(dtype).max).astype(dtype)
        p = str(tmp_path / f"cv_{np.dtype(dtype).name}.png")
        assert cv2.imwrite(p, img)
        got = tkitti.read_png(p)
        np.testing.assert_array_equal(got[..., ::-1], img)   # cv2 writes BGR
    with pytest.raises(ValueError, match="16-bit"):
        tkitti.read_png16_rgb(str(tmp_path / "cv_uint8.png"))


def test_overlay_equal():
    r = np.random.default_rng(7)
    lvl = (r.random((24, 36)) * 300 - 20).astype(np.float32)
    centers = np.stack(np.meshgrid(np.arange(4, 36, 5), np.arange(4, 24, 5),
                                   indexing="ij"), -1).reshape(-1, 2).astype(np.float32)
    u = (r.random(centers.shape) * 8 - 4).astype(np.float32)
    for scale, max_patches in ((0, 4000), (1, 5)):
        got = toverlay.draw_grid_overlay(lvl, centers, u, scale, 8, max_patches)
        want = joverlay.draw_grid_overlay(lvl, centers, u, scale, 8, max_patches)
        np.testing.assert_array_equal(got, want)


def test_metrics_equal():
    flow, gt = _flow(16, 20, 8), _flow(16, 20, 9)
    gt[0, :4] = 1e10
    flow[3, 3] = np.nan
    valid = np.random.default_rng(10).random((16, 20)) > 0.3
    for v in (None, valid):
        assert tmetrics.epe(flow, gt, v) == jmetrics.epe(flow, gt, v)
        assert (tmetrics.bad_pixel_ratio(flow, gt, 1.0, valid=v)
                == jmetrics.bad_pixel_ratio(flow, gt, 1.0, valid=v))
    assert tmetrics.angular_error(flow, gt) == jmetrics.angular_error(flow, gt)
    assert np.isnan(tmetrics.epe(flow, gt, np.zeros_like(valid)))
    # epe_torch is the counterpart of epe_jax (the same masking).
    got = float(tmetrics.epe_torch(torch.from_numpy(flow), torch.from_numpy(gt)))
    want = float(jmetrics.epe_jax(jnp.asarray(flow), jnp.asarray(gt)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_checkpoint_fingerprint_equal(name, tmp_path):
    j, t = jconfig.PRESETS[name], tconfig.PRESETS[name]
    assert tckpt._fingerprint(t) == jckpt._fingerprint(j)
    flow = _flow(6, 8, 11)
    jckpt.SequenceCheckpoint(str(tmp_path), j).save(4, flow)
    idx, last = tckpt.SequenceCheckpoint(str(tmp_path), t).resume()
    assert idx == 5
    np.testing.assert_array_equal(last, flow)
    other = dataclasses.replace(t, iterations=t.iterations + 1)
    assert tckpt.SequenceCheckpoint(str(tmp_path), other).resume() == (0, None)


def _write_pngs(tmp_path, r):
    """Gray, RGB and RGBA 8-bit PNGs written by PIL: {name: path}."""
    from PIL import Image

    paths = {}
    for mode, shape in (("L", (21, 33)), ("RGB", (17, 25, 3)), ("RGBA", (9, 13, 4))):
        p = str(tmp_path / f"{mode}.png")
        Image.fromarray((r.random(shape) * 255).astype(np.uint8), mode=mode).save(p)
        paths[mode] = p
    return paths


@pytest.mark.parametrize("decoder", ["native", "pil", "numpy"])
def test_imread_gray_equal(tmp_path, monkeypatch, decoder):
    paths = _write_pngs(tmp_path, np.random.default_rng(12))
    want = {m: jio.imread_gray(p) for m, p in paths.items()}
    if decoder != "native":
        _no_native(monkeypatch)
    if decoder == "numpy":
        _no_pil(monkeypatch)
    for mode, p in paths.items():
        got = tio.imread_gray(p)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want[mode], err_msg=mode)


def test_imwrite_without_pil_round_trips(tmp_path, monkeypatch):
    from PIL import Image

    r = np.random.default_rng(13)
    gray = (r.random((23, 31)) * 255).astype(np.uint8)
    bgr = (r.random((19, 29, 3)) * 255).astype(np.uint8)
    with monkeypatch.context() as m:
        _no_pil(m)
        tio.imwrite(str(tmp_path / "g.png"), gray)
        tio.imwrite(str(tmp_path / "c.png"), bgr)
        _no_native(m)
        np.testing.assert_array_equal(tio.imread_gray(str(tmp_path / "g.png")), gray)
        rgb_gray = tio.imread_gray(str(tmp_path / "c.png"))
    # PIL decodes the files to the same arrays (the colour one as RGB).
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "g.png")), gray)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "c.png")), bgr[..., ::-1])
    np.testing.assert_array_equal(rgb_gray, jio.imread_gray(str(tmp_path / "c.png")))
    # With PIL installed, the port writes the same file, whose pixels are
    # what dis_tpu writes; it writes PNG only.
    tio.imwrite(str(tmp_path / "t.png"), bgr)
    jio.imwrite(str(tmp_path / "j.png"), bgr)
    assert _read(tmp_path / "t.png") == _read(tmp_path / "c.png")
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))
    with pytest.raises(ValueError, match="PNG only"):
        tio.imwrite(str(tmp_path / "t.jpg"), bgr)


def test_phase_timer_and_trace(tmp_path):
    import dis_tpu_torch

    timer = profiling.PhaseTimer(log_path=str(tmp_path / "phases.jsonl"), device="cpu")
    x = torch.rand(32, 48) * 255
    cfg = dis_tpu_torch.DISConfig(iterations=4, coarsest_scale=1, patch_overlap=0.3)
    with profiling.trace(str(tmp_path / "prof")):
        with timer.phase("flow", frame=1):
            dis_tpu_torch.dis_flow(x, x.roll(1, 1), cfg)
    with timer.phase("flow", frame=2):
        pass
    assert [r["frame"] for r in timer.records] == [1, 2]
    assert set(timer.summary()) == {"flow"}
    lines = (tmp_path / "phases.jsonl").read_text().splitlines()
    assert [json.loads(s)["phase"] for s in lines] == ["flow", "flow"]
    (trace_file,) = (tmp_path / "prof").glob("*.json")
    names = {e.get("name") for e in json.loads(trace_file.read_text())["traceEvents"]}
    assert {"pyramid", "scale_1", "scale_0"} <= names
