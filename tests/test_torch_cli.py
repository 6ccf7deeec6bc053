"""The port's CLI (``dis_tpu_torch.cli``, ``--device cpu``) against the JAX
package's (``dis_tpu.cli``) on the same numpy-seeded 64x96 sequence of 4
frames, and ``dis_flow_padded(return_debug=True)`` against ``dis_tpu``'s.

Gates for the flows, as ``tests/test_torch_dis.py``: mean |delta| <= 1e-3
px, at most 1% of pixels over 1e-2 px, |delta EPE| <= 1e-3 px.  The
output files, the stdout lines (numbers aside) and the JSON records'
keys are the same; ``--batch`` is bitwise equal to serial; the config
flags make the configs ``dis_tpu``'s make.
"""

import dataclasses
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dis_tpu.cli as jcli
import dis_tpu.models.dis as jdis_mod
import dis_tpu_torch
import dis_tpu_torch.cli as tcli
import dis_tpu_torch.runner as trunner
from dis_tpu.config import DISConfig as JConfig
from dis_tpu.utils.flo import save_flo
from dis_tpu_torch import interop
from dis_tpu_torch.utils.flo import load_flo

from conftest import synthetic_pair
from torch_threads import one_thread

H, W, FRAMES = 64, 96, 4
SHIFT = (2.0, 1.0)          # px per frame (x, y)


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """``frames/frame_000{1..4}.png`` (8-bit gray; frame t+1 is frame t
    shifted by SHIFT) and ``gt/frame_000{1..3}.flo``; returns the root."""
    from PIL import Image
    from scipy.signal import convolve2d

    root = tmp_path_factory.mktemp("cli")
    (root / "frames").mkdir()
    (root / "gt").mkdir()
    r = np.random.default_rng(3)
    big = (r.random((96, 128)) * 255).astype(np.float32)
    k = np.ones((7, 7), np.float32) / 49
    big = convolve2d(convolve2d(big, k, "same", "symm"), k, "same", "symm")
    for t in range(FRAMES):
        fr = big[16 - t:16 - t + H, 16 - 2 * t:16 - 2 * t + W]
        Image.fromarray(np.clip(fr, 0, 255).astype(np.uint8)).save(
            root / "frames" / f"frame_{t + 1:04d}.png")
    gt = np.broadcast_to(np.float32(SHIFT), (H, W, 2))
    for t in range(1, FRAMES):
        save_flo(str(root / "gt" / f"frame_{t:04d}.flo"), gt)
    return root


def _run(main, root, out, extra, capsys, params=None):
    """Run a CLI ``main`` from ``root``; returns (rc, stdout lines, JSON
    records, stderr)."""
    log = root / f"{out}.jsonl"
    params = params or ["frames", "1", str(FRAMES), "16", "8", "2", "0", "0.3", "1", "0"]
    argv = params + ["--out-dir", str(root / out), "--save-flo", "--gt-dir",
                     str(root / "gt"), "--json-log", str(log)] + extra
    with pytest.MonkeyPatch.context() as m:
        m.chdir(root)
        with one_thread():
            rc = main(argv)
    cap = capsys.readouterr()
    recs = [json.loads(s) for s in log.read_text().splitlines()] if log.exists() else []
    return rc, cap.out.splitlines(), recs, cap.err


def _form(line):
    return re.sub(r"\d+\.\d+", "N", line)


@pytest.mark.parametrize("mode", ["compat", "fixed"])
def test_cli_matches_jax(seq, capsys, mode):
    extra = ["--mode", mode] + (["--no-early-exit"] if mode == "compat" else [])
    jrc, jout, jrecs, _ = _run(jcli.main, seq, f"jax_{mode}", extra, capsys)
    trc, tout, trecs, _ = _run(tcli.main, seq, f"port_{mode}", ["--device", "cpu"] + extra,
                               capsys)
    assert jrc == trc == 0
    assert [_form(s) for s in tout] == [_form(s) for s in jout]
    assert len(tout) == 2 * (FRAMES - 1) + 2
    assert [sorted(r) for r in trecs] == [sorted(r) for r in jrecs] == [
        ["epe", "frame", "seconds"]] * (FRAMES - 1)
    assert (sorted(p.name for p in (seq / f"port_{mode}").iterdir())
            == sorted(p.name for p in (seq / f"jax_{mode}").iterdir()))
    for t, (tr, jr) in enumerate(zip(trecs, jrecs), start=1):
        got = load_flo(str(seq / f"port_{mode}" / f"frame_{t:04d}.flo"))
        ref = load_flo(str(seq / f"jax_{mode}" / f"frame_{t:04d}.flo"))
        assert got.shape == ref.shape == (H, W, 2)
        d = np.sqrt(((got - ref) ** 2).sum(-1))
        assert d.mean() <= 1e-3, d.mean()
        assert (d > 1e-2).mean() <= 0.01, (d > 1e-2).mean()
        assert abs(tr["epe"] - jr["epe"]) <= 1e-3, (tr["epe"], jr["epe"])


@pytest.mark.parametrize("n", [1, 2, 4, 11])
def test_arity_rule(capsys, n):
    argv = ["x"] * n
    assert jcli.main(argv) == 2
    assert tcli.main(argv) == 2
    assert "0, 3 or 10" in capsys.readouterr().err


def test_batch_equals_serial(seq, capsys):
    """``--batch 2`` over 3 pairs (a tail chunk repeats the last pair) is
    bitwise equal to the serial run; ``dt`` is per pair."""
    assert _run(tcli.main, seq, "serial", ["--device", "cpu"], capsys)[0] == 0
    rc, out, recs, _ = _run(tcli.main, seq, "batch", ["--device", "cpu", "--batch", "2"],
                            capsys)
    assert rc == 0 and [r["frame"] for r in recs] == [1, 2, 3]
    assert recs[0]["seconds"] == recs[1]["seconds"]
    for t in range(1, FRAMES):
        np.testing.assert_array_equal(load_flo(str(seq / "batch" / f"frame_{t:04d}.flo")),
                                      load_flo(str(seq / "serial" / f"frame_{t:04d}.flo")))


FLAG_CASES = [
    ["--preset", "medium"],
    ["--preset", "fast", "--refine", "3"],
    ["--refine", "2", "--refine-planes", "intensity"],
    ["--refine", "2", "--refine-planes", "intensity", "--refine-alpha", "5"],
    ["--refine-planes", "q1"],
    ["--preset", "full", "--refine-alpha", "20"],
    ["--mode", "fixed", "--no-early-exit"],
]


@pytest.mark.parametrize("flags", FLAG_CASES, ids=lambda f: " ".join(f))
def test_config_flags_match(seq, capsys, monkeypatch, flags):
    """The config each CLI hands its pipeline, and the notes it prints,
    for the same flags (the pipelines replaced by recorders)."""
    seen = {}

    def jfake(a, b, cfg):
        seen["jax"] = cfg
        return jnp.zeros(a.shape + (2,), jnp.float32)

    def tfake(cfg, device, batch=None, eager=False):
        seen["port"] = cfg
        return lambda a, b: torch.zeros(tuple(np.shape(a)) + (2,))

    monkeypatch.setattr(jdis_mod, "dis_flow", jfake)
    monkeypatch.setattr(trunner, "flow_function", tfake)
    params = ["frames", "1", "2", "40", "8", "2", "0", "0.5", "1", "0"]
    _, _, _, jerr = _run(jcli.main, seq, "flags_j", flags, capsys, params)
    _, _, _, terr = _run(tcli.main, seq, "flags_t", ["--device", "cpu"] + flags, capsys,
                         params)
    assert dataclasses.asdict(seen["port"]) == dataclasses.asdict(seen["jax"])
    assert terr == jerr


def test_no_gpu_main_exits_nonzero(seq, capsys, monkeypatch):
    """Without a CUDA device and without ``--device cpu`` the CLI refuses:
    it never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(seq)
    assert tcli.main(["frames", "1", "2", "--out-dir", str(seq / "nogpu")]) == 1
    assert "--device cpu" in capsys.readouterr().err
    assert not (seq / "nogpu").exists()
    assert tcli.main(["frames", "1", "2", "--device", "tpu"]) == 2
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trunner.run_sequence(str(seq / "frames"), 1, 2, dis_tpu_torch.DIS_FAST,
                             out_dir=str(seq / "nogpu_runner"))


def test_draw_grid_and_profile(seq, capsys):
    """``draw_grid = 1`` writes an overlay per scale from the same run and
    its flows are bitwise those of the run without it; ``--profile-dir``
    writes a trace naming the stages, flows again unchanged."""
    params = ["frames", "1", "3", "16", "8", "2", "0", "0.3", "1"]
    assert _run(tcli.main, seq, "plain", ["--device", "cpu"], capsys, params + ["0"])[0] == 0
    assert _run(tcli.main, seq, "grid", ["--device", "cpu"], capsys, params + ["1"])[0] == 0
    assert _run(tcli.main, seq, "grid_b", ["--device", "cpu", "--batch", "2"], capsys,
                params + ["1"])[0] == 0
    assert _run(tcli.main, seq, "prof", ["--device", "cpu", "--profile-dir",
                                         str(seq / "trace")], capsys, params + ["0"])[0] == 0
    for out in ("grid", "grid_b"):
        names = {p.name for p in (seq / out).iterdir()}
        assert {f"frame_000{t}_grid_s{s}.png" for t in (1, 2) for s in (0, 1, 2)} <= names
    for t in (1, 2):
        want = load_flo(str(seq / "plain" / f"frame_{t:04d}.flo"))
        for out in ("grid", "grid_b", "prof"):
            np.testing.assert_array_equal(load_flo(str(seq / out / f"frame_{t:04d}.flo")), want)
    (trace_file,) = (seq / "trace").glob("*.json")
    names = {e.get("name") for e in json.loads(trace_file.read_text())["traceEvents"]}
    assert {"pyramid", "scale_2", "scale_1", "scale_0"} <= names


@pytest.mark.parametrize("mode", ["compat", "fixed"])
def test_return_debug_matches_jax(mode):
    """Per scale, coarsest first: the patch centers equal ``dis_tpu``'s
    bitwise; the level images agree to the pyramid's gate
    (``tests/test_torch_image.py``: XLA's CPU fusion moves an ulp) and are
    bitwise the port's own pyramid levels; ``u`` agrees to the search's
    (within 1e-3 px but for under 2% of the patches, whose freeze trip
    flipped) and is bitwise the port's own search."""
    from dis_tpu_torch.models.dis import dis_scale_window
    from dis_tpu_torch.ops.pyramid import construct_pyramid

    jcfg = JConfig(iterations=16, patch_size=8, coarsest_scale=2, finest_scale=0,
                   patch_overlap=0.3, mode=mode)
    tcfg = interop.config_from_dict(dataclasses.asdict(jcfg))
    i1, i2 = synthetic_pair(H, W)
    jflow, jdbg = jdis_mod.dis_flow_padded(jnp.asarray(i1), jnp.asarray(i2), jcfg,
                                           return_debug=True)
    a, b = torch.from_numpy(i1), torch.from_numpy(i2)
    with one_thread():
        tflow, tdbg = dis_tpu_torch.dis_flow_padded(a, b, tcfg, return_debug=True)
        assert torch.equal(tflow, dis_tpu_torch.dis_flow_padded(a, b, tcfg))
        p = tcfg.img_padding
        pyr1, pyr2 = (construct_pyramid(x, 2, p) for x in (a, b))
        flow = None
        assert [s for s, *_ in tdbg] == [s for s, *_ in jdbg] == [2, 1, 0]
        for (s, tc, tu, tl), (_, jc, ju, jl) in zip(tdbg, jdbg):
            np.testing.assert_array_equal(np.asarray(tc), np.asarray(jc))
            lv = pyr1[s]
            assert torch.equal(tl, lv.img[p:p + lv.height, p:p + lv.width])
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
            flow, _, res = dis_scale_window(pyr1[s], pyr2[s], flow, tcfg, s, 0, lv.height)
            assert torch.equal(tu, res.u)
            du = np.abs(tu.numpy() - np.asarray(ju)).max(-1)
            assert (du > 1e-3).mean() < 0.02, (s, (du > 1e-3).mean())
