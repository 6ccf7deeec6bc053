"""The port's sequence runner (``dis_tpu_torch.runner``, ``device="cpu"``):
the resume-after-kill and fresh-run cases of ``tests/test_runner.py``,
the fresh run's flows against ``dis_tpu.runner``'s on the same frames
(the gates of ``tests/test_torch_dis.py``), and a checkpoint written by
``dis_tpu``'s ``SequenceCheckpoint`` resuming in the port."""

import dataclasses
import os

import numpy as np
import pytest

from dis_tpu.config import DISConfig as JConfig
from dis_tpu.runner import run_sequence as jrun_sequence
from dis_tpu.utils.checkpoint import SequenceCheckpoint as JCheckpoint
from dis_tpu_torch import interop
from dis_tpu_torch.runner import run_sequence
from dis_tpu_torch.utils.flo import load_flo

from torch_threads import one_thread


@pytest.fixture
def seq_dir(tmp_path):
    from PIL import Image
    from scipy.signal import convolve2d

    d = tmp_path / "seq"
    d.mkdir()
    r = np.random.default_rng(1)
    big = (r.random((64, 96)) * 255).astype(np.float32)
    k = np.ones((5, 5), np.float32) / 25
    big = convolve2d(big, k, "same", "symm")
    for t in range(5):
        fr = np.roll(big, shift=-t, axis=1)[:48, :64]
        Image.fromarray(np.clip(fr, 0, 255).astype(np.uint8)).save(
            str(d / f"frame_{t+1:04d}.png"))
    return str(d)


JCFG = JConfig(iterations=8, coarsest_scale=2, patch_overlap=0.5, mode="fixed")
CFG = interop.config_from_dict(dataclasses.asdict(JCFG))


class Preempted(Exception):
    pass


def test_run_sequence_and_resume(seq_dir, tmp_path):
    out = str(tmp_path / "out")
    ck = str(tmp_path / "ck")

    def bomb(i, flow):
        if i >= 2:
            raise Preempted()

    with one_thread():
        with pytest.raises(Preempted):
            run_sequence(seq_dir, 1, 5, CFG, out_dir=out, ckpt_dir=ck, on_pair=bomb,
                         device="cpu")
        # pairs 1 and 2 completed and were checkpointed
        assert os.path.exists(os.path.join(out, "frame_0001.png"))
        assert os.path.exists(os.path.join(out, "frame_0002.png"))

        # Rejoin: only the remaining pairs run.
        summary = run_sequence(seq_dir, 1, 5, CFG, out_dir=out, ckpt_dir=ck, save_flo=True,
                               device="cpu")
        fresh = run_sequence(seq_dir, 1, 5, CFG, out_dir=str(tmp_path / "fresh"),
                             save_flo=True, device="cpu")
    assert summary["resumed_from"] == 3
    assert summary["pairs_done"] == 2  # pairs 3 and 4
    assert fresh["pairs_done"] == 4 and fresh["resumed_from"] == 1
    for t in (3, 4):
        np.testing.assert_array_equal(
            load_flo(os.path.join(out, f"frame_{t:04d}.flo")),
            load_flo(str(tmp_path / "fresh" / f"frame_{t:04d}.flo")))


def test_run_sequence_fresh(seq_dir, tmp_path):
    """Three pairs with ``.flo`` output and EPE against ``.flo`` GT; the
    flows and the EPE agree with ``dis_tpu``'s runner."""
    from dis_tpu.utils.flo import save_flo

    gt_dir = tmp_path / "gt"
    gt_dir.mkdir()
    for t in (1, 2, 3):
        save_flo(str(gt_dir / f"frame_{t:04d}.flo"),
                 np.broadcast_to(np.float32([1.0, 0.0]), (48, 64, 2)))
    out = str(tmp_path / "o2")
    with one_thread():
        s = run_sequence(seq_dir, 1, 4, CFG, out_dir=out, save_flo=True,
                         gt_dir=str(gt_dir), device="cpu")
    j = jrun_sequence(seq_dir, 1, 4, JCFG, out_dir=str(tmp_path / "j2"), save_flo=True,
                      gt_dir=str(gt_dir))
    assert s["pairs_done"] == j["pairs_done"] == 3
    assert os.path.exists(os.path.join(out, "frame_0003.flo"))
    assert sorted(s) == sorted(j)
    assert abs(s["avg_epe"] - j["avg_epe"]) <= 1e-3, (s["avg_epe"], j["avg_epe"])
    for t in (1, 2, 3):
        got = load_flo(os.path.join(out, f"frame_{t:04d}.flo"))
        ref = load_flo(str(tmp_path / "j2" / f"frame_{t:04d}.flo"))
        d = np.sqrt(((got - ref) ** 2).sum(-1))
        assert d.mean() <= 1e-3 and (d > 1e-2).mean() <= 0.01, (d.mean(), (d > 1e-2).mean())


def test_resume_from_jax_checkpoint(seq_dir, tmp_path):
    """A checkpoint ``dis_tpu`` wrote after pair 2 (same config) resumes
    the port at pair 3; one written under another config is ignored."""
    ck = str(tmp_path / "ck")
    JCheckpoint(ck, JCFG).save(2, np.zeros((48, 64, 2), np.float32))
    with one_thread():
        s = run_sequence(seq_dir, 1, 5, CFG, out_dir=str(tmp_path / "o"), ckpt_dir=ck,
                         device="cpu")
    assert (s["resumed_from"], s["pairs_done"]) == (3, 2)
    ck2 = str(tmp_path / "ck2")
    JCheckpoint(ck2, dataclasses.replace(JCFG, iterations=9)).save(2)
    with one_thread():
        s = run_sequence(seq_dir, 1, 3, CFG, out_dir=str(tmp_path / "o2"), ckpt_dir=ck2,
                         device="cpu")
    assert (s["resumed_from"], s["pairs_done"]) == (1, 2)


@pytest.mark.parametrize("entry", ["runner", "cli"])
def test_cuda_requires_native_io(seq_dir, tmp_path, monkeypatch, capsys, entry):
    """On a CUDA device a failed native I/O build stops the run with the
    build's reason; neither entry point goes on with the NumPy codecs."""
    import torch

    from dis_tpu_torch import cli
    from dis_tpu_torch.utils import native

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(native, "_load", lambda: (None, "g++ failed (faked)"))
    if entry == "runner":
        with pytest.raises(RuntimeError, match="native I/O library is unavailable"):
            run_sequence(seq_dir, 1, 3, CFG, out_dir=str(tmp_path / "o"), device="cuda")
    else:
        assert cli.main([seq_dir, "1", "3", "--out-dir", str(tmp_path / "o")]) == 1
        assert "g++ failed (faked)" in capsys.readouterr().err
