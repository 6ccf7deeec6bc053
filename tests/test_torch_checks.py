"""The port's ``DIS_TPU_CHECK`` guard layer (``dis_tpu_torch.utils.checks``)
in the cases of ``tests/test_checks.py``, each held against ``dis_tpu``'s
layer on the same numpy-seeded inputs: off by default, a clean run
passes (flows under the port's gates), a NaN input raises, the policing
invariant fires, the runner and the CLI wire the checks, and a batch."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

import dis_tpu_torch
from dis_tpu.config import DISConfig as JConfig
from dis_tpu.models import dis as jdis
from dis_tpu.ops import iclk as jiclk
from dis_tpu.utils import checks as jchecks
from dis_tpu_torch import interop
from dis_tpu_torch.ops import iclk as ticlk
from dis_tpu_torch.utils import checks

from conftest import synthetic_pair
from torch_threads import one_thread

JCFG = JConfig(iterations=6, coarsest_scale=2, patch_overlap=0.5, early_exit=False)
CFG = interop.config_from_dict(dataclasses.asdict(JCFG))


def _port_fn():
    return checks.checked(lambda a, b: dis_tpu_torch.dis_flow_padded(a, b, CFG))


@functools.lru_cache(maxsize=None)
def _jax_fn():
    """One checkified program for the tests that share its shape (one
    compile)."""
    return jchecks.checked(jax.jit(lambda a, b: jdis.dis_flow_padded(a, b, JCFG)))


def test_disabled_by_default(monkeypatch):
    monkeypatch.delenv("DIS_TPU_CHECK", raising=False)
    assert not checks.enabled() and not jchecks.enabled()
    checks.check(False, "never raised when disabled")
    jchecks.check(False, "never raised when disabled")
    # Off, a guard makes no tensor: not even an object torch cannot take
    # is looked at, inside checked() or out of it.
    assert checks.checked(lambda: checks.check(object(), "x") or 1)() == 1
    assert not checks.active()


def test_clean_run_passes_under_checks(monkeypatch):
    monkeypatch.setenv("DIS_TPU_CHECK", "1")
    i1, i2 = synthetic_pair(32, 40, shift=(1.0, 0.5), seed=51)
    ref = np.asarray(_jax_fn()(jnp.asarray(i1), jnp.asarray(i2)))
    a, b = torch.from_numpy(i1), torch.from_numpy(i2)
    with one_thread():
        flow = _port_fn()(a, b)
        monkeypatch.delenv("DIS_TPU_CHECK")
        assert torch.equal(flow, dis_tpu_torch.dis_flow_padded(a, b, CFG))
    got = flow.numpy()
    assert np.isfinite(got).all()
    d = np.sqrt(((got - ref) ** 2).sum(-1))
    assert d.mean() <= 1e-3 and (d > 1e-2).mean() <= 0.01


def test_nan_input_throws(monkeypatch):
    monkeypatch.setenv("DIS_TPU_CHECK", "1")
    i1, i2 = synthetic_pair(32, 40, shift=(1.0, 0.5), seed=52)
    i1 = i1.copy()
    i1[10, 10] = np.nan
    with pytest.raises(checkify.JaxRuntimeError):
        _jax_fn()(jnp.asarray(i1), jnp.asarray(i2))
    with one_thread(), pytest.raises(RuntimeError, match="non-finite"):
        _port_fn()(torch.from_numpy(i1), torch.from_numpy(i2))


def test_user_invariant_fires(monkeypatch):
    monkeypatch.setenv("DIS_TPU_CHECK", "1")

    def bad(x):
        checks.check((x > 0).all(), "expected all-positive, got min {m}", m=x.min())
        checks.check(True, "a true bool passes")
        return x * 2

    fn = checks.checked(bad)
    assert torch.equal(fn(torch.tensor([1.0, 2.0])), torch.tensor([2.0, 4.0]))
    with pytest.raises(RuntimeError, match="all-positive, got min -2.0"):
        fn(torch.tensor([1.0, -2.0]))


@pytest.mark.parametrize("moved", [0.0, 3.9, 4.5])
def test_policing_invariant_fires(monkeypatch, moved):
    """A patch that ends farther than ``outlier_thresh`` (4 px at ps 8)
    from its start, and not at its init, trips the Q9 guard in both
    packages; one at its init or within the threshold passes."""
    monkeypatch.setenv("DIS_TPU_CHECK", "1")
    r = np.random.default_rng(5)
    centers = (r.random((6, 2)) * 40).astype(np.float32)
    init_u = (r.random((6, 2)) * 2 - 1).astype(np.float32)
    u = init_u.copy()
    u[2, 0] += moved
    Q = np.zeros((6, 64), np.float32)
    start = centers + init_u
    fires = moved > JCFG.outlier_thresh

    jfn = jchecks.checked(lambda *a: jiclk._guard_result(*a, JCFG.outlier_thresh, JCFG))
    jargs = [jnp.asarray(x) for x in (u, Q, centers, init_u, start)]
    tfn = checks.checked(lambda *a: ticlk._guard_result(*a, CFG))
    targs = [torch.from_numpy(x) for x in (u, Q, centers, init_u, start)]
    if fires:
        with pytest.raises(checkify.JaxRuntimeError, match="policing"):
            jfn(*jargs)
        with pytest.raises(RuntimeError, match="policing"):
            tfn(*targs)
    else:
        jfn(*jargs)
        tfn(*targs)


def test_unwrapped_run_does_not_record(monkeypatch):
    """``DIS_TPU_CHECK=1`` without ``checked`` (a graph capture, a user's
    own call) leaves the guard sites silent."""
    monkeypatch.setenv("DIS_TPU_CHECK", "1")
    i1, i2 = synthetic_pair(32, 40, shift=(1.0, 0.5), seed=53)
    i1[3, 3] = np.nan
    with one_thread():
        flow = dis_tpu_torch.dis_flow_padded(torch.from_numpy(i1), torch.from_numpy(i2), CFG)
    assert flow.shape == (32, 40, 2)
    assert not checks.active()


def test_runner_wires_checks(monkeypatch, tmp_path):
    """``run_sequence`` runs checked under ``DIS_TPU_CHECK=1``: a NaN frame
    raises instead of silently flowing, in both packages."""
    from PIL import Image
    from dis_tpu.runner import run_sequence as jrun
    from dis_tpu.utils import io as jio
    from dis_tpu_torch.runner import run_sequence
    from dis_tpu_torch.utils import io as tio

    monkeypatch.setenv("DIS_TPU_CHECK", "1")
    seq = tmp_path / "seq"
    seq.mkdir()
    i1, i2 = synthetic_pair(32, 40, shift=(1.0, 0.5), seed=54)
    for t, fr in enumerate([i1, i2]):
        Image.fromarray(np.clip(fr, 0, 255).astype(np.uint8)).save(
            seq / f"frame_{t + 1:04d}.png")
    with one_thread():
        out = run_sequence(str(seq), 1, 2, CFG, out_dir=str(tmp_path / "o"), device="cpu")
    assert out["pairs_done"] == 1

    # PNG frames cannot hold NaN, so corrupt through the loader instead.
    def bad_read(orig):
        def read(path):
            img = orig(path).astype(np.float32)
            img[3, 3] = np.nan
            return img
        return read

    monkeypatch.setattr(tio, "imread_gray", bad_read(tio.imread_gray))
    monkeypatch.setattr(jio, "imread_gray", bad_read(jio.imread_gray))
    with pytest.raises(checkify.JaxRuntimeError):
        jrun(str(seq), 1, 2, JCFG, out_dir=str(tmp_path / "j2"))
    with one_thread(), pytest.raises(RuntimeError, match="non-finite"):
        run_sequence(str(seq), 1, 2, CFG, out_dir=str(tmp_path / "o2"), device="cpu")


def test_checked_batch(monkeypatch):
    """``checked`` covers a batch ``[B, H, W]`` (the JAX package needs
    ``checked_vmap``): a clean batch passes with each pair's bits alone;
    a NaN in one pair raises in both packages."""
    monkeypatch.setenv("DIS_TPU_CHECK", "1")
    i1, i2 = synthetic_pair(32, 40, shift=(1.0, 0.5), seed=55)
    a = np.stack([i1, i2])
    b = np.stack([i2, i1])
    fn = _port_fn()
    with one_thread():
        flows = fn(torch.from_numpy(a), torch.from_numpy(b))
        for k in range(2):
            assert torch.equal(flows[k], fn(torch.from_numpy(a[k]), torch.from_numpy(b[k])))
        bad = a.copy()
        bad[1, 3, 3] = np.nan
        with pytest.raises(RuntimeError):
            fn(torch.from_numpy(bad), torch.from_numpy(b))
    jfn = jchecks.checked_vmap(lambda x, y: jdis.dis_flow_padded(x, y, JCFG))
    with pytest.raises(checkify.JaxRuntimeError):
        jfn(jnp.asarray(bad), jnp.asarray(b))


def test_cli_under_checks(monkeypatch, tmp_path, capsys):
    """The CLI under ``DIS_TPU_CHECK=1`` (serial and ``--batch 2``) writes
    the flows of the unchecked run, bitwise."""
    from PIL import Image
    from dis_tpu_torch.cli import main
    from dis_tpu_torch.utils.flo import load_flo

    seq = tmp_path / "frames"
    seq.mkdir()
    i1, i2 = synthetic_pair(32, 40, shift=(1.0, 0.5), seed=56)
    i3, _ = synthetic_pair(32, 40, shift=(1.0, 0.5), seed=57)
    for t, fr in enumerate([i1, i2, i3]):
        Image.fromarray(np.clip(fr, 0, 255).astype(np.uint8)).save(
            seq / f"frame_{t + 1:04d}.png")
    params = ["frames", "1", "3", "6", "8", "2", "0", "0.5", "1", "0", "--device", "cpu",
              "--save-flo"]
    monkeypatch.chdir(tmp_path)
    with one_thread():
        assert main(params + ["--out-dir", "plain"]) == 0
        monkeypatch.setenv("DIS_TPU_CHECK", "1")
        assert main(params + ["--out-dir", "checked"]) == 0
        assert main(params + ["--out-dir", "checked_b", "--batch", "2"]) == 0
    capsys.readouterr()
    for t in (1, 2):
        want = load_flo(str(tmp_path / "plain" / f"frame_{t:04d}.flo"))
        for out in ("checked", "checked_b"):
            np.testing.assert_array_equal(
                load_flo(str(tmp_path / out / f"frame_{t:04d}.flo")), want)
