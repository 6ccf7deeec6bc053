"""The port's serving path (``dis_tpu_torch.serving``) on CPU.

On an explicitly requested CPU device ``aot_compile`` gives the planned
eager ``dis_flow`` behind the bucket's shape guard, so it is bitwise the
port's ``dis_flow``, and a batch equals its singles bitwise.  Against
``dis_tpu.serving.aot_compile`` (JAX CPU) it is held to the ``dis_flow``
gates of tests/test_torch_dis.py.  The CUDA-graph form is checked on the
card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import dis_tpu_torch
import dis_tpu_torch.models.dis as tdis
from dis_tpu import serving as jserving
from dis_tpu.config import DISConfig as JConfig
from dis_tpu_torch import interop
from dis_tpu_torch.ops import grid as tgrid
from dis_tpu_torch.serving import CompiledFlow, aot_compile

from conftest import synthetic_pair
from torch_threads import one_thread

JCFG = JConfig(iterations=8, patch_size=8, coarsest_scale=2, finest_scale=0,
               patch_overlap=0.3, mode="compat", early_exit=False)
CFG = interop.config_from_dict(dataclasses.asdict(JCFG))


def _batch(h, w, seeds):
    pairs = [synthetic_pair(h, w, shift=(2.0, 1.0), seed=s) for s in seeds]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def test_compiled_flow_cpu_equals_dis_flow():
    i1, i2 = synthetic_pair(44, 60)
    cf = aot_compile(CFG, 44, 60, device="cpu")
    got = cf(i1, i2)
    want = dis_tpu_torch.dis_flow(torch.from_numpy(i1), torch.from_numpy(i2), CFG)
    assert got.shape == (44, 60, 2) and got.device.type == "cpu"
    assert torch.equal(got, want)


def test_compiled_flow_shape_guard():
    cf = aot_compile(CFG, 44, 60, device="cpu")
    i1, i2 = synthetic_pair(48, 64)
    with pytest.raises(ValueError, match="compiled for"):
        cf(i1, i2)
    cb = aot_compile(CFG, 44, 60, batch=2, device="cpu")
    a, b = _batch(44, 60, (0, 1))
    with pytest.raises(ValueError, match="compiled for"):
        cb(a[:1], b[:1])
    with pytest.raises(ValueError, match="compiled for"):
        cb(a[0], b[0])


def test_compiled_flow_batch_equals_singles():
    a, b = _batch(40, 56, (0, 1, 2))
    got = aot_compile(CFG, 40, 56, batch=3, device="cpu")(a, b)
    single = aot_compile(CFG, 40, 56, device="cpu")
    assert got.shape == (3, 40, 56, 2)
    for k in range(3):
        assert torch.equal(got[k], single(a[k], b[k])), k


def test_compiled_flow_matches_jax_aot():
    a, b = _batch(40, 56, (0, 1, 2))
    ref = np.asarray(jserving.aot_compile(JCFG, 40, 56, batch=3)(a, b))
    got = aot_compile(CFG, 40, 56, batch=3, device="cpu")(a, b).numpy()
    gt = np.broadcast_to(np.float32([2.0, 1.0]), (40, 56, 2))
    valid = np.ones((40, 56), bool)
    from dis_tpu_torch.utils.synth import masked_epe

    for k in range(3):
        d = np.sqrt(((got[k] - ref[k]) ** 2).sum(-1))
        assert d.mean() <= 1e-3, (k, d.mean())
        assert (d > 1e-2).mean() <= 0.01, (k, (d > 1e-2).mean())
        de = masked_epe(got[k], gt, valid) - masked_epe(ref[k], gt, valid)
        assert abs(de) <= 1e-3, (k, de)


def test_aot_compile_refusals():
    with pytest.raises(ValueError, match="CUDA or CPU"):
        aot_compile(CFG, 40, 56, device="meta")
    with pytest.raises(ValueError, match="batch"):
        aot_compile(CFG, 40, 56, batch=0, device="cpu")
    # A refinement preset is no longer refused: it builds and runs.
    med = aot_compile(dis_tpu_torch.DIS_MEDIUM, 40, 56, device="cpu")
    i1, i2 = synthetic_pair(40, 56)
    with one_thread():
        assert torch.equal(med(i1, i2), dis_tpu_torch.dis_flow(
            torch.from_numpy(i1), torch.from_numpy(i2), dis_tpu_torch.DIS_MEDIUM))
    if not torch.cuda.is_available():
        # A CUDA device either captures or raises: never a CPU fallback.
        with pytest.raises(RuntimeError, match="no CUDA device"):
            aot_compile(CFG, 40, 56)


def test_compiled_flow_holds_its_plans(monkeypatch):
    """The executable owns exactly the plans its flow reads, and they are
    the cached ones even after many other shapes have been planned."""
    cfg = dataclasses.replace(CFG, finest_scale=1)
    cf = aot_compile(cfg, 44, 60, batch=2, device="cpu")
    assert len(cf.plans) == cfg.coarsest_scale - cfg.finest_scale + 1
    for k in range(80):
        tgrid.scale_plan(16 + k, 16, cfg.steps, cfg.patch_size, torch.device("cpu"))
    used = []
    real = tdis.scale_plan
    monkeypatch.setattr(tdis, "scale_plan", lambda *a: used.append(real(*a)) or used[-1])
    cf(*_batch(44, 60, (0, 1)))
    assert len(used) == len(cf.plans)
    assert all(u is p for u, p in zip(used, cf.plans))


def test_compiled_flow_needs_aot_compile():
    """A CUDA executable is made only by capture: the graph fields are not
    constructor arguments, and one made by hand refuses to run eagerly."""
    with pytest.raises(TypeError):
        CompiledFlow(CFG, 40, 56, None, torch.device("cuda"), graph=None)
    cf = CompiledFlow(CFG, 40, 56, None, torch.device("cuda"))
    z = np.zeros((40, 56), np.float32)
    with pytest.raises(RuntimeError, match="no captured graph"):
        cf(z, z)
