"""The port as a package: config and constant drift against dis_tpu, a
JAX-free import, CPU dispatch of the kernel wrappers, and its refusals."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import dis_tpu.config as jconfig
import dis_tpu_torch
import dis_tpu_torch.config as tconfig
from dis_tpu.models import dis as jdis
from dis_tpu_torch import _build, interop
from dis_tpu_torch.models import dis as tdis
from dis_tpu_torch.ops import iclk
from dis_tpu_torch.ops.cuda.extract_kernel import extract_regions
from dis_tpu_torch.ops.cuda.iclk_kernel import iclk_search
from dis_tpu_torch.ops.cuda.pyramid_kernel import pyramid_level, pyramid_levels
from dis_tpu_torch.ops.grid import make_grid

from conftest import synthetic_pair
from torch_threads import one_thread

WRAPPERS = (pyramid_levels, extract_regions, iclk_search)


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_config_copy_has_not_drifted(name):
    """The port's copy of DISConfig (dis_tpu/__init__ imports JAX, so the
    port cannot import it) must stay equal to the JAX package's."""
    j, t = jconfig.PRESETS[name], tconfig.PRESETS[name]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("steps", "outlier_thresh", "img_padding", "num_points_patch",
                 "num_scales"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert interop.config_from_dict(dataclasses.asdict(j)) == t
    for scale in range(t.coarsest_scale + 1):
        assert tdis.motion_bound(t, scale) == jdis.motion_bound(j, scale)


def test_config_fields_and_validation_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.DISConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.DISConfig)]
    assert tf == jf
    for bad in ({"mode": "x"}, {"patch_size": 7}, {"finest_scale": 4},
                {"kernel": "cuda"}, {"refinement_planes": "rgb"}):
        with pytest.raises(ValueError):
            jconfig.DISConfig(**bad)
        with pytest.raises(ValueError):
            tconfig.DISConfig(**bad)


def test_import_is_jax_free():
    code = ("import sys, dis_tpu_torch, dis_tpu_torch.interop; "
            "import dis_tpu_torch.ops.cuda.iclk_kernel, dis_tpu_torch.ops.cuda.extract_kernel, "
            "dis_tpu_torch.ops.cuda.extract_banded_kernel, dis_tpu_torch.parallel.tiles, "
            "dis_tpu_torch.ops.cuda.pyramid_kernel, dis_tpu_torch.serving, "
            "dis_tpu_torch.parallel, dis_tpu_torch.utils, dis_tpu_torch.ops.variational, "
            "dis_tpu_torch.cli, dis_tpu_torch.runner, dis_tpu_torch.__main__, "
            "dis_tpu_torch.utils.flo, dis_tpu_torch.utils.native, dis_tpu_torch.utils.io, "
            "dis_tpu_torch.utils.color, dis_tpu_torch.utils.kitti, dis_tpu_torch.utils.metrics, "
            "dis_tpu_torch.utils.overlay, dis_tpu_torch.utils.checkpoint, "
            "dis_tpu_torch.utils.profiling, dis_tpu_torch.utils.checks, dis_tpu_torch.cost, "
            "dis_tpu_torch.parallel.mesh, dis_tpu_torch.parallel.distributed, "
            "dis_tpu_torch.parallel.sequence, dis_tpu_torch.parallel.launch, "
            "dis_tpu_torch.utils.synth, dis_tpu_torch.dryrun; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dis_tpu')); print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_parallel_names_have_counterparts():
    """Every public name of ``dis_tpu.parallel`` exists in the port's
    ``parallel``, and those of ``__graft_entry__.py`` in ``dryrun``."""
    import dis_tpu.parallel as jparallel
    import dis_tpu_torch.parallel as tparallel
    from dis_tpu_torch import dryrun

    assert set(jparallel.__all__) <= set(tparallel.__all__)
    for name in tparallel.__all__:
        assert callable(getattr(tparallel, name)), name
    assert callable(dryrun.entry) and callable(dryrun.dryrun_multichip)


def test_wrappers_take_plain_path_on_cpu():
    for w in WRAPPERS:
        w.launches = 0
    i1, i2 = synthetic_pair(32, 48)
    cfg = dis_tpu_torch.DISConfig(iterations=4, coarsest_scale=1, patch_overlap=0.3,
                                  mode="fixed")
    flow = dis_tpu_torch.dis_flow(torch.from_numpy(i1), torch.from_numpy(i2), cfg)
    assert flow.shape == (32, 48, 2) and flow.device.type == "cpu"
    assert [w.launches for w in WRAPPERS] == [0, 0, 0]


def test_wrappers_refuse_non_cuda_non_cpu_tensors():
    """Off the CPU the wrappers launch their kernel or raise: a tensor on
    another device is refused before any build or launch."""
    meta = torch.empty((40, 56), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pyramid_level(meta, 8, base=True)
    with pytest.raises(ValueError, match="CUDA"):
        extract_regions(meta, torch.zeros((3, 2), device="meta"), 8, 8)
    n, ps = 4, 8
    cfg = dis_tpu_torch.DISConfig(patch_size=ps)
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device="meta")
    tpl = iclk.PatchTemplates(z(n, 64), z(n, 64), z(n, 64), z(n, 2, 2))
    with pytest.raises(ValueError, match="CUDA"):
        iclk_search(z(n, 19, 19), z(n, dt=torch.int32), z(n, dt=torch.int32), tpl,
                    None, z(n, 2), z(n, 2), z(n, dt=torch.bool), cfg, 40, 30)
    assert [w.launches for w in WRAPPERS] == [0, 0, 0]


def test_build_is_keyed_by_sources_and_needs_nvcc(monkeypatch):
    p = _build.library_path()
    assert p.parent == _build.BUILD_DIR and p == _build.library_path()
    assert {s.name for s in _build.CSRC_DIR.glob("*.cu")} == {
        "pyramid_level.cu", "extract_regions.cu", "extract_banded.cu", "iclk.cu"}
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", str(_build.PKG_DIR / "no-such-toolkit"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_refinement_configs_raise():
    """``DIS_MEDIUM`` and ``DIS_FULL`` no longer raise: ``dis_flow`` runs
    them through the refinement (an odd size, so padding and crop run)."""
    i1, i2 = synthetic_pair(45, 61)
    for cfg in (dis_tpu_torch.DIS_MEDIUM, dis_tpu_torch.DIS_FULL):
        with one_thread():
            flow = dis_tpu_torch.dis_flow(torch.from_numpy(i1), torch.from_numpy(i2), cfg)
        assert flow.shape == (45, 61, 2) and bool(torch.isfinite(flow).all())


def test_refinement_epsilons_have_not_drifted():
    """The port's copies of the Charbonnier epsilons equal the JAX
    package's."""
    from dis_tpu.ops import variational as jvar
    from dis_tpu_torch.ops import variational as tvar

    assert (tvar._EPS2_DATA, tvar._EPS2_SMOOTH) == (jvar._EPS2_DATA, jvar._EPS2_SMOOTH)
    assert (tvar._EPS2_DATA, tvar._EPS2_SMOOTH) == (1e-2, 1e-6)


def test_pair_checks():
    x = torch.zeros((32, 32))
    with pytest.raises(ValueError, match="device"):
        dis_tpu_torch.dis_flow(x, torch.zeros((32, 32), device="meta"))
    with pytest.raises(TypeError):
        dis_tpu_torch.dis_flow(np.zeros((32, 32), np.float32), x)
    with pytest.raises(ValueError, match="shapes differ"):
        dis_tpu_torch.dis_flow(x, torch.zeros((32, 40)))


def test_search_accepts_zero_patches():
    img = torch.zeros((40, 56))
    geom = make_grid(40, 24, 5)
    cfg = dis_tpu_torch.DISConfig(patch_size=8, iterations=3)
    e = torch.zeros((0, 2))
    tpl = iclk.PatchTemplates(torch.zeros((0, 64)), torch.zeros((0, 64)),
                              torch.zeros((0, 64)), torch.zeros((0, 2, 2)))
    res = iclk.inverse_search(img, tpl, e, e, cfg, geom.num_w, geom.num_h)
    assert res.u.shape == (0, 2) and res.Q.shape == (0, 64)
