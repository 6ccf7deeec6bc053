"""The port's saved serving artifact (``export_flow``, ``save_exported``,
``load_exported``) and its cost analysis, on the CPU (the serving CLI:
tests/test_torch_serving_cli.py).

A CPU artifact is the bucket's ``dis_flow`` traced by ``torch.export``
with the kernels' plain versions as ATen ops: reloaded, it is bitwise
the eager ``dis_flow`` (single and batched; a reduced refinement config
in tests/test_torch_serving_refine_export.py), it holds no ``dis_tpu_torch`` op, and it loads and runs in a
process that never imports the port.  Against ``dis_tpu.serving``'s
``jax.export`` artifact on JAX CPU it meets the ``dis_flow`` gates of
tests/test_torch_serving.py.  The CUDA artifact is checked on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import io
import json
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode, is_fake

import dis_tpu_torch
from dis_tpu import serving as jserving
from dis_tpu_torch import _build, cost, serving
from dis_tpu_torch.ops import grid as tgrid
from dis_tpu_torch.ops.grid import make_grid
from dis_tpu_torch.utils import checks

from conftest import synthetic_pair
from test_torch_serving import CFG, JCFG, _batch

H, W = 44, 60


def _eager(a, b, cfg=CFG):
    return dis_tpu_torch.dis_flow(torch.as_tensor(a), torch.as_tensor(b), cfg)


@pytest.fixture(scope="module")
def single():
    """(artifact bytes, the pair, eager flow made before the export) for
    the 44 x 60 bucket under ``CFG``."""
    i1, i2 = synthetic_pair(H, W)
    before = _eager(i1, i2)
    return serving.export_flow(CFG, H, W, device="cpu"), (i1, i2), before


@pytest.fixture(scope="module")
def loaded(single):
    """``load_exported`` of the single bucket's artifact: (run, program)."""
    return serving.load_exported(single[0])


def test_cpu_roundtrip_is_bitwise(single, loaded, tmp_path):
    data, (i1, i2), before = single
    run, program = loaded
    assert run.input_shape == (H, W) and run.device.type == "cpu"
    got = run(i1, i2)
    assert got.shape == (H, W, 2)
    assert torch.equal(got, _eager(i1, i2))
    assert torch.equal(got, before)
    assert cost.kernel_ops(program) == {"K3": 0, "K2": 0, "K2c": 0, "K1": 0}
    assert not any("dis_tpu_torch" in str(n.target) for n in program.graph.nodes)
    meta = serving.artifact_meta(data)
    assert meta["device"] == "cpu" and meta["kernels"] is None
    assert dis_tpu_torch.DISConfig(**meta["config"]) == CFG
    assert (meta["height"], meta["width"], meta["batch"]) == (H, W, None)


def test_cpu_roundtrip_batched_is_bitwise(tmp_path):
    a, b = _batch(H, W, (0, 1, 2))
    path = str(tmp_path / "flow_b3.pt2")
    serving.save_exported(path, CFG, H, W, batch=3, device="cpu")
    run, _ = serving.load_exported(path)
    got = run(a, b)
    assert got.shape == (3, H, W, 2)
    assert torch.equal(got, _eager(a, b))
    with pytest.raises(ValueError, match="compiled for"):
        run(a[:2], b[:2])


def test_cpu_artifact_runs_without_the_port(single, tmp_path):
    """The CPU artifact holds ATen ops only: a process that never imports
    dis_tpu_torch loads it with torch.export.load and gets the same bits."""
    data, (i1, i2), before = single
    (tmp_path / "flow.pt2").write_bytes(data)
    np.save(tmp_path / "i1.npy", i1)
    np.save(tmp_path / "i2.npy", i2)
    code = (
        "import sys, numpy as np, torch\n"
        "d = sys.argv[1]\n"
        "program = torch.export.load(d + '/flow.pt2')\n"
        "a, b = (torch.from_numpy(np.load(d + f'/i{k}.npy')) for k in (1, 2))\n"
        "np.save(d + '/flow.npy', program.module()(a, b).numpy())\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('dis_tpu_torch', 'dis_tpu'))\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = torch.from_numpy(np.load(tmp_path / "flow.npy"))
    assert torch.equal(got, before)


def test_reloaded_flow_matches_jax_export(single, loaded, tmp_path):
    """The port's reloaded flow against ``dis_tpu.serving``'s reloaded
    ``jax.export`` artifact (JAX CPU), under the gates of
    ``test_compiled_flow_matches_jax_aot``."""
    from dis_tpu_torch.utils.synth import masked_epe

    _, (i1, i2), _ = single
    path = str(tmp_path / "flow.jaxexp")
    jserving.save_exported(path, JCFG, H, W)
    jrun, _ = jserving.load_exported(path)
    ref = np.asarray(jrun(i1, i2))
    got = loaded[0](i1, i2).numpy()
    d = np.sqrt(((got - ref) ** 2).sum(-1))
    assert d.mean() <= 1e-3, d.mean()
    assert (d > 1e-2).mean() <= 0.01, (d > 1e-2).mean()
    gt = np.broadcast_to(np.float32([2.0, 1.0]), (H, W, 2))
    valid = np.ones((H, W), bool)
    de = masked_epe(got, gt, valid) - masked_epe(ref, gt, valid)
    assert abs(de) <= 1e-3, de


def test_plans_stay_real_after_export(single):
    """An export builds its plans eagerly: the plan cache holds no fake
    tensor and eager dis_flow at the bucket's shape keeps its bits.  A
    plan first asked for under fake tensors raises and is not cached."""
    _, (i1, i2), before = single
    assert not any(is_fake(t) for p in tgrid._PLANS.values() for t in p[1:])
    assert torch.equal(_eager(i1, i2), before)
    cpu = torch.device("cpu")
    n = len(tgrid._PLANS)
    with FakeTensorMode():
        with pytest.raises(RuntimeError, match="fake tensors"):
            tgrid.scale_plan(1000 + n, 24, 5, 8, cpu)
    assert len(tgrid._PLANS) == n
    plan = tgrid.scale_plan(1000 + n, 24, 5, 8, cpu)
    assert not is_fake(plan.centers) and len(tgrid._PLANS) == n + 1


def _retag(data: bytes, **changes) -> bytes:
    """The artifact with its stored description changed."""
    src = zipfile.ZipFile(io.BytesIO(data))
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as dst:
        for item in src.infolist():
            body = src.read(item)
            if item.filename.endswith("/extra/" + serving.META_FILE):
                body = json.dumps({**json.loads(body), **changes}).encode()
            dst.writestr(item, body)
    return out.getvalue()


def test_load_refusals(single, loaded):
    """A CUDA artifact whose kernel sources differ is refused, and so is
    one where there is no card; so are another device and a wrong shape."""
    data, (i1, i2), _ = single
    with pytest.raises(RuntimeError, match="export it again"):
        serving.load_exported(_retag(data, device="cuda:0",
                                     kernels="libdis_kernels_0000000000000000.so"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving.load_exported(_retag(data, device="cuda:0",
                                         kernels=_build.library_path().name))
    with pytest.raises(ValueError, match="not for"):
        serving.load_exported(data, device="cuda")
    with pytest.raises(ValueError, match="serving artifact"):
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w") as z:
            z.writestr("archive/data.pkl", b"")
        serving.load_exported(buf.getvalue())
    run, _ = loaded
    with pytest.raises(ValueError, match="compiled for"):
        run(i1[:-4], i2[:-4])
    assert run.memory_analysis() is None


def test_export_refusals(monkeypatch):
    with pytest.raises(ValueError, match="batch"):
        serving.export_flow(CFG, H, W, batch=0, device="cpu")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        serving.export_flow(CFG, H, W, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving.export_flow(CFG, H, W)
    monkeypatch.setenv("DIS_TPU_CHECK", "1")
    with pytest.raises(RuntimeError, match="DIS_TPU_CHECK"):
        checks.checked(lambda: serving.export_flow(CFG, H, W, device="cpu"))()


def _kernel_formulas(cfg, h, w):
    """The kernel launches of one CPU call at a bucket divisible by
    2**coarsest, by the package's formulas: K3 per image, K2 and K1 per
    scale (K1 for all its trips), coarsest scale first."""
    p, ps = cfg.img_padding, cfg.patch_size
    levels = cfg.coarsest_scale + 1
    k3 = [cost.pyramid_cost(1, h, w, p, levels)] * 2
    k2, k1 = [], []
    for s in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
        g = make_grid(w >> s, h >> s, cfg.steps)
        n = g.num_w * g.num_h
        k2.append(cost.extract_cost(1, (h >> s) + 2 * p, (w >> s) + 2 * p, n, ps))
        k1.append(cost.search_cost(1, n, ps, cfg.mode == "fixed", cfg.patch_normalization,
                                   n * (cfg.iterations + 1)))
    return {"K3": k3, "K2": k2, "K2c": [], "K1": k1}


def test_cost_analysis(loaded):
    """Positive, the same at every call and for every executable of the
    bucket (the loaded artifact's too), and the sum of its kernel entries,
    which are the package's formulas, and its glue."""
    cf = serving.aot_compile(CFG, H, W, device="cpu")
    c = cf.cost_analysis()
    assert c["flops"] > 0 and c["bytes accessed"] > 0 and c["glue"]["ops"] > 0
    assert cf.cost_analysis() == c
    assert loaded[0].cost_analysis() == c
    assert serving.aot_compile(CFG, H, W, device="cpu").cost_analysis() == c
    want = _kernel_formulas(CFG, H, W)
    got = {k: [(e["bytes accessed"], e["flops"]) for e in v] for k, v in c["kernels"].items()}
    assert got == want
    launches = [e for v in c["kernels"].values() for e in v]
    assert c["flops"] == c["glue"]["flops"] + sum(e["flops"] for e in launches)
    assert c["bytes accessed"] == (c["glue"]["bytes accessed"]
                                   + sum(e["bytes accessed"] for e in launches))
    batched = serving.aot_compile(CFG, H, W, batch=2, device="cpu").cost_analysis()
    assert [e["flops"] for e in batched["kernels"]["K1"]] == [
        2 * e["flops"] for e in c["kernels"]["K1"]]
    assert not any(is_fake(t) for p in tgrid._PLANS.values() for t in p[1:])


_X = torch.zeros(6, 8)
_IDX = torch.tensor([0, 2])


@pytest.mark.parametrize("func, args, want", [
    (torch.ops.aten.empty_like.default, (_X,), 0),
    (torch.ops.aten._unsafe_view.default, (_X, [48]), 0),
    (torch.ops.aten.zeros_like.default, (_X,), 192),
    (torch.ops.aten.add.Tensor, (_X, _X), 3 * 192),
    # two rows of eight gathered: 64 bytes read of the source, 16 of the
    # index, 64 written
    (torch.ops.aten.index_select.default, (_X, 0, _IDX), 64 + 16 + 64),
])
def test_glue_bytes(func, args, want):
    """A glue op's bytes: inputs read and outputs written, nothing for an
    allocation or a view, the output alone for a fill, at most the
    output's bytes of a gather's source."""
    assert cost.glue_bytes(func, args, {}, func(*args)) == want
