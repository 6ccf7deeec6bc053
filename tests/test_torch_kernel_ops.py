"""The kernels as registered ops (``dis_tpu_torch/ops/cuda``) on the CPU.

Each of the five ops (``pyramid_levels``, ``extract_regions``,
``extract_regions_banded``, ``iclk_search`` and its plane mode
``iclk_search_plane``) passes ``torch.library.opcheck`` on CPU inputs at
small shapes: its schema, its fake function against its CPU function
(the kernel's plain version), and a trace.  The plane mode's wrapper
checks its inputs as the kernel needs them.  The wrappers take the
plain version inline for CPU tensors (so a CPU trace holds no
``dis_tpu_torch`` op), and route through the ops only within
``ops_on_cpu``, with the same bits.  The CUDA functions run
on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import dis_tpu_torch
from dis_tpu_torch.ops import cuda as kops
from dis_tpu_torch.ops import iclk
from dis_tpu_torch.ops.cuda import extract_banded_kernel as bk
from dis_tpu_torch.ops.cuda import extract_kernel as ek
from dis_tpu_torch.ops.cuda import iclk_kernel as ik
from dis_tpu_torch.ops.cuda import pyramid_kernel as pk
from dis_tpu_torch.ops.cuda import scale_kernel as sk
from dis_tpu_torch.ops.grid import make_grid

from conftest import synthetic_pair

OPS = {"pyramid_levels": pk.pyramid_levels_op, "extract_regions": ek.extract_regions_op,
       "extract_regions_banded": bk.extract_regions_banded_op,
       "iclk_search": ik.iclk_search_op, "iclk_search_plane": ik.iclk_search_plane_op}


def _rng_tensor(rng, *shape):
    return torch.from_numpy(rng.random(shape, dtype=np.float32))


def _search_args(fixed: bool, batch: int = 2):
    """K1's op arguments on a 40 x 24 level's grid: regions from a random
    plane, random templates, inits and start freezes."""
    rng = np.random.default_rng(3)
    geom = make_grid(40, 24, 5)
    n = geom.num_w * geom.num_h
    centers = torch.from_numpy(geom.centers)
    init_u = torch.from_numpy(rng.uniform(-2, 2, (batch, n, 2)).astype(np.float32))
    img = _rng_tensor(rng, batch, 40, 56) * 255
    regions = iclk.extract_regions_plain(img, centers + init_u, 8, 8)
    T, Tdx, Tdy = (_rng_tensor(rng, batch, n, 64) for _ in range(3))
    Hinv = _rng_tensor(rng, batch, n, 2, 2) * 1e-3
    conv0 = torch.from_numpy(rng.random((batch, n)) < 0.2)
    Tn = T - T.mean(-1, keepdim=True) if fixed else None
    return (*regions, T, Tdx, Tdy, Hinv, Tn, centers, init_u, conv0, 8, 3, 0, 40, 24,
            True, fixed, 0.01)


def _plane_args(fixed: bool, batch=2, plane=(40, 56), row0: int = 0, spread: float = 2.0):
    """K1's plane-mode op arguments on a 40 x 24 level's grid: a random
    plane (its first row global row ``row0``), starts up to ``spread`` px
    off the centers, random templates and start freezes."""
    rng = np.random.default_rng(4)
    geom = make_grid(40, 24, 5)
    n = geom.num_w * geom.num_h
    lead = () if batch is None else (batch,)
    centers = torch.from_numpy(geom.centers)
    init_u = torch.from_numpy(rng.uniform(-spread, spread, lead + (n, 2)).astype(np.float32))
    img = _rng_tensor(rng, *lead, *plane) * 255
    T, Tdx, Tdy = (_rng_tensor(rng, *lead, n, 64) for _ in range(3))
    Hinv = _rng_tensor(rng, *lead, n, 2, 2) * 1e-3
    conv0 = torch.from_numpy(rng.random(lead + (n,)) < 0.2)
    Tn = T - T.mean(-1, keepdim=True) if fixed else None
    return (img, centers + init_u, T, Tdx, Tdy, Hinv, Tn, centers, init_u, conv0, 8, 3, row0,
            40, 24, True, fixed, 0.01)


@pytest.mark.parametrize("base", [True, False])
def test_opcheck_pyramid_levels(base):
    rng = np.random.default_rng(0)
    src = _rng_tensor(rng, 32, 48) * 255 if base else _rng_tensor(rng, 2, 48, 64)
    torch.library.opcheck(pk.pyramid_levels_op, (src, 8, 2, base))


@pytest.mark.parametrize("batch", [None, 2])
def test_opcheck_extract_regions(batch):
    rng = np.random.default_rng(1)
    geom = make_grid(40, 24, 5)
    lead = () if batch is None else (batch,)
    img = _rng_tensor(rng, *lead, 40, 56)
    pos = torch.from_numpy(geom.centers).expand(*lead, -1, -1).contiguous() + 3.5
    torch.library.opcheck(ek.extract_regions_op, (img, pos, 8, 8, 0, geom.num_h))


@pytest.mark.parametrize("with_outside", [False, True])
def test_opcheck_extract_regions_banded(with_outside):
    rng = np.random.default_rng(2)
    geom = make_grid(40, 24, 5)
    img = _rng_tensor(rng, 40, 56)
    pos = torch.from_numpy(geom.centers) - 2.25
    outside = torch.zeros(1, dtype=torch.int32) if with_outside else None
    torch.library.opcheck(bk.extract_regions_banded_op,
                          (img, pos, 8, 8, 0, geom.num_w, geom.num_h, outside))


@pytest.mark.parametrize("fixed", [False, True], ids=["compat", "fixed"])
def test_opcheck_iclk_search(fixed):
    torch.library.opcheck(ik.iclk_search_op, _search_args(fixed))


@pytest.mark.parametrize("fixed", [False, True], ids=["compat", "fixed"])
def test_search_op_cpu_is_the_plain_version(fixed):
    """The op's CPU function is ``iclk_search_plain`` under the config its
    flat arguments name (padding ps, policing threshold ps / 2)."""
    args = _search_args(fixed)
    cfg = dis_tpu_torch.DISConfig(iterations=3, patch_size=8,
                                  mode="fixed" if fixed else "compat", conv_eps=0.01)
    want = iclk.iclk_search_plain(*args[:3], iclk.PatchTemplates(*args[3:7]), args[7],
                                  *args[8:11], cfg, 40, 24)
    got = torch.ops.dis_tpu_torch.iclk_search(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("fixed", [False, True], ids=["compat", "fixed"])
@pytest.mark.parametrize("batch", [None, 2])
def test_opcheck_iclk_search_plane(fixed, batch):
    torch.library.opcheck(ik.iclk_search_plane_op, _plane_args(fixed, batch))


@pytest.mark.parametrize("fixed", [False, True], ids=["compat", "fixed"])
@pytest.mark.parametrize("case", ["pairs", "row0", "edges", "small_plane"])
def test_search_plane_op_cpu_is_extraction_then_search(fixed, case):
    """The plane mode's CPU function is ``extract_regions_plain`` followed
    by ``iclk_search_plain``, and equals K1's op on K2's op's regions: on
    2 pairs, a stripe's plane (row0 > 0), starts past every edge of the
    plane (windows clipped to it), and a plane shorter and narrower than
    a region (K2's edge rule)."""
    kw = {"pairs": {}, "row0": {"row0": 6, "plane": (34, 56)},
          "edges": {"spread": 14.0}, "small_plane": {"plane": (17, 18)}}[case]
    args = _plane_args(fixed, **kw)
    img, pos0, row0 = args[0], args[1], args[12]
    cfg = dis_tpu_torch.DISConfig(iterations=3, patch_size=8,
                                  mode="fixed" if fixed else "compat", conv_eps=0.01)
    regions = iclk.extract_regions_plain(img, pos0, 8, 8, row0)
    want = iclk.iclk_search_plain(*regions, iclk.PatchTemplates(*args[2:6]), args[6],
                                  *args[7:10], cfg, 40, 24, row0)
    got = torch.ops.dis_tpu_torch.iclk_search_plane(*args)
    k2 = torch.ops.dis_tpu_torch.extract_regions(img, pos0, 8, 8, row0, pos0.shape[-2])
    k1 = torch.ops.dis_tpu_torch.iclk_search(*k2, *args[2:])
    for g, w, k in zip(got, want, k1):
        assert torch.equal(g, w) and torch.equal(g, k)
    inline = ik.iclk_search_plane(img, pos0, iclk.PatchTemplates(*args[2:6]), args[6],
                                  *args[7:10], cfg, 40, 24, row0)
    assert all(torch.equal(g, i) for g, i in zip(got, inline))


@pytest.mark.parametrize("bad", ["img_pairs", "img_dtype", "pos0_shape", "ps_24",
                                 "fixed_without_tn", "empty_plane"])
def test_search_plane_checks_its_inputs(bad):
    """The plane mode's wrapper refuses, before any launch, a plane
    without the pair axis of the inits, a plane not float32, starts of
    another shape, a patch size the kernel does not take, fixed mode
    without its residual template and an empty plane."""
    args = list(_plane_args(bad == "fixed_without_tn"))
    cfg = dis_tpu_torch.DISConfig(iterations=3, patch_size=8, conv_eps=0.01,
                                  mode="fixed" if bad == "fixed_without_tn" else "compat")
    if bad == "img_pairs":
        args[0] = args[0][0]
    elif bad == "img_dtype":
        args[0] = args[0].double()
    elif bad == "pos0_shape":
        args[1] = args[1][:, :-1]
    elif bad == "ps_24":
        cfg = dis_tpu_torch.DISConfig(iterations=3, patch_size=24)
    elif bad == "fixed_without_tn":
        args[6] = None
    else:
        args[0] = args[0][:, :0]
    with kops.ops_on_cpu(), pytest.raises((ValueError, TypeError)):
        ik.iclk_search_plane(args[0], args[1], iclk.PatchTemplates(*args[2:6]), args[6],
                             *args[7:10], cfg, 40, 24)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "dis_tpu_torch":
            name = func.name().split("::")[1].split(".")[0]
            self.calls[name] = self.calls.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def test_wrappers_route_cpu_tensors_inline_and_through_ops():
    """For CPU tensors every wrapper runs its plain version inline: a flow
    dispatches no kernel op.  Within ``ops_on_cpu`` the same flow calls
    each kernel as one op (K3 once per image, K1 in its plane mode, S1,
    S3 and S4 once per scale, S3 in fixed mode; S1 writes the search start
    too) with the same bits, and launches nothing."""
    cfg = dis_tpu_torch.DISConfig(iterations=4, patch_size=8, coarsest_scale=2,
                                  patch_overlap=0.3, mode="fixed")
    a, b = (torch.from_numpy(x) for x in synthetic_pair(40, 56))
    wrappers = (pk.pyramid_levels, ek.extract_regions, bk.extract_regions_banded,
                ik.iclk_search, ik.iclk_search_plane, sk.scale_templates, sk.fixed_weights,
                sk.densify)
    for w in wrappers:
        w.launches = 0
    with _CountOps() as inline:
        want = dis_tpu_torch.dis_flow(a, b, cfg)
    assert inline.calls == {}
    with _CountOps() as routed, kops.ops_on_cpu():
        got = dis_tpu_torch.dis_flow(a, b, cfg)
    assert routed.calls == {"pyramid_levels": 2, "iclk_search_plane": 3,
                            "scale_templates": 3, "fixed_weights": 3, "densify": 3}
    assert torch.equal(got, want)
    assert [w.launches for w in wrappers] == [0] * 8
    assert kops.all_on_cpu(a)         # the routing ends with its context


def test_dispatch_picks_the_op_or_its_cuda_function(monkeypatch):
    """An eager call on CUDA tensors goes straight to the op's CUDA
    function; an export, and a call on CPU tensors (within ``ops_on_cpu``),
    goes through the op.  A wrapper reaches its op through ``dispatch``."""
    def op(*a):
        return "op"

    def fn(*a):
        return "fn"

    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert kops.dispatch(op, fn, cuda) == "fn"
    assert kops.dispatch(op, fn, cpu) == "op"
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    assert kops.dispatch(op, fn, cuda) == "op"
    assert kops.dispatch(op, fn, cpu) == "op"
    src = torch.rand(16, 24)
    want = pk.pyramid_levels(src, 2, 2)
    with _CountOps() as routed, kops.ops_on_cpu():
        got = pk.pyramid_levels(src, 2, 2)
    assert routed.calls == {"pyramid_levels": 1}
    assert all(torch.equal(g, w) for lg, lw in zip(got, want) for g, w in zip(lg, lw))


SCHEMAS = {
    "pyramid_levels": "(Tensor src, SymInt p, SymInt levels, bool base) -> Tensor[]",
    "extract_regions": "(Tensor img2, Tensor pos0, SymInt ps, SymInt pad, SymInt row0, "
                       "SymInt num_h) -> (Tensor, Tensor, Tensor)",
    "extract_regions_banded": "(Tensor img2, Tensor pos0, SymInt ps, SymInt pad, SymInt "
                              "row0, SymInt num_w, SymInt num_h, Tensor(a7!)? outside) -> "
                              "(Tensor, Tensor, Tensor)",
    "iclk_search": "(Tensor regions, Tensor base_y, Tensor base_x, Tensor T, Tensor Tdx, "
                   "Tensor Tdy, Tensor Hinv, Tensor? Tn, Tensor centers, Tensor init_u, "
                   "Tensor conv0, SymInt ps, SymInt iterations, SymInt row0, SymInt width, "
                   "SymInt height, bool normalize, bool fixed, float conv_eps) -> "
                   "(Tensor, Tensor, Tensor)",
    "iclk_search_plane": "(Tensor img2, Tensor pos0, Tensor T, Tensor Tdx, Tensor Tdy, "
                         "Tensor Hinv, Tensor? Tn, Tensor centers, Tensor init_u, "
                         "Tensor conv0, SymInt ps, SymInt iterations, SymInt row0, "
                         "SymInt width, SymInt height, bool normalize, bool fixed, "
                         "float conv_eps) -> (Tensor, Tensor, Tensor)",
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_ops_are_registered_with_flat_schemas(name):
    """One op per C entry point, of tensors, ints, floats and bools; only
    K2c's optional window count is written in place."""
    assert str(OPS[name]._opoverload._schema) == f"dis_tpu_torch::{name}{SCHEMAS[name]}"


def test_export_records_one_op_node_per_launch():
    """A trace through the ops (the CUDA path's route, here on the CPU
    within ``ops_on_cpu``) records each launch as one op node, as a CUDA
    export does; the program, saved and reloaded, runs the ops' CPU
    functions with the eager bits."""
    import io

    from dis_tpu_torch.cost import kernel_ops
    from dis_tpu_torch.models.dis import flow_plans
    from dis_tpu_torch.serving import _Flow

    cfg = dis_tpu_torch.DISConfig(iterations=4, patch_size=8, coarsest_scale=2,
                                  patch_overlap=0.3, mode="compat", early_exit=False)
    a, b = (torch.from_numpy(x) for x in synthetic_pair(40, 56))
    flow_plans(cfg, 40, 56, a.device)
    with kops.ops_on_cpu():
        program = torch.export.export(_Flow(cfg), (torch.zeros(40, 56), torch.zeros(40, 56)))
    assert kernel_ops(program) == {"K3": 2, "K2": 0, "K2c": 0, "K1": 3, "S1": 3, "S4": 3}
    assert not any(n.target is torch.ops.aten.gather.default for n in program.graph.nodes)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    buf.seek(0)
    assert torch.equal(torch.export.load(buf).module()(a, b),
                       dis_tpu_torch.dis_flow(a, b, cfg))
