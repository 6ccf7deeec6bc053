"""Port parity: the multi-rank tiling engines of ``dis_tpu_torch.parallel``
(``torch.distributed``, gloo, on the CPU).

One world of 4 ranks (``parallel.launch.spawn``: a ``file://``
rendezvous, one intra-op thread a rank) runs every case of this file on
meshes of its first 2, 3 or 4 ranks; each rank returns its own rows and
the test stitches them.  Within the port every flow equals the
single-device ``dis_flow_padded`` bitwise: ``tiled_flow_fn`` at n = 2, 3
and 4 with the halo from neighbour shifts and from a gather, with and
without refinement, and ``grid_tiled_flow_fn`` with ragged windows and
per-level refinement.  Once each, ``tiled_flow_fn`` and the grid engine
(``tiled_flow_fn`` routes per-level refinement to it) are held to the JAX
package's multi-device functions on the virtual CPU mesh (conftest), at
the shapes of ``tests/test_parallel.py``'s tests, under the gates of
``tests/test_torch_tiles.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_tpu.config import DISConfig as JConfig
from dis_tpu.parallel import make_mesh as jmake_mesh
from dis_tpu.parallel import tiled_flow_fn as jtiled_flow_fn
from dis_tpu_torch import interop
from dis_tpu_torch.models import dis as tdis
from dis_tpu_torch.parallel import min_stripe_halo
from dis_tpu_torch.parallel.launch import spawn

import torch_ranks
from conftest import synthetic_pair
from test_torch_tiles import _gate
from torch_threads import one_thread

WORLD = 4
CFG = JConfig(iterations=6, coarsest_scale=2, patch_overlap=0.5, early_exit=False)
# tests/test_parallel.py::test_tiled_exact_large_motion
CFG_LARGE = JConfig(iterations=8, coarsest_scale=3, patch_overlap=0.5, early_exit=False)
CFG_REFINE = JConfig(iterations=6, coarsest_scale=2, patch_overlap=0.5, early_exit=False,
                     mode="fixed", refinement_iters=2)
CFG_LEVEL = JConfig(iterations=6, coarsest_scale=2, patch_overlap=0.5, early_exit=False,
                    mode="fixed", refinement_iters=1, refine_per_level=True,
                    refinement_inner_sweeps=3, refinement_sor_sweeps=2, refinement_omega=1.6)
# tests/test_parallel.py::test_grid_tiled_finest_scale_1_compat
CFG_F1 = JConfig(iterations=6, coarsest_scale=2, finest_scale=1, patch_overlap=0.5,
                 early_exit=False, refinement_iters=1, refine_per_level=True,
                 refinement_inner_sweeps=2, refinement_sor_sweeps=1)

# label: (engine, config, n, halo, (h, w), shift, seed); "gather" in a
# label means the halo outgrows a neighbour's block.
CASES = {
    "stripes2_large_motion": ("tiled", CFG_LARGE, 2, None, (256, 48), (3.0, 6.0), 7),
    "stripes2_halo96": ("tiled", CFG, 2, 96, (192, 48), (2.0, 1.0), 5),
    "stripes3": ("tiled", CFG, 3, None, (384, 48), (2.0, -1.0), 11),
    "stripes3_gather": ("tiled", CFG, 3, None, (96, 48), (1.0, 2.0), 12),
    "stripes4": ("tiled", CFG, 4, None, (512, 48), (2.0, 3.0), 13),
    "stripes4_gather": ("tiled", CFG, 4, None, (128, 48), (1.0, 1.0), 3),
    "stripes2_refine": ("tiled", CFG_REFINE, 2, None, (256, 48), (1.0, 0.5), 9),
    "stripes4_refine_gather": ("tiled", CFG_REFINE, 4, None, (128, 48), (1.0, 0.5), 9),
    "grid4_ragged": ("grid", CFG, 4, None, (72, 96), (2.0, 1.0), 3),
    "grid3_refine": ("grid", CFG_REFINE, 3, None, (96, 48), (1.0, 0.5), 4),
    "grid_routed4_per_level": ("tiled", CFG_LEVEL, 4, None, (128, 48), (1.0, 0.5), 9),
    "grid_routed4_finest1": ("tiled", CFG_F1, 4, None, (128, 48), (2.0, 0.0), 21),
}
HALO_FRAME = np.arange(WORLD * 6 * 5, dtype=np.float32).reshape(WORLD * 6, 5)


def _tcfg(jcfg):
    return interop.config_from_dict(dataclasses.asdict(jcfg))


def _pair(label):
    _, _, _, _, (h, w), shift, seed = CASES[label]
    return synthetic_pair(h, w, shift=shift, seed=seed)


@pytest.fixture(scope="module")
def world():
    cases = [(label, engine, _tcfg(cfg), n, halo) + _pair(label)
             for label, (engine, cfg, n, halo, *_rest) in CASES.items()]
    calls = [("halo", torch_ranks.halo_world, (HALO_FRAME, 3)),
             ("tiling", torch_ranks.tiling_world, (cases,)),
             ("refusals", torch_ranks.tiling_refusals, (_tcfg(CFG),))]
    out = spawn(WORLD, torch_ranks.several, calls, device="cpu")
    flows = {label: torch.cat([out[r]["tiling"][label] for r in range(CASES[label][2])])
             for label in CASES}
    return out, flows


@pytest.mark.parametrize("label", list(CASES))
def test_multi_rank_tiling_equals_untiled(world, label):
    engine, cfg, n, halo, (h, w), _, _ = CASES[label]
    tcfg = _tcfg(cfg)
    if engine == "tiled" and not cfg.refine_per_level:
        halo = halo or min_stripe_halo(tcfg, w, h, n)
        assert (halo > h // n) == ("gather" in label), (halo, h // n)
    i1, i2 = (torch.from_numpy(x) for x in _pair(label))
    with one_thread():
        want = tdis.dis_flow_padded(i1, i2, tcfg)
    got = world[1][label]
    assert got.shape == want.shape
    assert torch.equal(got, want)
    assert [r["tiling"]["staged_bytes"] for r in world[0]] == [0] * WORLD   # CPU tensors


@pytest.mark.parametrize("label,mesh_shape", [("stripes2_large_motion", (1, 2)),
                                              ("grid_routed4_finest1", (1, 4))])
def test_multi_rank_tiling_matches_jax(world, label, mesh_shape):
    """The JAX package's ``tiled_flow_fn`` (stripes with a ppermute halo;
    for the per-level config, its grid-tiled engine) on the virtual CPU
    mesh, against the port's ranks."""
    _, cfg, n, _, (h, w), _, _ = CASES[label]
    i1, i2 = _pair(label)
    fn = jtiled_flow_fn(cfg, jmake_mesh(mesh_shape, axis_names=("batch", "space")), h, w)
    ref = np.asarray(fn(jnp.asarray(i1), jnp.asarray(i2)))
    _gate(world[1][label].numpy(), ref)


def test_shift_and_exchange_halo(world):
    """``shift`` as ``lax.ppermute`` (zeros where nothing arrives),
    ``exchange_halo``'s extended block (neighbour rows inside, the edge
    row replicated outside the frame) and ``all_gather_rows``."""
    out = [r["halo"] for r in world[0]]
    frame, k, halo = torch.from_numpy(HALO_FRAME), HALO_FRAME.shape[0] // WORLD, 3
    blocks = frame.split(k)
    for i, r in enumerate(out):
        assert torch.equal(r["ring"], blocks[(i - 1) % WORLD])
        assert torch.equal(r["down"], blocks[i - 1][:2] if i else torch.zeros((2, 5)))
        lo, hi = i * k - halo, (i + 1) * k + halo
        idx = torch.arange(lo, hi).clamp(0, frame.shape[0] - 1)
        assert torch.equal(r["ext"], frame[idx])
        assert torch.equal(r["gathered"], frame)
        assert "exceeds the row block" in r["too_wide"]


def test_multi_rank_tiling_refusals(world):
    r = world[0][0]["refusals"]
    assert "divisible by n_space*4" in r["stripe_height"]
    assert "must be divisible by n_space=2" in r["grid_height"]
    assert "expected this rank's row block" in r["block_shape"]
