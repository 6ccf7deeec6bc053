"""Port parity: the batch and sequence axes of ``dis_tpu_torch.parallel``
(``torch.distributed``, gloo, on the CPU).

One world of 4 ranks (``parallel.launch.spawn``) runs every case:
``batched_flow_fn`` and ``batched_flow_epe_fn`` with a mesh (the batch
axis of a ``(4,)`` and of a ``(2, 2)`` batch x space mesh), whose flows
and mean EPE equal the single-device functions bitwise;
``sequence_pair_flow_fn`` and ``sequence_flow_fn`` over 4 ranks, whose
flows equal the serial ``dis_flow_padded`` of each pair bitwise (the
frame form's final slot zeros); and the refusals of stacks that do not
shard evenly.  Once, ``sequence_pair_flow_fn`` is held to the JAX
package's on the virtual CPU mesh at the shape of
``tests/test_parallel.py::test_sequence_pair_sharded_no_dummy_slot``,
under the gates of ``tests/test_torch_tiles.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_tpu.config import DISConfig as JConfig
from dis_tpu.parallel import make_mesh as jmake_mesh
from dis_tpu.parallel import sequence_pair_flow_fn as jsequence_pair_flow_fn
from dis_tpu_torch import interop
from dis_tpu_torch.models import dis as tdis
from dis_tpu_torch.parallel import batched_flow_epe_fn
from dis_tpu_torch.parallel.launch import spawn

import torch_ranks
from conftest import synthetic_pair
from test_torch_tiles import _gate
from torch_threads import one_thread

WORLD = 4
CFG = JConfig(iterations=6, coarsest_scale=2, patch_overlap=0.5, early_exit=False)
CFG_FIXED = JConfig(iterations=8, coarsest_scale=2, patch_overlap=0.3, mode="fixed",
                    finest_scale=1)
MESHES = {"batch4": (4,), "batch2_space2": (2, 2)}
B, H, W = 8, 24, 32


def _tcfg(jcfg):
    return interop.config_from_dict(dataclasses.asdict(jcfg))


def _pairs():
    ps = [synthetic_pair(H, W, shift=(2.0, 1.0), seed=s) for s in range(B)]
    a = np.stack([p[0] for p in ps])
    b = np.stack([p[1] for p in ps])
    gt = np.zeros((B, H // 2, W // 2, 2), np.float32)   # finest scale 1
    gt[..., 0], gt[..., 1] = 1.0, 0.5
    return a, b, gt


def _clip(t):
    """t frames of a 1-px-per-frame horizontal pan (the clip of
    tests/test_parallel.py's sequence tests)."""
    base, _ = synthetic_pair(H, W, seed=11)
    return np.stack([np.roll(base, s, axis=1) for s in range(t)]).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    a, b, gt = _pairs()
    calls = [(name, torch_ranks.batch_world, (_tcfg(CFG_FIXED), a, b, gt, shape))
             for name, shape in MESHES.items()]
    calls.append(("seq", torch_ranks.sequence_world, (_tcfg(CFG), _clip(9), _clip(8))))
    return spawn(WORLD, torch_ranks.several, calls, device="cpu")


def _stitch(world, name, key, ranks):
    return torch.cat([world[r][name][key] for r in ranks])


@pytest.mark.parametrize("name", list(MESHES))
def test_batch_mesh_equals_single_device(world, name):
    a, b, gt = (torch.from_numpy(x) for x in _pairs())
    with one_thread():
        flows, mean = batched_flow_epe_fn(_tcfg(CFG_FIXED))(a, b, gt)
    n_batch = MESHES[name][0]
    ranks = [r * (WORLD // n_batch) for r in range(n_batch)]   # space index 0
    assert torch.equal(_stitch(world, name, "flows", ranks), flows)
    assert torch.equal(_stitch(world, name, "plain", ranks), flows)
    for r in range(WORLD):
        assert torch.equal(world[r][name]["mean_epe"], mean)
        assert "not divisible by the 'batch' axis size" in world[r][name]["odd_batch"]
    if len(MESHES[name]) == 2:   # the space replicas flow the same pairs
        for r in range(WORLD):
            assert torch.equal(world[r][name]["flows"], world[r - r % 2][name]["flows"])


@pytest.mark.parametrize("form,t", [("pair", 9), ("frame", 8)])
def test_sequence_forms_equal_serial(world, form, t):
    clip = torch.from_numpy(_clip(t))
    got = _stitch(world, "seq", form, range(WORLD))
    assert got.shape == (t - 1 if form == "pair" else t, H, W, 2)
    with one_thread():
        for i in range(t - 1):
            assert torch.equal(got[i], tdis.dis_flow_padded(clip[i], clip[i + 1], _tcfg(CFG))), i
    if form == "frame":
        assert not got[-1].any()


def test_sequence_refusals(world):
    for r in range(WORLD):
        seq = world[r]["seq"]
        assert "leading dim 9" in seq["pair_length"]
        assert "leading dim 7" in seq["frame_length"]
    assert "needs the clip's final frame" in world[WORLD - 1]["seq"]["no_last"]


def test_sequence_pair_matches_jax(world):
    clip = _clip(9)
    fn = jsequence_pair_flow_fn(CFG, jmake_mesh((WORLD,), axis_names=("seq",)))
    ref = np.asarray(fn(jnp.asarray(clip)))
    _gate(_stitch(world, "seq", "pair", range(WORLD)).numpy(), ref)
