"""Port parity: kernel K2c's function (dis_tpu_torch vs dis_tpu).

K2c (``ops/cuda/extract_banded_kernel.py``) computes K2's function, so its
plain version is ``ops/iclk.py::extract_regions_plain``: held bitwise
against the JAX package's column-banded Pallas kernel run in interpret
mode (as ``tests/test_pallas_extract.py`` runs it), with a stripe's
``row0``, with a pair axis and on an empty grid.  The CUDA kernel itself
is held against the same plain version, K2 and K1's plane mode on the
card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py`` phase 1c).
The port's search launches no K2c (``tests/test_torch_tracing.py`` holds
every scale and stripe to K1's plane mode).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dis_tpu_torch
from dis_tpu.config import DISConfig as JConfig
from dis_tpu.ops import iclk as jiclk
from dis_tpu.ops.pallas.extract_kernel import extract_regions_banded as j_banded
from dis_tpu_torch import interop
from dis_tpu_torch.models import dis as tdis
from dis_tpu_torch.ops import iclk as ticlk
from dis_tpu_torch.ops.cuda.extract_banded_kernel import extract_regions_banded
from dis_tpu_torch.ops.cuda.extract_kernel import (MIN_BLOCKS_PER_SM, PATCHES_PER_GROUP,
                                                   STAGE_FLOATS, blocks_per_sm,
                                                   shared_bytes)
from dis_tpu_torch.ops.grid import GridGeometry

BENCH = JConfig(iterations=16, patch_size=8, coarsest_scale=3, finest_scale=0,
                patch_overlap=0.3, patch_normalization=True, mode="compat",
                early_exit=False)


def _tcfg(jcfg):
    return interop.config_from_dict(dataclasses.asdict(jcfg))


# -- K2c's function -----------------------------------------------------------

def _banded_inputs(ps, num_h, seed, pairs=None):
    """test_pallas_extract.py's banded case: an 88x280 plane and a 12 x
    num_h x-outer grid of stride 4 with an init flow bounded by 12 px."""
    rng = np.random.default_rng(seed)
    th, tw = 88, 280
    shape = (th, tw) if pairs is None else (pairs, th, tw)
    img = (rng.random(shape) * 255).astype(np.float32)
    num_w, steps, bound = 12, 4, 12.0
    xs = (np.arange(num_w) * steps + 3).astype(np.float32)
    ys = (np.arange(num_h) * steps + 2).astype(np.float32)
    cx, cy = np.meshgrid(xs, ys, indexing="ij")
    centers = np.stack([cx.ravel(), cy.ravel()], -1)
    init = (rng.random(shape[:-2] + centers.shape) * 2 - 1) * bound
    pos0 = (centers + init).astype(np.float32)
    geom = GridGeometry(num_w, num_h, 3, 2, steps, centers.astype(np.float32))
    return img, pos0, geom, bound


@pytest.mark.parametrize("ps,row0", [(8, 0), (12, 0), (8, 24)])
def test_banded_function_matches_pallas_interpret(ps, row0):
    img, pos0, geom, bound = _banded_inputs(ps, 16, seed=ps + row0)
    want = j_banded(jnp.asarray(img), jnp.asarray(pos0), ps, ps, geom.num_w,
                    geom.num_h, row0=row0, interpret=True)
    plain = ticlk.extract_regions_plain(torch.from_numpy(img), torch.from_numpy(pos0),
                                        ps, ps, row0)
    extract_regions_banded.launches = 0
    wrapped = extract_regions_banded(torch.from_numpy(img), torch.from_numpy(pos0),
                                     ps, ps, geom, bound, row0)
    assert extract_regions_banded.launches == 0          # CPU: the plain version
    for w, p, k in zip(want, plain, wrapped):
        np.testing.assert_array_equal(p.numpy(), np.asarray(w))
        np.testing.assert_array_equal(k.numpy(), np.asarray(w))


def test_banded_pair_axis_matches_per_pair_pallas():
    ps = 8
    img, pos0, geom, bound = _banded_inputs(ps, 16, seed=3, pairs=2)
    got = extract_regions_banded(torch.from_numpy(img), torch.from_numpy(pos0), ps, ps,
                                 geom, bound, row0=8)
    for i in range(2):
        want = j_banded(jnp.asarray(img[i]), jnp.asarray(pos0[i]), ps, ps, geom.num_w,
                        geom.num_h, row0=8, interpret=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


def test_banded_empty_grid():
    """num_h = 0 (a stripe's empty patch range): empty outputs.  The TPU
    kernel divides by zero there (extract_kernel.py:54-55), so the JAX
    side is its XLA extraction."""
    ps = 8
    img, pos0, geom, bound = _banded_inputs(ps, 0, seed=5)
    assert pos0.shape == (0, 2)
    want = jiclk.extract_regions(jnp.asarray(img), jnp.asarray(pos0), ps, ps)
    got = extract_regions_banded(torch.from_numpy(img), torch.from_numpy(pos0), ps, ps,
                                 geom, bound)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
    assert tuple(got[0].shape) == (0, 19, 19)


def test_banded_refusals():
    ps = 8
    img, pos0, geom, bound = _banded_inputs(ps, 16, seed=7)
    with pytest.raises(ValueError, match="x-outer grid"):
        extract_regions_banded(torch.from_numpy(img), torch.from_numpy(pos0[:-1]), ps, ps,
                               geom, bound)
    meta = torch.empty(img.shape, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        extract_regions_banded(meta, torch.zeros(pos0.shape, device="meta"), ps, ps,
                               geom, bound)
    # A region wider than the kernel's table fields.
    with pytest.raises(ValueError, match="patch_size"):
        extract_regions_banded(meta, torch.zeros(pos0.shape, device="meta"), 32, 32,
                               geom, bound)
    assert extract_regions_banded.launches == 0


def test_banded_staged_box_fits_the_4k_route():
    """At the 4K finest scale of the compat bench config (stride 5, init
    bound 56, twice the policing-chain bound of scale 1, which does not
    size the kernel) a 48-patch group of a column with up to 16 px of flow
    spread in y and 8 in x is staged whole in the fixed stage, a block's
    shared memory fits a Hopper block's 227 KB, and 2 blocks share an SM;
    2 blocks also share an SM at ps 12."""
    cfg = _tcfg(BENCH)
    assert 2.0 * tdis.motion_bound(cfg, 1) == 56.0
    rows = (PATCHES_PER_GROUP - 1) * cfg.steps + 19 + 16
    assert rows * ((3 + 19 + 8 + 3) & ~3) <= STAGE_FLOATS
    assert shared_bytes(8) <= 232_448 and blocks_per_sm(8) == MIN_BLOCKS_PER_SM == 2
    assert blocks_per_sm(12) == 2
