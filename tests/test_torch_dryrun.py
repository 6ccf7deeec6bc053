"""The port's entry points (``dis_tpu_torch/dryrun.py``), counterpart of
``__graft_entry__.py``: ``dryrun_multichip`` over 4 gloo ranks on the
CPU, and ``entry()``'s step against the JAX package's within the gates of
``tests/test_torch_tiles.py``, stage by stage.

``entry()``'s pair is uniform noise, where the flow reaches 30 px and
the refinement's smoothness term spreads each pixel's difference to its
neighbours: the JAX package's own jitted and eager steps differ there by
about 1e-3 px mean with about 1% of pixels over 1e-2 px, at the gates.
So the search part of the step (the config without refinement) and its
refinement (of the same unrefined flow) are each held to the gates, and
the whole step to JAX's jitted step within wider end-to-end limits: set
between that jitted/eager gap and a control, the port's step with one
refinement iteration instead of two, which must fail them.
``python tests/test_torch_dryrun.py`` prints the readings the limits
were set from.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dis_tpu.config import DISConfig as JConfig
from dis_tpu.parallel.tiles import _refine_full as jrefine_full
from dis_tpu_torch import dryrun
from dis_tpu_torch.models.dis import dis_flow_padded
from dis_tpu_torch.parallel.tiles import _refine_full

from test_torch_tiles import _gate
from torch_threads import one_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# End-to-end limits against JAX's jitted step: mean |d| in px, and the
# share of pixels over 1e-2 px.
E2E_MEAN, E2E_FRAC = 1e-2, 5e-2


def _graft_entry():
    spec = importlib.util.spec_from_file_location(
        "_graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _e2e(a, b):
    """(mean |a - b|, share of pixels with |a - b| > 1e-2 px)."""
    d = np.abs(np.asarray(a) - np.asarray(b))
    return float(d.mean()), float((d > 1e-2).mean())


def test_dryrun_multichip_cpu(capsys):
    assert dryrun.main(["4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "dryrun_multichip OK on 4 ranks on cpu (batch=2, space=[2, 4], " \
           "grid_tiled_space=2, seq=4)" in out


def test_entry_matches_graft_entry():
    fn, (i1, i2) = dryrun.entry(device="cpu")
    graft = _graft_entry()
    jfn, (j1, j2) = graft.entry()
    np.testing.assert_array_equal(i1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(j2))
    with one_thread():
        got = fn(i1, i2)
    assert tuple(got.shape) == (128, 160, 2) and got.device.type == "cpu"
    assert bool(torch.isfinite(got).all())

    # The step's config is the JAX entry's (its fn's closure holds it).
    jcfg = JConfig(**dataclasses.asdict(dryrun.ENTRY_CFG))
    cells = dict(zip(jfn.__code__.co_freevars, (c.cell_contents for c in jfn.__closure__)))
    assert cells["cfg"] == jcfg
    bare_t = dataclasses.replace(dryrun.ENTRY_CFG, refinement_iters=0)
    bare_j = dataclasses.replace(jcfg, refinement_iters=0)
    with one_thread():
        bare = dis_flow_padded(i1, i2, bare_t)
        assert torch.equal(got, _refine_full(i1, i2, bare, dryrun.ENTRY_CFG))
    jbare = np.asarray(cells["dis_flow_padded"](j1, j2, bare_j))
    _gate(bare.numpy(), jbare)
    with one_thread():
        refined = _refine_full(i1, i2, torch.from_numpy(jbare.copy()), dryrun.ENTRY_CFG)
    jrefined = jax.jit(lambda a, b, f: jrefine_full(a, b, f, jcfg))(j1, j2, jnp.asarray(jbare))
    _gate(refined.numpy(), np.asarray(jrefined))

    # The whole step against JAX's jitted step, and the control outside.
    jstep = np.asarray(jax.jit(jfn)(j1, j2))
    mean, frac = _e2e(got.numpy(), jstep)
    assert mean <= E2E_MEAN and frac <= E2E_FRAC, (mean, frac)
    with one_thread():
        control = dis_flow_padded(
            i1, i2, dataclasses.replace(dryrun.ENTRY_CFG, refinement_iters=1))
    cmean, cfrac = _e2e(control.numpy(), jstep)
    assert cmean > E2E_MEAN and cfrac > E2E_FRAC, (cmean, cfrac)


if __name__ == "__main__":
    # The readings behind E2E_MEAN and E2E_FRAC, JAX on the CPU (its
    # eager step takes about a minute).  The conftest imported above (by
    # test_torch_tiles) jits the pipeline's top-level calls; undo that.
    import dis_tpu.models.dis as jdis_mod
    import dis_tpu.ops.variational as jvar_mod

    jax.config.update("jax_platforms", "cpu")
    for mod, name in ((jdis_mod, "dis_flow_padded"), (jdis_mod, "dis_flow"),
                      (jvar_mod, "variational_refinement")):
        setattr(mod, name, getattr(mod, name).__wrapped__)
    fn, (i1, i2) = dryrun.entry(device="cpu")
    jfn, (j1, j2) = _graft_entry().entry()
    with one_thread():
        port = fn(i1, i2).numpy()
        control = dis_flow_padded(
            i1, i2, dataclasses.replace(dryrun.ENTRY_CFG, refinement_iters=1)).numpy()
    jitted, eager = np.asarray(jax.jit(jfn)(j1, j2)), np.asarray(jfn(j1, j2))
    for name, a, b in (("port vs JAX jitted", port, jitted),
                       ("port vs JAX eager", port, eager),
                       ("JAX jitted vs JAX eager", jitted, eager),
                       ("control vs JAX jitted", control, jitted)):
        mean, frac = _e2e(a, b)
        print(f"{name}: mean |d| {mean} px, {frac} of pixels over 1e-2 px")
