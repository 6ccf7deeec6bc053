"""The port's compat ``dis_flow`` on the CPU against the C++ baseline
binary (``tools/cpp_baseline``), an implementation of the compat
semantics that shares no code with either package.  The tolerance is the
JAX package's own gate against the same binary
(``tests/test_cpp_baseline.py``); no pixel may differ by more than
0.01 px.

On one pair of the 40 (five configs, shifts (2, 1) and (3, 2), seeds
0-3) the binary departs from the NumPy spec (``dis_tpu/oracle``) itself,
by up to 0.17 px over 40 pixels at a corner patch; the JAX package and
the port follow the spec there.  That pair is held apart: the port to
the spec, and its departure from the binary to exactly the spec's."""

import dataclasses
import os
import subprocess

import numpy as np
import pytest
import torch

import dis_tpu_torch
from conftest import synthetic_pair
from torch_threads import one_thread

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL_DIR = os.path.join(ROOT, "tools", "cpp_baseline")
BIN = os.path.join(TOOL_DIR, "dis_baseline")


@pytest.fixture(scope="module")
def binary():
    if not os.path.exists(BIN):
        r = subprocess.run(["make", "-C", TOOL_DIR], capture_output=True,
                           text=True)
        if r.returncode != 0:
            pytest.skip(f"cannot build baseline: {r.stderr[-500:]}")
    return BIN


# (h, w, iterations, patch size, coarsest scale, overlap, normalization);
# finest scale 0.  The binary has no fixed mode: its argument 8 turns
# patch normalization on or off.
CONFIGS = [
    (48, 64, 8, 8, 2, 0.5, True),
    (96, 128, 12, 8, 3, 0.3, True),
    (96, 128, 16, 12, 2, 0.5, True),
    (128, 192, 16, 8, 3, 0.3, True),
    (96, 128, 12, 8, 3, 0.3, False),
]


def compat(iters, ps, coarsest, overlap, norm):
    return dis_tpu_torch.DISConfig(iterations=iters, patch_size=ps, coarsest_scale=coarsest,
                                   finest_scale=0, patch_overlap=overlap,
                                   patch_normalization=norm, mode="compat")


def port_flow(i1, i2, cfg):
    with one_thread():
        return dis_tpu_torch.dis_flow(torch.from_numpy(i1), torch.from_numpy(i2), cfg).numpy()


def binary_flow(binary, tmp_path, i1, i2, cfg):
    h, w = i1.shape
    p1, p2, po = (str(tmp_path / n) for n in ("a.f32", "b.f32", "flow.f32"))
    i1.astype("<f4").tofile(p1)
    i2.astype("<f4").tofile(p2)
    r = subprocess.run(
        [binary, str(w), str(h), str(cfg.iterations), str(cfg.patch_size),
         str(cfg.coarsest_scale), str(cfg.finest_scale), str(cfg.patch_overlap),
         str(int(cfg.patch_normalization)), "1", p1, p2, po],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return np.fromfile(po, dtype="<f4").reshape(h, w, 2)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("h,w,iters,ps,coarsest,overlap,norm", CONFIGS)
def test_port_matches_cpp_binary(binary, tmp_path, h, w, iters, ps, coarsest, overlap,
                                 norm, seed):
    i1, i2 = synthetic_pair(h, w, seed=seed)
    cfg = compat(iters, ps, coarsest, overlap, norm)
    want = binary_flow(binary, tmp_path, i1, i2, cfg)
    got = port_flow(i1, i2, cfg)
    np.testing.assert_allclose(got, want, atol=5e-3)
    assert float((np.abs(got - want) > 0.01).mean()) == 0.0


def test_binary_departs_from_the_spec_not_the_port(binary, tmp_path):
    from dis_tpu.config import DISConfig
    from dis_tpu.oracle import reference_semantics as spec

    i1, i2 = synthetic_pair(128, 192, shift=(3.0, 2.0), seed=3)
    cfg = compat(16, 8, 3, 0.3, True)
    cpp = binary_flow(binary, tmp_path, i1, i2, cfg)
    got = port_flow(i1, i2, cfg)
    oracle = spec.dis_flow_oracle(i1, i2, DISConfig(**dataclasses.asdict(cfg)))
    np.testing.assert_allclose(got, oracle, atol=5e-3)
    port_off = np.abs(got - cpp).max(-1) > 0.01
    spec_off = np.abs(oracle - cpp).max(-1) > 0.01
    assert spec_off.any()
    np.testing.assert_array_equal(port_off, spec_off)
