"""The harness loads neither JAX nor the JAX package, comparing top-level
module names whole, and the reference loads nothing of the program."""

import subprocess
import sys
from pathlib import Path

import pytest

from flowbench.run import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("names, found", [
    (["dis_tpu_torch", "dis_tpu_torch.ops.iclk", "torch", "numpy"], []),
    (["dis_tpu"], ["dis_tpu"]),
    (["dis_tpu.oracle.reference_semantics"], ["dis_tpu"]),
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen", "dis_tpu_torch"], ["flax"]),
    (["jaxtyping", "dis_tpu_torchx", "flaxen"], []),
])
def test_forbidden_modules(names, found):
    assert forbidden_modules(names) == found


def _loaded_after(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    loaded = _loaded_after("import flowbench.run, flowbench.calibrate, flowbench.trace, "
                           "flowbench.compare, flowbench.traffic.pool, dis_tpu_torch.serving")
    assert not loaded & {"jax", "jaxlib", "flax", "dis_tpu"}
    assert "dis_tpu_torch" in loaded


def test_reference_and_traffic_load_nothing_of_the_program():
    loaded = _loaded_after("import flowbench.reference.dis, flowbench.traffic.pool, "
                           "flowbench.compare, flowbench.roofline.search, "
                           "flowbench.roofline.refine")
    assert not loaded & {"jax", "jaxlib", "flax", "dis_tpu", "dis_tpu_torch"}
