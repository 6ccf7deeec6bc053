#!/usr/bin/env python
"""Mean EPE of the JAX package's ``dis_flow`` on the CPU for the pairs
``chip_smoke.py`` drives, the readings it pins (``EPE_JAX``).

    JAX_PLATFORMS=cpu python tools/jax_epe_readings.py medium full

Each argument is a preset name of ``dis_tpu.config.PRESETS``; each runs
jitted on ``bench.synth_pair()`` (1920x1080, a (3, 2) px shift) and
prints one JSON line: the preset, the mean end-point error against the
shift over every pixel, and the seconds the call took (trace, compile
and run).  Imports no torch.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHIFT = (3.0, 2.0)


def main(names) -> int:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from bench import synth_pair
    from dis_tpu.config import PRESETS
    from dis_tpu.models.dis import dis_flow

    i1, i2 = synth_pair()
    for name in names:
        t0 = time.perf_counter()
        f = np.asarray(jax.jit(dis_flow, static_argnames="cfg")(
            jnp.asarray(i1), jnp.asarray(i2), cfg=PRESETS[name]))
        secs = time.perf_counter() - t0
        epe = float(np.sqrt((f[..., 0] - SHIFT[0]) ** 2 + (f[..., 1] - SHIFT[1]) ** 2).mean())
        print(json.dumps({"preset": name, "epe": epe, "seconds": secs,
                          "finite": bool(np.isfinite(f).all())}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        raise SystemExit("usage: python tools/jax_epe_readings.py PRESET [PRESET ...]")
    sys.exit(main(sys.argv[1:]))
