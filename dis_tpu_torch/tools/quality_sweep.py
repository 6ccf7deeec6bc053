"""Per-family EPE sweep of a preset, with optional config overrides;
counterpart of ``tools/quality_sweep.py``.

Each motion family of ``utils/synth.py`` gives one pair with exact ground
truth; ``dis_flow`` runs on it on ``--device`` and the flow is scored by
``synth.masked_epe``.  The per-family lines and the last JSON line are
the JAX tool's (the JSON line also names the device).

Usage:
  python -m dis_tpu_torch.tools.quality_sweep --preset medium
  python -m dis_tpu_torch.tools.quality_sweep --preset full --device cpu
  python -m dis_tpu_torch.tools.quality_sweep --preset medium --set refinement_alpha=6
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import PRESETS, DISConfig
from ..models.dis import dis_flow
from ..serving import _device
from ..utils import synth


def apply_overrides(cfg: DISConfig, sets: Iterable[str]) -> DISConfig:
    """``cfg`` with each ``field=value`` of ``sets`` applied, the value
    parsed as the field's current type (a bool from ``True`` or ``1``)."""
    for ov in sets:
        k, v = ov.split("=", 1)
        typ = type(getattr(cfg, k))
        val = (v == "True" or v == "1") if typ is bool else typ(v)
        cfg = dataclasses.replace(cfg, **{k: val})
    return cfg


def sweep(cfg: DISConfig, height: int, width: int,
          families: Optional[Sequence[str]] = None,
          device="cuda") -> Dict[str, Tuple[float, np.ndarray]]:
    """{family: (masked EPE, flow [H, W, 2] on the host)} of ``cfg`` on
    each family's pair (all of ``synth.FAMILIES`` by default, sorted) at
    ``height`` x ``width``, the flow computed on ``device``."""
    dev = _device(device, "quality_sweep")
    out = {}
    for fam in (families or sorted(synth.FAMILIES)):
        i1, i2, gt, valid = synth.make_pair(fam, height, width)
        a, b = (torch.from_numpy(x).to(dev) for x in (i1, i2))
        flow = dis_flow(a, b, cfg).cpu().numpy()
        out[fam] = (synth.masked_epe(flow, gt, valid), flow)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="medium", choices=sorted(PRESETS))
    ap.add_argument("--size", default="384x512", metavar="HxW")
    ap.add_argument("--families", default=None,
                    help="comma-separated families (default: all)")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override field=value (repeatable)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to run on the CPU)")
    args = ap.parse_args(argv)

    h, w = (int(v) for v in args.size.split("x"))
    cfg = apply_overrides(PRESETS[args.preset], args.set)
    fams = args.families.split(",") if args.families else None
    dev = _device(args.device, "quality_sweep")
    epe = {}
    for fam, (e, _) in sweep(cfg, h, w, fams, dev).items():
        epe[fam] = round(e, 4)
        print(f"{fam:16s} {epe[fam]:.4f}", flush=True)
    epe["mean"] = round(float(np.mean(list(epe.values()))), 4)
    print(json.dumps({"preset": args.preset, "size": args.size,
                      "overrides": args.set, "epe": epe, "device": str(dev)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
