"""The comparison that decides ``correct``: each flow the timed path
returned against the plain reference's flow of the same pair.

Per pair, the endpoint gap ``|flow - ref|`` of every pixel.  The number
compared, ``off_pct``, is the share in % of a pair's pixels whose gap is
over ``OFF_PX`` or not finite, the worst over the compared pairs.  DIS
makes discrete decisions (a patch policed back to its start, or frozen
as converged) on sums whose rounding differs between any two float32
orders of summation, so a sound program departs from the reference at a
few patches by whole pixels; a share of pixels counts those patches by
their area, as a mean or a percentile of the gap cannot.  The gap's mean
and 99.9th percentile are printed beside it.  The limits of a cell are
in ``flowbench/limits/<cell>.json``, set from the readings of sound runs
and of the lower-precision control (``PERF.md``); a number is within
its limit when it is at most the limit, and a NaN never is.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict

import torch

LIMITS_DIR = Path(__file__).resolve().parent / "limits"


OFF_PX = 0.1


def pair_gaps(flow: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """``off_pct`` of one pair, and the gap's mean and 99.9th percentile
    (NaN where a gap is not finite), for the log."""
    d = torch.linalg.vector_norm((flow.float() - ref.float()).reshape(-1, 2), dim=1)
    off = ~(d <= OFF_PX)                      # NaN is off
    k = max(1, math.ceil(0.999 * d.numel()))
    return {"off_pct": 100.0 * float(off.sum()) / d.numel(),
            "gap_mean_px": float(d.mean()),
            "gap_p999_px": float(d.kthvalue(k).values)}


def worst(readings) -> Dict[str, float]:
    """Each number's worst (largest, NaN first) over the pairs' readings."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            cur = out.get(k)
            if cur is None or math.isnan(v) or (not math.isnan(cur) and v > cur):
                out[k] = v
    return out


def masked_epe(flow: torch.Tensor, gt: torch.Tensor, valid: torch.Tensor,
               border: int = 12) -> float:
    """Mean endpoint error over valid pixels away from the frame border."""
    m = torch.zeros_like(valid)
    m[border:-border, border:-border] = True
    m &= valid
    d = torch.linalg.vector_norm(flow.float() - gt.float(), dim=-1)
    return float(d[m].mean())


def limits(cell: str) -> Dict[str, float]:
    return json.loads((LIMITS_DIR / f"{cell}.json").read_text())["limits"]


def judge(numbers: Dict[str, float], lim: Dict[str, float]) -> bool:
    """Every limited number present and within its limit."""
    return all(k in numbers and not math.isnan(numbers[k]) and numbers[k] <= v
               for k, v in lim.items())
