"""Readings behind a cell's limits, in one process on the card.

    python3 -m flowbench.calibrate --workload <cell> --seeds 1 2 ... [--control-seeds 1 2 3]

For each of ``--seeds``: the cell's pool from that seed, every request of
it through the cell's entry (the timed path: the replayed graph), and
each flow against the plain reference, as a run compares it
(``compare.pair_gaps``, worst over the pairs).  For each of
``--control-seeds``: the lower-precision control, the reference computed
in bfloat16 in the program's place (the configuration states float32),
against the float32 reference on the same pairs.  One JSON line a seed
and side; the benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import compare
from .reference import dis as reference
from .run import load_cell
from .traffic.pool import make_pool


def _requests(pool, batch):
    if batch == 1:
        return [((pool.img1[i], pool.img2[i]), [i]) for i in range(len(pool))]
    return [((pool.img1[i:i + batch], pool.img2[i:i + batch]), list(range(i, i + batch)))
            for i in range(0, len(pool), batch)]


def readings(name: str, seeds, control_seeds, device, pairs=None, emit=print):
    """One dict a seed and side, each also passed to ``emit``: the worst
    numbers over the pairs, the mean EPE against the ground truth, and a
    row a pair (its entry, gap mean, gap p99.9, the largest finite gap, the
    mean over finite pixels, non-finite pixels, pixels over 0.1 px)."""
    import dis_tpu_torch
    from dis_tpu_torch import serving

    spec = load_cell(name)
    config, mix = spec["config"], spec["mix"]
    height, width = config["height"], config["width"]
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dis_tpu_torch.DISConfig(**config["dis"])
    prm = reference.Params.from_fields(config["dis"])
    batch = mix["batch"]
    entry = serving.aot_compile(cfg, height, width, batch if batch > 1 else None, device=dev)
    out = []
    for side, seed_list in (("program", seeds), ("control", control_seeds)):
        for seed in seed_list:
            pool = make_pool(mix["pairs"], seed, height, width, dev)
            reqs = _requests(pool, batch)
            if pairs is not None:
                reqs = reqs[:max(1, pairs // batch)]
            got, epes, detail = [], [], []
            t0 = time.perf_counter()
            for (a, b), idx in reqs:
                if side == "program":
                    flows = entry(a, b)
                    flows = flows if batch > 1 else flows[None]
                for k, p in enumerate(idx):
                    ref = reference.flow(pool.img1[p], pool.img2[p], prm)
                    fl = (flows[k] if side == "program" else
                          reference.flow(pool.img1[p], pool.img2[p], prm, dtype=torch.bfloat16))
                    got.append(compare.pair_gaps(fl, ref))
                    d = torch.linalg.vector_norm(fl.float() - ref, dim=-1)
                    finite = torch.isfinite(d)
                    detail.append([pool.names[p], got[-1]["gap_mean_px"],
                                   got[-1]["gap_p999_px"], float(d[finite].max()),
                                   float(d[finite].mean()), int((~finite).sum()),
                                   int((d > 0.1).sum())])
                    epes.append(compare.masked_epe(fl, pool.gt[p], pool.valid[p]))
            rec = {"side": side, "seed": seed, "pairs": len(got),
                   **compare.worst(got), "epe": sum(epes) / len(epes),
                   "seconds": time.perf_counter() - t0,
                   "pairs_detail": detail}
            out.append(rec)
            emit(json.dumps(rec))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flowbench.calibrate", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--pairs", type=int, default=None, help="pairs a seed (default: the pool)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flowbench.calibrate: no CUDA card", file=sys.stderr)
        return 1
    readings(args.workload, args.seeds, args.control_seeds, torch.device("cuda", 0),
             pairs=args.pairs, emit=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
