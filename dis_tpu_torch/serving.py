"""The serving path: fixed-shape flow executables and a saved artifact;
counterpart of ``dis_tpu/serving.py``.

:func:`aot_compile` builds a :class:`CompiledFlow` for one shape bucket,
a single pair [H, W] or a batch [B, H, W].  On a CUDA device it runs
``dis_flow`` on static input buffers a few times on a side stream (which
builds the kernels and the per-scale plans), then captures one call into
a ``torch.cuda.CUDAGraph``; each request copies its frames into the
static inputs and replays the graph, so no Python runs per kernel and no
op is dispatched from the host.  A CUDA device either captures or
raises.  On an explicitly requested CPU device the executable is the
same planned eager ``dis_flow``, with the same shape guard.
``cost_analysis`` counts the bucket's operations and bytes from shapes
(``cost.py``); ``memory_analysis`` reads what the executable holds on
the card.

:func:`export_flow` saves the program of one bucket as a
``torch.export`` archive (:func:`save_exported` writes it to a file), and
:func:`load_exported` loads it as a :class:`CompiledFlow`, with no
tracing of the pipeline's Python.  Shapes are static: one program per
bucket, as on the TPU.  On a CUDA device the program holds the kernels
as ops of the ``dis_tpu_torch`` namespace (``ops/cuda``; R0, R1, R23
and R3 where the config refines, F1-F3 where the frame needs them), so the loading process
imports the package for their registrations only; on the CPU it holds the plain versions as ATen ops and loads without the
package.  The bucket's plans are the program's constants.  The archive
keeps beside the program the config, the bucket, the device and, for a
CUDA program, the key of the kernel sources it was checked against
(``_build.library_path``); a CUDA archive is refused where there is no
card or where the sources differ.  A CUDA graph holds device addresses
and cannot be saved, so a loaded CUDA program is captured anew in the
serving process: its first call builds and loads the kernel library,
runs the program twice on a side stream and captures a third run, as
:func:`aot_compile` does; later calls replay.

CLI: ``python -m dis_tpu_torch.serving export --size 1080x1920 --out
flow.pt2``, then ``python -m dis_tpu_torch.serving run flow.pt2`` (runs
the artifact on random frames and prints its time per call).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import zipfile
from typing import Callable, Dict, Optional, Tuple

import torch

from . import _build
from .config import PRESETS, DISConfig
from .cost import CORE_KERNELS, KERNELS, flow_cost
from .models.dis import dis_flow, flow_plans
from .ops.grid import ScalePlan, plan_cache_bytes
from .utils import checks, profiling

WARMUP_CALLS = 2
META_FILE = "dis_tpu_torch.json"    # the archive's extra file


@dataclasses.dataclass
class CompiledFlow:
    """A fixed-shape flow executable, made by :func:`aot_compile` or
    :func:`load_exported`.  Inputs must be ``(height, width)`` (with the
    leading ``batch`` dim if set); call it as ``flow = compiled(img1,
    img2)``."""

    cfg: DISConfig
    height: int
    width: int
    batch: Optional[int]
    device: torch.device
    # The per-scale plans of the bucket, coarsest first.  The graph reads
    # their device memory at every replay, so the executable owns them.
    plans: Tuple[ScalePlan, ...] = dataclasses.field(init=False, default=())
    # A loaded program (torch.export) and its constants, the bucket's
    # plans; None: the executable runs dis_flow.
    program: Optional[Callable] = dataclasses.field(init=False, default=None)
    constants: Tuple[torch.Tensor, ...] = dataclasses.field(init=False, default=())
    graph: Optional[torch.cuda.CUDAGraph] = dataclasses.field(
        init=False, default=None)                  # None on the CPU
    static_in: Tuple[torch.Tensor, ...] = dataclasses.field(init=False, default=())
    static_out: Optional[torch.Tensor] = dataclasses.field(init=False, default=None)
    # The kernel launches captured into the graph, in launch order, each
    # with its op, kernel id, stage and scale (utils/profiling.py; a loaded
    # program runs no pipeline Python, so its launches have no stage): a
    # replay runs them in this order.  graph_launches counts them by
    # kernel.  (A kernel counts a launch when it is captured, not when it
    # is replayed.)
    graph_manifest: Tuple[profiling.Launch, ...] = dataclasses.field(init=False,
                                                                    default=())
    graph_launches: Dict[str, int] = dataclasses.field(init=False,
                                                       default_factory=dict)
    # A timing event captured as the graph's first node: a replay records
    # it when the graph starts to run on the card (profiling.Recorder).
    graph_head: Optional[torch.cuda.Event] = dataclasses.field(init=False, default=None)

    @property
    def input_shape(self) -> Tuple[int, ...]:
        hw = (self.height, self.width)
        return hw if self.batch is None else (self.batch,) + hw

    def __call__(self, img1, img2) -> torch.Tensor:
        """Flow [(B,) H, W, 2] float32 on the executable's device.  On CUDA
        the result is a fresh tensor (a clone of the graph's output
        buffer), so it stays valid across later calls.  A loaded program
        is captured at its first call.  While a profiler runs or a
        recorder records (``utils/profiling.py``), the request's copy-in,
        replay and copy-out are its stages."""
        a, b = torch.as_tensor(img1), torch.as_tensor(img2)
        want = self.input_shape
        if tuple(a.shape) != want or tuple(b.shape) != want:
            raise ValueError(
                f"compiled for {want}, got {tuple(a.shape)} / {tuple(b.shape)}; "
                "aot_compile a new bucket for other shapes")
        if self.device.type == "cpu":
            f32 = torch.float32
            return self._run(a.to(self.device, f32), b.to(self.device, f32))
        if self.graph is None:
            if self.program is None:
                raise RuntimeError(f"CompiledFlow on {self.device} holds no captured "
                                   "graph: make it with aot_compile")
            self._capture()
        req = profiling.request(self.graph_head)
        if req is None:
            self.static_in[0].copy_(a)
            self.static_in[1].copy_(b)
            self.graph.replay()
            return self.static_out.clone()
        with req:
            req.stage(0)
            self.static_in[0].copy_(a)
            self.static_in[1].copy_(b)
            req.stage(1)
            self.graph.replay()
            req.stage(2)
            out = self.static_out.clone()
        return out

    def _run(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.program is not None:
            return self.program(a, b)
        return dis_flow(a, b, self.cfg)

    def _capture(self) -> None:
        """Build and load the kernels, run the program ``WARMUP_CALLS``
        times on a side stream, then capture one run into a CUDA graph
        over static inputs, after a timing event (``graph_head``), with
        the launch manifest of the run.  A first launch inside the capture
        would load the library and set K2's shared-memory allowance
        mid-capture."""
        dev = self.device
        _build.library()
        with torch.cuda.device(dev):
            static_in = tuple(torch.zeros(self.input_shape, dtype=torch.float32,
                                          device=dev) for _ in range(2))
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_CALLS):
                    self._run(*static_in)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            head = torch.cuda.Event(enable_timing=True, external=True)
            with profiling.launch_manifest() as manifest, torch.cuda.graph(graph):
                head.record()
                static_out = self._run(*static_in)
        self.graph, self.static_in, self.static_out = graph, static_in, static_out
        self.graph_head = head
        self.graph_manifest = tuple(manifest)
        # K3, K2, K2c and K1 always; R0, R1, R23 and R3 where the program
        # refines; S1, S3 and S4 where they launch (S3 in fixed mode); F1-F3
        # where the frame pads, refines on intensity planes, and upsamples.
        counts = collections.Counter(KERNELS[e.op] for e in manifest)
        self.graph_launches = {k: counts[k] for k in dict.fromkeys(KERNELS.values())
                               if k in CORE_KERNELS or counts[k]}

    def cost_analysis(self) -> Dict:
        """``{"flops", "bytes accessed", "kernels", "glue"}`` of one call,
        counted from shapes (``cost.flow_cost``): K1 for all its
        ``iterations + 1`` trips.  The same on every device."""
        return flow_cost(self.cfg, self.height, self.width, self.batch)

    def memory_analysis(self) -> Optional[Dict[str, int]]:
        """Bytes the executable holds on the card: its static inputs and
        output, the graph's private memory pool (what the capture
        allocated, the output included), its plans (a loaded program's
        constants), and the process-wide plan cache on its device, which
        never evicts.  None on the CPU, or before a loaded program's first
        call."""
        if self.graph is None:
            return None
        pool = self.graph.pool()
        graph_pool = sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                         if tuple(s.get("segment_pool_id", ())) == tuple(pool))
        held = self.constants or [t for p in self.plans for t in p[1:]]
        entries, cache = plan_cache_bytes(self.device)
        return {"argument bytes": sum(t.nbytes for t in self.static_in),
                "output bytes": self.static_out.nbytes,
                "graph pool bytes": graph_pool,
                "plan bytes": sum(t.nbytes for t in held),
                "plan cache bytes": cache, "plan cache entries": entries}


def _device(device, what: str) -> torch.device:
    """``device`` as a CPU device or an indexed CUDA device; raises for
    another device, or for CUDA where there is none."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} takes a CUDA or CPU device, got {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{what} on {dev}: no CUDA device is available "
                               "(pass device='cpu' for the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def aot_compile(cfg: DISConfig, height: int, width: int,
                batch: Optional[int] = None,
                device="cuda") -> CompiledFlow:
    """The flow pipeline for one shape bucket, built now rather than at
    the first request.  ``batch=None`` takes a single pair [H, W];
    ``batch=B`` a batch [B, H, W], whose kernels fold the pairs into
    their launches.  A refinement config (``DIS_MEDIUM``, ``DIS_FULL``)
    captures its sweeps into the same graph."""
    if batch is not None and batch < 1:
        raise ValueError(f"batch must be None or >= 1, got {batch}")
    dev = _device(device, "aot_compile")
    compiled = CompiledFlow(cfg, height, width, batch, dev)
    with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
        # Made here, before the warm-up: the capture fetches these same
        # plans from the cache and records their memory.
        compiled.plans = flow_plans(cfg, height, width, dev)
    if dev.type == "cuda":
        compiled._capture()
    return compiled


class _Flow(torch.nn.Module):
    """``dis_flow`` under one config, as the module ``torch.export`` takes."""

    def __init__(self, cfg: DISConfig):
        super().__init__()
        self.cfg = cfg

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        return dis_flow(img1, img2, self.cfg)


def export_flow(cfg: DISConfig, height: int, width: int,
                batch: Optional[int] = None, device="cuda") -> bytes:
    """The flow program of one bucket (static [height, width] inputs, or
    [batch, height, width]) as a ``torch.export`` archive, in bytes.  The
    bucket's plans are built eagerly first: the program holds them as
    constants.  Raises under live ``DIS_TPU_CHECK`` guards, whose host
    read has no place in a saved program."""
    if batch is not None and batch < 1:
        raise ValueError(f"batch must be None or >= 1, got {batch}")
    if checks.active():
        raise RuntimeError("export_flow under live DIS_TPU_CHECK guards: export "
                           "outside checks.checked (their host read cannot be saved)")
    dev = _device(device, "export_flow")
    shape = (height, width) if batch is None else (batch, height, width)
    with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
        flow_plans(cfg, height, width, dev)
        example = tuple(torch.zeros(shape, dtype=torch.float32, device=dev)
                        for _ in range(2))
        program = torch.export.export(_Flow(cfg), example)
    program.example_inputs = None       # the archive holds no frames
    meta = {"config": dataclasses.asdict(cfg), "height": height, "width": width,
            "batch": batch, "device": str(dev),
            "kernels": _build.library_path().name if dev.type == "cuda" else None}
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={META_FILE: json.dumps(meta)})
    return buf.getvalue()


def save_exported(path: str, cfg: DISConfig, height: int, width: int,
                  batch: Optional[int] = None, device="cuda") -> None:
    data = export_flow(cfg, height, width, batch, device)
    with open(path, "wb") as f:
        f.write(data)


def artifact_meta(data: bytes) -> Dict:
    """What :func:`export_flow` stored beside the program, read without
    loading it."""
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        names = [n for n in z.namelist() if n.endswith("/extra/" + META_FILE)]
        if not names:
            raise ValueError("not a dis_tpu_torch serving artifact: the archive "
                             f"holds no {META_FILE}")
        return json.loads(z.read(names[0]))


def load_exported(path_or_bytes, device=None):
    """Load an artifact of :func:`export_flow`; returns ``(run,
    exported_program)``, where ``run(img1, img2) -> flow`` is a
    :class:`CompiledFlow` over the loaded program.  ``device`` (default:
    the artifact's) must be the device the artifact was made for.  A CUDA
    artifact is refused where the kernel sources differ from the ones it
    was checked against, and where there is no card."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    meta = artifact_meta(data)
    made = torch.device(meta["device"])
    if made.type == "cuda":
        key = _build.library_path().name
        if meta["kernels"] != key:
            raise RuntimeError(f"the artifact was made with the kernels {meta['kernels']}, "
                               f"the sources here build {key}: export it again")
        if not torch.cuda.is_available():
            raise RuntimeError(f"the artifact is a program for {made} and no CUDA "
                               "device is available")
    if device is not None:
        want = torch.device(device)
        if want.type != made.type or (want.index is not None and want != made):
            raise ValueError(f"the artifact is a program for {made}, not for {want}")
    program = torch.export.load(io.BytesIO(data))
    run = CompiledFlow(DISConfig(**meta["config"]), meta["height"], meta["width"],
                       meta["batch"], made)
    run.program = program.module()
    run.constants = tuple(program.constants.values())
    return run, program


def _parse_size(s: str) -> Tuple[int, int]:
    h, w = s.lower().split("x")
    return int(h), int(w)


def main(argv=None) -> int:
    import argparse
    import sys
    import time

    import numpy as np

    ap = argparse.ArgumentParser(prog="dis_tpu_torch.serving", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    ex = sub.add_parser("export", help="save the flow program of one bucket")
    ex.add_argument("--size", required=True, metavar="HxW")
    ex.add_argument("--batch", type=int, default=None)
    ex.add_argument("--preset", default="fast", choices=sorted(PRESETS))
    ex.add_argument("--mode", default="compat", choices=("compat", "fixed"))
    ex.add_argument("--out", required=True)
    rn = sub.add_parser("run", help="run a saved artifact on random frames")
    rn.add_argument("artifact")
    rn.add_argument("--reps", type=int, default=3)
    for p in (ex, rn):
        p.add_argument("--device", default="cuda",
                       help="torch device of the program (default cuda; cpu for "
                            "the plain versions)")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"dis_tpu_torch.serving: --device {dev} needs a CUDA GPU and "
              "torch.cuda.is_available() is False; pass --device cpu to run on "
              "the CPU", file=sys.stderr)
        return 1

    if args.cmd == "export":
        h, w = _parse_size(args.size)
        cfg = dataclasses.replace(PRESETS[args.preset], mode=args.mode)
        save_exported(args.out, cfg, h, w, args.batch, dev)
        print(f"exported {args.size} batch={args.batch} preset={args.preset} "
              f"device={dev} -> {args.out}")
        return 0

    t0 = time.perf_counter()
    run, _ = load_exported(args.artifact, dev)
    loaded = time.perf_counter() - t0
    shape = run.input_shape
    r = np.random.default_rng(0)
    a = torch.from_numpy(r.random(shape, dtype=np.float32) * 255).to(run.device)
    b = torch.from_numpy(r.random(shape, dtype=np.float32) * 255).to(run.device)
    t0 = time.perf_counter()
    flow = run(a, b)                # the first call captures on the card
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    print(f"loaded in {loaded:.3f} s; first call {time.perf_counter() - t0:.3f} s")
    if run.device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.reps):
            flow = run(a, b)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / args.reps
    else:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            flow = run(a, b)
        dt = (time.perf_counter() - t0) / args.reps
    print(f"in {shape} -> flow {tuple(flow.shape)}; {dt * 1e3:.2f} ms/call "
          f"(|u| mean {float(flow.abs().mean()):.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
