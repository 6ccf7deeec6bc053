"""Device layer: the share of a recorded window, with no profiler, in which
the card ran none of a request's work (its copy-in, graph or copy-out),
in %: CUDA events the program records around each request
(``dis_tpu_torch/utils/profiling.py``, ``Recorder.summary``'s
``idle_pct``).  Nothing where the run recorded no window."""


def read(ctx):
    recorded = getattr(ctx, "recorded", None)
    if not recorded:
        return None
    return recorded.get("idle_pct")
