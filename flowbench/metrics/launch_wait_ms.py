"""Entry layer: device ms a request from the replay call to the graph's
first node (an event captured at the graph's head), the graph's
submission, in a recorded window with no profiler
(``Recorder.summary``'s ``device_ms["launch_wait"]``).  Nothing where the
run recorded no window or the card timed no head event."""


def read(ctx):
    recorded = getattr(ctx, "recorded", None)
    if not recorded or "device_ms" not in recorded:
        return None
    return recorded["device_ms"]["launch_wait"]
