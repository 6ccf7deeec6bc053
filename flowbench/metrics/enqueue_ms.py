"""Entry layer: host ms from the call into the entry (``CompiledFlow.__call__``
or ``dis_flow``) to its return, before the wait, over all requests of the
untraced window: the benchmark's own span around the call."""


def read(ctx):
    if ctx.requests == 0:
        return None
    return ctx.enqueue_s / ctx.requests * 1e3
