"""Device layer: the share of the traced window in which no kernel, copy
or fill ran on the card (one less the union of the device spans over the
window), in %."""


def read(ctx):
    if ctx.window is None or ctx.window.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.window.busy_s / ctx.window.window_s)
