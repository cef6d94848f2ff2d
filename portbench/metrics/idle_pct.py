"""Share of the traced window in which no kernel, copy or fill ran on
the device, in %."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
