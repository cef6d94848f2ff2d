"""Host ms of a call into the step (no synchronize), mean over the
untraced rest of the traced run's window."""


def read(ctx):
    ms = ctx.rest["enqueue_ms"]
    return sum(ms) / len(ms) if ms else None
