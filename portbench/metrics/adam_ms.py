"""Device ms a step inside torch's own "Optimizer.step#Adam.step"
ranges."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.adam_ranges:
        return None
    return ctx.trace.per_step_ms(lambda op: op["adam"])
