"""Device ms a step of the port's render kernels (``kernel_table.json``
layer "render": in these cells K1, K2, K3, K9, K10, K13, K14, K15)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.per_step_ms(lambda op: op["layer"] == "render")
