"""Device ms a step of the operations that are neither the port's
kernels nor Adam's: PyTorch's own kernels, copies and fills of the
render and the loss (in mtv_rgb_sh, the unfused SH chain)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.per_step_ms(lambda op: op["k"] is None
                                 and not op["adam"])
