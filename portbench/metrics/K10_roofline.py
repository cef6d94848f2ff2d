"""K10's share of its roofline over the traced steps (the work of
``counts/kernel_K10.py`` over K10's device time), in %."""
from portbench.metrics.common import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "K10")
