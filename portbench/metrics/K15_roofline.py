"""K15's share of its roofline over the traced steps (the work of
``counts/kernel_K15.py`` over K15's device time), in %."""
from portbench.metrics.common import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "K15")
