"""Helpers of the metric readers."""
from __future__ import annotations

from portbench import counts


def roofline_pct(ctx, kernel):
    """Kernel's share of its roofline over the traced steps: the sum of
    its least times for each step's work over its device time, in %."""
    if ctx.trace is None or ctx.peaks is None or not ctx.steps:
        return None
    ms = ctx.trace.device_ms(lambda op: op["k"] == kernel)
    work = counts.kernel(kernel)
    if ms <= 0 or work is None:
        return None
    least = sum(counts.least_seconds(work(s), ctx.peaks) for s in ctx.steps)
    return 100.0 * least / (ms / 1e3)
