"""The whole step's share of the device's peak, in %: the least time of
the step's stages (``counts/stage_*.py``: for each, the larger of its
operations over the peak of their type and its bytes over the memory
rate), mean over the traced steps, over the host-clock ms a step of the
untraced rest of the window."""
from portbench import counts


def read(ctx):
    if ctx.peaks is None or not ctx.steps or ctx.rest["rest_steps"] < 1:
        return None
    stages = counts.stages()
    least = sum(counts.least_seconds(f(s), ctx.peaks)
                for s in ctx.steps for f in stages.values()) / len(ctx.steps)
    step_s = ctx.rest["rest_s"] / ctx.rest["rest_steps"]
    return 100.0 * least / step_s
