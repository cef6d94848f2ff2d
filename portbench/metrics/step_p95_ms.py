"""95th percentile of the intervals between CUDA events recorded at each
step's start, over the untraced rest of the traced run's window (at
least 200 intervals, so that ten lie beyond it)."""
import statistics


def read(ctx):
    iv = ctx.rest["intervals_ms"]
    if len(iv) < 200:
        return None
    return statistics.quantiles(iv, n=20)[18]
