"""Per-layer metric readers, one file a metric, named as the metric:
``<name>.py`` with ``read(ctx) -> float | None``.  ``ctx`` holds the
traced run: ``trace`` (`portbench.trace.Trace` of the traced steps,
None without a device trace), ``steps`` (the traced steps' shapes,
`portbench.shapes`), ``rest`` (the untraced rest of the window: step
intervals from CUDA events, host ms of each step call, its steps and
seconds) and ``peaks`` (the device's row of ``peaks.json``, or None).
A reader that finds nothing to read returns None and the metric is left
out of the result line; a share of a roofline or a peak is never given
as 0 for want of a reading.
"""
from __future__ import annotations

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def reader(name, root=HERE):
    """The read function of metric `name`: ``<name>.py``, or for a name
    qualified by its cell's end-to-end metric (``adam_ms.mtv_direct``)
    the file of the name before its last dot (``adam_ms.py``); None if
    neither exists."""
    path = os.path.join(root, f"{name}.py")
    if not os.path.isfile(path) and "." in name:
        path = os.path.join(root, f"{name.rsplit('.', 1)[0]}.py")
    if not os.path.isfile(path):
        return None
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
