"""Work counts: the operations and bytes a stage of the step, or one
kernel, needs for the shapes of one step, as functions of the step's
shape (`portbench.shapes.StepShape`).

Each stage and each kernel has a file of its own, found by name:
``stage_<name>.py`` and ``kernel_<K#>.py``, each with
``count(shape) -> {"ops": n, "bytes": n, "peak": "f32" | "bf16"}``.
Bytes count every input read once and every output written once;
operations count what these inputs need.  The arithmetic of the kernels
is that of the repository's ``chip_smoke.py`` bounds; a stage counts its
own inputs and outputs, whatever kernels implement it, so a later change
that removes a kernel still faces the same count.
"""
from __future__ import annotations

import glob
import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(path):
    name = "portbench_counts_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.count


def stages(root=HERE):
    """{stage name: count function} of every ``stage_*.py``."""
    return {os.path.basename(p)[6:-3]: _load(p)
            for p in sorted(glob.glob(os.path.join(root, "stage_*.py")))}


def kernel(name, root=HERE):
    """The count function of kernel `name` (``kernel_<name>.py``) or
    None."""
    path = os.path.join(root, f"kernel_{name}.py")
    return _load(path) if os.path.isfile(path) else None


def least_seconds(work, peaks):
    """The least time of `work` on a device of `peaks` ({"hbm_bytes_per_s",
    "f32", "bf16"} per second): the larger of bytes over the memory rate
    and operations over the peak of their type."""
    return max(work["bytes"] / peaks["hbm_bytes_per_s"],
               work["ops"] / peaks[work["peak"]])
