"""Reduce a ``torch.profiler`` trace of the traced steps to what the
per-layer readers need: each device operation (kernel, copy, fill) with
its port kernel number and layer, the device ranges of Adam's step, the
busy time and the idle gaps labelled by the host operation that was
running.

Kernel names map to the port's kernel numbers and layers through
``kernel_table.json``.  The port's kernel names are read from its CUDA
sources; one the table lacks is reported on standard error and counted
under "unmapped", never dropped.  A binned tile-gradient pipeline (a
``tiles_key_kernel`` up to its ``tiles_grad_gather_kernel``) is K9's when
it zero-fills by rows, and K10's otherwise.
"""
from __future__ import annotations

import bisect
import collections
import glob
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ADAM_RANGE = "Optimizer.step#Adam.step"


def base_name(name):
    """A device operation's function name without return type, namespaces,
    template arguments and parameters."""
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    cuts = [i for i in (n.find("("), n.find("<")) if i > 0]
    if cuts:
        n = n[:min(cuts)]
    return n.split("::")[-1].strip()


def port_kernel_names(package_dir):
    """The kernel function names of the port's CUDA sources."""
    names = set()
    for p in glob.glob(os.path.join(package_dir, "csrc", "*.cu*")):
        with open(p) as f:
            names |= set(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                r"(\w+)\s*\(", f.read()))
    return names


def load_table():
    with open(os.path.join(HERE, "kernel_table.json")) as f:
        return json.load(f)["kernels"]


class Trace:
    """The device timeline of the traced steps."""

    def __init__(self, prof, window_s, n_steps, package_dir):
        from torch.autograd import DeviceType
        table = load_table()
        port = port_kernel_names(package_dir)
        self.window_s, self.n_steps = window_s, n_steps
        ops, adam, cpu = [], [], []
        for e in prof.events():
            t0, t1 = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                if e.is_user_annotation:
                    if e.name == ADAM_RANGE:
                        adam.append((t0, t1))
                else:
                    ops.append([t0, t1, e.name])
            elif e.device_type == DeviceType.CPU:
                cpu.append((t0, t1, e.name))
        ops.sort()
        adam.sort()
        self.unmapped = collections.Counter()
        self.ops = []
        for t0, t1, name in ops:
            b = base_name(name)
            k, layer = table.get(b, (None, None))
            if k is None and b in port:
                self.unmapped[b] += 1
                k, layer = "unmapped", "unmapped"
            self.ops.append({"t0": t0, "t1": t1, "name": name, "base": b,
                             "k": k, "layer": layer,
                             "adam": _inside(adam, t0)})
        self._split_binned()
        for b, n in sorted(self.unmapped.items()):
            print(f"[portbench] port kernel {b} is not in kernel_table.json "
                  f"({n} launches traced)", file=sys.stderr)
        self.adam_ranges = adam
        self.cpu = sorted(cpu)
        self._busy()

    def _split_binned(self):
        """Give each binned tile-gradient pipeline's kernels K9 or K10."""
        run = None
        for op in self.ops:
            if op["base"] == "tiles_key_kernel":
                run = [op]
            elif run is not None and op["k"] in ("K9/K10", "K9/K10/K17",
                                                 "K9", "K10"):
                run.append(op)
                if op["base"] == "tiles_grad_gather_kernel":
                    rows = any(o["base"] == "tiles_zero_rows_kernel"
                               for o in run)
                    for o in run:
                        o["k"] = "K9" if rows else "K10"
                    run = None

    def _busy(self):
        merged = []
        for op in self.ops:
            if merged and op["t0"] <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], op["t1"])
            else:
                merged.append([op["t0"], op["t1"]])
        self.busy_s = sum(b - a for a, b in merged) / 1e6
        self.gaps = [(b0, a1) for (_, b0), (a1, _) in zip(merged, merged[1:])
                     if a1 > b0]

    def device_ms(self, pred):
        """Device ms of the operations for which pred(op) holds."""
        return sum(op["t1"] - op["t0"] for op in self.ops if pred(op)) / 1e3

    def per_step_ms(self, pred):
        return self.device_ms(pred) / max(self.n_steps, 1)

    def host_label(self, t):
        """The innermost host operation running at time t."""
        i = bisect.bisect_right(self.cpu, (t, float("inf"), ""))
        best = None
        for t0, t1, name in reversed(self.cpu[max(0, i - 400):i]):
            if t1 >= t and (best is None or t0 > best[0]):
                best = (t0, name)
        return best[1] if best else "host idle"

    def breakdown(self, top=10):
        """{"device_ops": [[name, s]], "idle_gaps": [[host op, s]]}: the
        device operations that took most time, and the idle gaps summed
        by what the host was doing (the longest 500 gaps labelled)."""
        by_op = collections.Counter()
        for op in self.ops:
            by_op[op["base"]] += (op["t1"] - op["t0"]) / 1e6
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:500]
        by_host = collections.Counter()
        for a, b in gaps:
            by_host[self.host_label((a + b) / 2)] += (b - a) / 1e6
        return {"device_ops": [[k, v] for k, v in by_op.most_common(top)],
                "idle_gaps": [[k, v] for k, v in by_host.most_common(top)]}


def _inside(ranges, t):
    i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
    return i >= 0 and ranges[i][0] <= t <= ranges[i][1]
