"""The benchmark of the PyTorch and CUDA port (``videoloop3d_torch``).

    python portbench/run.py --workload <name> --seed <n> --seconds <s>
                            --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the first CUDA device: set-up
(the program's stage-2 trainer at the cell's level, its first steps from
the seed, every step shape warmed), a closed-loop window of `--seconds`
seconds, then the check that decides ``correct`` (the first steps against
the plain reference).  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; last comes
``checks``, each compared number with its limit, which also end the
standard error.

A cell is found by name: its configuration ``configs/<config>.json``,
its traffic mix ``traffic/<traffic>.json``, its limits
``limits/<workload>.json``; each per-layer metric ``metrics/<name>.py``;
each stage's and kernel's work ``counts/``.  Exit codes: 0 with a result;
2 without a CUDA device, with too few, or without the program; 3 when
JAX or the JAX package was loaded.
"""
from __future__ import annotations

import os
import time

T_START = time.perf_counter()
# one process with one host thread a pool: host-paced steps vary less
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "videoloop3d_tpu")


def cell_spec(bench, workload, root=HERE):
    """(workload entry, configuration, traffic) of `workload`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    w = cells[workload]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(os.path.dirname(root), cfg["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    return w, config, traffic


def cell_metrics(bench, workload, traced):
    """The metrics the cell reports: its end-to-end ones untraced, its
    per-layer ones traced."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [workload])]


def loaded_forbidden():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def caches_in_checkout():
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its library into build/torch_kernels itself)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None, device=None, bench_path=None, root=HERE):
    """Run one cell.  `device` other than None (a test's "cpu") skips the
    look for a CUDA device; `bench_path` and `root` point a test at a copy
    of the benchmark."""
    a = parse(argv)
    with open(bench_path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    w, config, traffic = cell_spec(bench, a.workload, root)
    caches_in_checkout()
    import torch
    torch.set_num_threads(1)
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < w["chips"]:
            print(f"{w['chips']} CUDA devices needed, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
        device = "cuda:0"
    device = torch.device(device)
    try:
        import videoloop3d_torch
    except ImportError as e:
        print(f"the program is missing: {e}", file=sys.stderr)
        return 2
    from portbench import correct, window
    from portbench.system import System

    t_sys = time.perf_counter()
    system = System(config, traffic, a.seed, device)
    t_prime = time.perf_counter()
    prog, compared, _ = window.prime(system, traffic)
    setup_s = time.perf_counter() - T_START
    parts = ", ".join(f"{k} {v:.1f} s" for k, v in system.setup_s.items())
    print(f"[portbench] set-up: imports {t_sys - T_START:.1f} s, {parts}, "
          f"first steps {setup_s - (t_prime - T_START):.1f} s",
          file=sys.stderr)
    if a.trace:
        win = window.measure_traced(system, a.seconds,
                                    int(traffic["trace_steps"]))
        n_steps = len(win["traced"]) + win["rest_steps"]
    else:
        n_steps, win_s = window.measure(system, a.seconds)
    cuda = device.type == "cuda"
    mem_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    bad = loaded_forbidden()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    failed = system.failed_reads
    system.free()
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    metrics, dev = {}, {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": 1, "memory_peak_bytes": int(mem_peak)}
    extra = {}
    if a.trace:
        metrics, dev_t, extra = traced_metrics(bench, a.workload, config,
                                               traffic, win, device, root)
        dev.update(dev_t)
    else:
        values = {"setup_s": setup_s, "step_ms": win_s * 1e3 / n_steps,
                  "peak_mem_gib": mem_peak / 2 ** 30}
        for m in cell_metrics(bench, a.workload, False):
            # a cell's own end-to-end metric (step_ms.<config>) reads its
            # base quantity
            v = values.get(m["name"], values.get(m["name"].split(".")[0]))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    t_ref = time.perf_counter()
    refr = correct.reference_readings(config, traffic, a.seed, compared,
                                      device)
    print(f"[portbench] reference: {time.perf_counter() - t_ref:.1f} s",
          file=sys.stderr)
    values = correct.numbers(prog, refr)
    ok, rows = correct.judge(values, correct.load_limits(root, a.workload))
    checks = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    for k, v, lim in rows:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    out = {"correct": bool(ok), "attempted": n_steps, "failed": failed,
           "metrics": metrics, "device": dev, **extra,
           "program": prog, "reference": {k: refr[k] for k in
                                          ("losses", "grad_norms",
                                           "change_norms", "slots")},
           "checks": checks}
    print(json.dumps(out))
    return 0


def traced_metrics(bench, workload, config, traffic, win, device, root):
    """(per-layer metrics, device keys, {"breakdown"}) of a traced run."""
    from portbench import metrics as readers
    from portbench.shapes import Shapes
    from portbench.trace import Trace
    import videoloop3d_torch
    import types
    trace = None
    if device.type == "cuda":
        trace = Trace(win["profiler"], win["traced_s"], len(win["traced"]),
                      os.path.dirname(videoloop3d_torch.__file__))
    shapes = Shapes(config, traffic, device)
    steps = [shapes.of(b) for b in win["traced"]]
    with open(os.path.join(root, "peaks.json")) as f:
        peaks = json.load(f)["devices"]
    kind = None
    if device.type == "cuda":
        import torch
        kind = torch.cuda.get_device_name(device)
    ctx = types.SimpleNamespace(trace=trace, steps=steps, rest=win,
                                peaks=peaks.get(kind), config=config)
    out = {}
    for m in cell_metrics(bench, workload, True):
        read = readers.reader(m["name"], os.path.join(root, "metrics"))
        v = None if read is None else read(ctx)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    dev, extra = {}, {}
    if trace is not None:
        dev = {"busy_s": trace.busy_s, "window_s": trace.window_s}
        extra["breakdown"] = trace.breakdown()
    return out, dev, extra


if __name__ == "__main__":
    sys.exit(main())
