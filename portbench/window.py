"""Set-up's first steps and the measured window.

`prime` drives the program from the seed through its first steps (the
ones the reference follows), then on until every loss config of the cell
has run `warm_per_loss_config` times, so that no step shape is first met
inside the window.  `measure` runs the closed loop for the window's
seconds and ends it with a synchronize: step time is the window's time
over all its steps.  `measure_traced` runs the window untraced with a
CUDA event at each step's start and the host time of each step call,
then traces a fixed number of steps more under ``torch.profiler``.
"""
from __future__ import annotations

import collections
import time

import torch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _norm(t):
    return float(torch.linalg.vector_norm(t.detach().double()))


def prime(system, traffic):
    """Returns (the program's readings {"losses", "grad_norms",
    "change_norms"}, the compared steps' descriptions, steps taken)."""
    n_cmp = int(traffic["compared_steps"])
    start = {k: v.detach().clone() for k, v in system.leaves().items()}
    compared, losses, grad_norms = [], [], None
    for i in range(n_cmp):
        b = system.next_batch()
        losses.append(system.run(b)["loss"])
        compared.append(b)
        if i == 0:
            grad_norms = {k: _norm(g)
                          for k, g in system.first_gradient().items()}
    change = {k: _norm(v - start[k]) for k, v in system.leaves().items()}
    del start
    seen = collections.Counter(b.key for b in compared)
    taken = n_cmp
    warm = int(traffic["warm_per_loss_config"])
    while any(seen[k] < warm for k in system.steps):
        b = system.next_batch()
        system.run(b)
        seen[b.key] += 1
        taken += 1
    _sync(system.device)
    system.failed_reads = 0
    readings = {"losses": [float(v) for v in losses],
                "grad_norms": grad_norms, "change_norms": change}
    return readings, compared, taken


def measure(system, seconds):
    """The untraced window: (steps, seconds)."""
    _sync(system.device)
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        system.run(system.next_batch())
        n += 1
    _sync(system.device)
    return n, time.perf_counter() - t0


def measure_traced(system, seconds, trace_steps):
    """The traced run's window: `seconds` untraced, with a CUDA event at
    each step's start and the host time of each step call, then
    `trace_steps` more steps under ``torch.profiler``.  Returns a dict:
    for the untraced part its step-start intervals (ms), the host ms of
    each call, its steps and seconds; the profiler, the traced steps'
    descriptions and the traced part's host seconds."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = system.device.type == "cuda"
    events, enqueue_ms = [], []
    _sync(system.device)
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds or n < 2:
        ev = None
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        b = system.next_batch()
        t = time.perf_counter()
        system.run(b)
        enqueue_ms.append((time.perf_counter() - t) * 1e3)
        events.append(ev)
        n += 1
    end = None
    if cuda:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
    _sync(system.device)
    rest_s = time.perf_counter() - t0
    intervals = []
    if cuda:
        marks = events + [end]
        intervals = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    traced = []
    with profile(activities=acts) as prof:
        t1 = time.perf_counter()
        while len(traced) < trace_steps:
            b = system.next_batch()
            with record_function("portbench.step"):
                system.run(b)
            traced.append(b)
        _sync(system.device)
        traced_s = time.perf_counter() - t1
    return {"profiler": prof, "traced": traced, "traced_s": traced_s,
            "intervals_ms": intervals, "enqueue_ms": enqueue_ms,
            "rest_steps": n, "rest_s": rest_s}
