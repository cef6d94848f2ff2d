"""Shared trainer utilities (counterpart of
``videoloop3d_tpu/train/common.py``): losses and the scale-invariant
gain, intrinsic jitter, the sparse-phase flags, run snapshots, JSONL
metrics, step timing and profiling, and the failure handling (graceful
shutdown, hang watchdog).
"""
from __future__ import annotations

import json
import math
import os
import shutil
import signal
import sys
import threading
import time

import numpy as np
import torch

from videoloop3d_torch.config import args_to_string


def mse(x, y):
    return torch.mean((x - y) ** 2)


def mse_to_psnr(v):
    return -10.0 * torch.log(v) / math.log(10.0)


def scale_invariant_gain(gt, render):
    """Global gain aligning render brightness to the ground truth, damped
    toward 1.  Parity: ref train_3d.py:216-219 / MPV.py:499-504."""
    scale = torch.exp(torch.mean(torch.log((gt + 0.01) / (render + 0.01))))
    return (scale + 3.0) / 4.0


def jitter_intrinsic(intrin, rng: np.random.Generator):
    """+-0.5 px principal-point jitter on the host (ref train_3d.py:194-197,
    anti-tiling)."""
    out = np.array(intrin, copy=True)
    out[..., :2, 2] += rng.random(2) - 0.5
    return out


def set_sparse_fastpath_bounds(model, args, tag, fast_grad_flag=None):
    """Counterpart of the JAX package's post-cull bound setup for
    ``--compact_tiles`` and ``--blocked_lookup``.  Those flags plan TPU
    work the port's kernels do not do: K1 reads the tile map directly,
    and K9/K10 scatter each sample with no per-tile window or active-tile
    bound.  They are accepted and change nothing; a sparse model prints
    one line that says so when either is set.

    fast_grad_flag names the trainer's per-tile-adjoint flag (stage 2:
    ``fast_stage2_grad``).  The port's tile gradients always take that
    route's rounding (f32 sums, one rounding to the texel dtype), never
    the bf16 scatter-add of the JAX package's autodiff route; a sparse
    model prints one line that says so."""
    flags = [f"--{k}" for k in ("compact_tiles", "blocked_lookup")
             if getattr(args, k, False)]
    if model.is_sparse and flags:
        print(f"{tag} {' and '.join(flags)}: no effect in the port (K1 "
              "reads the tile map directly; K9/K10 need no tile window or "
              "active-tile bound)")
    if model.is_sparse and fast_grad_flag:
        state = "set" if getattr(args, fast_grad_flag, False) else "not set"
        print(f"{tag} --{fast_grad_flag} {state}: the port's K9/K10 tile "
              "gradients always sum in f32 and round once to the texel "
              "dtype (the per-tile adjoint's rounding), never a bf16 "
              "scatter-add")


def extra_loss_weights(args, extras_keys):
    """Reflection over <name>_loss_weight flags (ref train_3d.py:224-228)."""
    return {k: float(getattr(args, f"{k}_loss_weight", 0.0))
            for k in extras_keys}


def snapshot_run(expdir, expname, args):
    """Persist the args, the config files and the package version
    (ref train_3d.py:133-150)."""
    run_dir = os.path.join(expdir, expname, f"source_{int(time.time())}")
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "args.txt"), "w") as f:
        f.write(args_to_string(args))
    for attr, name in (("config", "config.txt"), ("config1", "config1.txt")):
        path = getattr(args, attr, "")
        if path and os.path.exists(path):
            shutil.copyfile(path, os.path.join(run_dir, name))
    import videoloop3d_torch
    with open(os.path.join(run_dir, "version.json"), "w") as f:
        json.dump({"videoloop3d_torch": videoloop3d_torch.__version__}, f)
    return run_dir


class MetricsLogger:
    """Scalars appended to ``<logdir>/metrics.jsonl``, one JSON object
    {"tag", "value", "step"} per line.  enabled=False (a rank other than
    0 of a multi-process run) writes nothing."""

    def __init__(self, logdir, enabled=True):
        self._jsonl = None
        if enabled:
            os.makedirs(logdir, exist_ok=True)
            self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def scalar(self, tag, value, step):
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step)})
                + "\n")

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()


class Profiler:
    """Step timing, plus a ``torch.profiler`` trace over the
    ``--profile_steps start:stop`` window (written as a Chrome trace to
    ``--profile_dir`` or ``<rundir>/profile``).

    `tick()` ends a step.  The host clock gives the rolling steps/sec of
    the logs.  On a CUDA device every tick also records a CUDA event on
    the current stream: the time between two events is the step's
    period on the device timeline (its kernels plus any wait for the
    host), read after the run by `warm_step_ms` without adding a
    synchronization to the loop.
    """

    def __init__(self, args, rundir, device):
        self.window = None
        if getattr(args, "profile_steps", ""):
            a, b = args.profile_steps.split(":")
            self.window = (int(a), int(b))
            self.outdir = getattr(args, "profile_dir", "") or \
                os.path.join(rundir, "profile")
        self._cuda = torch.device(device).type == "cuda"
        self._prof = None
        self._times = []
        self._last = None
        self._events = []

    def step(self, step_idx):
        if self.window is None:
            return
        if step_idx == self.window[0] and self._prof is None:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self._cuda else [])
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        elif step_idx >= self.window[1] and self._prof is not None:
            self._stop_trace()

    def _stop_trace(self):
        self._prof.__exit__(None, None, None)
        os.makedirs(self.outdir, exist_ok=True)
        path = os.path.join(self.outdir, "trace.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        print(f"[profile] trace written to {path}")

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > 100:
                self._times.pop(0)
        self._last = now
        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._events.append(ev)

    def reset_timing(self):
        """Start the step timing anew (a new training phase)."""
        self._times, self._events, self._last = [], [], None

    def steps_per_sec(self):
        if not self._times:
            return 0.0
        return 1.0 / (sum(self._times) / len(self._times))

    def warm_step_ms(self):
        """Mean step period in ms over the steps after the first two
        (device timeline on CUDA, the last 100 on the host clock
        otherwise); None when fewer than two warm steps were taken."""
        if self._cuda:
            ev = self._events[2:]
            if len(ev) < 2:
                return None
            ev[-1].synchronize()
            return ev[0].elapsed_time(ev[-1]) / (len(ev) - 1)
        return None if not self._times else \
            1e3 * sum(self._times) / len(self._times)

    def close(self):
        if self._prof is not None:
            self._stop_trace()


class GracefulShutdown:
    """SIGTERM -> checkpoint-and-exit at the next safe point.

    The handler only sets a flag; the trainer polls it after each
    optimizer step and then writes a checkpoint whose epoch metadata makes
    the auto-resume re-run the interrupted epoch.  Handler installation is
    skipped off the main thread (``signal.signal`` raises there).
    """

    EXIT_CODE = 75        # EX_TEMPFAIL: the run can resume

    def __init__(self):
        self.requested = False
        self._prev = None
        self._installed = False
        try:
            self._prev = signal.signal(signal.SIGTERM, self._handler)
            self._installed = True
        except ValueError:     # not the main thread
            pass

    def _handler(self, signum, frame):
        self.requested = True
        # os.write, not print(): the handler can interrupt a print that
        # holds the stdout buffer lock
        os.write(2, b"[shutdown] SIGTERM received - checkpointing and "
                    b"exiting at the next safe point\n")

    def restore(self):
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev or signal.SIG_DFL)
            self._installed = False


class HangWatchdog:
    """Turns a silent hang into a fast, visible failure: a daemon thread
    watches the step heartbeat, and ``timeout_s`` seconds without a
    `tick()` print a diagnosis and exit the process with code 42, so a
    scheduler restarts it and the auto-resume continues from the newest
    checkpoint.  0 disables it."""

    EXIT_CODE = 42

    def __init__(self, timeout_s, context="", action=None):
        self.timeout_s = float(timeout_s or 0)
        self.context = context
        self._action = action or self._default_action
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = None
        if self.timeout_s > 0:
            self._thread = threading.Thread(
                target=self._run, name=f"hang-watchdog-{context}",
                daemon=True)
            self._thread.start()

    def tick(self):
        self._last = time.monotonic()

    def _run(self):
        poll = min(5.0, self.timeout_s / 4)
        while not self._stop.wait(poll):
            idle = time.monotonic() - self._last
            if idle > self.timeout_s:
                self._action(idle)
                return

    def _default_action(self, idle):
        print(f"[watchdog] {self.context}: no step progress for "
              f"{idle:.0f}s (> --hang_timeout {self.timeout_s:.0f}s); "
              f"exiting {self.EXIT_CODE} for a restart + auto-resume",
              file=sys.stderr, flush=True)
        os._exit(self.EXIT_CODE)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
