"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python portbench/calibrate.py --workload <name> --seeds 1,2,...
        [--control 3] [--faults 3] [--out file.jsonl]

For each seed, in one process: the program's first steps (set-up of a
run, no window) against the reference's, as a run compares them (the
sound readings), and the near ties of the first step's patch search:
how many of the reference's choices differ when its distances are
computed in float64 instead of float32.  For the first `--control`
seeds the control: the reference in the program's place with its
parameters (the atlases), float32 in the configuration, stored in
bfloat16 (each Adam update rounded to it).  For the first `--faults` seeds two faults planted in the
program: half the patch left out of the looping loss (its mean over the
rest), and a step that leaves the parameters unchanged.  One JSON line a
reading.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@contextlib.contextmanager
def half_patch_loss():
    """The looping loss over the left half of the patch only."""
    from videoloop3d_torch.losses import patch_nn as pnl
    saved = dict(pnl.LOSS_FNS)

    def cut(fn):
        def half(x, y, **kw):
            w = x.shape[3] // 2
            return fn(x[..., :w], y[..., :w], **kw)
        return half
    for k in list(pnl.LOSS_FNS):
        pnl.LOSS_FNS[k] = cut(saved[k])
    try:
        yield
    finally:
        pnl.LOSS_FNS.update(saved)


@contextlib.contextmanager
def frozen_state():
    """Every optimizer step returns the parameters unchanged."""
    import torch
    saved = torch.optim.Adam.step

    def step(self, closure=None):
        return None
    torch.optim.Adam.step = step
    try:
        yield
    finally:
        torch.optim.Adam.step = saved


def program_readings(config, traffic, seed, device, fault=None):
    """The program's readings and the compared steps of one seed."""
    import torch
    from portbench import window
    from portbench.system import System
    ctx = {"half_batch": half_patch_loss, "frozen": frozen_state}.get(
        fault, contextlib.nullcontext)
    with ctx():
        system = System(config, traffic, seed, device)
        readings, compared, _ = window.prime(system, traffic)
    system.free()
    del system
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return readings, compared


def near_ties(config, traffic, seed, compared, device):
    """(choices that differ between float32 and float64 distances, all
    choices) of the first compared step's search, on the reference's
    render."""
    import torch
    from portbench import correct
    from portbench.reference import stage2 as ref
    params, geom, maps, n_slots, batches, cfg = correct.reference_inputs(
        config, traffic, seed, compared[:1], device)
    b = batches[0]
    with torch.no_grad():
        rgb, _ = ref.render(params, geom, maps, n_slots, b["extrin"],
                            b["intrin"], *cfg["patch"], cfg)
        x, y = ref.loss_input(rgb, b["video"], b["losscfg"])
        a = ref.search_choices(x, y, b["losscfg"])
        c = ref.search_choices(x, y, b["losscfg"], dist_dtype=torch.float64)
    return (sum(int((p != q).sum()) for p, q in zip(a, c)),
            sum(p.numel() for p in a))


def readings(workload, seeds, n_control, n_faults, device, out, root=HERE,
             bench_path=None):
    """Write one JSON line a reading to `out` (a file object); returns the
    rows."""
    import torch
    from portbench import correct, run
    with open(bench_path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    _, config, traffic = run.cell_spec(bench, workload, root)
    rows = []

    def emit(kind, seed, prog, refr, **extra):
        row = {"workload": workload, "kind": kind, "seed": seed,
               **correct.numbers(prog, refr), **extra,
               "readings": {"program": prog, "reference": {
                   k: refr[k] for k in ("losses", "grad_norms",
                                        "change_norms")}}}
        rows.append(row)
        out.write(json.dumps(row) + "\n")
        out.flush()

    for i, seed in enumerate(seeds):
        prog, compared = program_readings(config, traffic, seed, device)
        refr = correct.reference_readings(config, traffic, seed, compared,
                                          device)
        ties, choices = near_ties(config, traffic, seed, compared, device)
        emit("sound", seed, prog, refr, near_ties=ties, choices=choices,
             first_step_ref_view=bool(compared[0].ref))
        if i < n_control:
            ctrl = correct.reference_readings(
                config, traffic, seed, compared, device,
                param_dtype=torch.bfloat16)
            emit("control_bf16_params", seed, ctrl, refr)
        if i < n_faults:
            for fault in ("half_batch", "frozen"):
                bad, _ = program_readings(config, traffic, seed, device,
                                          fault)
                emit(f"fault_{fault}", seed, bad, refr)
        del refr
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    out = open(a.out, "a") if a.out else sys.stdout
    try:
        readings(a.workload, seeds, a.control, a.faults, "cuda:0", out)
    finally:
        if a.out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
