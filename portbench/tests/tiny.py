"""A tiny copy of the benchmark for CPU tests: every configuration cut to
a 36 x 64 scene of 8 planes and 6 frames, 4 views, the level's patches
18 x 32; the program runs its plain versions on the CPU."""
from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

TINY_SCENE = {"H": 36, "W": 64, "frames": 6, "planes": 16, "verts_h": 10,
              "verts_w": 17, "views": 4, "test_view": 1, "ref_views": [2],
              "rig_step": 0.03}
TINY_ARGS = {"patch_h_size": 18, "patch_h_stride": 9, "patch_w_size": 32,
             "patch_w_stride": 16, "pyr_minimal_dim": 7, "mpv_frm_num": 6,
             "test_view_idx": "1", "loss_ref_idx": "2"}


def tiny_copy(dst, limits=None):
    """Copy the benchmark (BENCHMARK.json and portbench/) under dst with
    every configuration made tiny; `limits` ({workload: {number: limit}})
    written as the cells' limits files.  Returns (bench path, copy's
    portbench dir)."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    pb = os.path.join(dst, "portbench")
    shutil.copytree(BENCH, pb, ignore=shutil.ignore_patterns("__pycache__"))
    for name in os.listdir(os.path.join(pb, "configs")):
        path = os.path.join(pb, "configs", name)
        with open(path) as f:
            cfg = json.load(f)
        cfg["scene"].update(TINY_SCENE)
        cfg["args"].update(TINY_ARGS)
        with open(path, "w") as f:
            json.dump(cfg, f)
    for w, lim in (limits or {}).items():
        with open(os.path.join(pb, "limits", f"{w}.json"), "w") as f:
            json.dump({"limits": lim}, f)
    return os.path.join(dst, "BENCHMARK.json"), pb
