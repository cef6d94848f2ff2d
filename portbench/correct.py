"""What decides ``correct``: the program's first steps against the plain
reference's (``reference/stage2.py``) on the same inputs.

The program's readings come from set-up (``window.prime``): each step's
loss, the first gradient of each leaf as Adam got it (from its first
moment), and the norm of each leaf's change over the compared steps.
The reference makes the same inputs again from the seed, works out the
level's grid, slot bound, crops and learning rates itself, and follows
the same steps.  Three numbers are compared, each with its own limit:

* ``loss_gap``: the largest |program - reference| / |reference| of the
  steps' losses;
* ``grad_gap``: over the leaves, the largest gap between the program's
  and the reference's norm of the first gradient, over the reference's
  norm of that leaf or of the median leaf, whichever is larger;
* ``change_gap``: the same for the norm of each leaf's change.

Leaves whose reference gradient norm is under a thousandth of the median
leaf's move by round-off alone under Adam; they are left out of the
change.  The limits live in ``limits/<workload>.json``.
"""
from __future__ import annotations

import json
import os
import statistics

import numpy as np
import torch

from portbench import scene as scene_mod
from portbench.reference import stage2 as ref

NUMBERS = ("loss_gap", "grad_gap", "change_gap")


def level_grid(args, H, W, level):
    """The level's (h, w) and the pad that makes the patch grid tile it."""
    num = int(np.log(args["pyr_minimal_dim"] / min(H, W))
              / np.log(args["pyr_factor"])) + 1
    f = args["pyr_factor"] ** (num - 1 - level)
    h, w = int(H * f), int(W * f)
    ph, pw = args["patch_h_size"], args["patch_w_size"]
    if h * w < ph * pw:
        return (h, w), (0, 0), (h, w), 1
    sh, sw = args["patch_h_stride"], args["patch_w_stride"]
    hs = np.arange(0, h - ph + sh, sh)
    ws = np.arange(0, w - pw + sw, sw)
    return (h, w), (int(hs.max() + ph - h), int(ws.max() + pw - w)), \
        (ph, pw), len(hs) * len(ws)


def loss_config(args, ref_view):
    sfx = "_ref" if ref_view else ""
    return {"patch_size": args[f"swd_patch_size{sfx}"],
            "patcht_size": args[f"swd_patcht_size{sfx}"],
            "stride": args[f"swd_stride{sfx}"],
            "stridet": args[f"swd_stridet{sfx}"],
            "alpha": args[f"swd_alpha{sfx}"], "rou": args[f"swd_rou{sfx}"],
            "scaling": args[f"swd_scaling{sfx}"],
            "macro_block": args["swd_macro_block"],
            "loss_gain": args["swd_loss_gain_ref"] if ref_view else 1.0}


def reference_inputs(config, traffic, seed, compared, device):
    """The reference's inputs of the compared steps (descriptions with
    view, h0, w0, jitter, epoch), made anew from the seed: (params, geom,
    maps, slot bound, batches, render config)."""
    sc, args = config["scene"], config["args"]
    H, W = sc["H"], sc["W"]
    geom = ref.geometry(sc)
    tm_s, tm_d = scene_mod.tile_layout(sc)
    maps = tuple(torch.as_tensor(m, device=device) for m in (tm_s, tm_d))
    poses, intrins = scene_mod.rig(sc)
    views, is_ref = scene_mod.train_views(sc)
    (h, w), pad, patch, per_view = level_grid(args, H, W, traffic["level"])
    intr = intrins[views].astype(np.float32).copy()
    intr[:, 0] *= w / W
    intr[:, 1] *= h / H
    hom = np.zeros((len(views), 4, 4), np.float32)
    hom[:, :3] = poses[views]
    hom[:, 3, 3] = 1.0
    extr = np.linalg.inv(hom)
    n_slots = ref.slot_bound(geom, maps, extr, intr, h + pad[0], w + pad[1])
    params = scene_mod.texels(sc, int((tm_s >= 0).sum()),
                              int((tm_d >= 0).sum()), seed, device)
    vids = scene_mod.videos(sc, traffic["content"], len(views), seed, device)
    steps_in_epoch = len(views) * per_view
    weights = {k: args.get(f"{k}_loss_weight", 0) for k in
               ("rgb_smooth", "a_smooth")}
    cfg = {"decoder": sc["decoder"], "weights": weights, "patch": patch}
    ph, pw = patch
    batches = []
    for b in compared:
        K = intr[b.view].copy()
        K[0, 2] -= b.w0
        K[1, 2] -= b.h0
        K[:2, 2] += b.jitter
        crop = vids[b.view, :, b.h0:b.h0 + ph, b.w0:b.w0 + pw]
        lr = args["lrate"] * 0.1 ** (b.epoch / (args["lrate_decay"] * 1000.0))
        if args.get("lrate_adaptive"):
            lr = lr / steps_in_epoch
        batches.append({
            "extrin": torch.as_tensor(extr[b.view][None], device=device),
            "intrin": torch.as_tensor(K[None], device=device),
            "video": crop.float() / 255.0,
            "losscfg": loss_config(args, is_ref[b.view]), "lr": lr})
    return params, geom, maps, n_slots, batches, cfg


def reference_readings(config, traffic, seed, compared, device,
                       param_dtype=torch.float32):
    """The reference's readings of the compared steps; `param_dtype`
    below the configuration's float32 makes the control."""
    params, geom, maps, n_slots, batches, cfg = reference_inputs(
        config, traffic, seed, compared, device)
    losses, grads, change = ref.follow(params, geom, maps, n_slots, batches,
                                       cfg, param_dtype=param_dtype)
    return {"losses": losses, "grad_norms": grads, "change_norms": change,
            "slots": n_slots}


def numbers(prog, refr):
    """The compared numbers {name: value}."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["losses"], refr["losses"]))
    g_ref = refr["grad_norms"]
    med_g = statistics.median(g_ref.values())

    def worst(key, leaves):
        r = refr[key]
        med = statistics.median(r[k] for k in leaves)
        return max(abs(prog[key][k] - r[k]) / max(r[k], med, 1e-30)
                   for k in leaves)

    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * med_g]
    return {"loss_gap": loss_gap,
            "grad_gap": worst("grad_norms", list(g_ref)),
            "change_gap": worst("change_norms", moved)}


def load_limits(root, workload):
    path = os.path.join(root, "limits", f"{workload}.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)["limits"]


def judge(values, limits):
    """(correct, [(name, value, limit)]).  No limits file: not correct."""
    rows = [(k, values[k], None if limits is None else limits.get(k))
            for k in NUMBERS]
    ok = all(lim is not None and np.isfinite(v) and v <= lim
             for _, v, lim in rows)
    return ok, rows
