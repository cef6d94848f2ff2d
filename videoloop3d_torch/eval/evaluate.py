"""Test-view evaluation, the metric suite of the reference evaluator
(counterpart of ``videoloop3d_tpu/eval/evaluate.py``; ref
script_evaluate_ours.py:33-306): renders every test view over the whole
loop, center-crops 40 px, and computes masked static PSNR/SSIM, the
dynamics (std-map) error, LPIPS and sliding-window LPIPS (when weights are
available), Loop Quality and NNMSE completeness/coherence at 3 patch
scales and optionally SVFID; writes ``eval_metrics.txt`` with the same
column layout.

The render (K1-K4, or K16 for a dense checkpoint), LPIPS, SVFID's C3D and
the NN searches (K18/K19) run on `device`; PSNR, SSIM, the loop masks and
the dynamics error are float64 numpy on the host, as in the JAX package.
The seconds each metric group took are printed as one JSON line.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

from videoloop3d_torch.core import cameras
from videoloop3d_torch.data import llff
from videoloop3d_torch.data.loopmask import compute_loopable_mask
from videoloop3d_torch.data.video import to8b
from videoloop3d_torch.eval import metrics as M
from videoloop3d_torch.eval import nnmse as NN
from videoloop3d_torch.eval.lpips import (
    LPIPS, compute_lpips, compute_lpips_slidewindow)
from videoloop3d_torch.models import checkpoint as ckpt_io
from videoloop3d_torch.models.mpv import MPMeshVid
from videoloop3d_torch.train.stage2 import render_eval

PATCH_SIZES = [5, 11, 17]
STRIDE_SIZES = [2, 4, 6]
PATCHT_SIZES = [7, 5, 3]
STRIDET_SIZES = [1, 1, 1]


def load_mpv_from_run(args, H, W, ref_extrin, ref_intrin, near, far,
                      ckpt_path=None, *, device):
    """Newest checkpoint of the run directory (or `ckpt_path`) restored
    into an `MPMeshVid` on `device`.  Returns (model, params, rundir,
    ckpt_path)."""
    expname = args.expname + args.expname_postfix
    rundir = os.path.join(args.prefix, args.expdir, expname)
    if ckpt_path is None:
        ckpt_path = ckpt_io.latest_checkpoint(rundir)
        if ckpt_path is None:
            raise FileNotFoundError(f"no checkpoints under {rundir}")
    model = MPMeshVid(args, H, W, ref_extrin, ref_intrin, near, far,
                      device=device)
    ckpt = ckpt_io.load_checkpoint(ckpt_path)
    params = model.init_from_stage1(ckpt) if ckpt["meta"]["stage"] == "mpi" \
        else model.restore_checkpoint(ckpt)
    return model, params, rundir, ckpt_path


def evaluate(args, crop=40, compute_flags=None, pred_dir=None, *, device):
    """Run the full evaluation; returns the per-view metric table.

    ``pred_dir`` scores externally rendered loops instead of rendering
    from a checkpoint: it must hold one ``view{v:02d}.npy`` uint8
    (F, H, W, 3) array per evaluated view index ``v`` (the ORIGINAL
    scene view index, i.e. ``test_view_idx`` numbering).  Both packages'
    renders then go through the same metric code (reference evaluator:
    scripts/script_evaluate_ours.py:33-306).  ``eval_metrics.txt`` is
    then written into ``pred_dir``.
    """
    flags = {"static": True, "dyn": True, "lpips": True, "nnmse": True,
             "loopq": True, "svfid": False}
    if compute_flags:
        flags.update(compute_flags)
    seconds = {}

    def timed(group, start):
        seconds[group] = time.perf_counter() - start

    datadir = os.path.join(args.prefix, args.datadir.rstrip("/\\"))
    if datadir.endswith("_loop"):
        datadir = datadir[:-5]
    t0 = time.perf_counter()
    videos, fps, scene = llff.load_mv_videos(
        basedir=datadir, factor=args.factor,
        bd_factor=(args.near_factor, args.far_factor), recenter=True)
    H, W = scene["hw"]
    V = len(videos)
    test_view = [int(t) for t in args.test_view_idx.split(",")] \
        if args.test_view_idx else list(range(V))
    videos = [np.asarray(videos[i]) for i in test_view]
    poses = scene["poses"][test_view]
    intrins = scene["intrins"][test_view]
    V = len(videos)

    loopmasks = [1.0 - compute_loopable_mask(v / 255).astype(np.float32)
                 for v in videos]
    timed("load", t0)

    t0 = time.perf_counter()
    if pred_dir is not None:
        rundir = pred_dir
        preds = []
        for tv in test_view:
            path = os.path.join(pred_dir, f"view{tv:02d}.npy")
            arr = np.load(path)
            if arr.shape[1:3] != (H, W):
                raise ValueError(f"{path}: shape {arr.shape} does not "
                                 f"match scene {H}x{W}")
            preds.append(arr.astype(np.uint8))
        print(f"[eval] scoring {len(preds)} pre-rendered views from "
              f"{pred_dir}")
    else:
        ref_pose = cameras.average_pose(poses)[:, :4]
        ref_extrin = cameras.pose_to_extrinsic(ref_pose)
        model, params, rundir, ckpt_path = load_mpv_from_run(
            args, H, W, ref_extrin, intrins[0],
            float(scene["bds"].min()), float(scene["bds"].max()),
            device=device)
        print(f"[eval] using checkpoint {ckpt_path}")

        extrins = cameras.pose_to_extrinsic(poses)
        preds = []
        for vi in range(V):
            frames = render_eval(model, params, H, W,
                                 extrins[vi:vi + 1], intrins[vi:vi + 1],
                                 np.arange(model.frm_num), chunk=2)
            preds.append(to8b(frames))
        del model, params
    timed("render", t0)

    # center-crop 40px like the reference, but clamp for small scenes
    crop = max(0, min(crop, H // 4, W // 4))
    if crop > 0:
        videos = [v[:, crop:-crop, crop:-crop] for v in videos]
        preds = [p[:, crop:-crop, crop:-crop] for p in preds]
        loopmasks = [m[crop:-crop, crop:-crop] for m in loopmasks]

    static_psnr, static_ssim, dyns = [0.0] * V, [1.0] * V, [0.0] * V
    # Metrics that were skipped or whose pretrained weights are
    # unavailable are reported as NaN, NOT 0.0 - a 0.0 LPIPS would be
    # indistinguishable from a perfect score in the CSV.
    lpips_v, lpips_sw = [float("nan")] * V, [float("nan")] * V

    full_psnr, full_ssim = [float("nan")] * V, [float("nan")] * V
    if flags["static"]:
        t0 = time.perf_counter()
        static_psnr, static_ssim = [], []
        full_psnr, full_ssim = [], []
        for vi in range(V):
            gt, pr = videos[vi], preds[vi]
            f = min(len(gt), len(pr))
            gt01, pr01 = gt[:f] / 255.0, pr[:f] / 255.0
            mask = loopmasks[vi][None]
            static_psnr.append(M.compute_img_metric(gt01, pr01, "psnr",
                                                    mask))
            static_ssim.append(M.compute_img_metric(gt01, pr01, "ssim",
                                                    mask))
            # Full-frame (unmasked) PSNR/SSIM as extra trailing columns:
            # on fully dynamic scenes the loopable mask covers everything
            # and the masked static PSNR degenerates to -inf/NaN; these
            # columns keep such scenes comparable.
            full_psnr.append(M.compute_img_metric(gt01, pr01, "psnr"))
            full_ssim.append(M.compute_img_metric(gt01, pr01, "ssim"))
        timed("static", t0)
    if flags["dyn"]:
        t0 = time.perf_counter()
        dyns = [M.dynamics_error(videos[vi], preds[vi]) for vi in range(V)]
        timed("dyn", t0)

    svfids = [float("nan")] * V
    if flags.get("svfid"):
        from videoloop3d_torch.eval.svfid import C3DFeatures, svfid
        t0 = time.perf_counter()
        c3d = C3DFeatures(device=device)
        if c3d.available:
            svfids = [svfid(c3d, videos[vi].astype(np.float32),
                            preds[vi].astype(np.float32))
                      for vi in range(V)]
            print(f"[eval] svfid: {svfids}")
        else:
            print("[eval] C3D weights unavailable - SVFID = NaN")
        timed("svfid", t0)

    if flags["lpips"]:
        t0 = time.perf_counter()
        net = LPIPS(device=device)
        if net.available:
            lpips_v = [compute_lpips(net, preds[vi].astype(np.float32),
                                     videos[vi].astype(np.float32))
                       for vi in range(V)]
            lpips_sw = [compute_lpips_slidewindow(
                net, preds[vi].astype(np.float32),
                videos[vi].astype(np.float32)) for vi in range(V)]
        else:
            print("[eval] LPIPS weights unavailable - reporting NaN")
        timed("lpips", t0)

    def to_cfhw(v):
        return np.moveaxis(v.astype(np.float32), -1, 0)

    # drop patch scales that do not fit the clip (tiny test scenes)
    min_frames = min(min(len(v) for v in videos),
                     min(len(p) for p in preds))
    min_dim = min(videos[0].shape[1], videos[0].shape[2])
    scales = [t for t in zip(PATCH_SIZES, STRIDE_SIZES, PATCHT_SIZES,
                             STRIDET_SIZES)
              if t[2] <= min_frames and t[0] <= min_dim]
    if len(scales) < len(PATCH_SIZES):
        print(f"[eval] clip too small for some patch scales; using "
              f"{scales}")
    patch_sizes = [t[0] for t in scales]
    loop_q = [[0.0] * len(scales)] * V
    nn_fwd = [[0.0] * len(scales)] * V
    nn_bwd = [[0.0] * len(scales)] * V

    if flags["loopq"]:
        t0 = time.perf_counter()
        loop_q = [[NN.loop_quality(to_cfhw(preds[vi]), to_cfhw(videos[vi]),
                                   p, s, pt, st, device=device)
                   for p, s, pt, st in scales] for vi in range(V)]
        timed("loopq", t0)
    if flags["nnmse"]:
        t0 = time.perf_counter()
        nn_fwd, nn_bwd = [], []
        for vi in range(V):
            pairs = [NN.compute_nnerr_pair(to_cfhw(videos[vi]),
                                           to_cfhw(preds[vi]), p, s, pt, st,
                                           device=device)
                     for p, s, pt, st in scales]
            nn_fwd.append([f for f, _ in pairs])
            nn_bwd.append([b for _, b in pairs])
        timed("nnmse", t0)

    # write eval_metrics.txt (ref :248-295 column layout)
    mean = lambda x: sum(x) / len(x) if len(x) else 0.0  # noqa: E731
    tags = [f"p{p}s{s}pt{pt}st{st}" for p, s, pt, st in scales]
    names = (["name", "nnf", "nnb", "dyn", "lpips", "lpips_sw", "loop",
              "psnr", "ssim"]
             + [f"nnf_{t}" for t in tags] + [f"nnb_{t}" for t in tags]
             + [f"loop_{t}" for t in tags] + ["psnr_full", "ssim_full"])
    dataname = os.path.basename(datadir)
    out_path = os.path.join(rundir, "eval_metrics.txt")
    with open(out_path, "w") as f:
        f.write(", ".join(names) + "\n")
        for vi in range(V):
            row = [mean(nn_fwd[vi]), mean(nn_bwd[vi]), dyns[vi],
                   lpips_v[vi], lpips_sw[vi], mean(loop_q[vi]),
                   static_psnr[vi], static_ssim[vi]]
            f.write(f"{dataname}_view{vi}, "
                    + ", ".join(map(str, row)) + ", "
                    + ", ".join(map(str, nn_fwd[vi])) + ", "
                    + ", ".join(map(str, nn_bwd[vi])) + ", "
                    + ", ".join(map(str, loop_q[vi])) + ", "
                    + f"{full_psnr[vi]}, {full_ssim[vi]}\n")
        agg = [mean([mean(r) for r in nn_fwd]),
               mean([mean(r) for r in nn_bwd]),
               mean(dyns), mean(lpips_v), mean(lpips_sw),
               mean([mean(r) for r in loop_q]),
               mean(static_psnr), mean(static_ssim)]
        per_scale = lambda rows: [mean([r[i] for r in rows])  # noqa: E731
                                  for i in range(len(patch_sizes))]
        f.write(f"{dataname}, " + ", ".join(map(str, agg)) + ", "
                + ", ".join(map(str, per_scale(nn_fwd))) + ", "
                + ", ".join(map(str, per_scale(nn_bwd))) + ", "
                + ", ".join(map(str, per_scale(loop_q))) + ", "
                + f"{mean(full_psnr)}, {mean(full_ssim)}\n")
    print(f"[eval] wrote {out_path}")
    print("[eval] " + json.dumps({"seconds": seconds}))
    return {"psnr": static_psnr, "ssim": static_ssim, "dyn": dyns,
            "psnr_full": full_psnr, "ssim_full": full_ssim,
            "lpips": lpips_v, "lpips_sw": lpips_sw, "loopq": loop_q,
            "nnf": nn_fwd, "nnb": nn_bwd, "svfid": svfids,
            "path": out_path}
