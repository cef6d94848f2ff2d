#!/usr/bin/env python3
"""Smoke run of the PyTorch port (videoloop3d_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from videoloop3d_torch/csrc (kernels.build);
  3. build the production-width sparse MTV of the JAX package's benchmark
     (360x640 render, D=32, F=50, 35x63 tiles of 12x12 texels: 9,786
     static + 4,257 dynamic tiles, seed 0) and write it as an mpv
     checkpoint next to a synthetic LLFF scene with 360x640 .npy videos;
  4. hold each kernel against its plain PyTorch version on the card at the
     shapes of one fixed-view chunk of 10 frames, f32 and bf16 texels, and
     time both (CUDA events);
  5. render through ``videoloop3d_torch.tools.render_video.main`` (bf16
     texels, the shipped ``--fp16``): a fixed view over the whole 50-frame
     loop in chunks of 10, then a 10-pose spiral one frame per call, each
     with the launch counters set to 0 just before and read just after;
  6. check the frames (shape, not constant) and hold three of them
     against a render made of the plain versions on the card;
  7. profile one warm fixed-view chunk and one spiral frame
     (torch.profiler): device busy share and the largest device times;
  8. stage 1 at the shipped width (configs/mpi_base.txt: 360x640 scene,
     576x1024 texel planes, D=32, 180x320 patches, B=1): hold K5-K8
     against their plain versions on the card, time them (CUDA events)
     beside torch.nn.functional.grid_sample for K5/K6;
  9. train through ``videoloop3d_torch.tools.train_3d.main`` on a 360x640
     synthetic scene (3 views x 12 frames) for 2 epochs, once on the
     shipped route and once with ``--fused_render``, each with the launch
     counters set to 0 just before and read just after; check the loss,
     the PSNR, the checkpoint and the launches;
 10. hold one stage-1 step with the kernels against the same step made
     of the plain versions on the card (loss, metrics, gradients), and
     profile one warm step of each route;
 11. cull a synthesized shipped-width dense atlas (about 20% of the
     70,560 tiles kept, about 30% of them dynamic) through
     ``models/sparsify.py``, and hold K1, K2 and K9 against their plain
     versions on the card at the sparse step's shapes, timed (CUDA
     events) with their bounds;
 12. train the shipped route through the cull with
     ``videoloop3d_torch.tools.train_3d.main`` and ``--N_iters 3
     --sparsify_epoch 2`` (2 dense epochs, the cull at a threshold cut
     to 0.03, 1 sparse epoch) with the launch counters set to 0 just
     before and read just after: the cull line, K1/K2/K9 launched, finite
     losses and a sparse ``ckpt_epoch_0002.npz``; then ``--N_iters 4``
     must auto-resume from it;
 13. hold one sparse step with the kernels against the same step made of
     the plain versions, and profile one warm sparse step;
 14. stage 2 on the benchmark MTV of phase 3 at the shipped config
     (``configs/mpv_base.txt`` with ``--factor 1 --mpv_frm_num 50``;
     ``--fp16``), one 180x320 patch: hold K10 and K9 on bf16 tiles, and
     K11 and K12 for both loss configs with f32 and bf16 search inputs,
     against their plain versions, timed (CUDA events) with bounds and
     library times;
 15. the shipped route's kernels on the same patch at the slot bound S of
     that view (printed beside D): K13 against its plain version
     (exact), K14 and K15 (shipped flags, timed, and every flag on)
     against theirs, K14 and K15 rerun bit for bit, timed with bounds;
 16. hold one stage-2 step with the kernels against the same step made of
     the plain versions, on the shipped route (``--compact_hits
     --fused_render``) and on the unfused, uncompacted route, for a ref
     view (alpha 0) and an other view;
 17. profile one warm stage-2 step of each route (device time by group,
     busy share, peak memory);
 18. train through ``videoloop3d_torch.tools.train_3dvid.main`` on the
     unmodified ``configs/mpv_base.txt`` (``--factor 1 --mpv_frm_num 50``
     on the command line) from the phase-11 cull (written as a sparse
     stage-1 checkpoint with dynamic tiles) on a 360x640 synthetic scene
     of 3 views x 50 frames, ``--pyr_init_level 4 --pyr_num_epoch 1``
     (levels 4 and 5), with the launch counters set to 0 just before and
     read just after: the hit-compaction line of each level with S < D,
     K2, K3, K9-K15 launched once per step, K1 once per step and once per
     view and level for the slot bound, K4 never, finite losses; then
     ``--pyr_num_epoch 2`` must auto-resume at level 5, epoch 1;
 19. (with phase 14) K1 with uv-noise draws against its plain version, bit
     for bit, and without them still bit for bit;
 20. the dense stage-2 phase at the mpv_base scratch width (396x704
     texel planes, D=32, F=50): K16 and K17 against their plain versions
     on f32 and bf16 texels, at the training patch (all frames) and an
     eval chunk (the 360x640 view, 10 frames through ts), timed (CUDA
     events) with bounds and grid_sample as the library yardstick;
 21. one dense stage-2 step (ref view, --fp16) with the kernels against
     the same step made of the plain versions, once as shipped and once
     with ``--add_uv_noise --bg_color random`` and the same draws fed to
     both; no sparse-route kernel may run;
 22. profile one warm dense step (device time by group, busy share, peak
     memory);
 23. train through ``videoloop3d_torch.tools.train_3dvid.main`` from
     scratch (no ``--init_from``) on the unmodified
     ``configs/mpv_base.txt`` with ``--factor 1 --mpv_frm_num 50
     --pyr_init_level 4 --pyr_num_epoch 1`` on phase 18's scene, with the
     launch counters set to 0 just before and read just after: K16 and
     K17 once per step, no sparse-route kernel, falling finite losses, a
     dense stage-2 checkpoint (7 GB);
 24. render through ``videoloop3d_torch.tools.render_video.main`` the
     fixed view over 50 frames in chunks of 10 of (a) that dense mpv
     checkpoint and (b) phase 9's dense stage-1 checkpoint (576x1024
     texels, broadcast to 50 frames on the card: 3.77 G elements), each
     held against a render of the plain versions;
 25. hold K18 (the banded temporal-patch NN search) and K19 (its
     selected-patch error) against their plain versions at the eval's
     shapes: view 0 of phase 18's scene and evaluate's render of phase
     18's checkpoint, cropped to 280x560, 50 frames, at the three patch
     scales, the pair (both directions) and the Loop Quality seam; index
     flips only on near ties, K19 within 1e-6 relative on the same
     indices; timed (CUDA events) with bounds and library yardsticks;
 26. (with phases 16 and 18) K18 at the stage-2 search shapes (both loss
     configs, f32 and bf16), one shipped-route step with --fast_nn_dist
     against its plain composition, and ``train_3dvid --fast_nn_dist`` on
     phase 18's setup (levels 4 and 5, one epoch each): K18 once per
     step, K11 never;
 27. ``videoloop3d_torch.tools.evaluate.main`` on phase 18's sparse mpv
     checkpoint (3 views x 50 frames, 360x640) with seeded local alex
     LPIPS weights (VL3D_LPIPS_WEIGHTS), the launch counters set to 0 just
     before and read just after: K1-K4, K18, K19 launched, the JAX
     package's column list, finite values, the NN columns within 1e-3 of
     the plain versions' metrics, the seconds of each metric group;
 28. ``videoloop3d_torch.tools.export_mesh.main`` on the same checkpoint:
     2 faces per kept tile, the static atlas packing_grid x the tile
     size, 50 dynamic frames, meta.json's frame_count.

The last lines are the ``{"kernels": [...]}`` record, the nvidia-smi line
and ``{"ok": true, "device": {...}}``.  Exits non-zero without a result
when no CUDA device is available.  Writes only under build/chip_smoke.
"""
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_OPS_PER_S = 67e12            # f32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # bf16 tensor cores, f32 sums (dense)
SLEEP_CYCLES = 200_000_000       # ~0.1 s of device clock (cuda_ms)
CHUNK = 10
DEVICE = "cuda:0"                # the card the main path runs on
GPU_NUM = "1"                    # render_video's --gpu_num for DEVICE
REPLACES = {
    "warp_lookup": "videoloop3d_tpu/render/renderer.py:95",
    "bilinear_tiles": "videoloop3d_tpu/render/sample.py:72",
    "bilinear_tiles_tilemajor": "videoloop3d_tpu/render/sample.py:133",
    "composite": "videoloop3d_tpu/render/fused.py:109",
    "sample_dense": "videoloop3d_tpu/render/adjoint.py:366",
    "sample_dense_grad": "videoloop3d_tpu/render/adjoint.py:156",
    "fused_s1_fwd": "videoloop3d_tpu/render/fused_s1.py:90",
    "fused_s1_bwd": "videoloop3d_tpu/render/fused_s1.py:150",
    "bilinear_tiles_grad": "videoloop3d_tpu/render/adjoint.py:574",
    "bilinear_tiles_tilemajor_grad": "videoloop3d_tpu/render/adjoint.py:663",
    "nn_argmin": "videoloop3d_tpu/losses/patch_nn.py:274",
    "nn_fold": "videoloop3d_tpu/losses/patch_nn.py:219",
    "compact_sweep": "videoloop3d_tpu/render/compact.py:63",
    "fused_s2_fwd": "videoloop3d_tpu/render/fused.py:120",
    "fused_s2_bwd": "videoloop3d_tpu/render/fused.py:169",
    "bilinear_planes_tilemajor": "videoloop3d_tpu/render/sample.py:193",
    # JAX takes this gradient by autodiff of the same gather
    "bilinear_planes_tilemajor_grad": "videoloop3d_tpu/render/sample.py:193",
    "nn_band_argmin": "videoloop3d_tpu/losses/patch_nn.py:338",
    "nn_band_err": "videoloop3d_tpu/eval/nnmse.py:132",
}
RENDER_KERNELS = ("warp_lookup", "bilinear_tiles", "bilinear_tiles_tilemajor",
                  "composite")
SOURCES = {k: f"videoloop3d_torch/csrc/{k}.cu" for k in REPLACES}
SOURCES.update({"sample_dense_grad": "videoloop3d_torch/csrc/sample_dense.cu",
                "fused_s1_fwd": "videoloop3d_torch/csrc/fused_s1.cu",
                "fused_s1_bwd": "videoloop3d_torch/csrc/fused_s1.cu",
                "bilinear_tiles_grad":
                    "videoloop3d_torch/csrc/bilinear_tiles.cu",
                "bilinear_tiles_tilemajor_grad":
                    "videoloop3d_torch/csrc/bilinear_tiles_tilemajor.cu",
                "compact_sweep": "videoloop3d_torch/csrc/compact.cu",
                "fused_s2_fwd": "videoloop3d_torch/csrc/fused_s2.cu",
                "fused_s2_bwd": "videoloop3d_torch/csrc/fused_s2.cu",
                "bilinear_planes_tilemajor_grad":
                    "videoloop3d_torch/csrc/bilinear_planes_tilemajor.cu",
                "nn_band_argmin": "videoloop3d_torch/csrc/nn_argmin.cu"})
SPARSE_KERNELS = ("warp_lookup", "bilinear_tiles", "bilinear_tiles_grad")
S1_HW = (360, 640)               # the shipped stage-1 scene (factor 1)
S1_PATCH = (180, 320)
S1_ROUTES = {"shipped": [], "fused": ["--fused_render"]}
S2_KERNELS = ("warp_lookup", "bilinear_tiles", "bilinear_tiles_grad",
              "bilinear_tiles_tilemajor", "bilinear_tiles_tilemajor_grad",
              "nn_argmin", "nn_fold")
SHIPPED_KERNELS = ("compact_sweep", "fused_s2_fwd", "fused_s2_bwd")
S2_ROUTES = {"shipped": S2_KERNELS + SHIPPED_KERNELS, "unfused": S2_KERNELS}
S2_PATCH = (180, 320)
DENSE_KERNELS = ("bilinear_planes_tilemajor",
                 "bilinear_planes_tilemajor_grad")
# the sparse routes' kernels, which a dense stage-2 model never reaches
SPARSE_ROUTE_KERNELS = ("warp_lookup", "bilinear_tiles",
                        "bilinear_tiles_tilemajor", "composite",
                        "bilinear_tiles_grad", "bilinear_tiles_tilemajor_grad",
                        "compact_sweep", "fused_s2_fwd", "fused_s2_bwd")


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean device time of fn() over `iters` back-to-back calls after one
    warm-up.  A sleep kernel holds the device while the host enqueues the
    calls, so the events time the device's work and not the wrappers'
    host overhead between launches, which exceeds a small kernel's run
    time (a function that synchronizes inside waits out the sleep and
    then runs host-bound as before)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes, n_ops, ops_per_s=F32_OPS_PER_S):
    """The least time for the work: bytes over the memory rate, or
    operations over the card's peak rate for their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def build_inputs(mtv):
    """Checkpoint + scene on disk (phase 3)."""
    from videoloop3d_torch.data import synthetic
    from videoloop3d_torch.models import checkpoint as ckpt_io

    shutil.rmtree(WORK, ignore_errors=True)
    scene_dir = os.path.join(WORK, "scene")
    H, W = mtv["hw"]
    scene = synthetic.make_scene(n_views=3, h=H, w=W, n_frames=2, seed=0)
    synthetic.write_llff_dir(scene, scene_dir, factor=1)
    ckpt_io.save_checkpoint(
        os.path.join(WORK, "runs", "mtv", "ckpt_000001.npz"),
        geom=mtv["geom"], params=mtv["params"], stage="mpv", is_sparse=True,
        has_dyn=True, tile_map_static=mtv["tile_map_static"],
        tile_map_dyn=mtv["tile_map_dyn"], tile_hw=mtv["tile_hw"],
        frm_num=mtv["frm_num"])
    return scene_dir


def cli_argv(scene_dir, frm_num, extra):
    return ["--datadir", scene_dir, "--expdir", os.path.join(WORK, "runs"),
            "--expname", "mtv", "--factor", "1", "--mpv_frm_num",
            str(frm_num), "--fp16", "--gpu_num", GPU_NUM] + extra


def fixed_view(scene_dir, frm_num):
    """Model, params and the fixed view 0 exactly as render_video sets
    them up."""
    import torch
    from videoloop3d_torch.config import parse_args_with_configs
    from videoloop3d_torch.core import cameras
    from videoloop3d_torch.data import llff
    from videoloop3d_torch.eval.evaluate import load_mpv_from_run

    args = parse_args_with_configs(cli_argv(scene_dir, frm_num, []))
    _, _, scene = llff.load_mv_videos(
        scene_dir, factor=1, bd_factor=(args.near_factor, args.far_factor),
        recenter=True, render_frames=frm_num)
    H, W = scene["hw"]
    poses, intrins = scene["poses"], scene["intrins"]
    model, params, _, _ = load_mpv_from_run(
        args, H, W, np.eye(4), intrins[0], float(scene["bds"].min()),
        float(scene["bds"].max()), device=torch.device(DEVICE))
    ext = cameras.pose_to_extrinsic(poses[:1]).astype(np.float32)
    return model, params, ext, intrins[:1], (H, W)


def plain_render(model, params, h, w, ext, intr, ts):
    """The model's sparse eval render composed of the plain versions only
    (the reference the kernels' render is held against)."""
    import torch
    from videoloop3d_torch.render import renderer as R
    from videoloop3d_torch.render.fused import composite_plain
    from videoloop3d_torch.render.sample import (
        bilinear_tiles_plain, bilinear_tiles_tilemajor_plain)

    dev = model.device
    g = model.geom
    G = R.homographies(g, torch.as_tensor(ext, device=dev),
                       torch.as_tensor(intr, device=dev)).contiguous()
    coords, k_s, k_d, fu, fv = R.warp_lookup_plain(
        G, model.tile_map_static, model.tile_map_dyn, h, w,
        (g.mpi_h, g.mpi_w), g.tile_span)
    valid0 = coords.valid[0]
    atlas_s = params["atlas"].to(model.gather_dtype)
    dyn = params["atlas_dyn"].to(model.gather_dtype)
    ths, tws = atlas_s.shape[1:3]
    th, tw = dyn.shape[1:3]
    vs, hs = bilinear_tiles_plain(atlas_s, k_s[0], fu[0] * (tws - 1),
                                  fv[0] * (ths - 1))
    vd, hd = bilinear_tiles_tilemajor_plain(
        dyn, k_d[0], fu[0] * (tw - 1), fv[0] * (th - 1),
        torch.as_tensor(ts, dtype=torch.int32, device=dev))
    out, _ = composite_plain(vs, valid0 & hs, vd, hd, valid0 & hd)
    rgb = out.movedim(2, 0)
    return (255.0 * rgb.clamp(0.0, 1.0)).to(torch.uint8).cpu().numpy()


def check_warp_lookup(G, maps, h, w, g):
    """K1 against its plain version: x, y, zview, fu, fv to 1e-4
    relative; k exact except within 1e-3 texel of a tile edge or the
    plane rectangle's edge.  Returns the record (times, bound)."""
    import torch
    from videoloop3d_torch.render import renderer as R

    k1_args = (G, *maps, h, w, (g.mpi_h, g.mpi_w), g.tile_span)
    kc, kks, kkd, kfu, kfv = R.warp_lookup(*k1_args)
    pc, pks, pkd, pfu, pfv = R.warp_lookup_plain(*k1_args)
    sy, sx = g.tile_span

    def near_edge(t, span, hi):
        return ((t - torch.round(t / span) * span).abs() < 1e-3) \
            | (t.abs() < 1e-3) | ((t - hi).abs() < 1e-3)

    edge = near_edge(pc.x, sx, g.mpi_w - 1) | near_edge(pc.y, sy,
                                                       g.mpi_h - 1)
    finite = torch.isfinite(pc.x) & torch.isfinite(pc.y)
    sel = pc.valid & ~edge
    rel = 0.0
    for a, b, m in ((kc.x, pc.x, finite), (kc.y, pc.y, finite),
                    (kc.zview, pc.zview, finite), (kfu, pfu, sel),
                    (kfv, pfv, sel)):
        r = ((a - b).abs() / b.abs().clamp(min=1.0))[m]
        rel = max(rel, float(r.max()) if r.numel() else 0.0)
    k_bad = int((((kks != pks) | (kkd != pkd) | (kc.valid != pc.valid))
                 & ~edge).sum())
    k_flips = int(((kks != pks) | (kkd != pkd)).sum())
    if rel > 1e-4 or k_bad:
        raise AssertionError(f"warp_lookup disagrees: rel {rel}, "
                             f"{k_bad} index mismatches off tile edges")
    n1 = G.shape[0] * G.shape[1] * h * w
    return dict(
        max_abs_err=max(max_err(kc.x, pc.x), max_err(kfu[sel], pfu[sel])),
        max_rel_err=rel, k_flips_at_edges=k_flips,
        ms=cuda_ms(lambda: R.warp_lookup(*k1_args), 20),
        plain_ms=cuda_ms(lambda: R.warp_lookup_plain(*k1_args), 5),
        bound=bound_ms(G.numel() * 4 + 2 * maps[0].numel() * 4 + n1 * 29,
                       n1 * 25))


def check_kernels(model, params, ext, intr, hw):
    """Phase 4: each kernel against its plain version at the main path's
    shapes (one fixed-view chunk of 10 frames).  Returns per-kernel
    records."""
    import torch
    from videoloop3d_torch.render import fused as FU
    from videoloop3d_torch.render import renderer as R
    from videoloop3d_torch.render import sample as S

    h, w = hw
    g = model.geom
    dev = model.device
    ts = torch.arange(CHUNK, dtype=torch.int32, device=dev)
    G = R.homographies(g, torch.as_tensor(ext, device=dev),
                       torch.as_tensor(intr, device=dev)).contiguous()
    maps = (model.tile_map_static, model.tile_map_dyn)
    k1_args = (G, *maps, h, w, (g.mpi_h, g.mpi_w), g.tile_span)
    rec = {}

    rec["warp_lookup"] = check_warp_lookup(G, maps, h, w, g)
    kc, kks, kkd, kfu, kfv = R.warp_lookup(*k1_args)

    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        atlas_s = params["atlas"].to(dtype).contiguous()
        dyn = params["atlas_dyn"].to(dtype).contiguous()
        item = atlas_s.element_size()
        ths, tws = atlas_s.shape[1:3]
        th, tw = dyn.shape[1:3]
        C = dyn.shape[-1]

        # K2, 1e-6: identical f32 lerps of the same texels
        k2_args = (atlas_s, kks, kfu * (tws - 1), kfv * (ths - 1))
        vs, hs = S.bilinear_tiles(*k2_args)
        ps, _ = S.bilinear_tiles_plain(*k2_args)
        e2 = max_err(vs, ps)
        n2 = kks.numel()
        used = torch.unique(kks[kks >= 0]).numel()
        r2 = dict(max_abs_err=e2,
                  ms=cuda_ms(lambda: S.bilinear_tiles(*k2_args), 20),
                  plain_ms=cuda_ms(lambda: S.bilinear_tiles_plain(*k2_args),
                                   5),
                  bound=bound_ms(n2 * 12 + used * ths * tws * C * item
                                 + n2 * C * 4, n2 * (9 * C + 10)))

        # K3, 1e-6, at the chunk's frames read through ts
        k3_args = (dyn, kkd[0], kfu[0] * (tw - 1), kfv[0] * (th - 1), ts)
        vd, hd = S.bilinear_tiles_tilemajor(*k3_args)
        pd, _ = S.bilinear_tiles_tilemajor_plain(*k3_args)
        e3 = max_err(vd, pd)
        n3 = kkd[0].numel()
        used = torch.unique(kkd[kkd >= 0]).numel()
        r3 = dict(max_abs_err=e3,
                  ms=cuda_ms(lambda: S.bilinear_tiles_tilemajor(*k3_args),
                             20),
                  plain_ms=cuda_ms(
                      lambda: S.bilinear_tiles_tilemajor_plain(*k3_args), 3),
                  bound=bound_ms(n3 * 12 + ts.numel() * 4
                                 + used * th * tw * CHUNK * C * item
                                 + n3 * CHUNK * C * 4,
                                 n3 * CHUNK * (9 * C + 10)))

        # K4, 1e-5: same operation order; exp may differ in the last ulp
        valid0 = kc.valid[0]
        k4_args = (vs[0].contiguous(), valid0 & hs[0], vd, hd, valid0 & hd)
        out, asum = FU.composite(*k4_args)
        pout, pasum = FU.composite_plain(*k4_args)
        e4 = max(max_err(out, pout), max_err(asum, pasum))
        n_hit = int(hd.sum())
        n_planes_px = hd.numel()
        P = h * w
        r4 = dict(max_abs_err=e4,
                  ms=cuda_ms(lambda: FU.composite(*k4_args), 20),
                  plain_ms=cuda_ms(lambda: FU.composite_plain(*k4_args), 3),
                  bound=bound_ms(n_hit * CHUNK * C * 4
                                 + (n_planes_px - n_hit) * C * 4
                                 + n_planes_px * 2 + P * CHUNK * 16,
                                 n_planes_px * CHUNK * 28))
        for name, r, tol in (("bilinear_tiles", r2, 1e-6),
                             ("bilinear_tiles_tilemajor", r3, 1e-6),
                             ("composite", r4, 1e-5)):
            if not r["max_abs_err"] <= tol:
                raise AssertionError(f"{name} ({tag}) disagrees with its "
                                     f"plain version: {r['max_abs_err']}")
            rec[f"{name}/{tag}"] = r
    for name, r in rec.items():
        r = dict(r)
        b, by = r.pop("bound")
        print(json.dumps({"kernel_check": name, **r, "bound_ms": b,
                          "bound_by": by}))
    return rec


def drive(argv):
    """Run render_video.main with the launch counters set to 0 just before
    and read just after; returns (frames, counts, render seconds, wall
    seconds)."""
    import torch
    from videoloop3d_torch import kernels
    from videoloop3d_torch.tools import render_video
    from videoloop3d_torch.train import stage2

    inner = stage2.render_eval
    spent = [0.0]

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*a, **kw)           # returns host numpy: synchronized
        spent[0] += time.perf_counter() - t
        return out

    stage2.render_eval = timed
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        frames = render_video.main(argv)
        wall = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
    finally:
        stage2.render_eval = inner
    return np.stack(frames), counts, spent[0], wall


def profile_render(model, params, hw, ext, intr, ts, chunk):
    """Device busy share and the largest device entries (kernels and
    copies, each counted once) of one warm `render_eval` call
    (torch.profiler, CPU + CUDA activities)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from videoloop3d_torch.train.stage2 import render_eval

    H, W = hw

    def call():
        return render_eval(model, params, H, W, ext, intr, ts, chunk=chunk,
                           u8=True)

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        call()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = device_entries(prof)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    device_ms = sum(ms for ms, _ in by_name.values())
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "top": [{"name": k[:60], "device_ms": ms, "calls": n}
                    for k, (ms, n) in rows[:10]]}


def device_entries(prof):
    """{name: (device ms, calls)} of the kernels and copies of a
    torch.profiler run, each counted once.  User annotations on the
    device timeline (such as "Optimizer.step#Adam.step") span other
    entries and are left out."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return by_name


PORT_KERNELS = ("warp_lookup_kernel", "bilinear_tiles_kernel",
                "bilinear_tiles_grad_kernel",
                "bilinear_tiles_tilemajor_kernel",
                "bilinear_tiles_tilemajor_grad_kernel",
                # K11 and K18: nn_search_kernel<T, false> and <T, true>
                "nn_search_kernel", "nn_fold_kernel", "composite_kernel",
                "sample_dense_kernel",
                "sample_dense_grad_kernel", "fused_s1_fwd_kernel",
                "fused_s1_reduce_kernel", "fused_s1_bwd_kernel",
                "compact_sweep_kernel", "fused_s2_fwd_kernel",
                "fused_s2_reduce_kernel", "fused_s2_bwd_kernel",
                "bilinear_planes_tilemajor_kernel",
                "bilinear_planes_tilemajor_grad_kernel",
                "nn_band_err_kernel", "crop_sums_kernel")


def device_groups(by_name):
    """{group: {device_ms, calls}} of device_entries' result: each port
    kernel by its CUDA function name, Adam's multi_tensor_apply passes,
    and everything else."""
    groups = {}
    for name, (ms, n) in by_name.items():
        key = next((k for k in PORT_KERNELS
                    if k + "(" in name or k + "<" in name), None)
        if key is None:
            key = "adam multi_tensor_apply" if "multi_tensor_apply" in name \
                else "other"
        g = groups.setdefault(key, {"device_ms": 0.0, "calls": 0})
        g["device_ms"] += ms
        g["calls"] += n
    return groups


def u8_close(a, b):
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16)).max(-1)
    return float((diff > 1).mean())


def s1_args(extra=()):
    """The shipped stage-1 configuration at factor 1 (the port's parser)."""
    from videoloop3d_torch.config import parse_args_with_configs
    return parse_args_with_configs(
        ["--config", os.path.join(REPO, "configs", "mpi_base.txt"),
         "--factor", "1", *extra])


def s1_setup(route, seed=0):
    """An MPMesh at the shipped width on the card with its initial
    parameters, and one batch as the trainer feeds it: a 180x320 patch at
    the centre of a 360x640 view, 0.05 to the side of the reference
    camera (the geometry of bench.py:run_stage1_bench)."""
    import torch
    from videoloop3d_torch.models.mpmesh import MPMesh

    args = s1_args(S1_ROUTES[route])
    H, W = S1_HW
    ph, pw = S1_PATCH
    focal = 0.9 * W
    intrin = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                      np.float32)
    model = MPMesh(args, H, W, np.eye(4, dtype=np.float32), intrin, 2.0,
                   10.0, device=DEVICE)
    params = model.init_params(1)
    ext = np.eye(4, dtype=np.float32)[None]
    ext[:, 0, 3] = 0.05
    pi = intrin.copy()
    pi[0, 2] -= (W - pw) / 2
    pi[1, 2] -= (H - ph) / 2
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    batch = {"extrin": torch.as_tensor(ext, device=DEVICE),
             "intrin": torch.as_tensor(pi[None], device=DEVICE),
             "rgb": torch.rand((1, ph, pw, 3), generator=gen, device=DEVICE),
             "loopmask": (torch.rand((1, ph, pw), generator=gen,
                                     device=DEVICE) < 0.3).float()}
    return args, model, params, batch


def s1_kernel_inputs():
    """Production-shape inputs of K5-K8: the warp of the s1_setup patch
    onto the 32 planes, a random 576x1024 atlas and mask atlas, and
    random cotangents (seeded on the card)."""
    import torch
    from videoloop3d_torch.render import renderer as R

    args, model, params, batch = s1_setup("shipped")
    g = model.geom
    ref_inv = torch.as_tensor(np.linalg.inv(g.ref_extrin_np()), device=DEVICE)
    coords = R.warp_coordinates(g, batch["extrin"] @ ref_inv[None],
                                batch["intrin"], *S1_PATCH)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    D, Ht, Wt = g.n_planes, g.mpi_h, g.mpi_w
    atlas = torch.randn((D, Ht, Wt, 4), generator=gen, device=DEVICE)
    mask = torch.randn((D, Ht, Wt, 1), generator=gen, device=DEVICE)
    x, y = coords.x.contiguous(), coords.y.contiguous()
    shape = x.shape
    cot = torch.randn(shape + (4,), generator=gen, device=DEVICE)
    cot_m = torch.randn(shape + (1,), generator=gen, device=DEVICE)
    return args, g, coords, atlas, mask, x, y, cot, cot_m


def check_s1_kernels():
    """Phase 8: K5-K8 against their plain versions on the card at the
    shipped stage-1 shapes, with CUDA-event times, bounds and, for K5/K6,
    grid_sample as the library yardstick."""
    import torch
    import torch.nn.functional as TF
    from videoloop3d_torch.render import fused_s1 as F1
    from videoloop3d_torch.render import sample as S

    args, g, coords, atlas, mask, x, y, cot, cot_m = s1_kernel_inputs()
    D, Ht, Wt = g.n_planes, g.mpi_h, g.mpi_w
    n = x.numel()
    rec = {}

    # K5: bit-exact (same lerps, one rounding per operation)
    feats, mfeats = S.sample_dense_fwd(atlas, mask, x, y)
    e5 = max(max_err(feats, S.bilinear_planes_plain(atlas, x, y)),
             max_err(mfeats, S.bilinear_planes_plain(mask, x, y)))
    # texels the samples touch (each read once in the bound)
    x0 = torch.floor(x).clamp(-2, Wt).long()
    y0 = torch.floor(y).clamp(-2, Ht).long()
    dd = torch.arange(D, device=DEVICE).view(1, D, 1, 1)
    idx = []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        inside = (xi >= 0) & (xi < Wt) & (yi >= 0) & (yi < Ht)
        idx.append(((dd * Ht + yi) * Wt + xi)[inside])
    touched = torch.unique(torch.cat(idx)).numel()
    # grid_sample on (D, 5, Ht, Wt) with normalized grids; the layout
    # change is done once here and not timed
    tex = torch.cat([atlas, mask], -1).permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([x[0] / (Wt - 1) * 2 - 1, y[0] / (Ht - 1) * 2 - 1],
                       -1).contiguous()

    def gs(t):
        return TF.grid_sample(t, grid, mode="bilinear", padding_mode="zeros",
                              align_corners=True)

    ref5 = gs(tex).permute(0, 2, 3, 1)[None]
    gs_err = max_err(torch.cat([feats, mfeats], -1), ref5)
    rec["sample_dense"] = dict(
        max_abs_err=e5, grid_sample_max_abs_diff=gs_err,
        ms=cuda_ms(lambda: S.sample_dense_fwd(atlas, mask, x, y), 20),
        plain_ms=cuda_ms(lambda: (S.bilinear_planes_plain(atlas, x, y),
                                  S.bilinear_planes_plain(mask, x, y)), 5),
        library_ms=cuda_ms(lambda: gs(tex), 20),
        bound=bound_ms(n * 8 + touched * 20 + n * 20, n * 55))

    # K6: atomics add in no fixed order -> 1e-5 relative to max|g|
    ga, gm = S.sample_dense_grad(cot, cot_m, x, y, atlas.shape, mask.shape)
    pa = S.bilinear_planes_grad_plain(cot, x, y, atlas.shape)
    pm = S.bilinear_planes_grad_plain(cot_m, x, y, mask.shape)
    e6 = max(max_err(ga, pa) / float(pa.abs().max()),
             max_err(gm, pm) / float(pm.abs().max()))
    tex_g = tex.clone().requires_grad_(True)
    out_g = gs(tex_g)
    cot_gs = torch.cat([cot, cot_m], -1)[0].permute(0, 3, 1, 2).contiguous()
    rec["sample_dense_grad"] = dict(
        max_abs_err=max(max_err(ga, pa), max_err(gm, pm)), max_rel_err=e6,
        ms=cuda_ms(lambda: S.sample_dense_grad(cot, cot_m, x, y, atlas.shape,
                                               mask.shape), 20),
        plain_ms=cuda_ms(lambda: (
            S.bilinear_planes_grad_plain(cot, x, y, atlas.shape),
            S.bilinear_planes_grad_plain(cot_m, x, y, mask.shape)), 3),
        library_ms=cuda_ms(lambda: torch.autograd.grad(
            out_g, tex_g, cot_gs, retain_graph=True), 20),
        bound=bound_ms(D * Ht * Wt * 20 + n * 20 + n * 8, n * 45))
    del pa, pm, ga, gm, tex_g, out_g

    # K7 / K8 at the flags of the shipped --fused_render step, and with
    # every flag on (checked, not timed)
    valid = coords.valid.contiguous()
    mf = mfeats[..., 0].contiguous()
    dinv = torch.rand(x.shape, device=DEVICE) * valid
    P = S1_PATCH[0] * S1_PATCH[1]
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    cts = [torch.randn(s, generator=gen, device=DEVICE)
           for s in ((1,) + S1_PATCH + (3,), (1,) + S1_PATCH,
                     (1,) + S1_PATCH, (1,) + S1_PATCH + (1,), (4,))]
    shipped = F1.FusedS1Cfg(D, args.sparsity_loss_weight > 0,
                            args.rgb_smooth_loss_weight > 0,
                            args.a_smooth_loss_weight > 0, False, True,
                            False)
    for cfg in (F1.FusedS1Cfg(D, True, True, True, True, True, True),
                shipped):
        dv = dinv if cfg.want_disp else None
        k7 = F1.fused_s1_fwd(cfg, feats, valid, mf, dv)
        p7 = F1.fused_composite_s1_plain_fwd(cfg, feats, valid, mf, dv)
        e7 = max(max_err(a, b) for a, b in zip(k7[:4], p7[:4]))
        r7 = float(((k7[4] - p7[4]).abs() / p7[4].abs().clamp(min=1e-30))
                   .max())
        k8 = F1.fused_s1_bwd(cfg, feats, valid, mf, dv, *cts)
        p8 = F1.fused_composite_s1_plain_bwd(cfg, feats, valid, mf, dv, *cts)
        e8 = max(max_err(a, b) / float(b.abs().max())
                 for a, b in zip(k8, p8) if b is not None)
        if not (e7 <= 1e-5 and r7 <= 1e-5 and e8 <= 1e-5):
            raise AssertionError(f"fused_s1 kernels disagree ({cfg}): "
                                 f"{e7} {r7} {e8}")
    reads = n * (16 + 1 + 4)
    rec["fused_s1_fwd"] = dict(
        max_abs_err=e7, regs_max_rel_err=r7,
        ms=cuda_ms(lambda: F1.fused_s1_fwd(shipped, feats, valid, mf, None),
                   20),
        plain_ms=cuda_ms(lambda: F1.fused_composite_s1_plain_fwd(
            shipped, feats, valid, mf, None), 3),
        library_ms=None,
        bound=bound_ms(reads + P * 24 + 16, n * 80))
    rec["fused_s1_bwd"] = dict(
        max_abs_err=max(max_err(a, b) for a, b in zip(k8, p8)),
        max_rel_err=e8,
        ms=cuda_ms(lambda: F1.fused_s1_bwd(shipped, feats, valid, mf, None,
                                           *cts), 20),
        plain_ms=cuda_ms(lambda: F1.fused_composite_s1_plain_bwd(
            shipped, feats, valid, mf, None, *cts), 3),
        library_ms=None,
        bound=bound_ms(reads + P * 24 + 16 + n * 20, n * 150))
    for name, tol in (("sample_dense", 0.0), ("sample_dense_grad", 1e-5)):
        r = rec[name]
        err = r["max_abs_err"] if name == "sample_dense" else r["max_rel_err"]
        if not err <= tol:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{err}")
    for name, r in rec.items():
        r = dict(r)
        b, by = r.pop("bound")
        print(json.dumps({"kernel_check": name, **r, "bound_ms": b,
                          "bound_by": by}), flush=True)
    return rec


def s1_scene():
    """A 360x640 synthetic LLFF scene, 3 views x 12 frames, as .npy."""
    from videoloop3d_torch.data import synthetic

    scene_dir = os.path.join(WORK, "s1_scene")
    scene = synthetic.make_scene(n_views=3, h=S1_HW[0], w=S1_HW[1],
                                 n_frames=12, seed=0)
    synthetic.write_llff_dir(scene, scene_dir, factor=1)
    return scene_dir


def run_train(argv, tool=None):
    """tool.main (train_3d by default) with the launch counters set to 0
    just before and read just after, its standard output echoed.  Returns
    (counts, metrics.jsonl rows, rundir, wall seconds, output text)."""
    import contextlib
    import io
    from videoloop3d_torch import kernels
    from videoloop3d_torch.tools import train_3d

    tool = tool or train_3d
    buf = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            _, _, rundir = tool.main(argv)
    finally:
        print(buf.getvalue(), end="", flush=True)
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    with open(os.path.join(rundir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return counts, rows, rundir, wall, buf.getvalue()


def drive_train(scene_dir, route):
    """Phase 9: train_3d.main with the launch counters set to 0 just
    before and read just after.  Returns (counts, metrics.jsonl rows,
    rundir, wall seconds)."""
    argv = ["--config", os.path.join(REPO, "configs", "mpi_base.txt"),
            "--factor", "1", "--N_iters", "2", "--i_video", "1000",
            "--datadir", scene_dir, "--expdir", os.path.join(WORK, "s1_runs"),
            "--expname", route, *S1_ROUTES[route]]
    return run_train(argv)[:4]


def check_train(route, counts, rows, rundir):
    """The trainer run's launches, loss, PSNR and checkpoint."""
    need = ["sample_dense", "sample_dense_grad"]
    if route == "fused":
        need += ["fused_s1_fwd", "fused_s1_bwd"]
    idle = [k for k in need if counts[k] == 0]
    if idle:
        raise AssertionError(f"stage-1 {route} run never launched {idle}")
    loss = [r["value"] for r in rows if r["tag"] == "stage1/loss"]
    psnr = [r["value"] for r in rows if r["tag"] == "stage1/psnr"]
    if not loss or not all(np.isfinite(loss)):
        raise AssertionError(f"stage-1 {route} loss not finite: {loss}")
    if len(psnr) < 2 or not psnr[-1] > psnr[0]:
        raise AssertionError(f"stage-1 {route} PSNR did not rise: {psnr}")
    if not os.path.isfile(os.path.join(rundir, "ckpt_epoch_0001.npz")):
        raise AssertionError(f"stage-1 {route} wrote no checkpoint")
    steps = max(r["step"] for r in rows if r["tag"] == "stage1/loss") + 1
    warm = [r["value"] for r in rows if r["tag"] == "stage1/warm_step_ms"]
    return {"steps": counts["sample_dense"], "logged_steps": steps,
            "warm_ms_per_step": warm[-1], "loss": loss, "psnr": psnr}


def make_plain_fused_s1():
    """render.fused_s1.fused_composite_s1 made of the plain forward and
    backward, for the plain composition of a step (phase 10)."""
    import torch
    from videoloop3d_torch.render import fused_s1 as F1

    class PlainFusedS1(torch.autograd.Function):
        @staticmethod
        def forward(ctx, cfg, feats, valid, mask_feats, dinv):
            ctx.cfg = cfg
            ctx.save_for_backward(feats, valid, mask_feats, dinv)
            return F1.fused_composite_s1_plain_fwd(cfg, feats, valid,
                                                   mask_feats, dinv)

        @staticmethod
        def backward(ctx, *grads):
            d_feats, d_mask = F1.fused_composite_s1_plain_bwd(
                ctx.cfg, *ctx.saved_tensors, *(t.contiguous() for t in grads))
            return None, d_feats, None, d_mask, None

    def fused(cfg, feats, valid, mask_feats=None, dinv=None):
        return F1.select_outputs(cfg, *PlainFusedS1.apply(
            cfg, feats, valid, mask_feats, dinv))
    return fused


def plain_sample(atlas, atlas_mask, coords):
    """renderer.sample_dense made of the plain version under autograd."""
    from videoloop3d_torch.render.sample import bilinear_planes_plain
    x, y = coords.x, coords.y
    return (bilinear_planes_plain(atlas, x, y),
            None if atlas_mask is None
            else bilinear_planes_plain(atlas_mask, x, y))


def s1_step_grads(route, plain):
    """Loss, metrics and atlas gradients of one stage-1 step (initial
    parameters, shipped weights), with the kernels or with the plain
    versions composed in their place."""
    import torch
    from videoloop3d_torch.models import mpmesh
    from videoloop3d_torch.render import renderer
    from videoloop3d_torch.train import common
    from videoloop3d_torch.train import stage1 as TS1

    args, model, params, batch = s1_setup(route)
    for t in params.values():
        t.requires_grad_(True)
    weights = common.extra_loss_weights(args, TS1.STAGE1_WEIGHT_KEYS)
    saved = (renderer.sample_dense, mpmesh.fused_composite_s1)
    if plain:
        renderer.sample_dense = plain_sample
        mpmesh.fused_composite_s1 = make_plain_fused_s1()
    try:
        total, metrics = TS1.make_stage1_loss_fn(model, args, *S1_PATCH)(
            params, batch, weights)
        total.backward()
    finally:
        renderer.sample_dense, mpmesh.fused_composite_s1 = saved
    return ({k: float(torch.as_tensor(v).detach())
             for k, v in metrics.items()},
            {k: params[k].grad for k in ("atlas", "atlas_mask")})


def check_s1_step(route):
    """Phase 10: the kernel step against the plain step on the card:
    metrics to 1e-5 relative, gradients to 1e-5 * max|g| (K6's atomics and
    the plain scatter both add in no fixed order)."""
    from videoloop3d_torch import kernels
    kernels.reset_launches()
    m_k, g_k = s1_step_grads(route, plain=False)
    launched = dict(kernels.LAUNCHES)
    m_p, g_p = s1_step_grads(route, plain=True)
    if kernels.LAUNCHES["sample_dense"] != launched["sample_dense"]:
        raise AssertionError("the plain step launched a kernel")
    rel = max(abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-12) for k in m_p)
    grel = max(max_err(g_k[k], g_p[k]) / float(g_p[k].abs().max())
               for k in g_k)
    if not (rel <= 1e-5 and grel <= 1e-5):
        raise AssertionError(f"stage-1 {route} step differs from its plain "
                             f"composition: metrics {rel}, grads {grel}")
    return {"metrics_max_rel_err": rel, "grads_max_rel_err": grel,
            "loss": m_k["loss"]}


def profile_s1_step(args, model, params, batch):
    """Device busy share and the largest device entries of one warm
    stage-1 train step (Adam included), plus its host-clock time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from videoloop3d_torch.train import common
    from videoloop3d_torch.train import stage1 as TS1

    step, opt_init, keys = TS1.make_train_step(model, args, *S1_PATCH)
    opt = opt_init(params)
    weights = common.extra_loss_weights(args, keys)
    for _ in range(3):
        step(params, opt, batch, 0.05, weights)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        step(params, opt, batch, 0.05, weights)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 100
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(params, opt, batch, 0.05, weights)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = device_entries(prof)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    device_ms = sum(ms for ms, _ in by_name.values())
    return {"step_ms_10_steps": step_ms, "profiled_wall_ms": wall_ms,
            "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
            "kernel_launches": sum(n for _, n in by_name.values()),
            "groups": device_groups(by_name),
            "top": [{"name": k[:60], "device_ms": ms, "calls": n}
                    for k, (ms, n) in rows[:12]]}


def stage1_phases():
    """Phases 8-10.  Returns (kernel records, launches per route)."""
    rec = check_s1_kernels()
    scene_dir = s1_scene()
    launches = {}
    for route in S1_ROUTES:
        counts, rows, rundir, wall = drive_train(scene_dir, route)
        summary = check_train(route, counts, rows, rundir)
        launches[route] = counts
        print(json.dumps({"train_3d": route, "cli_wall_s": wall,
                          "launches": counts, **summary}), flush=True)
    for route in S1_ROUTES:
        print(json.dumps({"plain_step_check": route,
                          **check_s1_step(route)}), flush=True)
    for route in S1_ROUTES:
        print(json.dumps({"profile": f"stage-1 step, {route} route",
                          **profile_s1_step(*s1_setup(route))}), flush=True)
    return rec, launches, scene_dir


def s1_dense_for_cull(geom, seed=0):
    """Dense stage-1 params at the shipped width whose cull keeps about
    20% of the tiles, about 30% of them dynamic: opaque (and, for the
    dynamic ones, loopable) blocks inside the chosen tiles, 4 texels in
    from every tile edge so that the cull's erode/dilate (net +2 texels)
    stays inside the tile, over a transparent, static background."""
    rng = np.random.default_rng(seed)
    D, Ht, Wt = geom.n_planes, geom.mpi_h, geom.mpi_w
    sy, sx = geom.tile_span
    r = rng.random((D, geom.n_tiles_h, geom.n_tiles_w))
    keep = r < 0.2
    dyn = keep & (rng.random(r.shape) < 0.3)
    atlas = rng.random((D, Ht, Wt, 4), dtype=np.float32)
    atlas[..., 3] = rng.uniform(-6.0, -4.0, (D, Ht, Wt))
    mask = rng.uniform(-4.0, -2.0, (D, Ht, Wt, 1)).astype(np.float32)
    for d, i, j in zip(*np.nonzero(keep)):
        y0, y1 = int(np.ceil(i * sy)) + 4, int(np.floor((i + 1) * sy)) - 3
        x0, x1 = int(np.ceil(j * sx)) + 4, int(np.floor((j + 1) * sx)) - 3
        atlas[d, y0:y1, x0:x1, 3] = rng.uniform(1.0, 3.0)
        if dyn[d, i, j]:
            mask[d, y0:y1, x0:x1] = 3.0
    return {"atlas": atlas, "atlas_mask": mask}, int(keep.sum()), \
        int(dyn.sum())


def s1_sparse_setup():
    """The s1_setup model and batch in the sparse phase: tile_cull of
    s1_dense_for_cull's params through sparsify.apply_tile_cull.  Returns
    (args, model, params, batch, cull record)."""
    from videoloop3d_torch.core.activations import get_activation
    from videoloop3d_torch.models.sparsify import apply_tile_cull

    args, model, params, batch = s1_setup("shipped")
    dense, n_keep, n_dyn = s1_dense_for_cull(model.geom)
    t = time.perf_counter()
    params, info = apply_tile_cull(
        model, {**dense, "verts": params["verts"]},
        get_activation(args.alpha_activate), erode_num=args.sparsify_erode,
        alpha_thresh=args.sparsify_alpha_thresh,
        rm_first_layers=args.sparsify_rmfirstlayer)
    cull_s = time.perf_counter() - t
    ns, nd = len(params["atlas"]), len(params["atlas_dyn"])
    if (ns + nd, nd) != (n_keep, n_dyn):
        raise AssertionError(f"cull kept {ns} + {nd} tiles, expected "
                             f"{n_keep - n_dyn} + {n_dyn}")
    return args, model, params, batch, {
        "cull_s": cull_s, "tiles_static": ns, "tiles_dyn": nd,
        "keep_frac": info["keep_frac"], "dyn_frac": info["dyn_frac"],
        "tile_hw": info["tile_hw"]}


def check_s1_sparse_kernels(model, params, batch):
    """Phase 11: K1, K2 and K9 against their plain versions on the card at
    the shipped sparse stage-1 shapes (the s1_sparse_setup patch and
    tiles, a random cotangent), with CUDA-event times and bounds."""
    import torch
    from videoloop3d_torch.render import renderer as R
    from videoloop3d_torch.render import sample as S

    g = model.geom
    h, w = S1_PATCH
    ref_inv = torch.as_tensor(np.linalg.inv(g.ref_extrin_np()), device=DEVICE)
    G = R.homographies(g, batch["extrin"] @ ref_inv[None],
                       batch["intrin"]).contiguous()
    maps = (model.tile_map_static, model.tile_map_dyn)
    rec = {"warp_lookup": check_warp_lookup(G, maps, h, w, g)}
    _, k_s, k_d, fu, fv = R.warp_lookup(G, *maps, h, w, (g.mpi_h, g.mpi_w),
                                        g.tile_span)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    n = k_s.numel()
    for key, k in (("atlas", k_s), ("atlas_dyn", k_d)):
        tiles = params[key].detach()
        N, th, tw, C = tiles.shape
        u = (fu * (tw - 1)).contiguous()
        v = (fv * (th - 1)).contiguous()
        args = (tiles, k, u, v)
        # K2, 1e-6: identical f32 lerps of the same texels
        e2 = max_err(S.bilinear_tiles(*args)[0],
                     S.bilinear_tiles_plain(*args)[0])
        # K9: atomics add in no fixed order -> 1e-5 relative to max|g|
        ct = torch.randn(k.shape + (C,), generator=gen, device=DEVICE)
        gargs = (ct, k, u, v, tiles.shape)
        g9, p9 = S.bilinear_tiles_grad(*gargs), S.bilinear_tiles_grad_plain(
            *gargs)
        e9 = max_err(g9, p9) / float(p9.abs().max())
        if not (e2 <= 1e-6 and e9 <= 1e-5):
            raise AssertionError(f"sparse kernels disagree on {key}: K2 "
                                 f"{e2}, K9 {e9}")
        if key != "atlas":
            continue
        hits = int((k >= 0).sum())
        used = torch.unique(k[k >= 0]).numel()
        texel = th * tw * C * 4
        rec["bilinear_tiles"] = dict(
            max_abs_err=e2, samples=n, hits=hits,
            ms=cuda_ms(lambda: S.bilinear_tiles(*args), 20),
            plain_ms=cuda_ms(lambda: S.bilinear_tiles_plain(*args), 5),
            bound=bound_ms(n * 4 + hits * 8 + used * texel + n * C * 4,
                           hits * (9 * C + 10)))
        rec["bilinear_tiles_grad"] = dict(
            max_abs_err=max_err(g9, p9), max_rel_err=e9, samples=n,
            hits=hits, tiles=N,
            ms=cuda_ms(lambda: S.bilinear_tiles_grad(*gargs), 20),
            plain_ms=cuda_ms(lambda: S.bilinear_tiles_grad_plain(*gargs), 3),
            library_ms=None,
            bound=bound_ms(n * 4 + hits * (8 + C * 4) + N * texel,
                           hits * (8 * C + 10)))
    for name, r in rec.items():
        r = dict(r)
        b, by = r.pop("bound")
        print(json.dumps({"kernel_check": f"{name}/stage-1 sparse", **r,
                          "bound_ms": b, "bound_by": by}), flush=True)
    return rec


def drive_sparse_train(scene_dir):
    """Phase 12: the shipped route through the cull: --N_iters 3
    --sparsify_epoch 2 (2 dense epochs, the cull, 1 sparse epoch), then
    --N_iters 4, which must auto-resume from the sparse checkpoint.  The
    run's K1, K2 and K9 launches all come from the sparse epoch (the dense
    epochs launch K5/K6 only, and there are no previews).

    The cull threshold is cut with the schedule: on this scene no texel
    reaches the shipped sparsify_alpha_thresh = 0.05 within a few epochs
    (sigmoid(-3) = 0.047 is where the alphas start), so that threshold
    culls every tile after 2 epochs; 0.03 keeps the tiles whose alphas
    have not fallen, about a quarter of them."""
    from videoloop3d_torch.models import checkpoint as ckpt_io

    def argv(n_iters):
        return ["--config", os.path.join(REPO, "configs", "mpi_base.txt"),
                "--factor", "1", "--N_iters", str(n_iters),
                "--sparsify_epoch", "2", "--sparsify_alpha_thresh", "0.03",
                "--i_video", "1000",
                "--i_img", "9", "--datadir", scene_dir,
                "--expdir", os.path.join(WORK, "s1_runs"),
                "--expname", "sparse"]

    counts, rows, rundir, wall, out = run_train(argv(3))
    cull = [ln for ln in out.splitlines() if "tile culling: keep" in ln]
    idle = [k for k in SPARSE_KERNELS + ("sample_dense", "sample_dense_grad")
            if counts[k] == 0]
    epoch_steps = counts["sample_dense"] // 2
    loss = [(r["step"], r["value"]) for r in rows
            if r["tag"] == "stage1/loss"]
    sparse_loss = [v for st, v in loss if st >= 2 * epoch_steps]
    if (len(cull) != 1 or idle or not sparse_loss
            or not np.isfinite([v for _, v in loss]).all()):
        raise AssertionError(f"sparse run: cull lines {cull}, idle {idle}, "
                             f"loss {loss}")
    ckpt = os.path.join(rundir, "ckpt_epoch_0002.npz")
    if not ckpt_io.load_checkpoint_meta(ckpt)["is_sparse"]:
        raise AssertionError("ckpt_epoch_0002.npz is not sparse")
    sparse_ms = [r["value"] for r in rows
                 if r["tag"] == "stage1/warm_step_ms_sparse"]
    r_counts, r_rows, _, r_wall, r_out = run_train(argv(4))
    resumed = f"auto-resuming from {ckpt} at epoch 3" in r_out
    new = [(r["step"], r["value"]) for r in r_rows[len(rows):]
           if r["tag"] == "stage1/loss"]
    last = ckpt_io.load_checkpoint_meta(
        os.path.join(rundir, "ckpt_epoch_0003.npz"))
    if not (resumed and new and new[0][0] == 3 * epoch_steps
            and np.isfinite([v for _, v in new]).all()
            and last["is_sparse"] and r_counts["bilinear_tiles_grad"] > 0):
        raise AssertionError(f"the resume did not continue the sparse run: "
                             f"resumed {resumed}, losses {new}")
    return counts, {
        "cull_line": cull[0], "cli_wall_s": wall, "loss": loss,
        "warm_ms_per_sparse_step": sparse_ms[-1],
        "resume": {"cli_wall_s": r_wall, "loss": new,
                   "launches": r_counts}}


def make_plain_sparse():
    """renderer.warp_lookup and renderer.sample_sparse made of the plain
    versions under autograd, for the plain composition of a sparse step
    (phase 13)."""
    from videoloop3d_torch.render import renderer as R
    from videoloop3d_torch.render.sample import bilinear_tiles_plain

    def sample_sparse(tiles, k, fu, fv):
        th, tw = tiles.shape[1:3]
        return bilinear_tiles_plain(tiles, k, fu * (tw - 1), fv * (th - 1))
    return R.warp_lookup_plain, sample_sparse


def check_s1_sparse_step(args, model, params, batch):
    """Phase 13: one sparse step with the kernels against the same step
    made of the plain versions on the card: metrics to 1e-5 relative,
    atlas and atlas_dyn gradients to 1e-5 * max|g|."""
    import torch
    from videoloop3d_torch import kernels
    from videoloop3d_torch.render import renderer
    from videoloop3d_torch.train import common
    from videoloop3d_torch.train import stage1 as TS1

    weights = common.extra_loss_weights(args, TS1.STAGE1_WEIGHT_KEYS)

    def grads(plain):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        saved = (renderer.warp_lookup, renderer.sample_sparse)
        if plain:
            renderer.warp_lookup, renderer.sample_sparse = make_plain_sparse()
        try:
            total, metrics = TS1.make_stage1_loss_fn(model, args, *S1_PATCH)(
                p, batch, weights)
            total.backward()
        finally:
            renderer.warp_lookup, renderer.sample_sparse = saved
        return ({k: float(torch.as_tensor(v).detach())
                 for k, v in metrics.items()},
                {k: p[k].grad for k in ("atlas", "atlas_dyn")})

    kernels.reset_launches()
    m_k, g_k = grads(False)
    launched = dict(kernels.LAUNCHES)
    m_p, g_p = grads(True)
    if kernels.LAUNCHES != launched or any(launched[k] == 0
                                           for k in SPARSE_KERNELS):
        raise AssertionError(f"launches: kernel step {launched}, plain step "
                             f"{kernels.LAUNCHES}")
    rel = max(abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-12) for k in m_p)
    grel = max(max_err(g_k[k], g_p[k]) / float(g_p[k].abs().max())
               for k in g_k)
    if not (rel <= 1e-5 and grel <= 1e-5):
        raise AssertionError(f"sparse step differs from its plain "
                             f"composition: metrics {rel}, grads {grel}")
    return {"metrics_max_rel_err": rel, "grads_max_rel_err": grel,
            "loss": m_k["loss"]}


def sparse_phases(scene_dir):
    """Phases 11-13.  Returns (kernel records, launches of the sparse
    trainer run, the cell-a model and params)."""
    args, model, params, batch, cull = s1_sparse_setup()
    print(json.dumps({"phase": "stage-1 sparse setup", **cull}), flush=True)
    rec = check_s1_sparse_kernels(model, params, batch)
    counts, summary = drive_sparse_train(scene_dir)
    print(json.dumps({"train_3d": "shipped, through the cull",
                      "launches": counts, **summary}), flush=True)
    print(json.dumps({"plain_step_check": "stage-1 sparse",
                      **check_s1_sparse_step(args, model, params, batch)}),
          flush=True)
    print(json.dumps({"profile": "stage-1 sparse step, shipped route",
                      **profile_s1_step(args, model, params, batch)}),
          flush=True)
    return rec, counts, (model, params)


def s2_args(extra=()):
    """The shipped stage-2 configuration at factor 1, 50 frames."""
    from videoloop3d_torch.config import parse_args_with_configs
    return parse_args_with_configs(
        ["--config", os.path.join(REPO, "configs", "mpv_base.txt"),
         "--factor", "1", "--mpv_frm_num", "50", *extra])


def s2_setup():
    """The benchmark MTV (make_sparse_mtv: 9,786 static and 4,257 dynamic
    12x12 tiles, F = 50) as a stage-2 model of the shipped config on the
    card (``--fused_render``, no slot bound yet: `s2_route` sets the
    route), and one batch as the trainer feeds it: a 180x320 patch at the
    centre of the 360x640 view, 0.05 to the side of the reference camera,
    with its target video (`s2_video`)."""
    import torch
    from videoloop3d_torch.data import synthetic
    from videoloop3d_torch.models.mpv import MPMeshVid

    mtv = synthetic.make_sparse_mtv(quick=False, seed=0)
    args = s2_args()
    H, W = mtv["hw"]
    model = MPMeshVid(args, H, W, np.eye(4, dtype=np.float32),
                      mtv["ref_intrin"], mtv["near"], mtv["far"],
                      device=DEVICE)
    params = model.restore_checkpoint({
        "meta": {"is_sparse": True, "tile_hw": list(mtv["tile_hw"]),
                 "frm_num": mtv["frm_num"], "extra": {}},
        "geom": mtv["geom"], "params": mtv["params"],
        "tile_map_static": mtv["tile_map_static"],
        "tile_map_dyn": mtv["tile_map_dyn"]})
    ph, pw = S2_PATCH
    ext = np.eye(4, dtype=np.float32)[None]
    ext[:, 0, 3] = 0.05
    pi = mtv["ref_intrin"].copy()
    pi[0, 2] -= (W - pw) / 2
    pi[1, 2] -= (H - ph) / 2
    batch = {"extrin": torch.as_tensor(ext, device=DEVICE),
             "intrin": torch.as_tensor(pi[None], device=DEVICE)}
    batch["video"] = s2_video(model, params, batch)
    return args, model, params, batch


def s2_video(model, params, batch):
    """A target video for the patch: the training render of the MTV with
    its raw colour channels mirrored (1 - c), rolled by 7 frames.  It
    differs from the render everywhere, so no NN distance is 0 (alpha 0
    divides by the column minima), and its temporal patches are equal only
    where the MTV is static (ties among equal patches fold to the same
    target).  (F, 180, 320, 3) f32."""
    import torch
    with torch.no_grad():
        p2 = {k: v.clone() for k, v in params.items()}
        for k in ("atlas", "atlas_dyn"):
            p2[k][..., :3] = 1.0 - p2[k][..., :3]
        rgb, _ = model.render(p2, *S2_PATCH, batch["extrin"],
                              batch["intrin"], None, training=True)
    return torch.roll(rgb, 7, dims=0).contiguous()


def s2_loss_inputs(model, params, batch, cfg):
    """The NN search inputs of the patch loss under `cfg` (as
    train/stage2.py:make_patch_loss_fn builds them, scale-invariant gain
    left out): x the loop-padded render (3, F + pt - 1, h, w), y the video
    (3, F, h, w), in the search dtype; the crop plan and alpha."""
    import torch
    from videoloop3d_torch.losses import patch_nn as PN
    with torch.no_grad():
        rgb, _ = model.render(params, *S2_PATCH, batch["extrin"],
                              batch["intrin"], None, training=True)
    x = rgb.permute(3, 0, 1, 2)
    x = torch.cat([x, x[:, :cfg["patcht_size"] - 1]], dim=1)
    y = batch["video"].permute(3, 0, 1, 2)
    xs, ys = PN._nn_cast(x.contiguous(), y.contiguous(), cfg["nn_bf16"])
    psz = (cfg["patcht_size"], cfg["patch_size"], cfg["patch_size"])
    plan = PN.lowmem_plan(x.shape[1], y.shape[1], x.shape[2], x.shape[3],
                          psz, (cfg["stridet"], cfg["stride"], cfg["stride"]),
                          cfg["macro_block"])
    return xs.contiguous(), ys.contiguous(), plan, \
        PN._norm_alpha(cfg["alpha"])


FLIP_LIMIT = 1e-5


def nn_flips(x, y, plan, alpha, nn_k):
    """K11's indices nn_k against the plain version's.  Both evaluate the
    expanded form (|X_i|^2 + |Y_j|^2 - 2 X_i.Y_j) / d, summing in another
    order; its rounding error scales with the terms it cancels, not with
    the distance (the MTV's low-contrast renders make distances 10-100x
    smaller than the terms).  So a flip is a near tie when the plain
    distances of the two choices lie within FLIP_LIMIT of that scale, not
    of the distance: (|X_i|^2 + |Y_j|^2) / d, and with alpha also the
    column minimum's own term scale times the normalized distance, over
    |alpha + column minimum|.  Raises on any other flip.  Returns (the
    plain indices, the flip mask, the largest flip gap: absolute, relative
    to the distance and relative to the scale); the record prints the gap
    relative to the distance too, so a change that widens it shows."""
    import torch
    from videoloop3d_torch.losses import patch_nn as PN

    ft, fh, fw = plan.fit
    scales = []
    for xc, yc in zip(PN._crops(x[:, :ft, :fh, :fw].float(), plan),
                      PN._crops(y[:, :plan.fit_ty, :fh, :fw].float(), plan)):
        nx = PN.extract_patches_3d(xc, plan.psz, plan.strides)
        ny = PN.extract_patches_3d(yc, plan.psz, plan.strides)
        d = nx.shape[-1]
        xx = (nx * nx).sum(-1).flatten(1).T          # (cols, ntx)
        yy = (ny * ny).sum(-1).flatten(1).T          # (cols, nty)
        scales.append((xx[..., :, None] + yy[..., None, :]) / d)
    return flip_gaps("nn_argmin", PN.nn_dist_plain(x, y, plan, None),
                     torch.stack(scales), alpha, nn_k)


def flip_gaps(name, raw, scale, alpha, nn_k, dim=3):
    """The kernel's indices nn_k (argmins over `dim` of the distances raw,
    alpha-normalized) against the plain argmin, given each distance's term
    scale: every flip must be a near tie (`nn_flips`).  Returns (the plain
    indices, the flip mask, the largest flip gap: absolute, relative to
    the distance and relative to the scale)."""
    import torch
    from videoloop3d_torch.losses import patch_nn as PN

    dist = PN.normalized_dist(raw.flatten(0, 1), alpha).view(raw.shape)
    nn_p = torch.argmin(dist, dim=dim).to(torch.int32)
    flips = nn_k != nn_p
    if not bool(flips.any()):
        return nn_p, flips, 0.0, 0.0, 0.0
    if alpha is not None:
        den = (alpha + raw.amin(dim=2, keepdim=True)).abs()
        scale = (scale + dist.abs() * scale.amax(dim=2, keepdim=True)) / den

    def at(t, nn):
        return torch.gather(t, dim, nn.long().unsqueeze(dim)).squeeze(dim)[
            flips]

    dk, dp = at(dist, nn_k), at(dist, nn_p)
    gap = (dk - dp).abs()
    rel_scale = gap / torch.maximum(at(scale, nn_k), at(scale, nn_p))
    rel_dist = float((gap / dp.abs().clamp(min=1e-30)).max())
    if not bool((rel_scale <= FLIP_LIMIT).all()):
        raise AssertionError(f"{name} differs off near ties: largest gap "
                             f"{float(rel_scale.max())} of the term scale, "
                             f"{int(flips.sum())} flips")
    return nn_p, flips, float(gap.max()), rel_dist, float(rel_scale.max())


def band_flips(x, y, plan, alpha, nn_k, scale_by_pt, dim=3):
    """`nn_flips` for K18: the banded per-frame distances, whose term scale
    is the banded sum of the per-frame (|X_f|^2 + |Y_g|^2) / d (/ pt with
    scale_by_pt); dim 3 for its rows, 2 for its columns."""
    import torch
    from videoloop3d_torch.losses import patch_nn as PN

    (pt, _, _), (st, _, _) = plan.psz, plan.strides
    ntx, nty = plan.grid[:2]
    ft, fh, fw = plan.fit
    scales = []
    for xc, yc in zip(PN._crops(x[:, :ft, :fh, :fw].float(), plan),
                      PN._crops(y[:, :plan.fit_ty, :fh, :fw].float(), plan)):
        px, py = PN._frame_patches(xc, plan), PN._frame_patches(yc, plan)
        xx, yy = (px * px).sum(-1), (py * py).sum(-1)     # (cols, F)
        s1 = (xx[..., :, None] + yy[..., None, :]) / px.shape[-1]
        band = PN.banded_temporal_dist_plain(s1, pt, st, ntx, nty)
        scales.append(band / pt if scale_by_pt else band)
    raw = PN.nn_band_dist_plain(x, y, plan, None, scale_by_pt)
    return flip_gaps("nn_band_argmin", raw, torch.stack(scales), alpha,
                     nn_k, dim)


def check_nn(x, y, plan, alpha):
    """K11 and K12 against their plain versions on one loss config's
    inputs.  K11's indices must equal the plain version's except at near
    ties (`nn_flips`); K12 is held on K11's own indices (1e-5: the sums run
    in another order).  Returns the records (times, bounds, library
    times)."""
    import torch
    import torch.nn.functional as TF
    from videoloop3d_torch.losses import patch_nn as PN

    nn_k = PN.nn_argmin(x, y, plan, alpha)
    _, flips, gap_abs, gap_dist, gap_scale = nn_flips(x, y, plan, alpha,
                                                      nn_k)
    n_flips = int(flips.sum())
    out_k = PN.nn_fold(y, nn_k, plan)
    out_p = PN.nn_fold_plain(y, nn_k, plan)
    e12 = max_err(out_k, out_p)
    if not e12 <= 1e-5:
        raise AssertionError(f"nn_fold disagrees with its plain version: "
                             f"{e12}")
    ntx, nty, nh, nw = plan.grid
    C = x.shape[0]
    d = C * int(np.prod(plan.psz))
    cols = len(plan.hs) * len(plan.ws) * nh * nw
    item = x.element_size()
    bf16 = x.dtype == torch.bfloat16
    # library yardsticks on pre-extracted patches (not timed): K11 as
    # baddbmm + amin + divide + argmin (bf16 patches: a bf16 GEMM with f32
    # sums and output, K11's arithmetic), K12 as the JAX package's fold, a
    # transposed convolution with the identity kernel, per crop
    ft, fh, fw = plan.fit
    xc = PN._crops(x[:, :ft, :fh, :fw], plan)
    yc = PN._crops(y[:, :plan.fit_ty, :fh, :fw], plan)
    Xf = torch.cat([PN.extract_patches_3d(c, plan.psz, plan.strides)
                    .reshape(ntx, nh * nw, d).transpose(0, 1) for c in xc])
    Yf = torch.cat([PN.extract_patches_3d(c, plan.psz, plan.strides)
                    .reshape(nty, nh * nw, d).transpose(0, 1) for c in yc])
    Xf, Yf = Xf.contiguous(), Yf.contiguous()
    xx = (Xf.float() ** 2).sum(-1)[..., :, None]
    yy = (Yf.float() ** 2).sum(-1)[..., None, :]
    YfT = Yf.transpose(1, 2)
    gemm = {"out_dtype": torch.float32} if bf16 else {}

    def lib11():
        dd = torch.baddbmm(xx + yy, Xf, YfT, alpha=-2.0, **gemm) / d
        if alpha is not None:
            dd = dd / (alpha + torch.amin(dd, dim=1, keepdim=True))
        return torch.argmin(dd, dim=2)

    sel = torch.take_along_dim(Yf.float(),
                               nn_k.reshape(-1, ntx).long()[..., None],
                               dim=1)                         # (cols, ntx, d)
    sel = sel.reshape(-1, nh, nw, ntx, d).permute(0, 4, 3, 1, 2).contiguous()
    kern = torch.zeros((d, C) + tuple(plan.psz), device=x.device)
    q = torch.arange(d, device=x.device)
    pt, ph, pw = plan.psz
    kern[q, q // (pt * ph * pw), (q // (ph * pw)) % pt, (q // pw) % ph,
         q % pw] = 1.0

    def lib12():
        return TF.conv_transpose3d(sel, kern, stride=plan.strides)

    lib_fold = lib12()
    if lib_fold.shape[2:] != (ft,) + tuple(plan.crop_hw):
        raise AssertionError(f"fold yardstick shape {tuple(lib_fold.shape)}")
    n_nn = nn_k.numel()
    r11 = dict(
        max_abs_err=gap_abs, index_flips=n_flips,
        flip_share=n_flips / n_nn, queries=n_nn,
        flip_gap_rel_distance=gap_dist, flip_gap_rel_term_scale=gap_scale,
        flip_limit_rel_term_scale=FLIP_LIMIT,
        ms=cuda_ms(lambda: PN.nn_argmin(x, y, plan, alpha), 10),
        plain_ms=cuda_ms(lambda: PN.nn_argmin_plain(x, y, plan, alpha), 2),
        library_ms=cuda_ms(lib11, 5),
        bound=bound_ms((x.numel() + y.numel()) * item + n_nn * 4,
                       cols * (2 * ntx * nty * d + 2 * (ntx + nty) * d
                               + 5 * ntx * nty),
                       BF16_OPS_PER_S if bf16 else F32_OPS_PER_S))
    covers = float(plan.weight[plan.weight >= 1].sum())
    r12 = dict(
        max_abs_err=e12,
        ms=cuda_ms(lambda: PN.nn_fold(y, nn_k, plan), 20),
        plain_ms=cuda_ms(lambda: PN.nn_fold_plain(y, nn_k, plan), 2),
        library_ms=cuda_ms(lib12, 10),
        bound=bound_ms(y[:, :plan.fit_ty].numel() * item + n_nn * 4
                       + out_k.numel() * 4, C * covers + out_k.numel()))
    return r11, r12


def check_band(x, y, plan, alpha=None, scale_by_pt=False, both=False,
               with_err=False, time_it=True):
    """K18 (and with with_err K19, both directions) against their plain
    versions on the card: K18's rows (and with both its columns) equal the
    plain version's except at near ties (`band_flips`); K19 within 1e-6
    relative on K18's own indices (f32 sums in another order).  With
    time_it, CUDA-event times, bounds and library times: K18 as baddbmm
    (the per-frame distances of pre-extracted patches), slice adds (the
    band) and argmin; K19 as take_along_dim, abs and mean.  Returns
    (K18's record, K19's record or None)."""
    import torch
    from videoloop3d_torch.losses import patch_nn as PN

    rows, cols = PN.nn_band_argmin(x, y, plan, alpha, scale_by_pt, both)
    _, flips, gap_abs, gap_dist, gap_scale = band_flips(
        x, y, plan, alpha, rows, scale_by_pt)
    n_flips, queries = int(flips.sum()), rows.numel()
    if both:
        _, cflips, cgap, cgap_dist, cgap_scale = band_flips(
            x, y, plan, alpha, cols, scale_by_pt, dim=2)
        n_flips += int(cflips.sum())
        queries += cols.numel()
        gap_abs, gap_dist, gap_scale = (max(gap_abs, cgap),
                                        max(gap_dist, cgap_dist),
                                        max(gap_scale, cgap_scale))
    (pt, _, _), (st, _, _) = plan.psz, plan.strides
    ntx, nty, nh, nw = plan.grid
    C = x.shape[0]
    d = C * plan.psz[1] * plan.psz[2]
    n_cols = len(plan.hs) * len(plan.ws) * nh * nw
    fx, fy = plan.fit[0], plan.fit_ty
    item = x.element_size()
    bf16 = x.dtype == torch.bfloat16
    r18 = dict(max_abs_err=gap_abs, index_flips=n_flips,
               flip_share=n_flips / queries, queries=queries,
               flip_gap_rel_distance=gap_dist,
               flip_gap_rel_term_scale=gap_scale,
               flip_limit_rel_term_scale=FLIP_LIMIT, crops=len(plan.hs)
               * len(plan.ws), columns=nh * nw, dim=d, frames=[fx, fy],
               patches=[ntx, nty])
    errs = []
    if with_err:
        for nn, reverse in ((rows, False), (cols, True))[:2 if both else 1]:
            got = PN.nn_band_err(x, y, plan, nn, reverse)
            want = PN.nn_band_err_plain(x, y, plan, nn, reverse)
            rel = float(((got - want).abs() / want.abs()).max())
            if not rel <= 1e-6:
                raise AssertionError(f"nn_band_err disagrees with its plain "
                                     f"version: {rel}")
            errs.append((nn, reverse, rel, float((got - want).abs().max())))
    if not time_it:
        return r18, None
    # pre-extracted per-frame patches for the library yardsticks (not
    # timed); bf16 patches: a bf16 GEMM with f32 sums and output
    ft, fh, fw = plan.fit
    Xf = torch.cat([PN._frame_patches(c, plan) for c in
                    PN._crops(x[:, :ft, :fh, :fw], plan)]).contiguous()
    Yf = torch.cat([PN._frame_patches(c, plan) for c in
                    PN._crops(y[:, :plan.fit_ty, :fh, :fw], plan)]).contiguous()
    xx = (Xf.float() ** 2).sum(-1)[..., :, None]
    yy = (Yf.float() ** 2).sum(-1)[..., None, :]
    YfT = Yf.transpose(1, 2)
    gemm = {"out_dtype": torch.float32} if bf16 else {}

    def lib18():
        d1 = torch.baddbmm(xx + yy, Xf, YfT, alpha=-2.0, **gemm) / d
        dist = PN.banded_temporal_dist_plain(d1, pt, st, ntx, nty)
        if scale_by_pt:
            dist = dist / pt
        if alpha is not None:
            dist = dist / (alpha + torch.amin(dist, dim=1, keepdim=True))
        return torch.argmin(dist, dim=2), (torch.argmin(dist, dim=1)
                                           if both else None)

    r18.update(
        ms=cuda_ms(lambda: PN.nn_band_argmin(x, y, plan, alpha, scale_by_pt,
                                             both), 10),
        plain_ms=cuda_ms(lambda: PN.nn_band_argmin_plain(
            x, y, plan, alpha, scale_by_pt, both), 2),
        library_ms=cuda_ms(lib18, 5),
        bound=bound_ms((x[:, :fx].numel() + y[:, :fy].numel()) * item
                       + queries * 4,
                       n_cols * (2 * fx * fy * d + 2 * (fx + fy) * d
                                 + 4 * fx * fy + (pt + 3) * ntx * nty),
                       BF16_OPS_PER_S if bf16 else F32_OPS_PER_S))
    if not with_err:
        return r18, None
    Xs, Ys = Xf.float(), Yf.float()
    r19 = {"max_abs_err": max(e[3] for e in errs),
           "max_rel_err": max(e[2] for e in errs), "directions": len(errs)}
    for nn, reverse, _, _ in errs:
        A, B = (Ys, Xs) if reverse else (Xs, Ys)
        ns = nn.shape[2]
        nt = ntx if reverse else nty
        idx = nn.reshape(-1, ns).long()[..., None]

        def lib19():
            tot = 0.0
            for k in range(pt):
                sel = torch.take_along_dim(B[:, k:k + (nt - 1) * st + 1:st],
                                           idx, dim=1)
                tot = tot + (sel - A[:, k:k + (ns - 1) * st + 1:st]).abs() \
                    .mean()
            return tot / pt

        tag = "reverse_" if reverse else ""
        r19[f"{tag}ms"] = cuda_ms(
            lambda: PN.nn_band_err(x, y, plan, nn, reverse), 10)
        r19[f"{tag}plain_ms"] = cuda_ms(
            lambda: PN.nn_band_err_plain(x, y, plan, nn, reverse), 2)
        r19[f"{tag}library_ms"] = cuda_ms(lib19, 5)
        r19[f"{tag}bound"] = bound_ms(
            (x[:, :fx].numel() + y[:, :fy].numel()) * item + nn.numel() * 4
            + len(plan.hs) * len(plan.ws) * 4, n_cols * ns * pt * d * 3)
    return r18, r19


def check_s2_kernels(args, model, params, batch):
    """Phase 14: K10, K9 on bf16 static tiles, K11 and K12 against their
    plain versions on the card at the stage-2 step's shapes (the s2_setup
    patch, both loss configs, f32 and bf16 search inputs), with
    CUDA-event times, bounds and library times.  Returns the records."""
    import torch
    from videoloop3d_torch.render import renderer as R
    from videoloop3d_torch.render import sample as S
    from videoloop3d_torch.train.stage2 import loss_config_from_args

    g = model.geom
    h, w = S2_PATCH
    G = R.homographies(g, batch["extrin"], batch["intrin"]).contiguous()
    _, k_s, k_d, fu, fv = R.warp_lookup(
        G, model.tile_map_static, model.tile_map_dyn, h, w,
        (g.mpi_h, g.mpi_w), g.tile_span)
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    rec = {}
    # K10 on the bf16 dynamic tiles: atomics add in no fixed order ->
    # 1e-5 relative to max|g|; through sample_tiles the gradient is that
    # f32 sum rounded once to bf16 (one bf16 ulp where the sums differ)
    dyn = params["atlas_dyn"].to(torch.bfloat16).contiguous()
    N, th, tw, F, C = dyn.shape
    k = k_d[0].contiguous()
    u = (fu[0] * (tw - 1)).contiguous()
    v = (fv[0] * (th - 1)).contiguous()
    ct = torch.randn(k.shape + (F, C), generator=gen, device=DEVICE)
    gargs = (ct, k, u, v, dyn.shape)
    g10 = S.bilinear_tiles_tilemajor_grad(*gargs)
    p10 = S.bilinear_tiles_tilemajor_grad_plain(*gargs)
    scale = float(p10.abs().max())
    e10 = max_err(g10, p10) / scale
    rounding = {}
    for key, kk, tiles in (("atlas_dyn", k, dyn),
                           ("atlas", k_s[0].contiguous(),
                            params["atlas"].to(torch.bfloat16).contiguous())):
        t = tiles.clone().requires_grad_(True)
        tu = (fu[0] * (t.shape[2] - 1)).contiguous()
        tv = (fv[0] * (t.shape[1] - 1)).contiguous()
        c = torch.randn(kk.shape + t.shape[3:], generator=gen, device=DEVICE)
        vals, _ = S.sample_tiles(t, kk, tu, tv)
        (vals * c).sum().backward()
        plain = (S.bilinear_tiles_grad_plain if t.dim() == 4
                 else S.bilinear_tiles_tilemajor_grad_plain)(
                     c, kk, tu, tv, t.shape)
        if t.grad.dtype != torch.bfloat16:
            raise AssertionError(f"{key}: gradient dtype {t.grad.dtype}")
        rounding[key] = max_err(t.grad, plain.to(torch.bfloat16)) / float(
            plain.abs().max())
        del t, c, vals, plain
    if not (e10 <= 1e-5 and max(rounding.values()) <= 2.0 ** -7):
        raise AssertionError(f"tile gradients disagree: K10 {e10}, bf16 "
                             f"rounding {rounding}")
    hits = int((k >= 0).sum())
    n = k.numel()
    rec["bilinear_tiles_tilemajor_grad"] = dict(
        max_abs_err=max_err(g10, p10), max_rel_err=e10,
        bf16_grad_max_rel_err=rounding, samples=n, hits=hits, tiles=N,
        ms=cuda_ms(lambda: S.bilinear_tiles_tilemajor_grad(*gargs), 10),
        plain_ms=cuda_ms(lambda: S.bilinear_tiles_tilemajor_grad_plain(
            *gargs), 2),
        library_ms=None,
        bound=bound_ms(n * 4 + hits * (8 + F * C * 4) + g10.numel() * 4,
                       hits * F * (8 * C + 10)))
    del g10, p10, ct
    torch.cuda.empty_cache()
    for ref in (False, True):
        cfg = loss_config_from_args(args, ref=ref)
        for bf16 in (False, True):
            cfg = dict(cfg, nn_bf16=bf16)
            tag = f"{'ref' if ref else 'other'}/{'bf16' if bf16 else 'f32'}"
            r11, r12 = check_nn(*s2_loss_inputs(model, params, batch, cfg))
            rec[f"nn_argmin/{tag}"] = r11
            rec[f"nn_fold/{tag}"] = r12
            torch.cuda.empty_cache()
    for name, r in rec.items():
        r = dict(r)
        b, by = r.pop("bound")
        print(json.dumps({"kernel_check": f"{name}/stage 2", **r,
                          "bound_ms": b, "bound_by": by}), flush=True)
    return rec


def s2_route(model, route, n_slots):
    """Put the stage-2 model on the shipped route (--compact_hits at
    n_slots slots, --fused_render) or on the unfused, uncompacted one."""
    import dataclasses
    shipped = route == "shipped"
    model.cfg = dataclasses.replace(model.cfg, fused_render=shipped)
    model.compact_slots = n_slots if shipped else None


def fused_s2_inputs(model, params, sweep):
    """K14/K15's inputs for one view's (S, h, w) sweep (k_s, k_d, fu, fv,
    valid, zview), as the training render makes them: the samples of the
    bf16 tiles, the masks and the masked reciprocal depth."""
    import torch
    from videoloop3d_torch.render import renderer as R
    k_s, k_d, fu, fv, valid, zview = sweep
    with torch.no_grad():
        vals_s, hit_s = R.sample_sparse(
            params["atlas"].to(model.gather_dtype).contiguous(), k_s, fu, fv)
        vals_d, hit_d = R.sample_sparse(
            params["atlas_dyn"].to(model.gather_dtype).contiguous(), k_d, fu,
            fv)
    ins = (vals_s, valid & hit_s, vals_d, hit_d, valid & hit_d)
    return ins, model._dinv(valid, zview).contiguous()


def fused_s2_ops(cfg, n_sp, n_dyn, F, backward):
    """Operations that the fused stage-2 function needs on this run's data
    (n_sp slot-pixels, n_dyn of them dynamic, F frames), each sample
    decoded once: a decode (4 sigmoids of 4 operations, 3 mask products,
    the alpha select: 20) per dynamic (slot, pixel, frame) and per static
    (slot, pixel).  The forward adds per (slot, pixel, frame) the composite
    (10: the blend weight, 3 products and 4 sums into out and alpha_sum,
    T *= 1 - a), the disparity (2), the sparsity sums (4) and, per smoothed
    channel, its right and down differences (2 x subtract, abs, add).  The
    backward adds per (slot, pixel, frame) the transmittance (2), the
    sparsity sums (4) and their terms (5), g_i (6, 8 with the disparity),
    da, dT and the rgb products (10), per smoothed channel the two
    differences and their signs (4) and their combination (6), and the
    sigmoid derivative (4 per channel) per dynamic (slot, pixel, frame),
    or the frame sum (4) per static (slot, pixel, frame) and one
    derivative per static (slot, pixel)."""
    n = n_sp * F
    n_stat = n_sp - n_dyn
    ch = 3 * cfg.use_rgb_smooth + cfg.use_a_smooth
    decode = 20 * (n_dyn * F + n_stat)
    if not backward:
        return decode + n * (10 + 2 * cfg.want_disp + 4 * cfg.use_sparsity
                             + 6 * ch)
    return (decode + n * (2 + 9 * cfg.use_sparsity + 6 + 2 * cfg.want_disp
                          + 10 + 10 * ch)
            + 16 * n_dyn * F + 4 * n_stat * F + 16 * n_stat)


def check_shipped_kernels(model, params, batch):
    """Phase 15: K13, K14 and K15 against their plain versions on the card
    at the shipped route's shapes (the s2_setup patch at its slot bound S,
    the samples of the bf16 tiles at slot volume, random cotangents), with
    CUDA-event times and bounds.  K13 must equal its plain version; K14
    within 1e-6 (outputs) and 2e-5 relative (the regularizer sums, summed
    in another order); K15 within 2e-5 * max|g|; both rerun bit for bit,
    at S and again uncompacted at S = D.  Returns (records, S)."""
    import torch
    from videoloop3d_torch.render import compact as CP
    from videoloop3d_torch.render import fused as FU
    from videoloop3d_torch.render import renderer as R

    g = model.geom
    h, w = S2_PATCH
    P = h * w
    D = g.n_planes
    maps = (model.tile_map_static, model.tile_map_dyn)
    n_slots = CP.slot_bound(g, *maps, batch["extrin"].cpu().numpy(),
                            batch["intrin"].cpu().numpy(), h, w)
    if not n_slots < D:
        raise AssertionError(f"slot bound {n_slots} of D={D}: no compaction")
    G = R.homographies(g, batch["extrin"], batch["intrin"]).contiguous()
    coords, k_s, k_d, fu, fv = R.warp_lookup(G, *maps, h, w,
                                             (g.mpi_h, g.mpi_w), g.tile_span)
    sweep = (k_s[0], k_d[0], fu[0], fv[0], coords.valid[0], coords.zview[0])
    cs = CP.compact_sweep(*sweep, n_slots)
    ps = CP.compact_sweep_plain(*sweep, n_slots)
    if not all(torch.equal(a, b) for a, b in zip(cs, ps)):
        raise AssertionError("compact_sweep differs from its plain version")
    hits = (k_s[0] >= 0) | (k_d[0] >= 0)
    kept = int(torch.minimum(hits.sum(0), torch.tensor(n_slots,
                                                       device=DEVICE)).sum())
    rec = {"compact_sweep": dict(
        max_abs_err=0.0, slots=n_slots, planes=D,
        max_hits=int(hits.sum(0).max()), mean_hits=float(hits.sum(0)
                                                         .float().mean()),
        ms=cuda_ms(lambda: CP.compact_sweep(*sweep, n_slots), 20),
        plain_ms=cuda_ms(lambda: CP.compact_sweep_plain(*sweep, n_slots), 5),
        library_ms=None,
        bound=bound_ms(D * P * 8 + kept * 13 + n_slots * P * 21, 0))}

    c = model.cfg
    shipped = FU.FusedCfg(D, c.sparsity_on, c.rgb_smooth_on, c.a_smooth_on,
                          c.d_smooth_on)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    # at the slot bound (the main path's shapes, timed below), then
    # uncompacted at S = D (--fused_render alone): the longest T_in sweep
    checks = {}
    for slots, sw in ((n_slots, cs), (D, sweep)):
        ins, dinv = fused_s2_inputs(model, params, sw)
        F = ins[2].shape[3]
        cts = [torch.randn(shp, generator=gen, device=DEVICE)
               for shp in ((h, w, F, 3), (h, w, F), (h, w, F), (3,))]
        worst = []
        for cfg in (FU.FusedCfg(D, True, True, True, True), shipped):
            dv = dinv if cfg.want_disp else None
            k14 = FU.fused_s2_fwd(cfg, *ins, dv)
            p14 = FU.fused_composite_fwd_plain(cfg, *ins, dv)
            e14 = max(max_err(a, b) for a, b in zip(k14[:3], p14[:3]))
            r14 = float(((k14[3] - p14[3]).abs()
                         / p14[3].abs().clamp(min=1e-30)).max())
            del p14
            k15 = FU.fused_s2_bwd(cfg, *ins, dv, *cts)
            p15 = FU.fused_composite_bwd_plain(cfg, *ins, dv, *cts)
            a15 = max(max_err(a, b) for a, b in zip(k15, p15))
            e15 = max(max_err(a, b) / float(b.abs().max())
                      for a, b in zip(k15, p15))
            del p15
            again = FU.fused_s2_fwd(cfg, *ins, dv)
            again_b = FU.fused_s2_bwd(cfg, *ins, dv, *cts)
            rerun = all(torch.equal(a, b) for a, b in zip(k14 + k15,
                                                          again + again_b))
            if not (e14 <= 1e-6 and r14 <= 2e-5 and e15 <= 2e-5 and rerun):
                raise AssertionError(
                    f"fused_s2 kernels disagree (S={slots}, {cfg}): {e14} "
                    f"{r14} {e15}, rerun equal {rerun}")
            del k14, k15, again, again_b
            torch.cuda.empty_cache()
            worst.append((e14, r14, a15, e15, rerun))
        cols = list(zip(*worst))         # the worst of the two flag sets
        checks[slots] = tuple(max(c) for c in cols[:4]) + (all(cols[4]),)
        if slots == n_slots:
            main_ins, main_dinv, main_cts = ins, dinv, cts
        del ins, dinv, cts
    ins, cts = main_ins, main_cts
    dvs = main_dinv if shipped.want_disp else None
    e14, r14, a15, e15, rerun = checks[n_slots]
    at_d = dict(zip(("max_abs_err", "regs_max_rel_err", "bwd_max_abs_err",
                     "bwd_max_rel_err", "bit_for_bit_rerun"), checks[D]))
    hit_d = ins[3]
    n_dyn = int(hit_d.sum())
    n_sp = hit_d.numel()
    # samples each (slot, pixel) selects, masks, dinv when on
    reads = (n_dyn * F * 16 + (n_sp - n_dyn) * 16 + n_sp * 3
             + (n_sp * 4 if shipped.want_disp else 0))
    # out and alpha_sum, the disparity when on, the three sums
    writes = P * F * (16 + 4 * shipped.want_disp) + 12
    rec["fused_s2_fwd"] = dict(
        max_abs_err=e14, regs_max_rel_err=r14, bit_for_bit_rerun=rerun,
        slots=n_slots, planes=D, at_slots_D=at_d,
        ms=cuda_ms(lambda: FU.fused_s2_fwd(shipped, *ins, dvs), 20),
        plain_ms=cuda_ms(lambda: FU.fused_composite_fwd_plain(
            shipped, *ins, dvs), 3),
        library_ms=None,
        bound=bound_ms(reads + writes,
                       fused_s2_ops(shipped, n_sp, n_dyn, F, False)))
    rec["fused_s2_bwd"] = dict(
        max_abs_err=a15, max_rel_err=e15, bit_for_bit_rerun=rerun,
        slots=n_slots, planes=D, at_slots_D=at_d,
        ms=cuda_ms(lambda: FU.fused_s2_bwd(shipped, *ins, dvs, *cts), 20),
        plain_ms=cuda_ms(lambda: FU.fused_composite_bwd_plain(
            shipped, *ins, dvs, *cts), 3),
        library_ms=None,
        # the cotangents read like the outputs written; the texel
        # cotangents (S, h, w, F, 4) and (S, h, w, 4) f32 written
        bound=bound_ms(reads + writes + n_sp * F * 16 + n_sp * 16,
                       fused_s2_ops(shipped, n_sp, n_dyn, F, True)))
    for name, r in rec.items():
        r = dict(r)
        b, by = r.pop("bound")
        print(json.dumps({"kernel_check": f"{name}/stage 2 shipped", **r,
                          "bound_ms": b, "bound_by": by}), flush=True)
    return rec, n_slots


def make_plain_fused_s2():
    """render.fused.fused_composite made of the plain forward and backward,
    for the plain composition of a shipped-route step (phase 16)."""
    import torch
    from videoloop3d_torch.render import fused as FU

    class PlainFusedS2(torch.autograd.Function):
        @staticmethod
        def forward(ctx, cfg, vals_s, m_s, vals_d, hit_d, m_d, dinv):
            ctx.cfg = cfg
            ctx.save_for_backward(vals_s, m_s, vals_d, hit_d, m_d, dinv)
            return FU.fused_composite_fwd_plain(cfg, vals_s, m_s, vals_d,
                                                hit_d, m_d, dinv)

        @staticmethod
        def backward(ctx, *grads):
            d_s, d_d = FU.fused_composite_bwd_plain(
                ctx.cfg, *ctx.saved_tensors, *(t.contiguous() for t in grads))
            return None, d_s, None, d_d, None, None, None

    def fused(cfg, vals_s, m_s, vals_d, hit_d, m_d, dinv):
        return FU.select_outputs(cfg, *PlainFusedS2.apply(
            cfg, vals_s, m_s, vals_d, hit_d, m_d, dinv))
    return fused


def make_plain_tile_sample():
    """renderer.sample_sparse made of the plain versions: the plain sample
    forward, the plain f32 gradient rounded once to the tiles' dtype
    backward (the kernels' rounding), for the plain composition of a
    stage-2 step (phase 16)."""
    import torch
    from videoloop3d_torch.render import sample as S

    class PlainTileSample(torch.autograd.Function):
        @staticmethod
        def forward(ctx, tiles, k, u, v):
            ctx.save_for_backward(k, u, v)
            ctx.shape, ctx.dtype = tiles.shape, tiles.dtype
            fwd = S.bilinear_tiles_plain if tiles.dim() == 4 \
                else S.bilinear_tiles_tilemajor_plain
            out, valid = fwd(tiles.detach(), k, u, v)
            ctx.mark_non_differentiable(valid)
            return out, valid

        @staticmethod
        def backward(ctx, g, _):
            k, u, v = ctx.saved_tensors
            bwd = S.bilinear_tiles_grad_plain if len(ctx.shape) == 4 \
                else S.bilinear_tiles_tilemajor_grad_plain
            return (bwd(g.contiguous(), k, u, v, ctx.shape).to(ctx.dtype),
                    None, None, None)

    def sample_sparse(tiles, k, fu, fv):
        th, tw = tiles.shape[1:3]
        return PlainTileSample.apply(tiles, k, fu * (tw - 1), fv * (th - 1))
    return sample_sparse


def s2_step_grads(args, model, params, batch, cfg, nn_kernel=None):
    """Metrics and atlas gradients of one stage-2 step (the loss of
    train/stage2.py:make_patch_loss_fn, shipped weights) on the model's
    route.  Without nn_kernel the step runs the kernels and returns K11's
    (under cfg's fast_nn_dist K18's) indices too; with nn_kernel (those
    indices) the plain versions are composed in the kernels' place, and
    where the plain search's choice differs at a near tie (`nn_flips`,
    `band_flips`) it takes the kernel's.  Returns
    (metrics, gradients, K11's indices or the number of near ties
    taken)."""
    import torch
    from videoloop3d_torch.losses import patch_nn as PN
    from videoloop3d_torch.models import mpv
    from videoloop3d_torch.render import compact as CP
    from videoloop3d_torch.render import renderer
    from videoloop3d_torch.train import common
    from videoloop3d_torch.train import stage2 as TS2

    weights = common.extra_loss_weights(args, TS2.STAGE2_WEIGHT_KEYS)
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    saved = (renderer.warp_lookup, renderer.sample_sparse, PN.nn_argmin,
             PN.nn_fold, mpv.compact_sweep, mpv.fused_composite,
             mpv.sample_planes_tilemajor, PN.nn_band_argmin)
    seen = []

    def kernel_nn(x, y, plan, alpha=None):
        seen.append(saved[2](x, y, plan, alpha))
        return seen[-1]

    def kernel_band(x, y, plan, alpha=None, scale_by_pt=False,
                    both_directions=False):
        out = saved[7](x, y, plan, alpha, scale_by_pt, both_directions)
        seen.append(out[0])
        return out

    def plain_nn(x, y, plan, alpha=None):
        nn_p, flips, *_ = nn_flips(x, y, plan, alpha, nn_kernel)
        seen.append(int(flips.sum()))
        return torch.where(flips, nn_kernel, nn_p)

    def plain_band(x, y, plan, alpha=None, scale_by_pt=False,
                   both_directions=False):
        nn_p, flips, *_ = band_flips(x, y, plan, alpha, nn_kernel,
                                     scale_by_pt)
        seen.append(int(flips.sum()))
        return torch.where(flips, nn_kernel, nn_p), None

    if nn_kernel is None:
        PN.nn_argmin, PN.nn_band_argmin = kernel_nn, kernel_band
    else:
        renderer.sample_sparse = make_plain_tile_sample()
        renderer.warp_lookup = renderer.warp_lookup_plain
        PN.nn_argmin, PN.nn_fold = plain_nn, PN.nn_fold_plain
        PN.nn_band_argmin = plain_band
        mpv.compact_sweep = CP.compact_sweep_plain
        mpv.fused_composite = make_plain_fused_s2()
        mpv.sample_planes_tilemajor = make_plain_plane_sample()
    try:
        total, metrics = TS2.make_patch_loss_fn(model, args, *S2_PATCH, cfg)(
            p, batch, weights)
        total.backward()
    finally:
        (renderer.warp_lookup, renderer.sample_sparse, PN.nn_argmin,
         PN.nn_fold, mpv.compact_sweep, mpv.fused_composite,
         mpv.sample_planes_tilemajor, PN.nn_band_argmin) = saved
    # (a dense model's empty static atlas gets no gradient)
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {k: p[k].grad for k in ("atlas", "atlas_dyn")
             if p[k].grad is not None}, seen[0])


def check_s2_step(args, model, params, batch, route, fast=False):
    """Phase 16: one stage-2 step with the kernels against the same step
    made of the plain versions on the card, on the model's route, for the
    ref-view (alpha 0) and the other-view loss config under the shipped
    --fp16 (bf16 texels and NN search): metrics to 1e-5 relative,
    gradients to one bf16 ulp (2^-7 * max|g|: both sum in f32 and round
    once to bf16, in another order).  Where the plain search breaks a
    near tie otherwise than K11 (`nn_flips`), the plain step takes K11's
    choice: a flipped patch moves its voxels' targets and so their
    gradients, and K11 is held to its plain version on its own in phase
    14.  With fast (--fast_nn_dist, phase 26) the search is K18, never
    K11, held the same way (`band_flips`)."""
    from videoloop3d_torch import kernels
    from videoloop3d_torch.train.stage2 import loss_config_from_args

    out = {}
    need = S2_ROUTES[route]
    if fast:
        need = tuple(k for k in need if k != "nn_argmin") + ("nn_band_argmin",)
    for ref in (True, False):
        cfg = dict(loss_config_from_args(args, ref=ref), fast_nn_dist=fast)
        kernels.reset_launches()
        m_k, g_k, nn_k = s2_step_grads(args, model, params, batch, cfg)
        launched = dict(kernels.LAUNCHES)
        m_p, g_p, ties = s2_step_grads(args, model, params, batch, cfg,
                                       nn_k)
        if (kernels.LAUNCHES != launched
                or any(launched[k] == 0 for k in need)
                or (fast and launched["nn_argmin"])):
            raise AssertionError(f"launches: kernel step {launched}, plain "
                                 f"step {kernels.LAUNCHES}")
        if route == "unfused" and any(launched[k] for k in SHIPPED_KERNELS):
            raise AssertionError(f"the unfused step launched {launched}")
        rel = max(abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-12)
                  for k in m_p)
        grel = max(max_err(g_k[k], g_p[k]) / float(g_p[k].abs().max())
                   for k in g_k)
        name = "ref" if ref else "other"
        if not (rel <= 1e-5 and grel <= 2.0 ** -7):
            raise AssertionError(f"stage-2 {route} {name} step differs from "
                                 f"its plain composition: metrics {rel}, "
                                 f"grads {grel}")
        out[name] = {"metrics_max_rel_err": rel, "grads_max_rel_err": grel,
                     "near_ties_taken_from_kernel": ties,
                     "nn_queries": nn_k.numel(), "loss": m_k["loss"],
                     "swd": m_k["swd"]}
    return out


def profile_s2_step(args, model, params, batch, clone=True):
    """Device busy share and device time by group of one warm stage-2
    train step on the ref-view config (Adam included), plus its
    host-clock time over 5 steps and the peak device memory.  With
    clone=False the steps update `params` in place (a 7 GB dense atlas is
    not copied)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from videoloop3d_torch.train import common
    from videoloop3d_torch.train import stage2 as TS2

    cfg = TS2.loss_config_from_args(args, ref=True)
    step, opt_init = TS2.make_stage2_step(model, args, *S2_PATCH, cfg)
    p = {k: v.detach().clone() for k, v in params.items()} if clone \
        else params
    opt = opt_init(p)
    weights = common.extra_loss_weights(args, TS2.STAGE2_WEIGHT_KEYS)
    for _ in range(2):
        step(p, opt, batch, 1e-3, weights)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(5):
        step(p, opt, batch, 1e-3, weights)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 200
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(p, opt, batch, 1e-3, weights)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = device_entries(prof)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    device_ms = sum(ms for ms, _ in by_name.values())
    return {"step_ms_5_steps": step_ms, "profiled_wall_ms": wall_ms,
            "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
            "max_memory_allocated_GB": peak / 1e9,
            "kernel_launches": sum(n for _, n in by_name.values()),
            "groups": device_groups(by_name),
            "top": [{"name": k[:60], "device_ms": ms, "calls": n}
                    for k, (ms, n) in rows[:12]]}


def drive_train_3dvid(s1_model, s1_params):
    """Phase 18: train_3dvid.main on the unmodified configs/mpv_base.txt
    (``--factor 1 --mpv_frm_num 50`` on the command line) from the cell-a
    sparse stage-1 model (written as a stage="mpi" checkpoint; it has
    dynamic tiles), on a 360x640 synthetic scene of 3 views x 50 frames:
    --pyr_init_level 4 --pyr_num_epoch 1 (levels 4 and 5 of 6: one lod
    downsample, one upsample, 12 + 27 steps), then --pyr_num_epoch 2,
    which must auto-resume at level 5, epoch 1.  Each level must print its
    hit-compaction line with S < D; every step must launch K2, K3 and
    K9-K15 once and K4 never; K1 runs once per step and once per view and
    level for the slot bound."""
    import torch
    from videoloop3d_torch.data import synthetic
    from videoloop3d_torch.tools import train_3dvid
    from videoloop3d_torch.train.stage1 import save_stage1_checkpoint

    init = os.path.join(WORK, "s2_init", "ckpt_epoch_0000.npz")
    save_stage1_checkpoint(init, s1_model, s1_params, 0)
    scene_dir = os.path.join(WORK, "s2_scene")
    n_views = 3
    scene = synthetic.make_scene(n_views=n_views, h=S1_HW[0], w=S1_HW[1],
                                 n_frames=50, seed=0)
    synthetic.write_llff_dir(scene, scene_dir, factor=1)
    del scene

    def argv(n_epoch):
        return ["--config", os.path.join(REPO, "configs", "mpv_base.txt"),
                "--factor", "1", "--datadir", scene_dir,
                "--expdir", os.path.join(WORK, "s2_runs"), "--expname", "s2",
                "--init_from", init, "--mpv_frm_num", "50",
                "--pyr_init_level", "4", "--pyr_num_epoch", str(n_epoch),
                "--i_img", "1", "--i_video", "1000"]

    def run(n_epoch, n_steps, n_levels, skip=0):
        torch.cuda.reset_peak_memory_stats()
        counts, rows, rundir, wall, out = run_train(argv(n_epoch),
                                                    train_3dvid)
        new = rows[skip:]
        loss = [(r["step"], r["value"]) for r in new
                if r["tag"] == "stage2/loss"]
        compaction = [ln for ln in out.splitlines() if "hit-compaction" in ln]
        want = {k: n_steps for k in S2_ROUTES["shipped"]}
        want["warp_lookup"] = n_steps + n_views * n_levels
        want["composite"] = 0
        bad = {k: counts[k] for k in want if counts[k] != want[k]}
        if (bad or len(loss) != n_steps or len(compaction) != n_levels
                or any("no win" in ln for ln in compaction)
                or not np.isfinite([v for _, v in loss]).all()):
            raise AssertionError(f"stage-2 run of {n_steps} steps: "
                                 f"launches {bad}, compaction {compaction}, "
                                 f"loss {loss}")
        warm = {r["tag"].split("/")[1]: r["value"] for r in new
                if "warm_step_ms" in r["tag"]}
        return rows, rundir, out, {
            "cli_wall_s": wall, "steps": n_steps, "launches": counts,
            "compaction_lines": compaction,
            "warm_step_ms": warm, "first_step": loss[0][0],
            "loss_first_last": [loss[0][1], loss[-1][1]],
            "max_memory_allocated_GB": torch.cuda.max_memory_allocated()
            / 1e9}

    rows, rundir, out, first = run(1, 39, 2)
    lines = [ln for ln in out.splitlines()
             if "no effect in the port" in ln or "--fast_stage2_grad" in ln
             or "activations" in ln]
    ckpt = os.path.join(rundir, "ckpt_l5_epoch_0000.npz")
    from videoloop3d_torch.models import checkpoint as ckpt_io
    meta = ckpt_io.load_checkpoint_meta(ckpt)
    if not (meta["stage"] == "mpv" and meta["is_sparse"]
            and meta["extra"]["pyr_i"] == 5):
        raise AssertionError(f"stage-2 checkpoint meta {meta}")
    _, _, r_out, resumed = run(2, 27, 1, skip=len(rows))
    if f"auto-resuming from {ckpt} at level 5 epoch 1" not in r_out \
            or resumed["first_step"] != 39:
        raise AssertionError("the rerun did not resume at level 5, epoch 1")
    return {k: first["launches"][k] + resumed["launches"][k]
            for k in first["launches"]}, {
        "route_lines": lines, "run": first, "resume": resumed}


def stage2_phases(s1_model, s1_params):
    """Phases 14-18.  Returns (kernel records, launches of the train_3dvid
    runs, the patch's slot bound)."""
    import torch
    args, model, params, batch = s2_setup()
    rec = check_s2_kernels(args, model, params, batch)
    rec["warp_lookup/uv noise"] = check_warp_lookup_noise(model, batch)
    shipped_rec, n_slots = check_shipped_kernels(model, params, batch)
    rec.update(shipped_rec)
    torch.cuda.empty_cache()
    for route in S2_ROUTES:
        s2_route(model, route, n_slots)
        print(json.dumps({"plain_step_check": f"stage 2, {route} route",
                          **check_s2_step(args, model, params, batch,
                                          route)}), flush=True)
    rec.update(check_band_training(args, model, params, batch))
    s2_route(model, "shipped", n_slots)
    print(json.dumps({"plain_step_check": "stage 2, shipped route, "
                      "--fast_nn_dist",
                      **check_s2_step(args, model, params, batch, "shipped",
                                      fast=True)}), flush=True)
    for route in S2_ROUTES:
        s2_route(model, route, n_slots)
        print(json.dumps({"profile": f"stage-2 step, ref view, {route} "
                          f"route (S={model.compact_slots} of D="
                          f"{model.geom.n_planes})",
                          **profile_s2_step(args, model, params, batch)}),
              flush=True)
    del model, params, batch
    torch.cuda.empty_cache()
    counts, summary = drive_train_3dvid(s1_model, s1_params)
    print(json.dumps({"train_3dvid": "configs/mpv_base.txt, levels 4-5",
                      **summary}), flush=True)
    fast_counts, summary = drive_train_3dvid_fast()
    print(json.dumps({"train_3dvid": "configs/mpv_base.txt --fast_nn_dist, "
                      "levels 4-5", **summary}), flush=True)
    counts["nn_band_argmin"] = fast_counts["nn_band_argmin"]
    return rec, counts


def check_band_training(args, model, params, batch):
    """Phase 26 (a): K18 against its plain version at the stage-2 step's
    search shapes under --fast_nn_dist (the s2_setup patch, the ref view
    at alpha 0 and the other view at alpha off, f32 and bf16 inputs; the
    banded sums divided by pt), timed with bounds and library times.
    Returns the records."""
    from videoloop3d_torch.train.stage2 import loss_config_from_args

    rec = {}
    for ref in (True, False):
        for bf16 in (True, False):
            cfg = dict(loss_config_from_args(args, ref=ref), nn_bf16=bf16)
            x, y, plan, alpha = s2_loss_inputs(model, params, batch, cfg)
            r, _ = check_band(x, y, plan, alpha, scale_by_pt=True)
            tag = f"{'ref' if ref else 'other'}/{'bf16' if bf16 else 'f32'}"
            rec[f"nn_band_argmin/train/{tag}"] = r
            print(json.dumps({"kernel": f"nn_band_argmin, stage 2 {tag}",
                              **r}), flush=True)
    return rec


def drive_train_3dvid_fast():
    """Phase 26 (b): train_3dvid.main with --fast_nn_dist on phase 18's
    setup (the unmodified configs/mpv_base.txt from the same sparse
    stage-1 checkpoint and scene, --pyr_init_level 4 --pyr_num_epoch 1:
    levels 4 and 5, 12 + 27 steps), with the launch counters set to 0
    just before and read just after: K18 and K12 once per step (one loss
    view a step), K11 never, the shipped route's kernels once per step,
    finite losses.  Returns (launches, summary)."""
    from videoloop3d_torch.tools import train_3dvid

    argv = ["--config", os.path.join(REPO, "configs", "mpv_base.txt"),
            "--factor", "1", "--datadir", os.path.join(WORK, "s2_scene"),
            "--expdir", os.path.join(WORK, "s2_runs"), "--expname", "s2fast",
            "--init_from", os.path.join(WORK, "s2_init", "ckpt_epoch_0000.npz"),
            "--mpv_frm_num", "50", "--pyr_init_level", "4",
            "--pyr_num_epoch", "1", "--fast_nn_dist", "--i_img", "1",
            "--i_video", "1000"]
    counts, rows, rundir, wall, _ = run_train(argv, train_3dvid)
    loss = [r["value"] for r in rows if r["tag"] == "stage2/loss"]
    n = len(loss)
    want = {k: n for k in S2_ROUTES["shipped"] if k != "nn_argmin"}
    # K1 also once per view and level for the slot bound
    want.update(nn_band_argmin=n, nn_argmin=0, composite=0,
                warp_lookup=n + 3 * 2)
    bad = {k: counts[k] for k in want if counts[k] != want[k]}
    if bad or n != 39 or not np.isfinite(loss).all():
        raise AssertionError(f"--fast_nn_dist run: launches {bad}, loss "
                             f"{loss}")
    warm = {r["tag"].split("/")[1]: r["value"] for r in rows
            if "warm_step_ms" in r["tag"]}
    shutil.rmtree(rundir, ignore_errors=True)
    return counts, {"cli_wall_s": wall, "steps": n, "launches": counts,
                    "warm_step_ms": warm, "loss_first_last": [loss[0],
                                                              loss[-1]]}


def check_warp_lookup_noise(model, batch):
    """Phase 19: K1 with uv-noise draws (--add_uv_noise on the sparse
    routes) against its plain version, bit for bit, at the s2_setup
    patch's shapes; without draws K1 still equals its plain version bit
    for bit.  Returns the record (time with draws, bound)."""
    import torch
    from videoloop3d_torch.render import renderer as R

    g = model.geom
    h, w = S2_PATCH
    G = R.homographies(g, batch["extrin"], batch["intrin"]).contiguous()
    k1_args = (G, model.tile_map_static, model.tile_map_dyn, h, w,
               (g.mpi_h, g.mpi_w), g.tile_span)
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    nx, ny = R.texel_noise(gen, (1, g.n_planes, h, w))
    same = {}
    for tag, extra in (("no noise", ()), ("noise", (nx, ny))):
        got = R.warp_lookup(*k1_args, *extra)
        ref = R.warp_lookup_plain(*k1_args, *extra)
        same[tag] = all(torch.equal(a, b) for a, b in zip(
            list(got[0]) + list(got[1:]), list(ref[0]) + list(ref[1:])))
    moved = int((got[1] != R.warp_lookup(*k1_args)[1]).sum())
    if not all(same.values()) or not moved:
        raise AssertionError(f"warp_lookup with noise: bit-equal {same}, "
                             f"{moved} samples moved to another tile")
    n1 = G.shape[1] * h * w
    rec = dict(max_abs_err=0.0, bit_equal=same, samples_moved_tile=moved,
               ms=cuda_ms(lambda: R.warp_lookup(*k1_args, nx, ny), 20),
               plain_ms=cuda_ms(lambda: R.warp_lookup_plain(*k1_args, nx,
                                                            ny), 5),
               library_ms=None,
               bound=bound_ms(G.numel() * 4 + 2 * model.tile_map_static
                              .numel() * 4 + n1 * 37, n1 * 27))
    r = dict(rec)
    b, by = r.pop("bound")
    print(json.dumps({"kernel_check": "warp_lookup/uv noise, stage 2", **r,
                      "bound_ms": b, "bound_by": by}), flush=True)
    return rec


def dense_s2_setup(seed=7):
    """A dense stage-2 model of the shipped config (configs/mpv_base.txt,
    --factor 1, F = 50, --fp16) at the scratch geometry of the 360x640
    scene (396x704 texel planes, D = 32) on the card, with a random atlas
    made there (colours N(0, 1), alpha N(-2, 1) before the sigmoids: every
    plane partly visible), and one batch as the trainer feeds it: a
    180x320 patch at the centre of the view, 0.05 to the side of the
    reference camera, with a random target video."""
    import torch
    from videoloop3d_torch.models.mpv import MPMeshVid

    args = s2_args()
    H, W = S1_HW
    ph, pw = S2_PATCH
    focal = 0.9 * W
    intrin = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                      np.float32)
    model = MPMeshVid(args, H, W, np.eye(4, dtype=np.float32), intrin, 2.0,
                      10.0, device=DEVICE)
    g = model.geom
    if (g.n_planes, g.mpi_h, g.mpi_w, model.frm_num) != (32, 396, 704, 50):
        raise AssertionError(f"dense geometry {g}")
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    dyn = torch.randn((g.n_planes, g.mpi_h, g.mpi_w, model.frm_num, 4),
                      generator=gen, device=DEVICE)
    dyn[..., 3] -= 2.0
    params = {"atlas": torch.zeros((0, 1, 1, 4), device=DEVICE),
              "atlas_dyn": dyn,
              "verts": torch.from_numpy(g.vertex_grid()).to(DEVICE)}
    ext = np.eye(4, dtype=np.float32)[None]
    ext[:, 0, 3] = 0.05
    pi = intrin.copy()
    pi[0, 2] -= (W - pw) / 2
    pi[1, 2] -= (H - ph) / 2
    batch = {"extrin": torch.as_tensor(ext, device=DEVICE),
             "intrin": torch.as_tensor(pi[None], device=DEVICE),
             "video": torch.rand((model.frm_num, ph, pw, 3), generator=gen,
                                 device=DEVICE)}
    return args, model, params, batch, intrin


def planes_touched(x, y, Ht, Wt):
    """Texels (plane, row, column) that the bilinear corners inside the
    plane read, for (D, N) coordinates: each counted once."""
    import torch
    D = x.shape[0]
    x0 = torch.floor(x).clamp(-2, Wt).long()
    y0 = torch.floor(y).clamp(-2, Ht).long()
    dd = torch.arange(D, device=x.device)[:, None]
    idx = []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        inside = (xi >= 0) & (xi < Wt) & (yi >= 0) & (yi < Ht)
        idx.append(((dd * Ht + yi) * Wt + xi)[inside])
    return torch.unique(torch.cat(idx)).numel()


def check_dense_kernels(model, params, batch, intrin):
    """Phase 20: K16 and K17 against their plain versions on the card at
    the dense stage-2 shapes: f32 and bf16 texels of the (32, 396, 704, 50,
    4) stack; the training patch (180x320 samples per plane, all frames)
    and an eval chunk (the whole 360x640 view, frames 20-29 through ts).
    K16 must equal its plain version bit for bit, K17 within 1e-5 * max|g|
    (atomics).  Timed with CUDA events beside their bounds, the plain
    versions and torch.nn.functional.grid_sample (align_corners=True,
    zeros padding) on a (D, F*C, Ht, Wt) copy of the texels made outside
    the timing (for K17 grid_sample's input gradient).  Returns the
    records."""
    import torch
    import torch.nn.functional as TF
    from videoloop3d_torch.render import renderer as R
    from videoloop3d_torch.render import sample as S

    g = model.geom
    D, Ht, Wt = g.n_planes, g.mpi_h, g.mpi_w
    F, C = model.frm_num, 4
    H, W = S1_HW
    coords = R.warp_coordinates(g, batch["extrin"], batch["intrin"],
                                *S2_PATCH)
    x = coords.x[0].reshape(D, -1).contiguous()
    y = coords.y[0].reshape(D, -1).contiguous()
    full = R.warp_coordinates(g, batch["extrin"],
                              torch.as_tensor(intrin[None], device=DEVICE),
                              H, W)
    xe = full.x[0].reshape(D, -1).contiguous()
    ye = full.y[0].reshape(D, -1).contiguous()
    ts = torch.arange(20, 30, dtype=torch.int32, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    ct = torch.randn(x.shape + (F, C), generator=gen, device=DEVICE)
    n, ne = x.numel(), xe.numel()
    touched = planes_touched(x, y, Ht, Wt)
    touched_e = planes_touched(xe, ye, Ht, Wt)

    def grid_of(xx, yy, hw):
        return torch.stack([xx / (Wt - 1) * 2 - 1, yy / (Ht - 1) * 2 - 1],
                           -1).reshape((D,) + hw + (2,)).contiguous()

    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        # grid_sample takes its grid in the input's dtype
        grid = grid_of(x, y, S2_PATCH).to(dtype)
        grid_e = grid_of(xe, ye, (H, W)).to(dtype)
        tex = params["atlas_dyn"].detach().to(dtype).contiguous()
        item = tex.element_size()
        # K16, bit for bit, at the training patch (all frames)...
        got = S.bilinear_planes_tilemajor(tex, x, y)
        e16 = max_err(got, S.bilinear_planes_tilemajor_plain(tex, x, y))
        # ...and at the eval chunk (10 frames through ts)
        got_e = S.bilinear_planes_tilemajor(tex, xe, ye, ts)
        e16e = max_err(got_e, S.bilinear_planes_tilemajor_plain(tex, xe, ye,
                                                                ts))
        # the library's layout, made once here and not timed
        lib = tex.permute(0, 3, 4, 1, 2).reshape(D, F * C, Ht, Wt) \
            .contiguous()
        lib_e = tex[..., 20:30, :].permute(0, 3, 4, 1, 2).reshape(
            D, 10 * C, Ht, Wt).contiguous()

        def gs(t, gr):
            return TF.grid_sample(t, gr, mode="bilinear",
                                  padding_mode="zeros", align_corners=True)

        # (a bf16 grid moves the samples: compared in f32 only)
        gs_diff = None
        if dtype == torch.float32:
            gs_diff = max_err(got, gs(lib, grid).reshape(D, F, C, -1)
                              .permute(0, 3, 1, 2))
        rec[f"bilinear_planes_tilemajor/{tag}"] = dict(
            max_abs_err=e16, eval_chunk_max_abs_err=e16e,
            grid_sample_max_abs_diff=gs_diff, samples=n,
            ms=cuda_ms(lambda: S.bilinear_planes_tilemajor(tex, x, y), 20),
            plain_ms=cuda_ms(lambda: S.bilinear_planes_tilemajor_plain(
                tex, x, y), 3),
            library_ms=cuda_ms(lambda: gs(lib, grid), 20),
            bound=bound_ms(n * 8 + touched * F * C * item + n * F * C * 4,
                           n * F * (9 * C + 10)))
        rec[f"bilinear_planes_tilemajor/{tag}/eval chunk"] = dict(
            max_abs_err=e16e, samples=ne, frames=int(ts.numel()),
            ms=cuda_ms(lambda: S.bilinear_planes_tilemajor(tex, xe, ye, ts),
                       10),
            plain_ms=cuda_ms(lambda: S.bilinear_planes_tilemajor_plain(
                tex, xe, ye, ts), 2),
            library_ms=cuda_ms(lambda: gs(lib_e, grid_e), 10),
            bound=bound_ms(ne * 8 + ts.numel() * 4
                           + touched_e * ts.numel() * C * item
                           + ne * ts.numel() * C * 4,
                           ne * ts.numel() * (9 * C + 10)))
        del got, got_e, lib_e
        torch.cuda.empty_cache()
        # K17: atomics add in no fixed order -> 1e-5 relative to max|g|
        g17 = S.bilinear_planes_tilemajor_grad(ct, x, y, tex.shape)
        p17 = S.bilinear_planes_tilemajor_grad_plain(ct, x, y, tex.shape)
        scale = float(p17.abs().max())
        e17 = max_err(g17, p17) / scale
        a17 = max_err(g17, p17)
        del g17, p17
        torch.cuda.empty_cache()
        lib_g = lib.requires_grad_(True)
        out_g = gs(lib_g, grid)
        cot_gs = ct.permute(0, 2, 3, 1).reshape(D, F * C, *S2_PATCH) \
            .contiguous().to(dtype)
        rec[f"bilinear_planes_tilemajor_grad/{tag}"] = dict(
            max_abs_err=a17, max_rel_err=e17, samples=n,
            ms=cuda_ms(lambda: S.bilinear_planes_tilemajor_grad(
                ct, x, y, tex.shape), 10),
            plain_ms=cuda_ms(lambda: S.bilinear_planes_tilemajor_grad_plain(
                ct, x, y, tex.shape), 2),
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                out_g, lib_g, cot_gs, retain_graph=True), 10),
            bound=bound_ms(n * 8 + n * F * C * 4 + D * Ht * Wt * F * C * 4,
                           n * F * (8 * C + 10)))
        del lib, lib_g, out_g, cot_gs, tex
        torch.cuda.empty_cache()
        if not (e16 == 0.0 and e16e == 0.0 and e17 <= 1e-5):
            raise AssertionError(f"dense kernels ({tag}) disagree with their "
                                 f"plain versions: K16 {e16} / {e16e}, K17 "
                                 f"{e17}")
    for name, r in rec.items():
        r = dict(r)
        b, by = r.pop("bound")
        print(json.dumps({"kernel_check": f"{name}/stage 2 dense", **r,
                          "bound_ms": b, "bound_by": by}), flush=True)
    return rec


def make_plain_plane_sample():
    """render.sample.sample_planes_tilemajor made of the plain versions:
    the plain forward, the plain f32 gradient rounded once to the
    texture's dtype backward (the kernels' rounding), for the plain
    composition of a dense stage-2 step and render (phases 21, 23)."""
    import torch
    from videoloop3d_torch.render import sample as S

    class PlainPlaneSample(torch.autograd.Function):
        @staticmethod
        def forward(ctx, tex, x, y):
            ctx.save_for_backward(x, y)
            ctx.shape, ctx.dtype = tex.shape, tex.dtype
            return S.bilinear_planes_tilemajor_plain(tex.detach(), x, y)

        @staticmethod
        def backward(ctx, g):
            x, y = ctx.saved_tensors
            return (S.bilinear_planes_tilemajor_grad_plain(
                g.contiguous(), x, y, ctx.shape).to(ctx.dtype), None, None)

    def sample(tex, x, y, ts=None):
        if ts is None:
            return PlainPlaneSample.apply(tex, x, y)
        return S.bilinear_planes_tilemajor_plain(tex, x, y, ts)
    return sample


def check_dense_step(args, model, params, batch, tag):
    """Phase 21: one dense stage-2 step (the ref-view loss config under
    the shipped --fp16) with the kernels against the same step made of the
    plain versions on the card: metrics to 1e-5 relative, gradients to one
    bf16 ulp (2^-7 * max|g|); near ties of the NN search taken from K11 as
    in phase 16.  The step must launch K16, K17, K11 and K12 and none of
    the sparse routes' kernels, whatever --compact_hits and --fused_render
    say."""
    from videoloop3d_torch import kernels
    from videoloop3d_torch.train.stage2 import loss_config_from_args

    cfg = loss_config_from_args(args, ref=True)
    kernels.reset_launches()
    m_k, g_k, nn_k = s2_step_grads(args, model, params, batch, cfg)
    launched = dict(kernels.LAUNCHES)
    m_p, g_p, ties = s2_step_grads(args, model, params, batch, cfg, nn_k)
    if (kernels.LAUNCHES != launched
            or any(launched[k] != 1 for k in DENSE_KERNELS)
            or not launched["nn_argmin"] or not launched["nn_fold"]
            or any(launched[k] for k in SPARSE_ROUTE_KERNELS)):
        raise AssertionError(f"dense {tag} step launches: kernel step "
                             f"{launched}, plain step {kernels.LAUNCHES}")
    rel = max(abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-12) for k in m_p)
    grel = max(max_err(g_k[k], g_p[k]) / float(g_p[k].abs().max())
               for k in g_k)
    if list(g_k) != ["atlas_dyn"] or not (rel <= 1e-5 and grel <= 2.0 ** -7):
        raise AssertionError(f"dense {tag} step differs from its plain "
                             f"composition: metrics {rel}, grads {grel}")
    return {"metrics_max_rel_err": rel, "grads_max_rel_err": grel,
            "near_ties_taken_from_k11": ties, "nn_queries": nn_k.numel(),
            "loss": m_k["loss"], "swd": m_k["swd"]}


def dense_step_phases():
    """Phases 20-22: K16/K17, one dense step with and without the
    training options, and a step profile.  Returns the kernel records."""
    import dataclasses
    import torch
    from videoloop3d_torch.render import renderer as R

    args, model, params, batch, intrin = dense_s2_setup()
    if not (args.compact_hits and args.fused_render and args.fp16):
        raise AssertionError("configs/mpv_base.txt lost its shipped flags")
    rec = check_dense_kernels(model, params, batch, intrin)
    print(json.dumps({"plain_step_check": "stage 2 dense, ref view",
                      **check_dense_step(args, model, params, batch,
                                         "shipped flags")}), flush=True)
    # --add_uv_noise --bg_color random: the same draws to both steps
    base_cfg = model.cfg
    model.cfg = dataclasses.replace(base_cfg, add_uv_noise=True,
                                    bg_color="random")
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    g = model.geom
    noisy = dict(batch, draws={
        "uv": R.texel_noise(gen, (1, g.n_planes) + S2_PATCH),
        "bg": torch.rand(3, generator=gen, device=DEVICE)})
    print(json.dumps({"plain_step_check": "stage 2 dense, ref view, "
                      "--add_uv_noise --bg_color random",
                      **check_dense_step(args, model, params, noisy,
                                         "uv-noise")}), flush=True)
    model.cfg = base_cfg
    torch.cuda.empty_cache()
    print(json.dumps({"profile": "stage-2 step, ref view, dense (D=32, "
                      "396x704 texels, F=50)",
                      **profile_s2_step(args, model, params, batch,
                                        clone=False)}), flush=True)
    del model, params, batch
    torch.cuda.empty_cache()
    return rec


def drive_dense_train_3dvid():
    """Phase 23: train_3dvid.main from scratch (no --init_from) on the
    unmodified configs/mpv_base.txt, only --factor 1 --mpv_frm_num 50
    --pyr_init_level 4 --pyr_num_epoch 1 on the command line, on phase
    18's 360x640 scene of 3 views x 50 frames (levels 4 and 5: 297x528 then
    396x704 texel planes, 12 + 27 steps), with the launch counters set to
    0 just before and read just after: K16 and K17 once per step, none of
    the sparse routes' kernels, finite losses that fall (the mean of the
    last five against the first five), and the dense stage="mpv"
    checkpoint of level 5.  Returns (launches, summary, run directory)."""
    import torch
    from videoloop3d_torch.models import checkpoint as ckpt_io
    from videoloop3d_torch.tools import train_3dvid

    argv = ["--config", os.path.join(REPO, "configs", "mpv_base.txt"),
            "--factor", "1", "--mpv_frm_num", "50",
            "--pyr_init_level", "4", "--pyr_num_epoch", "1",
            "--datadir", os.path.join(WORK, "s2_scene"),
            "--expdir", os.path.join(WORK, "s2d_runs"), "--expname", "dense",
            "--i_img", "1", "--i_video", "1000"]
    torch.cuda.reset_peak_memory_stats()
    counts, rows, rundir, wall, _ = run_train(argv, train_3dvid)
    loss = [(r["step"], r["value"]) for r in rows
            if r["tag"] == "stage2/loss"]
    vals = [v for _, v in loss]
    n_steps = len(loss)
    bad = {k: counts[k] for k in DENSE_KERNELS if counts[k] != n_steps}
    bad.update({k: counts[k] for k in SPARSE_ROUTE_KERNELS if counts[k]})
    if (bad or n_steps != 39 or not np.isfinite(vals).all()
            or not np.mean(vals[-5:]) < np.mean(vals[:5])):
        raise AssertionError(f"dense stage-2 run: launches {bad}, loss "
                             f"{loss}")
    ckpt = os.path.join(rundir, "ckpt_l5_epoch_0000.npz")
    meta = ckpt_io.load_checkpoint_meta(ckpt)
    if not (meta["stage"] == "mpv" and not meta["is_sparse"]
            and meta["extra"]["base_mpi_hw"] == [396, 704]):
        raise AssertionError(f"dense stage-2 checkpoint meta {meta}")
    warm = {r["tag"].split("/")[1]: r["value"] for r in rows
            if "warm_step_ms" in r["tag"]}
    return counts, {
        "cli_wall_s": wall, "steps": n_steps, "launches": counts,
        "warm_step_ms": warm, "loss": loss,
        "checkpoint_GB": os.path.getsize(ckpt) / 1e9,
        "max_memory_allocated_GB": torch.cuda.max_memory_allocated() / 1e9}


def plain_render_dense(model, params, h, w, ext, intr, ts):
    """A dense model's eval render composed of the plain versions only (the
    reference the kernels' render is held against), as uint8."""
    import torch
    from videoloop3d_torch.models import mpv

    saved = mpv.sample_planes_tilemajor
    mpv.sample_planes_tilemajor = make_plain_plane_sample()
    try:
        with torch.inference_mode():
            rgb, _ = model.render(params, h, w, ext, intr, ts)
    finally:
        mpv.sample_planes_tilemajor = saved
    return (255.0 * rgb.clamp(0.0, 1.0)).to(torch.uint8).cpu().numpy()


def drive_dense_render(scene_dir, expdir, expname, label):
    """Phase 24: render_video.main of a run's dense checkpoint, the fixed
    view 0 over the 50-frame loop in chunks of 10, with the launch
    counters set to 0 just before and read just after: K16 once per chunk
    and none of the sparse routes' kernels; the frames held against a
    render of the plain versions (|diff| <= 1 except on <= 0.1% of the
    pixels).  Returns (launches, summary)."""
    import torch
    from videoloop3d_torch.config import parse_args_with_configs
    from videoloop3d_torch.core import cameras
    from videoloop3d_torch.data import llff
    from videoloop3d_torch.eval.evaluate import load_mpv_from_run

    argv = ["--datadir", scene_dir, "--expdir", expdir, "--expname",
            expname, "--factor", "1", "--mpv_frm_num", "50", "--fp16",
            "--gpu_num", GPU_NUM]
    frames, counts, spent, wall = drive(argv + ["--v", "0"])
    H, W = S1_HW
    bad = {k: counts[k] for k in SPARSE_ROUTE_KERNELS if counts[k]}
    if counts["bilinear_planes_tilemajor"] != 5:
        bad["bilinear_planes_tilemajor"] = counts["bilinear_planes_tilemajor"]
    if (bad or frames.shape != (50, H, W, 3) or frames.dtype != np.uint8
            or frames.std() < 1.0):
        raise AssertionError(f"dense render {label}: launches {bad}, frames "
                             f"{frames.shape} std {frames.std()}")
    args = parse_args_with_configs(argv)
    _, _, scene = llff.load_mv_videos(
        scene_dir, factor=1, bd_factor=(args.near_factor, args.far_factor),
        recenter=True, render_frames=50)
    poses, intrins = scene["poses"], scene["intrins"]
    model, params, _, _ = load_mpv_from_run(
        args, H, W, cameras.pose_to_extrinsic(
            cameras.average_pose(poses)[:, :4]), intrins[0],
        float(scene["bds"].min()), float(scene["bds"].max()),
        device=torch.device(DEVICE))
    ext = cameras.pose_to_extrinsic(poses[:1]).astype(np.float32)
    worst = 0.0
    for t_idx in (0, 37):
        ref = plain_render_dense(model, params, H, W, ext, intrins[:1],
                                 [t_idx])[0]
        worst = max(worst, u8_close(frames[t_idx], ref))
    if worst > 1e-3:
        raise AssertionError(f"dense render {label} differs from the plain "
                             f"render on {worst:.2e} of pixels")
    g = model.geom
    summary = {"render": f"fixed view, dense {label}", "frames": len(frames),
               "planes": [g.n_planes, g.mpi_h, g.mpi_w, model.frm_num],
               "ms_per_frame": spent * 1e3 / len(frames), "cli_wall_s": wall,
               "plain_render_u8_diff_gt1_share": worst, "launches": counts}
    del model, params
    torch.cuda.empty_cache()
    return counts, summary


def dense_phases(s1_scene_dir):
    """Phases 20-24: the dense stage-2 phase.  Returns (kernel records,
    K16 and K17 launches of the main-path runs)."""
    rec = dense_step_phases()
    counts, summary = drive_dense_train_3dvid()
    print(json.dumps({"train_3dvid": "configs/mpv_base.txt from scratch, "
                      "levels 4-5", **summary}), flush=True)
    launches = {k: counts[k] for k in DENSE_KERNELS}
    renders = (
        (os.path.join(WORK, "s2_scene"), os.path.join(WORK, "s2d_runs"),
         "dense", "mpv checkpoint (the scratch run's)"),
        (s1_scene_dir, os.path.join(WORK, "s1_runs"), "shipped",
         "stage-1 checkpoint (576x1024, broadcast to 50 frames)"))
    for scene_dir, expdir, name, label in renders:
        r_counts, summary = drive_dense_render(scene_dir, expdir, name, label)
        print(json.dumps(summary), flush=True)
        launches["bilinear_planes_tilemajor"] += \
            r_counts["bilinear_planes_tilemajor"]
        if name == "dense":
            shutil.rmtree(expdir, ignore_errors=True)     # a 7 GB checkpoint
    return rec, launches


EVAL_SCALES = ((5, 2, 7, 1), (11, 4, 5, 1), (17, 6, 3, 1))
EVAL_HEADER = (["name", "nnf", "nnb", "dyn", "lpips", "lpips_sw", "loop",
                "psnr", "ssim"]
               + [f"{m}_p{p}s{s}pt{pt}st{st}" for m in ("nnf", "nnb", "loop")
                  for p, s, pt, st in EVAL_SCALES]
               + ["psnr_full", "ssim_full"])
EVAL_KERNELS = RENDER_KERNELS + ("nn_band_argmin", "nn_band_err")


def eval_argv():
    """evaluate's (and export_mesh's) arguments for phase 18's run: the
    shipped configs/mpv_base.txt (--fp16: bf16 texels in the render) at
    factor 1 and 50 frames."""
    return ["--config", os.path.join(REPO, "configs", "mpv_base.txt"),
            "--factor", "1", "--mpv_frm_num", "50",
            "--datadir", os.path.join(WORK, "s2_scene"),
            "--expdir", os.path.join(WORK, "s2_runs"), "--expname", "s2",
            "--gpu_num", GPU_NUM]


def lpips_weights(path, seed=0):
    """Seeded alex LPIPS weights in the layout of eval/lpips.py (He-scaled
    normal convolutions, |normal| linear heads), made locally."""
    from videoloop3d_torch.eval import lpips as L
    rng = np.random.default_rng(seed)
    out, ic = {"net": np.array("alex")}, 3
    for i, (oc, k, _, _) in enumerate(L._ALEX_CFG):
        out[f"conv{i}/w"] = rng.normal(0, (2.0 / (ic * k * k)) ** 0.5,
                                       (oc, ic, k, k)).astype(np.float32)
        out[f"conv{i}/b"] = rng.normal(0, 0.01, oc).astype(np.float32)
        ic = oc
    for i, c in enumerate(L._CHNS["alex"]):
        out[f"lin{i}/w"] = np.abs(rng.normal(0, 0.1, (1, c, 1, 1))).astype(
            np.float32)
    np.savez(path, **out)
    return path


def check_band_eval():
    """Phase 25: K18 and K19 against their plain versions on the card at
    the eval's shapes: view 0 of phase 18's scene (3, 50, 360, 640) and
    evaluate's render of phase 18's checkpoint, both cropped 40 px to
    280x560, u8 values in f32.  At each of the three patch scales: the
    pair (both directions from one K18 launch; K19 each way) and the Loop
    Quality seam (2 (pt - 1) frames of the render against the video).
    Returns {scale: (K18 record, K19 record)} (times of the pair)."""
    import torch
    from videoloop3d_torch.config import parse_args_with_configs
    from videoloop3d_torch.core import cameras
    from videoloop3d_torch.data import llff
    from videoloop3d_torch.data.video import to8b
    from videoloop3d_torch.eval.evaluate import load_mpv_from_run
    from videoloop3d_torch.losses import patch_nn as PN
    from videoloop3d_torch.train.stage2 import render_eval

    args = parse_args_with_configs(eval_argv())
    videos, _, sc = llff.load_mv_videos(
        os.path.join(WORK, "s2_scene"), factor=1,
        bd_factor=(args.near_factor, args.far_factor), recenter=True)
    H, W = sc["hw"]
    ref = cameras.pose_to_extrinsic(cameras.average_pose(sc["poses"])[:, :4])
    model, params, _, _ = load_mpv_from_run(
        args, H, W, ref, sc["intrins"][0], float(sc["bds"].min()),
        float(sc["bds"].max()), device=torch.device(DEVICE))
    pred = to8b(render_eval(model, params, H, W,
                            cameras.pose_to_extrinsic(sc["poses"][:1]),
                            sc["intrins"][:1], np.arange(50), chunk=2))
    del model, params
    c = 40

    def cfhw(v):
        return torch.as_tensor(np.ascontiguousarray(np.moveaxis(
            v[:, c:-c, c:-c].astype(np.float32), -1, 0)), device=DEVICE)

    gt, pr = cfhw(np.asarray(videos[0])), cfhw(pred)
    del videos
    out = {}
    for p, s, pt, st in EVAL_SCALES:
        psz, strides = (pt, p, p), (st, s, s)
        plan = PN.lowmem_plan(50, 50, gt.shape[2], gt.shape[3], psz, strides,
                              65)
        r18, r19 = check_band(gt, pr, plan, both=True, with_err=True)
        seam = torch.cat([pr[:, -pt + 1:], pr[:, :pt - 1]], 1).contiguous()
        splan = PN.lowmem_plan(seam.shape[1], 50, gt.shape[2], gt.shape[3],
                               psz, strides, 65)
        s18, _ = check_band(seam, gt, splan, with_err=True, time_it=False)
        r18["seam"] = {k: s18[k] for k in ("index_flips", "queries",
                                           "flip_gap_rel_term_scale")}
        tag = f"p{p}s{s}pt{pt}st{st}"
        out[tag] = (r18, r19)
        print(json.dumps({"kernel": f"nn_band_argmin, eval pair {tag}",
                          **r18}), flush=True)
        print(json.dumps({"kernel": f"nn_band_err, eval pair {tag}",
                          **r19}), flush=True)
        torch.cuda.empty_cache()
    return out


def drive_evaluate():
    """Phase 27: ``python -m videoloop3d_torch.tools.evaluate``'s main on
    phase 18's sparse mpv checkpoint (3 views x 50 frames, 360x640), with
    seeded locally made alex LPIPS weights named by VL3D_LPIPS_WEIGHTS and
    the launch counters set to 0 just before and read just after: K1-K4,
    K18 and K19 launched; eval_metrics.txt's header equal to the JAX
    package's column list and every value finite; the nnf, nnb and loop
    columns within 1e-3 relative of the same metrics computed through
    K18's and K19's plain versions on the card (near ties may break
    otherwise).  Returns (launches, summary)."""
    import contextlib
    import io
    import torch
    from videoloop3d_torch import kernels
    from videoloop3d_torch.config import parse_args_with_configs
    from videoloop3d_torch.eval.evaluate import evaluate
    from videoloop3d_torch.losses import patch_nn as PN
    from videoloop3d_torch.tools import evaluate as tool

    os.environ["VL3D_LPIPS_WEIGHTS"] = lpips_weights(
        os.path.join(WORK, "lpips_alex.npz"))
    buf = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            table = tool.main(eval_argv())
    finally:
        print(buf.getvalue(), end="", flush=True)
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    seconds = next(json.loads(ln[len("[eval] "):])["seconds"]
                   for ln in buf.getvalue().splitlines()
                   if ln.startswith('[eval] {"seconds"'))
    with open(table["path"]) as f:
        lines = f.read().splitlines()
    # the masked static PSNR/SSIM of a view whose static mask is empty are
    # -inf/NaN in both packages (the reference's npix correction); every
    # other value must be finite
    static = static_shares()
    masked = [EVAL_HEADER.index(k) for k in ("psnr", "ssim")]
    bad = [(ln.split(", ")[0], EVAL_HEADER[i])
           for row, ln in enumerate(lines[1:])
           for i, v in enumerate(ln.split(", ")[1:], 1)
           if not np.isfinite(float(v))
           and not (i in masked and min(static[row:row + 1] or static) == 0)]
    idle = [k for k in EVAL_KERNELS if counts[k] == 0]
    if idle or lines[0].split(", ") != EVAL_HEADER or len(lines) != 5 or bad:
        raise AssertionError(f"evaluate: idle kernels {idle}, non-finite "
                             f"{bad}, table {lines}")
    saved = (PN.nn_band_argmin, PN.nn_band_err)
    PN.nn_band_argmin, PN.nn_band_err = PN.nn_band_argmin_plain, \
        PN.nn_band_err_plain
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            plain = evaluate(parse_args_with_configs(eval_argv()),
                             compute_flags={"static": False, "dyn": False,
                                            "lpips": False},
                             device=torch.device(DEVICE))
    finally:
        PN.nn_band_argmin, PN.nn_band_err = saved
    rel = max(abs(a - b) / abs(b) for k in ("nnf", "nnb", "loopq")
              for ra, rb in zip(table[k], plain[k]) for a, b in zip(ra, rb))
    if not rel <= 1e-3:
        raise AssertionError(f"evaluate's NN metrics differ from the plain "
                             f"versions' by {rel}")
    return counts, {"evaluate": "tools.evaluate on phase 18's checkpoint",
                    "cli_wall_s": wall, "seconds_by_group": seconds,
                    "static_mask_share_by_view": static,
                    "launches": counts, "header": lines[0],
                    "aggregate_row": lines[-1],
                    "nn_metrics_max_rel_err_vs_plain": rel}


def static_shares():
    """The share of the static (not loopable) mask inside the eval's 40 px
    crop, per view of phase 18's scene (host numpy, as evaluate)."""
    from videoloop3d_torch.data import llff
    from videoloop3d_torch.data.loopmask import compute_loopable_mask
    videos, _, _ = llff.load_mv_videos(os.path.join(WORK, "s2_scene"),
                                       factor=1, recenter=True)
    out = []
    for v in videos:
        c = min(40, v.shape[1] // 4, v.shape[2] // 4)
        out.append(float(1.0 - compute_loopable_mask(np.asarray(v) / 255)
                         [c:-c, c:-c].mean()))
    return out


def drive_export():
    """Phase 28: ``python -m videoloop3d_torch.tools.export_mesh``'s main
    on the same checkpoint: geometry.obj with 2 faces per kept tile, the
    static atlas packing_grid x the tile size, 50 dynamic frames, and
    meta.json's frame_count 50.  Returns the summary."""
    from videoloop3d_torch.export.mesh_export import packing_grid
    from videoloop3d_torch.export.objio import load_obj
    from videoloop3d_torch.models import checkpoint as ckpt_io
    from videoloop3d_torch.tools import export_mesh

    t0 = time.perf_counter()
    outdir = export_mesh.main(eval_argv() + [
        "--mesh_folder", os.path.join(WORK, "meshes")])
    wall = time.perf_counter() - t0
    ck = ckpt_io.load_checkpoint(ckpt_io.latest_checkpoint(
        os.path.join(WORK, "s2_runs", "s2")))
    n_s = int((ck["tile_map_static"] >= 0).sum())
    n_d = int((ck["tile_map_dyn"] >= 0).sum())
    th, tw = ck["meta"]["tile_hw"]
    _, _, faces, _ = load_obj(os.path.join(outdir, "geometry.obj"))

    def image(name):
        path = os.path.join(outdir, name)
        if os.path.exists(path + ".npy"):
            return np.load(path + ".npy")
        import imageio.v2 as imageio
        return imageio.imread(path)

    rows, cols = packing_grid(n_s)
    static = image("static.png")
    frames = sorted(os.listdir(os.path.join(outdir, "dynamic")))
    with open(os.path.join(outdir, "meta.json")) as f:
        meta = json.load(f)
    if (len(faces) != 2 * (n_s + n_d)
            or static.shape != (rows * th, cols * tw, 4)
            or len(frames) != 50 or meta["frame_count"] != 50):
        raise AssertionError(f"export: {len(faces)} faces for {n_s} + {n_d} "
                             f"tiles, static {static.shape}, "
                             f"{len(frames)} frames, meta {meta}")
    return {"export_mesh": "tools.export_mesh on phase 18's checkpoint",
            "cli_wall_s": wall, "tiles": [n_s, n_d], "faces": len(faces),
            "static_atlas": list(static.shape),
            "dynamic_atlas": list(image(os.path.join("dynamic", "0000.png"))
                                  .shape), "frames": len(frames)}


def eval_phases():
    """Phases 25, 27 and 28.  Returns (kernel records, launches of the
    evaluate run)."""
    rec = check_band_eval()
    counts, summary = drive_evaluate()
    print(json.dumps(summary), flush=True)
    print(json.dumps(drive_export()), flush=True)
    return rec, counts


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from videoloop3d_torch import kernels
    from videoloop3d_torch.data import synthetic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)

    t = time.perf_counter()
    _, report = kernels.build()
    kernels.library()
    print(json.dumps({"phase": "build", "s": time.perf_counter() - t}))
    print("\n".join(ln for ln in report.splitlines()
                    if "registers" in ln or "spill" in ln
                    or ln.startswith("==")))

    t = time.perf_counter()
    mtv = synthetic.make_sparse_mtv(quick=False, seed=0)
    ns, nd = len(mtv["params"]["atlas"]), len(mtv["params"]["atlas_dyn"])
    if (ns, nd, mtv["tile_hw"]) != (9786, 4257, (12, 12)):
        raise AssertionError(f"unexpected MTV: {ns}, {nd}, {mtv['tile_hw']}")
    frm = mtv["frm_num"]
    scene_dir = build_inputs(mtv)
    del mtv
    print(json.dumps({"phase": "mtv", "tiles_static": ns, "tiles_dyn": nd,
                      "s": time.perf_counter() - t}), flush=True)

    model, params, ext, intr, hw = fixed_view(scene_dir, frm)
    rec = check_kernels(model, params, ext, intr, hw)

    fixed, c_fixed, s_fixed, w_fixed = drive(
        cli_argv(scene_dir, frm, ["--v", "0"]))
    spiral, c_spiral, s_spiral, w_spiral = drive(
        cli_argv(scene_dir, frm, ["--f", "10"]))
    for name, counts in (("fixed", c_fixed), ("spiral", c_spiral)):
        idle = [k for k in RENDER_KERNELS if counts[k] == 0]
        if idle:
            raise AssertionError(f"{name} render never launched {idle}")
    H, W = hw
    if fixed.shape != (frm, H, W, 3) or spiral.shape != (10, H, W, 3):
        raise AssertionError(f"frame shapes {fixed.shape} {spiral.shape}")
    for frames in (fixed, spiral):
        if frames.dtype != np.uint8 or frames.std() < 1.0:
            raise AssertionError("rendered frames are constant")
    if np.abs(fixed[0].astype(np.int16) - fixed[25]).max() == 0:
        raise AssertionError("the fixed view does not move over the loop")

    # three rendered frames against the plain-version render on the card
    worst = 0.0
    for t_idx in (0, 37):
        ref = plain_render(model, params, H, W, ext, intr, [t_idx])[0]
        worst = max(worst, u8_close(fixed[t_idx], ref))
    from videoloop3d_torch.core import cameras
    from videoloop3d_torch.data import llff
    sc = llff.load_llff_scene(scene_dir, factor=1, bd_factor=(0.9, 2.0),
                              render_frames=10)
    sp_ext = cameras.pose_to_extrinsic(sc["render_poses"][3:4])
    ref = plain_render(model, params, H, W, sp_ext.astype(np.float32),
                       sc["render_intrins"][3:4], [3])[0]
    worst = max(worst, u8_close(spiral[3], ref))
    if worst > 1e-3:
        raise AssertionError(f"render differs from the plain render on "
                             f"{worst:.2e} of pixels")
    print(json.dumps({
        "render": "fixed view", "frames": len(fixed),
        "ms_per_frame": s_fixed * 1e3 / len(fixed),
        "cli_wall_s": w_fixed, "launches": c_fixed}))
    print(json.dumps({
        "render": "spiral", "frames": len(spiral),
        "ms_per_frame": s_spiral * 1e3 / len(spiral),
        "cli_wall_s": w_spiral, "launches": c_spiral}))
    print(json.dumps({"plain_render_check": "u8 |diff|>1 share",
                      "worst": worst}))
    print(json.dumps({"profile": "fixed view, one 10-frame chunk",
                      **profile_render(model, params, hw, ext, intr,
                                       np.arange(CHUNK), CHUNK)}))
    print(json.dumps({"profile": "spiral, one frame",
                      **profile_render(model, params, hw,
                                       sp_ext.astype(np.float32),
                                       sc["render_intrins"][3:4], [3], 1)}))

    s1_rec, s1_launches, s1_scene_dir = stage1_phases()
    sp_rec, sp_launches, (s1_model, s1_params) = sparse_phases(s1_scene_dir)
    s2_rec, s2_launches = stage2_phases(s1_model, s1_params)
    del s1_model, s1_params
    d_rec, d_launches = dense_phases(s1_scene_dir)
    q_rec, q_launches = eval_phases()

    out = []
    for name in REPLACES:
        if name in s1_rec:
            r = s1_rec[name]
            ship, fused = s1_launches["shipped"][name], \
                s1_launches["fused"][name]
            extra = {"launches": ship + fused, "launches_shipped": ship,
                     "launches_fused": fused}
        elif name == "bilinear_tiles_grad":
            r = sp_rec[name]
            extra = {"launches": sp_launches[name] + s2_launches[name],
                     "launches_s1_sparse": sp_launches[name],
                     "launches_s2": s2_launches[name]}
        elif name in ("bilinear_tiles_tilemajor_grad",) + SHIPPED_KERNELS:
            r = s2_rec[name]
            extra = {"launches": s2_launches[name]}
        elif name in DENSE_KERNELS:
            # the bf16 texels of the shipped --fp16, training patch
            r = d_rec[f"{name}/bf16"]
            extra = {"launches": d_launches[name],
                     "f32_ms": d_rec[f"{name}/f32"]["ms"]}
        elif name in ("nn_band_argmin", "nn_band_err"):
            # the eval pair at the first patch scale, (5, 2, 7, 1)
            r18, r19 = q_rec["p5s2pt7st1"]
            r = r18 if name == "nn_band_argmin" else r19
            train = s2_launches.get(name, 0)
            extra = {"launches": q_launches[name] + train,
                     "launches_evaluate": q_launches[name],
                     "launches_train_fast_nn_dist": train,
                     "ms_by_scale": {t: q_rec[t][name == "nn_band_err"]["ms"]
                                     for t in q_rec}}
            if name == "nn_band_argmin":
                extra["train_ref_bf16_ms"] = \
                    s2_rec["nn_band_argmin/train/ref/bf16"]["ms"]
        elif name in ("nn_argmin", "nn_fold"):
            # the ref view's bf16 search: the shipped route's costliest
            r = s2_rec[f"{name}/ref/bf16"]
            extra = {"launches": s2_launches[name],
                     "other_view_bf16_ms": s2_rec[f"{name}/other/bf16"]["ms"],
                     "other_view_bf16_bound_ms":
                         s2_rec[f"{name}/other/bf16"]["bound"][0]}
        else:
            r = rec[name] if name in rec else rec[f"{name}/bf16"]
            extra = {"launches": c_fixed[name] + c_spiral[name]
                     + sp_launches[name] + s2_launches[name]
                     + q_launches[name],
                     "launches_fixed": c_fixed[name],
                     "launches_spiral": c_spiral[name],
                     "launches_s1_sparse": sp_launches[name],
                     "launches_s2": s2_launches[name],
                     "launches_evaluate": q_launches[name]}
        b, by = r["bound"]
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], **extra,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": b, "bound_by": by,
            "library_ms": r.get("library_ms")})
    shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
