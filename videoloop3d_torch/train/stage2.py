"""Stage-2 training: optimize the looping Multi-plane Tile Video
(counterpart of ``videoloop3d_tpu/train/stage2.py``, ref
train_3dvid.py:69-344, without its multi-device branches).

A host loop owns the resolution pyramid (`lod`, a fresh optimizer and a
fresh dataset per level), the per-view loss configs (the reference views
get the big-patch, high-gain config), the adaptive learning rate
(divided by the number of steps of the epoch), checkpoints and previews.
A step renders all frames of a patch (the sparse training render of
``models/mpv.py``), applies the view's looping loss and the weighted
regularizers, then Adam (eps 6e-8) updates the parameter tensors in
place.  The looping losses: the GPNN target built without gradient and a
robust penalty (``losses/patch_nn.py``: "gpnn_lm", "gpnn" with kernels
K11 and K12, under ``--fast_nn_dist`` K18 and K12; "gpnn_down", K11 on
the downsampled video and K12's parent mode; the "ssim" patch distance,
K11's ssim mode), or the sliced-Wasserstein loss "swd"
(``losses/swd.py``: K24, K25, K26).

The port trains from a sparse stage-1 checkpoint (either package's), on
the shipped route (``--compact_hits``: a per-level slot bound from
``render/compact.py:slot_bound`` and the K13 compaction in the render;
``--fused_render``: K14/K15) or with either flag off, as the JAX package
does; and the dense phase, from a scratch start (no ``--init_from``:
``MPMeshVid.init_params(args.seed)``) or a dense stage-1 checkpoint, whose
render is K16/K17 and the unfused composite whatever those two flags say.
Every decoder and activation of the JAX package trains: a decoder other
than direct, or another activation, takes the unfused composite under
``--fused_render`` (`MPMeshConfig.fused_decoder`), as in the JAX package.
A torch.Generator on the device, seeded from ``--seed``, gives every
step its ``--add_uv_noise`` and ``--bg_color random`` draws, then the swd
loss's projections and permutation.  Arguments that would reach an
unported part (``parallel/``) raise `NotImplementedError` at start-up
(`check_supported`), before any work.  `render_eval` is the chunked eval
render of the render and eval tools.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from videoloop3d_torch.core import cameras
from videoloop3d_torch.core.activations import get_activation
from videoloop3d_torch.data import llff
from videoloop3d_torch.data.patches import VideoPatchDataset
from videoloop3d_torch.data.video import to8b, write_video
from videoloop3d_torch.export.mesh_export import (full_tile_map,
                                                  save_mesh_preview)
from videoloop3d_torch.losses import patch_nn as pnl
from videoloop3d_torch.losses import swd
from videoloop3d_torch.models import checkpoint as ckpt_io
from videoloop3d_torch.models.mpmesh import _atlas_channels
from videoloop3d_torch.models.mpv import MPMeshVid
from videoloop3d_torch.render.compact import slot_bound
from videoloop3d_torch.train import common, optimizer as opt_lib

STAGE2_WEIGHT_KEYS = ("sparsity", "rgb_smooth", "a_smooth", "d_smooth",
                      "density")


def _rundir(args):
    return os.path.join(args.prefix, args.expdir,
                        args.expname + args.expname_postfix)


def loss_config_from_args(args, ref=False):
    """The two per-view loss configs (ref train_3dvid.py:160-192)."""
    sfx = "_ref" if ref else ""
    cfg = {
        "loss_name": getattr(args, f"loss_name{sfx}"),
        "patch_size": getattr(args, f"swd_patch_size{sfx}"),
        "patcht_size": getattr(args, f"swd_patcht_size{sfx}"),
        "stride": getattr(args, f"swd_stride{sfx}"),
        "stridet": getattr(args, f"swd_stridet{sfx}"),
        "alpha": getattr(args, f"swd_alpha{sfx}"),
        "rou": getattr(args, f"swd_rou{sfx}"),
        "scaling": getattr(args, f"swd_scaling{sfx}"),
        "dist_fn": getattr(args, f"swd_dist_fn{sfx}"),
        "macro_block": args.swd_macro_block,
        "factor": getattr(args, f"swd_factor{sfx}"),
        "loss_gain": args.swd_loss_gain_ref if ref else 1.0,
        "num_proj": args.swd_num_proj,
        "fast_nn_dist": bool(args.fast_nn_dist),
    }
    ovr = getattr(args, "fast_nn_dist_ref" if ref else "fast_nn_dist_other")
    if ovr:
        cfg["fast_nn_dist"] = ovr == "on"
    # the NN search and target in bf16 (they carry no gradient): follows
    # --fp16 unless --nn_bf16 says otherwise
    cfg["nn_bf16"] = (args.nn_bf16 == "on") if args.nn_bf16 \
        else bool(args.fp16)
    return cfg


def pyramid_schedule(args, H, W):
    """(factor, (h, w), num_epoch) per level (ref train_3dvid.py:103-120)."""
    if args.pyr_minimal_dim < 0:
        stages = ([int(s) for s in args.pyr_stage.split(",")]
                  if args.pyr_stage else [])
        stages = np.array([0] + stages + [args.N_iters])
        epochs = (stages[1:] - stages[:-1]).tolist()
        factors = [args.pyr_factor ** i for i in reversed(range(len(epochs)))]
    else:
        num = int(np.log(args.pyr_minimal_dim / min(H, W))
                  / np.log(args.pyr_factor)) + 1
        factors = [args.pyr_factor ** i for i in reversed(range(num))]
        epochs = [args.pyr_num_epoch] * num
    hw = [(int(H * f), int(W * f)) for f in factors]
    return list(zip(factors, hw, epochs))


def _ref_views(args):
    return [int(i) for i in args.loss_ref_idx.split(",")] \
        if args.loss_ref_idx else []


def check_supported(args):
    """Raise NotImplementedError, naming the ROADMAP item, when the
    arguments would reach a part of stage 2 the port does not have (the
    multi-device layer), and the JAX package's errors for an unknown
    loss, distance, decoder or activation.  Reads only the arguments."""
    def nyi(what, item):
        raise NotImplementedError(f"{what} is not ported yet (ROADMAP "
                                  f"{item})")

    refs = set(_ref_views(args))
    for ref in (False, True):
        if ref and not refs:
            continue
        sfx = "_ref" if ref else ""
        name = getattr(args, f"loss_name{sfx}")
        if name != "swd" and name not in pnl.LOSS_FNS:
            raise ValueError(f"unknown loss_name{sfx} '{name}'")
        dist_fn = getattr(args, f"swd_dist_fn{sfx}")
        if dist_fn not in pnl.DIST_FNS:
            raise ValueError(f"unknown swd_dist_fn{sfx} '{dist_fn}'")
    _atlas_channels(args.rgb_mlp_type, args.atlas_cnl)
    for name in (args.rgb_activate, args.alpha_activate):
        get_activation(name)
    if args.shard_views:
        nyi("--shard_views", "Queue A item 5: parallel/")
    if args.mesh_fp > 1:
        nyi("--mesh_fp", "Queue A item 5: parallel/")
    multi = (args.mesh_devices > 1 or args.num_processes > 1
             or args.coordinator_address
             or (args.mesh_devices == 0 and int(args.gpu_num) > 0
                 and torch.cuda.device_count() > 1))
    if multi:
        nyi("training on more than one device (pass --mesh_devices 1)",
            "Queue A item 5: parallel/")


def set_compact_slots(model, args, dataset, tag):
    """--compact_hits: the level's slot bound S on the padded level grid
    (patches are integer crops of it, so the per-view bound with its
    intrinsic-jitter margin covers every training patch), set as
    ``model.compact_slots``, or None when S == D (no win) or the flag is
    off.  Prints the JAX trainer's line."""
    model.compact_slots = None
    if not (args.compact_hits and model.is_sparse):
        return
    D = model.geom.n_planes
    S = slot_bound(model.geom, model.tile_map_static, model.tile_map_dyn,
                   cameras.pose_to_extrinsic(dataset.poses), dataset.intrins,
                   dataset.h + dataset.pad[0], dataset.w + dataset.pad[1])
    if S < D:
        model.compact_slots = S
    print(f"{tag} hit-compaction: S={S} of D={D}"
          + ("" if model.compact_slots else " (no win; off)"))


def device_crop(videos, view, h0, w0, ph, pw):
    """One training patch cropped on the device from the level's resident
    (V, F, H, W, 3) uint8 video stack: (F, ph, pw, 3) f32 in [0, 1]."""
    crop = videos[view, :, h0:h0 + ph, w0:w0 + pw]
    return crop.float() / 255.0


def resolve_video(batch, ph, pw):
    """batch["video"] cropped from the resident stack, unless the caller
    passed it (tests).  Training draws the caller passed ("draws") are
    kept."""
    if "video" in batch:
        return batch
    out = {"extrin": batch["extrin"], "intrin": batch["intrin"],
           "video": device_crop(batch["videos"], batch["view"],
                                batch["h0"], batch["w0"], ph, pw)}
    if "draws" in batch:
        out["draws"] = batch["draws"]
    return out


def make_patch_loss_fn(model: MPMeshVid, args, ph, pw, losscfg):
    """(params, batch {extrin, intrin, video (F, ph, pw, 3)[, draws]},
    weights[, gen]) -> (total loss, metrics) for one patch.  The random
    inputs are batch["draws"] when given (the render's, and under "swd"
    draws["swd"], `swd.swd_draws`' dict), else drawn from the
    torch.Generator gen: the render's first
    (``models/mpmesh.py:training_draws``), then the swd loss's (the JAX
    package draws both from the step's key)."""
    cfg = dict(losscfg)
    loss_name = cfg.pop("loss_name")
    loss_gain = float(cfg.pop("loss_gain", 1.0))
    num_proj = int(cfg.pop("num_proj", 256))
    pad_frames = (cfg["patcht_size"] - 1) if model.isloop else 0

    def loss(x, y, batch, gen):
        if loss_name != "swd":
            return pnl.LOSS_FNS[loss_name](x, y, **cfg)
        draws = (batch.get("draws") or {}).get("swd")
        if draws is None:
            if gen is None:
                raise ValueError("the swd loss needs a generator or "
                                 "batch['draws']['swd']")
            pt, st = cfg["patcht_size"], cfg["stridet"]
            draws = swd.swd_draws(
                gen, num_proj, x.shape[0], pt, cfg["patch_size"],
                swd.swd_n_short((x.shape[1] - pt) // st + 1,
                                (y.shape[1] - pt) // st + 1))
        return swd.swd_3d_loss(x, y, draws=draws, num_proj=num_proj, **cfg)

    def loss_fn(p, batch, weights, gen=None):
        rgb, variables = model.render(p, ph, pw, batch["extrin"],
                                      batch["intrin"], None, training=True,
                                      gen=gen, draws=batch.get("draws"))
        x = rgb.permute(3, 0, 1, 2)                   # (3, F, h, w)
        if pad_frames > 0:                            # loop closure pad
            x = torch.cat([x, x[:, :pad_frames]], dim=1)
        if args.scale_invariant:
            gain = common.scale_invariant_gain(
                torch.mean(batch["video"], dim=0),
                torch.mean(rgb.detach(), dim=0))
            x = x * gain
        y = batch["video"].permute(3, 0, 1, 2)
        main = loss(x, y, batch, gen) * loss_gain
        total = main
        metrics = {"swd": main}
        for k, v in model.training_extras(variables, loss_gain).items():
            metrics[k] = v
            total = total + weights[k] * v
        metrics["loss"] = total
        return total, metrics

    return loss_fn


def make_stage2_step(model: MPMeshVid, args, ph, pw, losscfg):
    """Returns (step, opt_init).  opt_init(params) builds the optimizer
    (Adam with eps 6e-8, or SGD) over the params dict; step(params,
    optimizer, batch, lr, weights, gen=None) takes one optimizer step in
    place, the render's draws from the torch.Generator gen, and returns
    the metrics (detached tensors)."""
    group_fn = opt_lib.make_group_fn(args.optimize_verts_gain)
    loss_fn = make_patch_loss_fn(model, args, ph, pw, losscfg)

    def opt_init(params):
        opt_lib.trainable(params)
        return opt_lib.make_optimizer(args.optimizer, params, group_fn,
                                      eps=6e-8)

    def step(params, optimizer, batch, lr, weights, gen=None):
        batch = resolve_video(batch, ph, pw)
        optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_fn(params, batch, weights, gen)
        total.backward()
        opt_lib.set_lr(optimizer, lr)
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step, opt_init


def render_eval(model, params, h, w, extrin, intrin, ts_list, chunk=2,
                u8=False):
    """Chunked full-frame eval render of one view over frames `ts_list`.

    Each chunk renders `chunk` frames in one call; the last chunk is
    padded by repeating its last frame.  u8=True quantizes on the device
    with ``(255 * clip(rgb, 0, 1)).to(uint8)`` (multiply, then truncate,
    the same bytes as ``data/video.py:to8b``), so 4x fewer bytes reach
    the host.  Returns (len(ts_list), h, w, 3) numpy.
    """
    frames = []
    ts_list = np.asarray(ts_list)
    with torch.inference_mode():
        e = torch.as_tensor(np.asarray(extrin), dtype=torch.float32,
                            device=model.device)
        i = torch.as_tensor(np.asarray(intrin), dtype=torch.float32,
                            device=model.device)
        for c in range(0, len(ts_list), chunk):
            sel = ts_list[c:c + chunk]
            pad = chunk - len(sel)
            sel_p = np.concatenate([sel, np.repeat(sel[-1:], pad)]) if pad \
                else sel
            rgb = model.render(params, h, w, e, i, sel_p)[0]
            if u8:
                rgb = (255.0 * rgb.clamp(0.0, 1.0)).to(torch.uint8)
            frames.append(rgb[:len(sel)].cpu().numpy())
    return np.concatenate(frames)


def save_stage2_checkpoint(path, model, params, pyr_i, epoch, epoch_total,
                           iter_total, factor, hw):
    """A sparse or dense stage-2 checkpoint (the JAX package's schema and
    ``extra_meta`` keys)."""
    ckpt_io.save_checkpoint(
        path, geom=model.geom, params=params, stage="mpv",
        is_sparse=model.is_sparse, has_dyn=True,
        tile_map_static=model.tile_map_static,
        tile_map_dyn=model.tile_map_dyn, tile_hw=model.tile_hw,
        frm_num=model.frm_num,
        extra_meta={"epoch_i": epoch, "pyr_i": pyr_i,
                    "epoch_total_step": epoch_total,
                    "iter_total_step": iter_total,
                    "train_factor": factor, "hw": list(hw),
                    "base_tile_hw": list(model.base_tile_hw)
                    if model.base_tile_hw else None,
                    "base_mpi_hw": [model.base_geom.mpi_h,
                                    model.base_geom.mpi_w],
                    "rgb_mlp_type": model.cfg.rgb_mlp_type,
                    "rgb_activate": model.cfg.rgb_activate,
                    "alpha_activate": model.cfg.alpha_activate})


def _epoch_batches(dataset, np_rng):
    """The epoch's patches in the JAX trainer's single-device order (and
    random draws): the shuffled items grouped by loss config, then the
    one-item batches shuffled."""
    groups = {}
    for item in dataset.iter_epoch(np_rng, shuffle=True):
        groups.setdefault(repr(sorted(item["losscfg"].items())),
                          []).append(item)
    batches = [(k, it) for k, items in groups.items() for it in items]
    np_rng.shuffle(batches)
    return batches


def _preview(model, params, scene, H, W, fps, rundir, pyr_i, epoch):
    """The i_video artifacts (ref train_3dvid.py:318-331): the spiral
    render (up to two loops, one frame per pose) and the mesh preview
    (the dense phase's: every tile, as the dynamic mesh)."""
    r_ext = cameras.pose_to_extrinsic(scene["render_poses"])
    frames = [render_eval(model, params, H, W, r_ext[ri:ri + 1],
                          scene["render_intrins"][ri:ri + 1],
                          [ri % model.frm_num], chunk=1, u8=True)[0]
              for ri in range(min(len(r_ext), 2 * model.frm_num))]
    write_video(os.path.join(rundir, f"l{pyr_i}_{epoch:04d}_rgb.mp4"),
                to8b(np.stack(frames)), fps=fps)
    if model.is_sparse:
        maps = (model.tile_map_static.cpu().numpy(),
                model.tile_map_dyn.cpu().numpy())
    else:
        maps = (None, full_tile_map(model.geom))
    save_mesh_preview(model.geom, *maps,
                      os.path.join(rundir, f"mesh_l{pyr_i}_{epoch:04d}"))


def train(args, device, shutdown):
    """The stage-2 loop on `device` over the `lod` pyramid.  Returns
    (model, params, rundir).  `shutdown` (a `common.GracefulShutdown`)
    stops the run at the next step with a resumable checkpoint."""
    check_supported(args)
    device = torch.device(device)
    expdir = os.path.join(args.prefix, args.expdir)
    rundir = _rundir(args)
    datadir = os.path.join(args.prefix, args.datadir)

    videos, fps, scene = llff.load_mv_videos(
        basedir=datadir, factor=args.factor,
        bd_factor=(args.near_factor, args.far_factor), recenter=True)
    H, W = scene["hw"]
    poses, intrins, bds = scene["poses"], scene["intrins"], scene["bds"]
    test_view = [int(t) for t in args.test_view_idx.split(",")] \
        if args.test_view_idx else []
    train_view = sorted(set(range(len(videos))) - set(test_view))
    videos = [videos[i] for i in train_view]
    poses, intrins = poses[train_view], intrins[train_view]
    ref_extrin = cameras.pose_to_extrinsic(cameras.average_pose(poses)[:, :4])
    near, far = float(bds.min()), float(bds.max())

    logger = common.MetricsLogger(rundir)
    common.snapshot_run(expdir, args.expname + args.expname_postfix, args)

    model = MPMeshVid(args, H, W, ref_extrin, intrins[0], near, far,
                      device=device)
    resume_at = None
    latest = None if args.disable_auto_resume \
        else ckpt_io.latest_checkpoint(rundir)
    if latest is not None:
        ckpt = ckpt_io.load_checkpoint(latest)
        if ckpt["meta"]["stage"] == "mpv":
            params = model.restore_checkpoint(ckpt)
            ex = ckpt["meta"].get("extra", {})
            resume_at = (int(ex.get("pyr_i", 0)),
                         int(ex.get("epoch_i", -1)) + 1,
                         int(ex.get("epoch_total_step", 0)) + 1,
                         int(ex.get("iter_total_step", 0)))
            print(f"[stage2] auto-resuming from {latest} at level "
                  f"{resume_at[0]} epoch {resume_at[1]}")
    if resume_at is None:
        if args.init_from:
            params = model.init_from_stage1(ckpt_io.load_checkpoint(
                os.path.join(args.prefix, args.init_from)))
        else:
            params = model.init_params(args.seed)

    # per-view loss configs (ref train_3dvid.py:160-192)
    cfg_other = loss_config_from_args(args, ref=False)
    cfg_ref = loss_config_from_args(args, ref=True)
    ref_idxs = _ref_views(args)
    loss_cfgs = [cfg_ref if v in ref_idxs else cfg_other for v in train_view]
    weights = common.extra_loss_weights(args, STAGE2_WEIGHT_KEYS)

    np_rng = np.random.default_rng(args.seed)
    # the renders' uv-noise and background draws (JAX: a PRNGKey split
    # per step; another stream, the same distributions)
    gen = torch.Generator(device=device).manual_seed(int(args.seed))
    schedule = pyramid_schedule(args, H, W)
    print("[stage2] pyramid:", [(f"{f:.3f}", hw, n) for f, hw, n in schedule])
    if not args.no_render_remat:
        print("[stage2] the port keeps the training render's activations "
              "(no recompute in the backward): without --no_render_remat "
              "the JAX package recomputes them, a memory trade that changes "
              "no number")

    prof = common.Profiler(args, rundir, device)
    watchdog = common.HangWatchdog(args.hang_timeout, "stage2")
    epoch_total, iter_total = 0, 0
    start_level, start_epoch = max(int(args.pyr_init_level), 0), 0
    if resume_at is not None:
        start_level, start_epoch, epoch_total, iter_total = resume_at
    metrics = {}
    stopping = False
    try:
        for pyr_i, (factor, hw, num_epoch) in enumerate(schedule):
            if pyr_i < start_level:
                continue
            params = model.lod(params, factor)
            dataset = VideoPatchDataset(
                hw, videos, (args.patch_h_size, args.patch_w_size),
                (args.patch_h_stride, args.patch_w_stride), poses, intrins,
                loss_cfgs)
            ph, pw = dataset.patch_size
            set_compact_slots(model, args, dataset, f"[stage2] l{pyr_i}")
            common.set_sparse_fastpath_bounds(
                model, args, f"[stage2] l{pyr_i}",
                fast_grad_flag="fast_stage2_grad")
            # the level's padded uint8 videos live on the device once; a
            # step crops its patch there
            videos_dev = torch.as_tensor(np.stack(dataset.videos),
                                         device=device)
            steps = {}
            for item_cfg in loss_cfgs:
                k = repr(sorted(item_cfg.items()))
                if k not in steps:
                    steps[k] = make_stage2_step(model, args, ph, pw,
                                                item_cfg)
            optimizer = next(iter(steps.values()))[1](params)
            watchdog.tick()

            for epoch in range(num_epoch):
                if pyr_i == start_level and epoch < start_epoch:
                    continue
                batches = _epoch_batches(dataset, np_rng)
                interrupted = False
                for cfg_key, item in batches:
                    lr = opt_lib.lr_schedule(epoch, args.lrate,
                                             decay_steps_k=args.lrate_decay)
                    if args.lrate_adaptive:
                        # the per-epoch update budget stays constant (ref
                        # train_3dvid.py:283-287)
                        lr = lr / len(batches)
                    intrin = item["intrin"]
                    if args.add_intrin_noise:
                        intrin = common.jitter_intrinsic(intrin, np_rng)
                    w0, h0 = item["wh_start"]
                    batch = {
                        "extrin": torch.as_tensor(
                            cameras.pose_to_extrinsic(item["pose"])[None]
                            .astype(np.float32), device=device),
                        "intrin": torch.as_tensor(
                            np.asarray(intrin, np.float32)[None],
                            device=device),
                        "videos": videos_dev, "view": item["view"],
                        "h0": h0, "w0": w0,
                    }
                    prof.step(iter_total)
                    metrics = steps[cfg_key][0](params, optimizer, batch, lr,
                                                weights, gen)
                    # bounded run-ahead of the host over the device
                    if iter_total % 8 == 0:
                        float(metrics["loss"])
                    prof.tick()
                    watchdog.tick()
                    if (iter_total + 1) % args.i_img == 0:
                        for k, v in metrics.items():
                            logger.scalar(f"stage2/{k}", float(v),
                                          iter_total)
                        logger.scalar("stage2/lr", lr, iter_total)
                    iter_total += 1
                    if shutdown.requested:
                        interrupted = True
                        break

                if metrics:
                    print(f"[stage2] l{pyr_i} epoch {epoch} "
                          f"loss={float(metrics['loss']):.4f} "
                          f"swd={float(metrics['swd']):.4f} "
                          f"({prof.steps_per_sec():.2f} it/s)")

                stopping = interrupted or shutdown.requested
                if stopping:
                    # a mid-epoch stop saves with epoch-1 metadata so the
                    # auto-resume re-runs the partial epoch; at epoch 0 the
                    # previous level's checkpoint (or the stage-1 init) is
                    # the resume point
                    ce = epoch - 1 if interrupted else epoch
                    cet = epoch_total - 1 if interrupted else epoch_total
                    if ce >= 0:
                        save_stage2_checkpoint(
                            os.path.join(rundir,
                                         f"ckpt_l{pyr_i}_epoch_{ce:04d}.npz"),
                            model, params, pyr_i, ce, cet, iter_total,
                            factor, hw)
                    print(f"[stage2] graceful shutdown at l{pyr_i} epoch "
                          f"{epoch}: checkpointed epoch {ce}; rerun to "
                          f"resume")
                    break

                if (epoch_total + 1) % args.i_weights == 0 \
                        or (pyr_i == len(schedule) - 1
                            and epoch == num_epoch - 1):
                    save_stage2_checkpoint(
                        os.path.join(rundir,
                                     f"ckpt_l{pyr_i}_epoch_{epoch:04d}.npz"),
                        model, params, pyr_i, epoch, epoch_total, iter_total,
                        factor, hw)
                    watchdog.tick()
                if (epoch_total + 1) % args.i_video == 0:
                    _preview(model, params, scene, H, W, fps, rundir, pyr_i,
                             epoch)
                    watchdog.tick()
                epoch_total += 1
            _log_warm_step(prof, logger, pyr_i, iter_total)
            if stopping:
                break
    finally:
        watchdog.stop()
        prof.close()
    logger.close()
    return model, params, rundir


def _log_warm_step(prof, logger, pyr_i, iter_total):
    """Log and print the warm step time of the level that is ending
    (``stage2/warm_step_ms_l<i>``), then start the timing anew."""
    step_ms = prof.warm_step_ms()
    prof.reset_timing()
    if step_ms is None:
        return
    key = f"warm_step_ms_l{pyr_i}"
    logger.scalar(f"stage2/{key}", step_ms, iter_total)
    print("[stage2] " + json.dumps({key: step_ms, "steps": iter_total}))
