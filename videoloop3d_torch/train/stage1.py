"""Stage-1 training: fit the static MPI and the learned 3D loop mask,
cull tiles at ``--sparsify_epoch`` and train the packed tiles, widen a
direct atlas to rgb_sh at ``--direct2sh_epoch``, and from epoch
``--optimize_geo_start`` on train the vertex grids too, in either phase
(counterpart of ``videoloop3d_tpu/train/stage1.py``, ref
train_3d.py:98-363).  Every decoder
(``--rgb_mlp_type``) and activation of the JAX package trains; a resume
takes the decoder and activations the checkpoint was saved with.

A train step (forward, loop BCE in the dense phase, scale-invariant MSE,
weighted regularizers, backward, optimizer step) driven by a host loop
that owns the data, the lr and density schedules, the tile cull,
checkpoints and previews.  The step updates the parameter tensors in
place; the cull and the direct -> SH conversion rebuild the step and the
optimizer (Adam's state starts again, as JAX's ``opt_init``).  More than
one process trains data-parallel (``parallel/dp_step.py``: each rank
takes its ``--patch_batch`` row of the global batch); with
``--shard_views`` each process decodes and holds only its own views, and
rows out of patches take weight-0 fillers.  Only rank 0 writes files.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from videoloop3d_torch.core import cameras
from videoloop3d_torch.core.activations import clip, get_activation
from videoloop3d_torch.data import llff
from videoloop3d_torch.data.patches import ImagePatchDataset
from videoloop3d_torch.data.video import to8b, write_image, write_video
from videoloop3d_torch.export.mesh_export import (full_tile_map,
                                                  save_mesh_preview)
from videoloop3d_torch.models import checkpoint as ckpt_io
from videoloop3d_torch.models.mpmesh import (MPMesh, _atlas_channels,
                                             convert_direct_to_sh)
from videoloop3d_torch.models.sparsify import apply_tile_cull
from videoloop3d_torch.parallel import distributed as dist
from videoloop3d_torch.parallel.dp_step import reduce_step
from videoloop3d_torch.render.geo_warp import vertex_crossing_report
from videoloop3d_torch.train import common, optimizer as opt_lib

STAGE1_WEIGHT_KEYS = ("sparsity", "rgb_smooth", "a_smooth", "d_smooth",
                      "l_smooth", "density")


def _rundir(args):
    return os.path.join(args.prefix, args.expdir,
                        args.expname + args.expname_postfix)


def check_supported(args):
    """Raise the JAX package's errors for an unknown decoder or
    activation and for ``--shard_views`` with ``--patch_batch`` > 1, and
    for ``--mesh_devices`` other than the number of processes
    (`distributed.check_world`), before any work."""
    if args.shard_views and max(int(args.patch_batch), 1) > 1:
        raise ValueError("--shard_views with stage-1 --patch_batch>1 is "
                         "not supported (per-row weight masking is one "
                         "patch per dp row)")
    _atlas_channels(args.rgb_mlp_type, args.atlas_cnl)
    for name in (args.rgb_activate, args.alpha_activate):
        get_activation(name)
    dist.check_world(args)


def resolve_image_batch(batch, h, w):
    """Crop the rgb / loop-mask patches on the device from the
    run-resident image and mask stacks, unless the batch carries them
    (tests).  Training draws the caller passed ("draws") are kept."""
    if "rgb" in batch:
        return batch
    rgbs, lms = [], []
    for v, y0, x0 in zip(batch["view"], batch["h0"], batch["w0"]):
        v, y0, x0 = int(v), int(y0), int(x0)
        rgbs.append(batch["images"][v, y0:y0 + h, x0:x0 + w])
        lms.append(batch["masks"][v, y0:y0 + h, x0:x0 + w])
    out = {"extrin": batch["extrin"], "intrin": batch["intrin"],
           "rgb": torch.stack(rgbs), "loopmask": torch.stack(lms)}
    if "draws" in batch:
        out["draws"] = batch["draws"]
    return out


def make_stage1_loss_fn(model: MPMesh, args, h, w):
    """(params, batch {extrin, intrin, rgb, loopmask[, draws]}, weights[,
    gen]) -> (total loss, metrics) for a batch of B patches (the loss is
    the batch mean).  The loop-mask loss exists in the dense phase only.
    The render's random inputs are batch["draws"] when given, else drawn
    from the torch.Generator gen (``models/mpmesh.py:training_draws``)."""
    learn_loop = model.cfg.learn_loop_mask and not model.is_sparse

    def loss_fn(p, batch, weights, gen=None):
        rgbl, extra = model.forward(p, h, w, batch["extrin"],
                                    batch["intrin"], training=True, gen=gen,
                                    draws=batch.get("draws"))
        rgb = rgbl[..., :3]
        loop_loss = 0.0
        if learn_loop:
            loop = clip(rgbl[..., 3], 0.001, 0.999)
            gt_loop = batch["loopmask"]
            entropy = gt_loop * torch.log(loop) \
                + (1 - gt_loop) * torch.log(1 - loop)
            loop_loss = -torch.mean(entropy)
        if args.scale_invariant:
            rgb = rgb * common.scale_invariant_gain(batch["rgb"],
                                                    rgb.detach())
        img_loss = common.mse(rgb, batch["rgb"])
        total = img_loss + loop_loss
        metrics = {"mse": img_loss, "loop_bce": loop_loss}
        for k, v in extra.items():
            metrics[k] = v
            total = total + weights[k] * v
        metrics["loss"] = total
        metrics["psnr"] = common.mse_to_psnr(img_loss)
        return total, metrics

    return loss_fn


def make_train_step(model: MPMesh, args, h, w, grid=None):
    """Returns (step, opt_init, weight keys).  opt_init(params) builds the
    optimizer over the params dict; step(params, optimizer, batch, lr,
    weights, gen=None) takes one optimizer step in place, the render's
    draws from the torch.Generator gen, and returns the metrics (detached
    tensors).  With a rank grid (``parallel/distributed.py:make_mesh``)
    the batch is this rank's dp row, and the gradients and metrics are
    reduced over dp (``parallel/dp_step.py:reduce_step``, weighted by
    batch["wt"] when given) before the optimizer's step."""
    group_fn = opt_lib.make_group_fn(args.optimize_verts_gain)
    loss_fn = make_stage1_loss_fn(model, args, h, w)

    def opt_init(params):
        opt_lib.trainable(params)
        return opt_lib.make_optimizer(args.optimizer, params, group_fn,
                                      eps=1e-8)

    def step(params, optimizer, batch, lr, weights, gen=None):
        wt = batch.get("wt")
        batch = resolve_image_batch(batch, h, w)
        optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_fn(params, batch, weights, gen)
        total.backward()
        if grid is None:
            metrics = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
                       for k, v in metrics.items()}
        else:
            metrics = reduce_step(optimizer, metrics, grid.dp, wt)
        opt_lib.set_lr(optimizer, lr)
        optimizer.step()
        return metrics

    return step, opt_init, STAGE1_WEIGHT_KEYS


def render_preview(model, params, h, w, render_extrins, render_intrins):
    """Render the spiral path (eval mode, full frames), quantized to uint8
    on the device like ``data/video.py:to8b``.  Returns (N, h, w, 3|4)."""
    frames = []
    with torch.no_grad():
        for i in range(len(render_extrins)):
            rgbl = model.forward(params, h, w, render_extrins[i:i + 1],
                                 render_intrins[i:i + 1])[0]
            frames.append((255.0 * rgbl[0].clamp(0.0, 1.0)).to(torch.uint8)
                          .cpu().numpy())
    return np.stack(frames)


def _tile_planes(planes):
    """(D, hh, ww, c) -> one near-square canvas of the planes."""
    d, hh, ww, c = planes.shape
    grid = int(np.ceil(np.sqrt(d)))
    canvas = np.zeros((grid * hh, grid * ww, c), np.float32)
    for i in range(d):
        r, col = divmod(i, grid)
        canvas[r * hh:(r + 1) * hh, col * ww:(col + 1) * ww] = planes[i]
    return canvas


def save_texture_preview(model, params, path_prefix):
    """Activated atlas dump (ref MPI.py:242-260 save_texture): the dense
    planes tiled into one image, or the packed static and dynamic tiles
    into ``<prefix>_static.png`` and ``<prefix>_dyn.png``."""
    def activate(t):
        with torch.no_grad():
            rgb = get_activation(model.cfg.rgb_activate)(t[..., :3])
            alpha = get_activation(model.cfg.alpha_activate)(t[..., -1:])
            return torch.cat([rgb, alpha], -1).cpu().numpy()

    if not model.is_sparse:
        write_image(path_prefix + ".png",
                    to8b(_tile_planes(activate(params["atlas"]))))
        return
    for key, name in (("atlas", "_static"), ("atlas_dyn", "_dyn")):
        if len(params[key]):
            write_image(path_prefix + name + ".png",
                        to8b(_tile_planes(activate(params[key]))))


def save_loopmask_preview(model, params, path_prefix):
    """Loop-mask atlas dump (ref MPI.py:262-271)."""
    if "atlas_mask" not in params:
        return
    with torch.no_grad():
        alpha = get_activation(model.cfg.alpha_activate)(
            params["atlas"][..., -1:]).cpu().numpy()
        loop = torch.sigmoid(params["atlas_mask"]).cpu().numpy()
    rgba = np.concatenate([1 - loop, loop, np.zeros_like(loop), alpha], -1)
    write_image(path_prefix + ".png", to8b(_tile_planes(rgba)))


def save_stage1_checkpoint(path, model, params, epoch):
    """A dense or sparse stage-1 checkpoint (the JAX package's schema)."""
    ckpt_io.save_checkpoint(
        path, geom=model.geom, params=params, stage="mpi",
        is_sparse=model.is_sparse, has_dyn=model.has_dyn,
        tile_map_static=model.tile_map_static,
        tile_map_dyn=model.tile_map_dyn, tile_hw=model.tile_hw,
        extra_meta={"epoch_i": epoch,
                    "rgb_mlp_type": model.cfg.rgb_mlp_type,
                    "rgb_activate": model.cfg.rgb_activate,
                    "alpha_activate": model.cfg.alpha_activate})


def _load_into_model(model, path):
    """Dense or sparse stage-1 checkpoint -> params (device tensors) and
    meta; a sparse one puts the model in its sparse phase.  The decoder
    type and activations the checkpoint was saved with replace the
    arguments' (they differ after a direct -> SH conversion; JAX
    ``train/stage1.py:283-288``)."""
    loaded = ckpt_io.load_checkpoint(path)
    meta = loaded["meta"]
    model.geom = loaded["geom"]
    ex = meta.get("extra", {})
    reps = {k: ex[k] for k in ("rgb_mlp_type", "rgb_activate",
                               "alpha_activate") if k in ex}
    if reps:
        model.cfg = dataclasses.replace(model.cfg, **reps)
    if meta["is_sparse"]:
        model.set_sparse(loaded["tile_map_static"], loaded["tile_map_dyn"],
                         meta["tile_hw"])
        model.has_dyn = meta["has_dyn"]
    params = ckpt_io.params_from_numpy(loaded["params"], model.device)
    return params, meta


def _preview(model, params, scene, H, W, rundir, epoch):
    """The i_video artifacts (ref train_3d.py:324-356): spiral rgb and
    loopable videos, texture, mesh (the culled maps in the sparse phase)
    and loop-mask dumps (dense phase only: the cull drops the mask)."""
    frames = render_preview(model, params, H, W,
                            cameras.pose_to_extrinsic(scene["render_poses"]),
                            scene["render_intrins"])
    write_video(os.path.join(rundir, f"epoch_{epoch:04d}_rgb.mp4"),
                frames[..., :3], fps=25)
    if frames.shape[-1] == 4:
        lm = frames[..., 3]
        lm = np.stack([np.zeros_like(lm), lm, np.zeros_like(lm)], -1)
        write_video(os.path.join(rundir, f"epoch_{epoch:04d}_loopable.mp4"),
                    lm, fps=25)
    save_texture_preview(model, params,
                         os.path.join(rundir, f"texture_epoch_{epoch:04d}"))
    if model.is_sparse:
        maps = (model.tile_map_static.cpu().numpy(),
                model.tile_map_dyn.cpu().numpy())
    else:
        maps = (full_tile_map(model.geom), None)
    save_mesh_preview(model.geom, *maps,
                      os.path.join(rundir, f"mesh_epoch_{epoch:04d}"))
    save_loopmask_preview(model, params,
                          os.path.join(rundir, f"loopable_epoch_{epoch:04d}"))


def _epoch_feed(dataset, np_rng, pending, bsz, n_dp, owner):
    """The epoch's steps as (items, weights): global batches of n_dp *
    bsz items, the leftover partial batch carried in `pending` across
    epochs (every patch of every epoch trained once); weights None.
    owner ({view: process}, ``--shard_views``, bsz 1): dp rows are
    process-major and a row takes only its process's views, a row out of
    patches a weight-0 patch of its process (JAX ``train/stage1.py``
    :488-521)."""
    if owner is None:
        feed = []
        for item in dataset.iter_epoch(np_rng, shuffle=True):
            pending.append(item)
            if len(pending) >= bsz * n_dp:
                feed.append((list(pending), None))
                pending.clear()
        return feed
    nproc = dist.world_size()
    rows_pp = n_dp // nproc
    queues = [[] for _ in range(nproc)]
    for item in dataset.iter_epoch(np_rng, shuffle=True):
        queues[owner[item["view"]]].append(item)
    if not all(queues):
        raise ValueError("--shard_views needs every process to own >= 1 "
                         "view (fillers must be process-local); reduce the "
                         "process count or add views")
    feed = []
    for b in range(max(-(-len(q) // rows_pp) for q in queues)):
        chunk, wts = [], []
        for p in range(nproc):
            rows = queues[p][b * rows_pp:(b + 1) * rows_pp]
            for r in range(rows_pp):
                chunk.append(rows[r] if r < len(rows) else queues[p][0])
                wts.append(1.0 if r < len(rows) else 0.0)
        feed.append((chunk, np.asarray(wts, np.float32)))
    return feed


def train(args, device, shutdown, progress_cb=None):
    """The stage-1 loop on `device` (dense epochs, the tile cull at
    ``--sparsify_epoch``, sparse epochs).  Returns (model, params,
    rundir).  `shutdown` (a `common.GracefulShutdown`) stops the run at
    the next step (at the end of the epoch in a multi-process run, where
    the ranks agree on it) with a resumable checkpoint.
    progress_cb(epoch, metrics) runs after each epoch."""
    check_supported(args)
    device = torch.device(device)
    expdir = os.path.join(args.prefix, args.expdir)
    rundir = _rundir(args)
    datadir = os.path.join(args.prefix, args.datadir)
    world = dist.world_size()
    primary = dist.is_primary()

    # --shard_views: the views' owners are decided before any is decoded
    # (one loss config: a plain round-robin over all views)
    owner = load_views = None
    if args.shard_views:
        n_views = llff.count_views(datadir, args.factor)
        owner = dist.partition_views(list(range(n_views)), [], world)
        load_views = {v for v, p in owner.items() if p == dist.rank()}
        print(f"[stage1] --shard_views: this process decodes views "
              f"{sorted(load_views)} of {n_views}")
    videos, _, scene = llff.load_mv_videos(
        basedir=datadir, factor=args.factor,
        bd_factor=(args.near_factor, args.far_factor), recenter=True,
        load_views=load_views)
    H, W = scene["hw"]
    poses, intrins, bds = scene["poses"], scene["intrins"], scene["bds"]
    ref_extrin = cameras.pose_to_extrinsic(cameras.average_pose(poses)[:, :4])
    near, far = float(bds.min()), float(bds.max())

    logger = common.MetricsLogger(rundir, enabled=primary)
    if primary:
        common.snapshot_run(expdir, args.expname + args.expname_postfix,
                            args)

    model = MPMesh(args, H, W, ref_extrin, intrins.mean(0), near, far,
                   device=device)
    params = model.init_params(args.seed)
    start_epoch = 0
    if args.init_from:
        params, _ = _load_into_model(model,
                                     os.path.join(args.prefix, args.init_from))
    elif not args.disable_auto_resume:
        latest = ckpt_io.latest_checkpoint(rundir)
        if latest:
            params, meta = _load_into_model(model, latest)
            start_epoch = int(meta["extra"].get("epoch_i", -1)) + 1
            print(f"[stage1] auto-resuming from {latest} at epoch "
                  f"{start_epoch}")
    common.set_sparse_fastpath_bounds(model, args, "[stage1]")

    # collapsed images and loop masks are cached per scene (VL3D_DATA_CACHE
    # = a directory, or off / 0 to disable, as in the JAX package)
    cache_env = os.environ.get("VL3D_DATA_CACHE", "")
    data_cache = None if cache_env.lower() in ("off", "0") else (
        cache_env or os.path.join(expdir, ".data_cache",
                                  os.path.basename(args.datadir.rstrip("/\\"))))
    dataset = ImagePatchDataset(
        (H, W), videos, (args.patch_h_size, args.patch_w_size),
        (args.patch_h_stride, args.patch_w_stride), poses, intrins,
        args.vid2img_mode, cache_dir=data_cache)
    del videos

    if primary:
        for vi, (img, mask) in enumerate(zip(dataset.images, dataset.masks)):
            if img is None:               # another process's view
                continue
            for sub, pic in ((f"imgvis_{args.vid2img_mode}", img),
                             ("loopvis", mask)):
                os.makedirs(os.path.join(rundir, sub), exist_ok=True)
                write_image(os.path.join(rundir, sub, f"{vi:04d}.png"),
                            to8b(pic))

    ph, pw = dataset.patch_size
    # the data-parallel grid (stage 1 has no frame axis: dp only)
    grid = None
    if world > 1:
        grid = dist.make_mesh(n_dp=world, n_fp=1)
        print(f"[stage1] mesh: dp={world} over {world} processes")
    n_dp = grid.n_dp if grid else 1
    local_index = None
    if owner is not None and grid is not None:
        # this process's views only; batch views become local indices
        positions = range(len(dataset.images))
        images_dev, local_index = dist.build_sharded_video_stack(
            owner, positions, dataset.images, device)
        masks_dev, _ = dist.build_sharded_video_stack(
            owner, positions, dataset.masks, device)
    else:
        images_dev = torch.as_tensor(np.stack(dataset.images), device=device)
        masks_dev = torch.as_tensor(np.stack(dataset.masks), device=device)

    def build_step():
        return make_train_step(model, args, ph, pw, grid)

    step_fn, opt_init, weight_keys = build_step()
    optimizer = opt_init(params)
    weights_base = common.extra_loss_weights(args, weight_keys)
    np_rng = np.random.default_rng(args.seed)
    # the renders' uv-noise and background draws (JAX: a PRNGKey split
    # per step; another stream, the same distributions), a stream per dp
    # row
    gen = torch.Generator(device=device).manual_seed(
        dist.fold_seed(args.seed, grid.dp_rank if grid else 0))

    prof = common.Profiler(args, rundir, device)
    watchdog = common.HangWatchdog(args.hang_timeout, "stage1")
    total_step = start_epoch * len(dataset)
    metrics = {}
    bsz = max(int(args.patch_batch), 1)
    # the leftover partial batch carries across epochs, so every patch of
    # every epoch is trained exactly once
    pending = []
    try:
        for epoch in range(start_epoch, args.N_iters):
            if epoch == args.sparsify_epoch and not model.is_sparse:
                # the dense phase's step time is logged before the cull
                _log_warm_step(prof, logger, model, total_step)
                prof.reset_timing()
                params, info = apply_tile_cull(
                    model, params, get_activation(model.cfg.alpha_activate),
                    erode_num=args.sparsify_erode,
                    alpha_thresh=args.sparsify_alpha_thresh,
                    rm_first_layers=args.sparsify_rmfirstlayer)
                print(f"[stage1] tile culling: keep {info['keep_frac']:.1%}"
                      f" of tiles, {info['dyn_frac']:.1%} dynamic")
                common.set_sparse_fastpath_bounds(model, args, "[stage1]")
                # the lr schedule goes on from total_step
                step_fn, opt_init, weight_keys = build_step()
                optimizer = opt_init(params)
                watchdog.tick()
            # the direct -> SH conversion (ref train_3d.py:287-290): widen
            # the atlas, rebuild the step and start the optimizer again
            if (epoch == args.direct2sh_epoch
                    and model.cfg.rgb_mlp_type == "direct"):
                print("[stage1] converting direct atlas to rgb_sh")
                _log_warm_step(prof, logger, model, total_step)
                prof.reset_timing()
                params = convert_direct_to_sh(model, params)
                step_fn, opt_init, weight_keys = build_step()
                optimizer = opt_init(params)
                watchdog.tick()
            # vertex-geometry optimization (ref MPI.py:152-156 gates on
            # step >= optimize_geo_start): from here the render warps
            # through the vertex grids in both phases (it reads the flag,
            # so the step needs no rebuild); the optimizer is kept, and
            # verts' Adam state starts at the steps taken since it was
            # built, as JAX's single step counter has it
            if (not model.optimize_geometry
                    and epoch >= args.optimize_geo_start):
                print("[stage1] enabling vertex-geometry optimization")
                # the flat phase's step time is logged before the event
                _log_warm_step(prof, logger, model, total_step)
                prof.reset_timing()
                model.optimize_geometry = True
                opt_lib.start_param(optimizer, params["verts"])
            # vertex-crossing guard: the warp keeps the global far->near
            # plane order, valid while every vertex stays within half the
            # inter-plane gap (render/geo_warp.py)
            if model.optimize_geometry and (epoch + 1) % args.i_weights == 0:
                dz, half_gap = vertex_crossing_report(
                    model.geom, params["verts"], args.normalize_verts)
                if dz > half_gap:
                    print(f"[stage1] WARNING: vertex depth deviation "
                          f"{dz:.4f} exceeds half the inter-plane gap "
                          f"{half_gap:.4f}; plane surfaces may cross and "
                          f"the global composite order becomes invalid "
                          f"(render/geo_warp.py validity bound)")
            # density-weight quadratic ramp (ref train_3d.py:292-293)
            pct = np.clip(epoch / (args.density_loss_epoch + 1), 0, 1)
            weights = dict(weights_base)
            weights["density"] = float(pct * pct * weights_base["density"])

            feed = _epoch_feed(dataset, np_rng, pending, bsz, n_dp,
                               owner if grid is not None else None)
            interrupted = False
            for chunk, wts in feed:
                lr = opt_lib.lr_schedule(total_step, args.lrate,
                                         decay_steps_k=args.lrate_decay)
                # every rank draws every row's jitter (one np_rng)
                intrs = [common.jitter_intrinsic(it["intrin"], np_rng)
                         if args.add_intrin_noise else it["intrin"]
                         for it in chunk]
                if grid is not None:
                    rows = len(chunk) // n_dp
                    chunk = dist.commit_batch(grid, chunk, rows)
                    intrs = dist.commit_batch(grid, intrs, rows)
                batch = {
                    "extrin": torch.as_tensor(np.stack(
                        [cameras.pose_to_extrinsic(it["pose"])
                         for it in chunk]).astype(np.float32), device=device),
                    "intrin": torch.as_tensor(
                        np.stack(intrs).astype(np.float32), device=device),
                    "view": [it["view"] if local_index is None
                             else local_index[it["view"]] for it in chunk],
                    "h0": [it["wh_start"][1] for it in chunk],
                    "w0": [it["wh_start"][0] for it in chunk],
                    "images": images_dev, "masks": masks_dev,
                }
                if grid is not None:
                    batch["wt"] = 1.0 if wts is None \
                        else float(wts[grid.dp_rank])
                prof.step(total_step)
                metrics = step_fn(params, optimizer, batch, lr, weights, gen)
                # bounded run-ahead of the host over the device
                if total_step % 8 == 0:
                    float(metrics["loss"])
                prof.tick()
                watchdog.tick()
                if total_step % args.i_img == 0:
                    for k, v in metrics.items():
                        logger.scalar(f"stage1/{k}", float(v), total_step)
                    logger.scalar("stage1/lr", lr, total_step)
                total_step += 1
                # a single process stops mid-epoch; the ranks of a
                # multi-process run agree at the epoch's end
                if shutdown.requested and world == 1:
                    interrupted = True
                    break

            if metrics and epoch % max(args.i_print // 10, 1) == 0:
                print(f"[stage1] epoch {epoch} "
                      f"loss={float(metrics['loss']):.4f} "
                      f"psnr={float(metrics['psnr']):.2f} "
                      f"({prof.steps_per_sec():.2f} it/s)")
            if progress_cb is not None:
                progress_cb(epoch, metrics)

            if interrupted or dist.any_process_flag(shutdown.requested):
                # a mid-epoch stop saves with epoch-1 metadata so the
                # auto-resume re-runs the partial epoch
                completed = epoch - 1 if interrupted else epoch
                if completed >= 0 and primary:
                    save_stage1_checkpoint(
                        os.path.join(rundir,
                                     f"ckpt_epoch_{completed:04d}.npz"),
                        model, dist.gather_for_host(params), completed)
                print(f"[stage1] graceful shutdown at epoch {epoch}: "
                      f"checkpointed epoch {completed}; rerun to resume")
                break

            if (epoch + 1) % args.i_weights == 0 or epoch == args.N_iters - 1:
                if primary:
                    save_stage1_checkpoint(
                        os.path.join(rundir, f"ckpt_epoch_{epoch:04d}.npz"),
                        model, dist.gather_for_host(params), epoch)
                watchdog.tick()
            # the previews render on one process only
            if (epoch + 1) % args.i_video == 0 and world == 1:
                _preview(model, params, scene, H, W, rundir, epoch)
                watchdog.tick()
    finally:
        watchdog.stop()
        prof.close()
    _log_warm_step(prof, logger, model, total_step)
    logger.close()
    return model, params, rundir


def _log_warm_step(prof, logger, model, total_step):
    """Log and print the warm step time of the phase that is ending
    (``warm_step_ms`` dense, ``warm_step_ms_sparse`` sparse, each with
    ``_geo`` under the vertex warp and ``_<rgb_mlp_type>`` for a decoder
    other than direct)."""
    step_ms = prof.warm_step_ms()
    if step_ms is None:
        return
    kind = model.cfg.rgb_mlp_type
    key = "warm_step_ms" + ("_sparse" if model.is_sparse else "") \
        + ("_geo" if model.optimize_geometry else "") \
        + ("" if kind == "direct" else f"_{kind}")
    logger.scalar(f"stage1/{key}", step_ms, total_step)
    print("[stage1] " + json.dumps({key: step_ms, "steps": total_step}))
