"""Stage-2 training: optimize the looping Multi-plane Tile Video
(counterpart of ``videoloop3d_tpu/train/stage2.py``, ref
train_3dvid.py:69-344).

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
loss's projections and permutation.

More than one process (``parallel/``: one process a rank over
``torch.distributed``) trains on a (dp, fp) rank grid: a patch a dp row
(``parallel/dp_step.py``; ``--dp_serial_below`` feeds small levels one
real patch a step), the frames over fp (``parallel/fp_step.py``, where
every loss config of the run supports it, else dp alone), and with
``--shard_views`` each process decodes and holds only its own views.
Only rank 0 writes checkpoints, previews and ``metrics.jsonl``.
`render_eval` is the chunked eval render of the render and eval tools.
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
from videoloop3d_torch.parallel import distributed as dist
from videoloop3d_torch.parallel.dp_step import reduce_step
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
    """Raise the JAX package's errors for an unknown loss, distance,
    decoder or activation, for ``--shard_views`` with ``--mesh_fp`` or
    ``--host_crops``, and for ``--mesh_devices`` other than the number of
    processes (`distributed.check_world`), before any work."""
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
    if args.shard_views and args.mesh_fp > 1:
        raise ValueError("--shard_views currently supports dp-only "
                         "meshes (the sharded video stack is laid out "
                         "over 'dp' rows); drop --mesh_fp")
    if args.shard_views and args.host_crops:
        raise ValueError("--shard_views is incompatible with "
                         "--host_crops (host crops need every view's "
                         "pixels on every process)")
    dist.check_world(args)


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


def make_stage2_step(model: MPMeshVid, args, ph, pw, losscfg, grid=None):
    """Returns (step, opt_init).  opt_init(params) builds the optimizer
    (Adam with eps 6e-8, or SGD) over the params dict; step(params,
    optimizer, batch, lr, weights, gen=None) takes one optimizer step in
    place, the render's draws from the torch.Generator gen, and returns
    the metrics (detached tensors).  With a rank grid
    (``parallel/distributed.py:make_mesh``) the batch is this rank's dp
    patch, and the gradients and metrics are reduced over dp
    (``parallel/dp_step.py:reduce_step``, weighted by batch["wt"] when
    given) before the optimizer's step."""
    group_fn = opt_lib.make_group_fn(args.optimize_verts_gain)
    loss_fn = make_patch_loss_fn(model, args, ph, pw, losscfg)

    def opt_init(params):
        opt_lib.trainable(params)
        return opt_lib.make_optimizer(args.optimizer, params, group_fn,
                                      eps=6e-8)

    def step(params, optimizer, batch, lr, weights, gen=None):
        wt = batch.get("wt")
        batch = resolve_video(batch, ph, pw)
        optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_fn(params, batch, weights, gen)
        total.backward()
        if grid is None:
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            metrics = reduce_step(optimizer, metrics, grid.dp, wt)
        opt_lib.set_lr(optimizer, lr)
        optimizer.step()
        return metrics

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


def _choose_fp(args, model, loss_cfgs, n_dev):
    """The fp size of an n_dev-rank grid (JAX ``train/stage2.py``:394-430):
    --mesh_fp, or with 0 the largest divisor of the ranks on one host
    that divides the frames into at least pt - 1 a rank; 1 under
    --shard_views, and 1 (with the reason printed) where a loss config of
    the run is one the fp step does not cover (the port lays every step
    of a run out on one grid)."""
    from videoloop3d_torch.parallel.fp_step import fp_supports
    if args.shard_views:
        return 1
    min_fl = max(max(c["patcht_size"] for c in loss_cfgs) - 1, 1)
    n_fp = int(args.mesh_fp)
    if n_fp <= 0:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", n_dev))
        n_fp = next(c for c in range(min(local, n_dev), 0, -1)
                    if n_dev % c == 0 and local % c == 0
                    and model.frm_num % c == 0
                    and model.frm_num // c >= min_fl)
    if n_fp > 1:
        for cfg in loss_cfgs:
            ok, why = fp_supports(cfg, isloop=model.isloop)
            if not ok:
                print(f"[stage2] WARNING: --mesh_fp={n_fp} ignored for loss "
                      f"config '{cfg['loss_name']}' ({why}); falling back "
                      f"to dp-only")
                return 1
    return n_fp


def batched_items(dataset, np_rng, n_dp, serial_below, owner_pos=None):
    """The epoch's steps as (cfg_key, items, weights) (JAX
    ``train/stage2.py``:454-600): the shuffled items grouped by loss
    config into batches of the dp size, the last one padded with weight-0
    copies, then the batches shuffled; weights None for a full batch.
    Below `serial_below` patches a level feeds one real patch a step (the
    other rows weight-0 copies).  owner_pos ({view position: process},
    ``--shard_views``): each process's rows take only its own views,
    rows out of items take a weight-0 item of their process.  With n_dp
    1: the single-device order."""
    groups = {}
    for item in dataset.iter_epoch(np_rng, shuffle=True):
        groups.setdefault(repr(sorted(item["losscfg"].items())),
                          []).append(item)
    n_items = sum(len(v) for v in groups.values())
    serial = n_dp > 1 and 0 < n_items < int(serial_below or 0)
    if owner_pos is not None:
        return _batched_items_sharded(groups, np_rng, n_dp, serial,
                                      owner_pos)
    batches = []
    for k, items in groups.items():
        if serial:
            wts = np.asarray([1.0] + [0.0] * (n_dp - 1), np.float32)
            batches += [(k, [it] * n_dp, wts) for it in items]
            continue
        for i in range(0, len(items), n_dp):
            chunk = items[i:i + n_dp]
            wts = None
            if len(chunk) < n_dp:
                wts = np.asarray([1.0] * len(chunk)
                                 + [0.0] * (n_dp - len(chunk)), np.float32)
                chunk = chunk + [chunk[-1]] * (n_dp - len(chunk))
            batches.append((k, chunk, wts))
    np_rng.shuffle(batches)
    return batches


def _batched_items_sharded(groups, np_rng, n_dp, serial, owner_pos):
    """`batched_items` under --shard_views: dp rows are process-major and
    a row trains only its process's views."""
    nproc = dist.world_size()
    rows_pp = n_dp // nproc
    filler = [None] * nproc
    for items in groups.values():
        for it in items:
            p = owner_pos[it["view"]]
            if filler[p] is None:
                filler[p] = it
    if any(f is None for f in filler):
        raise ValueError("--shard_views needs every process to own >= 1 "
                         "trained view (fillers must be process-local); "
                         "reduce the process count or add views")
    batches = []
    for k, items in groups.items():
        if serial:
            for it in items:
                p_own = owner_pos[it["view"]]
                slots, wts = [], []
                for p in range(nproc):
                    for j in range(rows_pp):
                        real = p == p_own and j == 0
                        slots.append(it if real else filler[p])
                        wts.append(1.0 if real else 0.0)
                batches.append((k, slots, np.asarray(wts, np.float32)))
            continue
        per_proc = [[] for _ in range(nproc)]
        for it in items:
            per_proc[owner_pos[it["view"]]].append(it)
        n_b = max(-(-len(q) // rows_pp) for q in per_proc if q)
        for b in range(n_b):
            slots, wts = [], []
            for p in range(nproc):
                real = per_proc[p]
                q = real or [filler[p]]
                for j in range(rows_pp):
                    i = b * rows_pp + j
                    if real and i < len(real):
                        slots.append(real[i])
                        wts.append(1.0)
                    else:
                        slots.append(q[i % len(q)])
                        wts.append(0.0)
            batches.append((k, slots, np.asarray(wts, np.float32)))
    np_rng.shuffle(batches)
    return batches


def train(args, device, shutdown, progress_cb=None):
    """The stage-2 loop on `device` over the `lod` pyramid.  Returns
    (model, params, rundir).  `shutdown` (a `common.GracefulShutdown`)
    stops the run at the next step (at the end of the epoch in a
    multi-process run, where the ranks agree on it) with a resumable
    checkpoint.  progress_cb(pyr_i, epoch, metrics) runs after each
    epoch."""
    check_supported(args)
    device = torch.device(device)
    expdir = os.path.join(args.prefix, args.expdir)
    rundir = _rundir(args)
    datadir = os.path.join(args.prefix, args.datadir)
    world = dist.world_size()
    primary = dist.is_primary()
    test_view = [int(t) for t in args.test_view_idx.split(",")] \
        if args.test_view_idx else []

    # --shard_views: the views' owners are decided before any is decoded
    owner = load_views = None
    if args.shard_views:
        n_views = llff.count_views(datadir, args.factor)
        tr = sorted(set(range(n_views)) - set(test_view))
        owner = dist.partition_views(tr, _ref_views(args), world)
        load_views = {v for v, p in owner.items() if p == dist.rank()}
        print(f"[stage2] --shard_views: this process decodes views "
              f"{sorted(load_views)} of {tr}")
    videos, fps, scene = llff.load_mv_videos(
        basedir=datadir, factor=args.factor,
        bd_factor=(args.near_factor, args.far_factor), recenter=True,
        load_views=load_views)
    H, W = scene["hw"]
    poses, intrins, bds = scene["poses"], scene["intrins"], scene["bds"]
    train_view = sorted(set(range(len(videos))) - set(test_view))
    videos = [videos[i] for i in train_view]
    poses, intrins = poses[train_view], intrins[train_view]
    owner_pos = None if owner is None else \
        {pos: owner[v] for pos, v in enumerate(train_view)}
    ref_extrin = cameras.pose_to_extrinsic(cameras.average_pose(poses)[:, :4])
    near, far = float(bds.min()), float(bds.max())

    logger = common.MetricsLogger(rundir, enabled=primary)
    if primary:
        common.snapshot_run(expdir, args.expname + args.expname_postfix,
                            args)

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

    # the rank grid: dp over the patches, fp over the frames
    grid = None
    if world > 1:
        n_fp = _choose_fp(args, model, loss_cfgs, world)
        grid = dist.make_mesh(n_dp=world // n_fp, n_fp=n_fp)
        print(f"[stage2] mesh: dp={grid.n_dp} x fp={n_fp} over {world} "
              "processes")
    n_dp = grid.n_dp if grid else 1

    np_rng = np.random.default_rng(args.seed)
    # the renders' uv-noise and background draws (JAX: a PRNGKey split
    # per step; another stream, the same distributions), a stream per dp
    # row
    gen = torch.Generator(device=device).manual_seed(
        dist.fold_seed(args.seed, grid.dp_rank if grid else 0))
    schedule = pyramid_schedule(args, H, W)
    print("[stage2] pyramid:", [(f"{f:.3f}", hw, n) for f, hw, n in schedule])
    if not args.no_render_remat:
        print("[stage2] the port keeps the training render's activations "
              "(no recompute in the backward): without --no_render_remat "
              "the JAX package recomputes them, a memory trade that changes "
              "no number")

    def build_step(item_cfg, ph, pw):
        if grid is not None and grid.n_fp > 1:
            from videoloop3d_torch.parallel.fp_step import make_fp_stage2_step
            return make_fp_stage2_step(model, args, ph, pw, item_cfg, grid)
        return make_stage2_step(model, args, ph, pw, item_cfg, grid)

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
            # the level's padded uint8 videos live on the device once (under
            # --shard_views, this process's views only); a step crops its
            # patch there
            local_index = None
            if owner_pos is not None and grid is not None:
                videos_dev, local_index = dist.build_sharded_video_stack(
                    owner_pos, range(len(train_view)), dataset.videos,
                    device)
            else:
                videos_dev = torch.as_tensor(np.stack(dataset.videos),
                                             device=device)
            if grid is not None:
                # the fp step trains this rank's frames of atlas_dyn
                params = dist.shard_params_by_frames(params, grid)
            steps = {}
            for item_cfg in loss_cfgs:
                k = repr(sorted(item_cfg.items()))
                if k not in steps:
                    steps[k] = build_step(item_cfg, ph, pw)
            optimizer = next(iter(steps.values()))[1](params)
            watchdog.tick()

            for epoch in range(num_epoch):
                if pyr_i == start_level and epoch < start_epoch:
                    continue
                batches = batched_items(
                    dataset, np_rng, n_dp, args.dp_serial_below,
                    owner_pos if grid is not None else None)
                interrupted = False
                for cfg_key, items, wts in batches:
                    lr = opt_lib.lr_schedule(epoch, args.lrate,
                                             decay_steps_k=args.lrate_decay)
                    if args.lrate_adaptive:
                        # the per-epoch update budget stays constant (ref
                        # train_3dvid.py:283-287): divided by the steps
                        lr = lr / len(batches)
                    # every rank draws every row's jitter (one np_rng)
                    intrs = [common.jitter_intrinsic(it["intrin"], np_rng)
                             if args.add_intrin_noise else it["intrin"]
                             for it in items]
                    r = grid.dp_rank if grid else 0
                    item = items[r]
                    w0, h0 = item["wh_start"]
                    view = item["view"] if local_index is None \
                        else local_index[item["view"]]
                    batch = {
                        "extrin": torch.as_tensor(
                            cameras.pose_to_extrinsic(item["pose"])[None]
                            .astype(np.float32), device=device),
                        "intrin": torch.as_tensor(
                            np.asarray(intrs[r], np.float32)[None],
                            device=device),
                        "videos": videos_dev, "view": view,
                        "h0": h0, "w0": w0,
                    }
                    if grid is not None:
                        batch["wt"] = 1.0 if wts is None else float(wts[r])
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
                    # a single process stops mid-epoch; the ranks of a
                    # multi-process run agree at the epoch's end
                    if shutdown.requested and world == 1:
                        interrupted = True
                        break

                if metrics:
                    print(f"[stage2] l{pyr_i} epoch {epoch} "
                          f"loss={float(metrics['loss']):.4f} "
                          f"swd={float(metrics['swd']):.4f} "
                          f"({prof.steps_per_sec():.2f} it/s)")
                if progress_cb is not None:
                    progress_cb(pyr_i, epoch, metrics)

                stopping = interrupted or dist.any_process_flag(
                    shutdown.requested)
                if stopping:
                    # a mid-epoch stop saves with epoch-1 metadata so the
                    # auto-resume re-runs the partial epoch; at epoch 0 the
                    # previous level's checkpoint (or the stage-1 init) is
                    # the resume point
                    ce = epoch - 1 if interrupted else epoch
                    cet = epoch_total - 1 if interrupted else epoch_total
                    if ce >= 0:
                        _save(model, params, grid, primary, rundir, pyr_i,
                              ce, cet, iter_total, factor, hw)
                    print(f"[stage2] graceful shutdown at l{pyr_i} epoch "
                          f"{epoch}: checkpointed epoch {ce}; rerun to "
                          f"resume")
                    break

                if (epoch_total + 1) % args.i_weights == 0 \
                        or (pyr_i == len(schedule) - 1
                            and epoch == num_epoch - 1):
                    _save(model, params, grid, primary, rundir, pyr_i,
                          epoch, epoch_total, iter_total, factor, hw)
                    watchdog.tick()
                # the eval render is not sharded: previews in a single
                # process only
                if (epoch_total + 1) % args.i_video == 0 and world == 1:
                    _preview(model, params, scene, H, W, fps, rundir, pyr_i,
                             epoch)
                    watchdog.tick()
                epoch_total += 1
            if grid is not None:
                params = dist.gather_params_by_frames(params, grid)
            _log_warm_step(prof, logger, pyr_i, iter_total)
            if stopping:
                break
    finally:
        watchdog.stop()
        prof.close()
    logger.close()
    return model, params, rundir


def _save(model, params, grid, primary, rundir, pyr_i, epoch, epoch_total,
          iter_total, factor, hw):
    """A stage-2 checkpoint of the level's params (gathered over fp, a
    collective), written by rank 0."""
    host = dist.gather_for_host(params, grid)
    if primary:
        save_stage2_checkpoint(
            os.path.join(rundir, f"ckpt_l{pyr_i}_epoch_{epoch:04d}.npz"),
            model, host, pyr_i, epoch, epoch_total, iter_total, factor, hw)


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
