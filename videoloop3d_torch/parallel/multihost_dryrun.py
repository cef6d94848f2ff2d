"""Worker of the multi-process dry runs (counterpart of
``videoloop3d_tpu/parallel/multihost_dryrun.py``).

Each process runs this module with its own ``--process_id``; together
they form one process group (gloo on the CPU unless ``--device cuda``)
through ``--init_method`` (``tcp://host:port`` or ``file://path``, the
latter needs no free port) and run, by ``--mode``:

* ``step``: ONE step of the real dp stage-2 step (``dp_step.py``) on a
  tiny scratch MTV, a patch of its own a rank, then the checkpoint
  gather; prints ``MULTIHOST_OK process=<i> procs=<n> devices=<n>
  loss=<l>`` (the dp mean: equal on every rank);
* ``shard_views``: the real stage-2 trainer with ``--shard_views`` over
  ``--sv_views`` views (uneven when they do not divide the ranks); a
  process must decode exactly the views ``partition_views`` gives it;
  prints ``MULTIHOST_SV_OK``;
* ``stage1_sv``: the real stage-1 trainer with ``--shard_views``; prints
  ``MULTIHOST_S1SV_OK``;
* ``sigterm_stop``: the stage-1 trainer with an unbounded epoch count,
  printing ``STOP_DRYRUN_EPOCH`` every 5 epochs until the launcher sends
  SIGTERM to one process; the per-epoch ``any_process_flag`` must stop
  every process at the same epoch and only rank 0 writes the checkpoint;
  prints ``MULTIHOST_STOP_OK``.

    python -m videoloop3d_torch.parallel.multihost_dryrun --process_id 0 \
        --num_processes 2 --init_method file:///tmp/pg --workdir /tmp/mh &
    python -m videoloop3d_torch.parallel.multihost_dryrun --process_id 1 \
        --num_processes 2 --init_method file:///tmp/pg --workdir /tmp/mh
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--num_processes", type=int, default=2)
    ap.add_argument("--init_method", default="tcp://localhost:29531")
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    ap.add_argument("--workdir", default="",
                    help="scene and run directories (a directory of the "
                         "system's temp dir by default)")
    ap.add_argument("--mode",
                    choices=["step", "shard_views", "stage1_sv",
                             "sigterm_stop"],
                    default="step")
    ap.add_argument("--sv_views", type=int, default=4,
                    help="scene view count for the shard_views modes "
                         "(uneven partitions when not divisible by "
                         "num_processes)")
    opts = ap.parse_args(argv)
    from videoloop3d_torch.parallel import distributed as dist
    device = dist.init_distributed(torch.device(opts.device),
                                   opts.init_method, opts.num_processes,
                                   opts.process_id)
    workdir = opts.workdir or os.path.join(tempfile.gettempdir(),
                                           "vl3d_multihost_dryrun")
    # each process its own scene copy (the same seed) and run directory
    root = os.path.join(workdir, f"p{opts.process_id}")
    fn = {"step": run_step, "shard_views": run_shard_views,
          "stage1_sv": run_stage1_shard_views,
          "sigterm_stop": run_sigterm_stop}[opts.mode]
    try:
        return fn(opts, device, root)
    finally:
        torch.distributed.destroy_process_group()


def _scene_dir(root, n_views, n_frames):
    from videoloop3d_torch.data import synthetic
    scene_dir = os.path.join(root, f"scene_v{n_views}")
    if not os.path.exists(os.path.join(scene_dir, "poses_bounds.npy")):
        scene = synthetic.make_scene(n_views=n_views, h=24, w=32,
                                     n_frames=n_frames, seed=0)
        synthetic.write_llff_dir(scene, scene_dir, factor=1)
    return scene_dir


TINY = ["--mpi_h_scale", "1.2", "--mpi_w_scale", "1.2",
        "--mpi_h_verts", "5", "--mpi_w_verts", "7", "--mpi_d", "4",
        "--atlas_grid_h", "2"]


def run_step(opts, device, root):
    from videoloop3d_torch.config import parse_args_with_configs
    from videoloop3d_torch.core import cameras
    from videoloop3d_torch.data import synthetic
    from videoloop3d_torch.models.mpv import MPMeshVid
    from videoloop3d_torch.parallel import distributed as dist
    from videoloop3d_torch.parallel.dp_step import make_dp_stage2_step

    h, w, frm = 24, 32, 4
    scene = synthetic.make_scene(n_views=2, h=h, w=w, n_frames=frm, seed=0)
    args = parse_args_with_configs(
        TINY + ["--mpv_frm_num", str(frm), "--mpv_isloop",
                "--scale_invariant", "--init_std", "0.02",
                "--rgb_smooth_loss_weight", "0.2",
                "--a_smooth_loss_weight", "0.2", "--gpu_num", "0"])
    poses, intrins, bds = scene["poses"], scene["intrins"], scene["bds"]
    model = MPMeshVid(args, h, w, cameras.pose_to_extrinsic(
        cameras.average_pose(poses)[:, :4]), intrins[0], float(bds[0]),
        float(bds[1]), device=device)
    params = model.init_params(0)
    grid = dist.make_mesh(n_dp=dist.world_size(), n_fp=1)
    losscfg = {"loss_name": "gpnn_lm", "patch_size": 3, "patcht_size": 3,
               "stride": 2, "stridet": 1, "alpha": 10000, "rou": "-2",
               "scaling": 0.1, "macro_block": 17, "factor": 1,
               "loss_gain": 1.0, "dist_fn": "mse", "num_proj": 32,
               "fast_nn_dist": False, "nn_bf16": False}
    step, opt_init = make_dp_stage2_step(model, args, h, w, losscfg, grid)
    optimizer = opt_init(params)
    # every rank builds the same global batch; row r takes view r % 2
    items = [{"extrin": cameras.pose_to_extrinsic(poses[i % 2])[None],
              "intrin": intrins[i % 2][None],
              "video": scene["videos"][i % 2]} for i in range(grid.n_dp)]
    mine = dist.commit_batch(grid, items)[0]
    batch = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
             for k, v in mine.items()}
    weights = {k: 0.1 for k in ("sparsity", "rgb_smooth", "a_smooth",
                                "d_smooth", "density")}
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    metrics = step(params, optimizer, batch, 0.1, weights)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), loss
    host = dist.gather_for_host(params, grid)
    for k, v in host.items():
        assert tuple(v.shape) == shapes[k], (k, v.shape, shapes[k])
        assert torch.isfinite(v).all(), k
    assert dist.is_primary() == (opts.process_id == 0)
    print(f"MULTIHOST_OK process={opts.process_id} "
          f"procs={dist.world_size()} devices={dist.world_size()} "
          f"loss={loss:.6f}", flush=True)


def _count_reads():
    """Record (file name, bytes) of every video the loaders decode."""
    from videoloop3d_torch.data import video as video_io
    decoded = []
    orig = video_io.read_video

    def counting(path):
        arr = orig(path)
        decoded.append((os.path.basename(path), arr.nbytes))
        return arr
    video_io.read_video = counting
    return decoded


def run_shard_views(opts, device, root):
    """The stage-2 trainer with --shard_views: this process decodes only
    the views `partition_views` gives it (the launcher checks that the
    processes' sets are disjoint and complete), over both loss configs
    (views 0 and 1 are reference views), with the per-epoch stop flag
    and rank 0's checkpoint (i_weights 1)."""
    from videoloop3d_torch.config import parse_args_with_configs
    from videoloop3d_torch.parallel import distributed as dist
    from videoloop3d_torch.train import common, stage2

    n_views = opts.sv_views
    scene_dir = _scene_dir(root, n_views, 4)
    decoded = _count_reads()
    argv = ["--datadir", scene_dir, "--expdir", os.path.join(root, "mpv"),
            "--expname", "sv", "--factor", "1", *TINY,
            "--mpv_frm_num", "4", "--mpv_isloop",
            "--patch_h_size", "24", "--patch_w_size", "32",
            "--patch_h_stride", "16", "--patch_w_stride", "24",
            "--lrate", "0.2", "--lrate_adaptive",
            "--pyr_minimal_dim", "20", "--pyr_num_epoch", "1",
            "--loss_name", "gpnn_lm",
            "--swd_patch_size", "3", "--swd_patcht_size", "3",
            "--swd_stride", "2", "--swd_stridet", "1",
            "--loss_ref_idx", "0,1", "--loss_name_ref", "gpnn_lm",
            "--swd_patch_size_ref", "3", "--swd_patcht_size_ref", "3",
            "--swd_stride_ref", "2", "--swd_stridet_ref", "1",
            "--swd_loss_gain_ref", "2.0",
            "--swd_macro_block", "17", "--swd_num_proj", "16",
            "--scale_invariant", "--init_std", "0.02",
            "--i_weights", "1", "--i_video", "1000", "--i_img", "100",
            "--i_print", "1000", "--seed", "1",
            "--shard_views", "--disable_auto_resume"]
    losses = []
    shutdown = common.GracefulShutdown()
    try:
        stage2.train(parse_args_with_configs(argv), device, shutdown,
                     progress_cb=lambda li, ep, m: losses.append(
                         float(m["loss"])))
    finally:
        shutdown.restore()
    owner = dist.partition_views(list(range(n_views)), {0, 1},
                                 dist.world_size())
    expected = sorted(v for v, p in owner.items() if p == dist.rank())
    mine = sorted(int(os.path.splitext(n)[0]) for n, _ in decoded)
    assert mine == expected, (mine, expected)
    assert losses and np.isfinite(losses[-1])
    rundir = os.path.join(root, "mpv", "sv")
    wrote = os.path.isdir(rundir) and any(
        f.endswith(".npz") for f in os.listdir(rundir))
    print(f"MULTIHOST_SV_OK process={dist.rank()} "
          f"views={','.join(map(str, mine))} "
          f"host_bytes={sum(b for _, b in decoded)} ckpt={int(wrote)} "
          f"loss={losses[-1]:.6f}", flush=True)


def run_stage1_shard_views(opts, device, root):
    """The stage-1 trainer with --shard_views: per-process decoding (the
    collapsed images and loop masks only for owned views), image stacks
    of the own views, weight-0 filler rows."""
    from videoloop3d_torch.config import parse_args_with_configs
    from videoloop3d_torch.parallel import distributed as dist
    from videoloop3d_torch.train import common, stage1

    n_views = 4
    scene_dir = _scene_dir(root, n_views, 4)
    decoded = _count_reads()
    argv = ["--datadir", scene_dir, "--expdir", os.path.join(root, "mpi"),
            "--expname", "s1sv", "--factor", "1", *TINY,
            "--patch_h_size", "24", "--patch_w_size", "32",
            "--patch_h_stride", "16", "--patch_w_stride", "24",
            "--lrate", "0.1", "--N_iters", "2",
            "--scale_invariant", "--learn_loop_mask",
            "--i_weights", "1000", "--i_video", "1000", "--i_img", "100",
            "--i_print", "1000", "--seed", "1",
            "--shard_views", "--disable_auto_resume"]
    losses = []
    shutdown = common.GracefulShutdown()
    try:
        stage1.train(parse_args_with_configs(argv), device, shutdown,
                     progress_cb=lambda e, m: losses.append(
                         float(m["loss"])))
    finally:
        shutdown.restore()
    assert len(decoded) == n_views // dist.world_size(), decoded
    mine = sorted(int(os.path.splitext(n)[0]) for n, _ in decoded)
    assert losses and np.isfinite(losses[-1])
    print(f"MULTIHOST_S1SV_OK process={dist.rank()} "
          f"views={','.join(map(str, mine))} "
          f"host_bytes={sum(b for _, b in decoded)} "
          f"loss={losses[-1]:.6f}", flush=True)


def run_sigterm_stop(opts, device, root):
    """The stage-1 trainer on a dp grid with an unbounded epoch count
    until the launcher sends SIGTERM to one process: every process must
    stop at the same epoch, and rank 0 (signalled or not) writes the
    shutdown checkpoint."""
    from videoloop3d_torch.config import parse_args_with_configs
    from videoloop3d_torch.parallel import distributed as dist
    from videoloop3d_torch.train import common, stage1

    scene_dir = _scene_dir(root, 3, 4)
    expdir = os.path.join(root, "mpi")
    rundir = os.path.join(expdir, "st")
    if os.path.isdir(rundir):          # checkpoints of an earlier run
        for f in os.listdir(rundir):
            if f.startswith("ckpt_"):
                os.remove(os.path.join(rundir, f))
    argv = ["--datadir", scene_dir, "--expdir", expdir,
            "--expname", "st", "--factor", "1", *TINY,
            "--patch_h_size", "24", "--patch_w_size", "32",
            "--patch_h_stride", "16", "--patch_w_stride", "24",
            "--lrate", "0.1", "--N_iters", "100000",
            "--scale_invariant",
            "--i_weights", "1000000", "--i_video", "1000000",
            "--i_img", "10000", "--i_print", "1000000", "--seed", "1",
            "--disable_auto_resume"]
    seen = []

    def cb(epoch, metrics):
        seen.append(epoch)
        if epoch % 5 == 0:
            print(f"STOP_DRYRUN_EPOCH process={dist.rank()} epoch={epoch}",
                  flush=True)

    shutdown = common.GracefulShutdown()
    try:
        stage1.train(parse_args_with_configs(argv), device, shutdown,
                     progress_cb=cb)
    finally:
        shutdown.restore()
    ckpts = sorted(f for f in os.listdir(rundir) if f.startswith("ckpt_")) \
        if os.path.isdir(rundir) else []
    print(f"MULTIHOST_STOP_OK process={dist.rank()} "
          f"signaled={int(shutdown.requested)} stopped_epoch={seen[-1]} "
          f"ckpts={len(ckpts)} is_primary={int(dist.is_primary())}",
          flush=True)


if __name__ == "__main__":
    main()
