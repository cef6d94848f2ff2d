"""LLFF-format scene loading: poses_bounds.npy + per-view videos
(counterpart of ``videoloop3d_tpu/data/llff.py``; same axis correction,
1/near rescaling, bound stretching, recentering, spiral render path and
intrinsics).
"""
from __future__ import annotations

import glob
import os

import numpy as np

from videoloop3d_torch.core import cameras
from videoloop3d_torch.data import video as video_io


def load_poses_bounds(basedir, factor=1):
    """Read poses_bounds.npy -> (poses (N,3,5), bds (N,2)) with the LLFF
    axis correction applied and hwf divided by `factor`."""
    arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = arr[:, :-2].reshape(-1, 3, 5)
    bds = arr[:, -2:]
    # axis correction: [-u r -t] -> [r u -t]
    poses = np.concatenate(
        [poses[:, :, 1:2], poses[:, :, 0:1], -poses[:, :, 2:3],
         poses[:, :, 3:]], axis=2)
    poses = poses.astype(np.float32)
    poses[:, :2, 4] /= factor       # h, w
    poses[:, 2, 4] /= factor        # focal
    return poses, bds.astype(np.float32)


def load_llff_scene(basedir, factor=2, recenter=True, bd_factor=(1, 1),
                    render_frames=120, render_scaling=1.0):
    """Poses/intrinsics/bounds + spiral render path for a scene directory.

    Returns dict with poses (N,3,4), intrins (N,3,3), bds (2,),
    render_poses (M,3,4), render_intrins (M,3,3), hw (H, W).
    """
    poses, bds = load_poses_bounds(basedir, factor)
    bds = np.array([bds.min(), bds.max()], np.float32)
    scale = 1.0 / bds[0]
    poses[:, :3, 3] *= scale
    bds = bds * scale
    if bd_factor is not None:
        bds = bds * np.asarray(bd_factor, np.float32)

    if recenter:
        poses = cameras.recenter_poses(poses)

    c2w = cameras.average_pose(poses)
    up = poses[:, :3, 1].sum(0)
    up = up / np.linalg.norm(up)
    close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
    dt = 0.75
    focus = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    zdelta = close_depth * 0.2
    radii = np.abs(poses[:, :3, 3]).max(0) * 0.8 * render_scaling
    render_poses = cameras.spiral_render_path(
        c2w[:, :4], up, radii, focus, zrate=0.5, zdelta=zdelta,
        rotations=2, n_frames=render_frames).astype(np.float32)

    H, W, _ = poses[0, :3, 4]
    H, W = int(H), int(W)
    intrins = np.zeros((len(poses), 3, 3), np.float32)
    intrins[:, 0, 0] = poses[:, 2, 4]
    intrins[:, 1, 1] = poses[:, 2, 4]
    intrins[:, 0, 2] = 0.5 * poses[:, 1, 4]
    intrins[:, 1, 2] = 0.5 * poses[:, 0, 4]
    intrins[:, 2, 2] = 1.0

    render_intrins = np.repeat(intrins[:1], len(render_poses), axis=0)
    return {
        "poses": poses[:, :3, :4],
        "intrins": intrins,
        "bds": bds,
        "render_poses": render_poses,
        "render_intrins": render_intrins,
        "hw": (H, W),
    }


def _video_paths(basedir, factor):
    pattern = os.path.join(basedir, f"videos_{factor}", "*")
    return pattern, sorted(p for p in glob.glob(pattern)
                           if not p.endswith(".txt"))


def count_views(basedir, factor=1):
    """The number of per-view videos, none decoded (``--shard_views``
    partitions the views before it loads them); raises FileNotFoundError
    where there is none, as `load_mv_videos` does."""
    pattern, paths = _video_paths(basedir, factor)
    if not paths:
        raise FileNotFoundError(f"no videos under {pattern}")
    return len(paths)


def load_mv_videos(basedir, factor=1, recenter=True, bd_factor=(1, 1),
                   render_frames=120, render_scaling=1.0, load_views=None):
    """Scene + decoded per-view videos from ``videos_{factor}/``.
    Returns (videos, fps, scene); videos is a list of (F, H, W, 3) uint8.
    load_views, a set of view indices, decodes only those; the other
    entries are None (``--shard_views``: each process decodes its own
    views)."""
    scene = load_llff_scene(basedir, factor, recenter, bd_factor,
                            render_frames, render_scaling)
    pattern, paths = _video_paths(basedir, factor)
    if not paths:
        raise FileNotFoundError(f"no videos under {pattern}")
    sel = None if load_views is None else {int(v) for v in load_views}
    videos = [video_io.read_video(p) if sel is None or i in sel else None
              for i, p in enumerate(paths)]
    fps = video_io.read_fps(paths[0])
    return videos, fps, scene


def save_poses_bounds(path, poses, intrins, bds, hw):
    """Inverse of `load_poses_bounds`.  poses: (N,3,4) in the loaded
    convention; intrins: (N,3,3); bds: (N,2) or (2,); hw: (H, W)."""
    n = len(poses)
    hwf = np.zeros((n, 3, 1), np.float32)
    hwf[:, 0, 0] = hw[0]
    hwf[:, 1, 0] = hw[1]
    hwf[:, 2, 0] = intrins[:, 0, 0]
    p = np.concatenate([poses, hwf], axis=2)            # (N, 3, 5)
    # undo the axis correction: loaded = [c1, c0, -c2, c3, c4]
    raw = np.concatenate(
        [p[:, :, 1:2], p[:, :, 0:1], -p[:, :, 2:3], p[:, :, 3:]], axis=2)
    bds = np.broadcast_to(np.asarray(bds, np.float32).reshape(-1, 2), (n, 2))
    arr = np.concatenate([raw.reshape(n, -1), bds], axis=1)
    np.save(path, arr.astype(np.float64))
