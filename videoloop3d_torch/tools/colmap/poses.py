"""COLMAP sparse model -> LLFF poses_bounds.npy conversion.

Parity: reference scripts/colmaps/llffposes/pose_utils.py:14-94 and
gen_poses (:273-317): invert image world-to-camera matrices, apply the
LLFF [-u, r, -t] axis swap, stack hwf, and take per-view 0.1/99.9
percentile depths of the visible sparse points as near/far bounds.

The port's own copy of ``videoloop3d_tpu/tools/colmap/poses.py`` (host
numpy).
"""
from __future__ import annotations

import glob
import os

import numpy as np

from videoloop3d_torch.tools.colmap import binmodel


def load_colmap_scene(scenedir):
    """Read sparse/0 and build LLFF-convention pose stack.

    Returns (poses (3,5,N) in LLFF axis order, pts3d dict, perm, names).
    """
    sparse = os.path.join(scenedir, "sparse", "0")
    cams = binmodel.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    images = binmodel.read_images_binary(os.path.join(sparse, "images.bin"))
    pts3d = binmodel.read_points3d_binary(
        os.path.join(sparse, "points3D.bin"))

    cam_list = [cams[k] for k in sorted(cams)]
    hwf = np.array([(c.height, c.width, c.params[0])
                    for c in cam_list]).T                 # (3, n_cams)

    names = [images[k].name for k in images]
    perm = np.argsort(names)
    c2w = []
    for k in images:
        im = images[k]
        R = binmodel.qvec_to_rotmat(im.qvec)
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = im.tvec
        c2w.append(np.linalg.inv(w2c))
    c2w = np.stack(c2w)                                   # (N, 4, 4)
    poses = c2w[:, :3, :4].transpose(1, 2, 0)             # (3, 4, N)
    if hwf.shape[-1] != poses.shape[-1]:
        hwf = np.repeat(hwf[:, :1], poses.shape[-1], axis=1)
    poses = np.concatenate([poses, hwf[:, None, :]], axis=1)   # (3, 5, N)

    # LLFF axis order: [r, -u, t] -> [-u, r, -t]
    poses = np.concatenate(
        [poses[:, 1:2], poses[:, 0:1], -poses[:, 2:3], poses[:, 3:4],
         poses[:, 4:5]], axis=1)
    return poses, pts3d, perm, names


def save_llff_poses(scenedir, poses, pts3d, perm):
    """Write poses_bounds.npy with percentile depth bounds per view."""
    n_views = poses.shape[-1]
    pts = np.array([p.xyz for p in pts3d.values()])
    vis = np.zeros((len(pts), n_views), np.int32)
    for row, p in enumerate(pts3d.values()):
        for iid in p.image_ids:
            if iid - 1 >= n_views:
                raise RuntimeError("point references unknown camera")
            vis[row, iid - 1] = 1

    # depth of each point along each view's forward axis (-t column)
    zvals = np.sum(-(pts[:, None, :].transpose(2, 0, 1)
                     - poses[:3, 3:4, :]) * poses[:3, 2:3, :], axis=0)

    rows = []
    for i in perm:
        zs = zvals[:, i][vis[:, i] == 1]
        close, far = np.percentile(zs, 0.1), np.percentile(zs, 99.9)
        rows.append(np.concatenate(
            [poses[..., i].ravel(), [close, far]]))
    np.save(os.path.join(scenedir, "poses_bounds.npy"), np.array(rows))


def gen_poses(scenedir, match_type="exhaustive_matcher", share_intrin=True,
              colmap_bin="colmap"):
    """Full pipeline: run COLMAP if needed, then convert
    (ref pose_utils.py:273-317)."""
    from videoloop3d_torch.tools.colmap.wrapper import run_colmap
    out = os.path.join(scenedir, "poses_bounds.npy")
    if os.path.exists(out):
        print(f"{out} exists; nothing to do")
        return out
    sparse = os.path.join(scenedir, "sparse", "0")
    needed = ["cameras.bin", "images.bin", "points3D.bin"]
    have = os.listdir(sparse) if os.path.isdir(sparse) else []
    if not all(f in have for f in needed):
        run_colmap(scenedir, match_type,
                   ["feature_extractor", "matcher", "mapper"],
                   share_intrin=share_intrin, colmap_bin=colmap_bin)

    poses, pts3d, perm, names = load_colmap_scene(scenedir)

    registered = {os.path.splitext(n)[0] for n in names}
    on_disk = {os.path.splitext(os.path.basename(p))[0]
               for p in glob.glob(os.path.join(scenedir, "images", "*"))
               if p.lower().endswith((".jpg", ".png", ".jpeg"))}
    missing = on_disk - registered
    if missing:
        raise RuntimeError(
            f"images failed to register: {sorted(missing)}; remove them "
            f"and rerun")
    save_llff_poses(scenedir, poses, pts3d, perm)
    return out
