"""Camera math on the host (numpy): poses, intrinsics, render paths.

Counterpart of ``videoloop3d_tpu/core/cameras.py`` for the parts the
data loader, the render CLI and the view-dependent decoders need
(`get_rays` and `unit_view_dirs` take tensors on any device).
Conventions (LLFF/NeRF lineage):
a *pose* is camera-to-world (3x4 or 4x4), an *extrinsic* its inverse;
intrinsics are 3x3 with last row (0, 0, 1).
"""
from __future__ import annotations

import numpy as np
import torch


def homogenize(mat):
    """Append the (0, 0, 0, 1) row to a batch of 3x4 matrices."""
    mat = np.asarray(mat)
    if mat.shape[-2] == 4:
        return mat
    bottom = np.zeros_like(mat[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return np.concatenate([mat, bottom], axis=-2)


def pose_to_extrinsic(pose):
    """Invert camera-to-world into world-to-camera (and vice versa)."""
    return np.linalg.inv(homogenize(pose))


def get_rays(h, w, intrin, pose):
    """Per-pixel ray origins and directions in world space (JAX
    ``core/cameras.py:75``, ref utils.py:159-166): intrin (3, 3) and the
    camera-to-world pose (3, 4) or (4, 4), tensors on one device.
    Returns (rays_o, rays_d), each (h, w, 3)."""
    dt, dev = intrin.dtype, intrin.device
    y, x = torch.meshgrid(torch.arange(h, dtype=dt, device=dev),
                          torch.arange(w, dtype=dt, device=dev),
                          indexing="ij")
    pix = torch.stack([x, y, torch.ones_like(x)], dim=-1)     # (h, w, 3)
    # inv_ex: no host synchronization on the card
    local = pix @ torch.linalg.inv_ex(intrin)[0].T
    rays_d = local @ pose[:3, :3].T
    return pose[:3, 3].expand(rays_d.shape), rays_d


def unit_view_dirs(h, w, extrins, intrins):
    """The unit view directions (B, h, w, 3) of the pixels of B views whose
    extrinsics (B, 4, 4) and intrinsics (B, 3, 3) are tensors: `get_rays`
    under the inverted extrinsics, normalized (JAX
    ``models/mpmesh.py:305-321``, ``models/mpv.py:250-256``)."""
    poses = torch.linalg.inv_ex(extrins)[0]
    dirs = torch.stack([get_rays(h, w, intrins[b], poses[b])[1]
                        for b in range(extrins.shape[0])])
    return dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)



def shift_intrinsic(intrin, h_start, w_start):
    """Intrinsics for a crop whose origin is (h_start, w_start)."""
    out = np.array(intrin, copy=True)
    out[..., 0, 2] -= w_start
    out[..., 1, 2] -= h_start
    return out


def scale_intrinsic(intrin, sy, sx):
    """Rescale intrinsics for a resized image (sy = new_h / old_h)."""
    scale = np.asarray([[sx, sx, sx], [sy, sy, sy], [1, 1, 1]],
                       dtype=intrin.dtype)
    return intrin * scale


def _normalize(v):
    return v / np.linalg.norm(v)


def look_at_matrix(forward, up, position):
    """3x4 camera-to-world from forward direction, up hint and position."""
    z = _normalize(forward)
    x = _normalize(np.cross(up, z))
    y = _normalize(np.cross(z, x))
    return np.stack([x, y, z, position], axis=1)


def average_pose(poses):
    """Average camera pose of a batch of (N, 3, 4+) poses."""
    center = poses[:, :3, 3].mean(0)
    forward = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    mat = look_at_matrix(forward, up, center)
    if poses.shape[-1] > 4:
        mat = np.concatenate([mat, poses[0, :3, -1:]], axis=1)
    return mat


def recenter_poses(poses):
    """Rigidly transform all poses so the average pose is the identity."""
    avg = homogenize(average_pose(poses)[:, :4][None])[0]
    poses4 = homogenize(poses[:, :3, :4])
    out = np.linalg.inv(avg) @ poses4
    result = poses.copy()
    result[:, :3, :4] = out[:, :3, :4]
    return result


def spiral_render_path(c2w, up, radii, focus_depth, zrate, zdelta, rotations,
                       n_frames):
    """Spiral of camera-to-world poses around a central pose."""
    radii = np.array(list(radii) + [1.0])
    poses = []
    for theta in np.linspace(0.0, 2.0 * np.pi * rotations, n_frames + 1)[:-1]:
        offs = np.array([np.cos(theta), -np.sin(theta),
                         (np.cos(theta * zrate) * zdelta) ** 2, 1.0]) * radii
        center = c2w[:3, :4] @ offs
        forward = _normalize(np.array([0, 0, focus_depth]) - center)
        poses.append(look_at_matrix(forward, up, center))
    return np.stack(poses)
