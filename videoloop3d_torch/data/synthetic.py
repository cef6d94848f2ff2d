"""Synthetic multi-view looping scenes and sparse MTVs for tests and the
chip smoke run (counterpart of ``videoloop3d_tpu/data/synthetic.py``).

`make_scene` ray-casts planes in numpy, a formulation independent of the
homography plane sweep.  `make_sparse_mtv` builds the production-width
sparse Multi-plane Tile Video that the JAX package's benchmark
(``bench.py:build_bench_setup``) synthesizes, array for array.
"""
from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np

from videoloop3d_torch.data import llff as llff_io
from videoloop3d_torch.models.geometry import MPIGeometry


def _bilinear(tex, x, y):
    """tex: (H, W, C); x, y arrays of texel coords; zeros outside."""
    H, W = tex.shape[:2]
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    out = 0.0
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xi, yi = x0 + dx, y0 + dy
            valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            v = tex[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)]
            out = out + v * wx * wy * valid[..., None]
    return out


def raycast_planes(pose, intrin, h, w, plane_depths, plane_texs,
                   plane_intrin):
    """Render RGBA planes at ref-space depths by casting rays from a
    camera (c2w (3,4) pose).  Returns (h, w, 3) float + alpha (h, w)."""
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32), indexing="xy")
    pix = np.stack([xs, ys, np.ones_like(xs)], -1)
    dirs = pix @ np.linalg.inv(intrin).T @ pose[:3, :3].T
    origin = pose[:3, 3]

    fx, fy = plane_intrin[0, 0], plane_intrin[1, 1]
    cx, cy = plane_intrin[0, 2], plane_intrin[1, 2]

    rgb = np.zeros((h, w, 3), np.float32)
    trans = np.ones((h, w, 1), np.float32)
    for idx in np.argsort(plane_depths):          # near -> far
        z = plane_depths[idx]
        t = (z - origin[2]) / dirs[..., 2]
        px = origin[0] + t * dirs[..., 0]
        py = origin[1] + t * dirs[..., 1]
        u = px / z * fx + cx
        v = py / z * fy + cy
        rgba = _bilinear(plane_texs[idx], u, v)
        inside = (u >= 0) & (u <= plane_texs[idx].shape[1] - 1) & \
                 (v >= 0) & (v <= plane_texs[idx].shape[0] - 1) & (t > 0)
        a = rgba[..., 3:] * inside[..., None]
        rgb = rgb + trans * a * rgba[..., :3]
        trans = trans * (1 - a)
    return rgb, 1 - trans[..., 0]


def checker(h, w, period, phase=0.0, channels=3, seed=0):
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = 0.5 + 0.5 * np.sin(2 * np.pi * (xs + ys) / period + phase)
    rng = np.random.default_rng(seed)
    color = rng.random(channels) * 0.7 + 0.3
    return base[..., None] * color[None, None]


def make_scene(n_views=3, h=48, w=64, n_frames=8, seed=0,
               variant="basic"):
    """A tiny multi-view looping scene.  variant "basic": a static far
    plane and a looping near plane.  "rich": three planes (static far, a
    static mid occluder, a looping near plane with a wider alpha band that
    every view sees) on a tighter rig (offset step 0.08 against 0.15).

    Returns dict: videos (V, F, h, w, 3) float[0,1], poses (V,3,4),
    intrins (V,3,3), bds (2,), and the plane description.
    """
    if variant not in ("basic", "rich"):
        raise ValueError(f"unknown scene variant {variant!r}")
    rich = variant == "rich"
    focal = 0.9 * w
    intrin = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
                      np.float32)
    # far, (mid,) near
    depths = np.array([4.5, 3.0, 2.0] if rich else [4.0, 2.0], np.float32)
    near, far = 1.5, 6.0

    th, tw = int(h * 1.5), int(w * 1.5)
    plane_intrin = intrin.copy()
    plane_intrin[0, 2] += (tw - w) / 2
    plane_intrin[1, 2] += (th - h) / 2

    far_tex = np.concatenate(
        [checker(th, tw, 14 if rich else 16, 0.0, seed=seed),
         np.ones((th, tw, 1))], -1)
    static = [far_tex]
    if rich:
        # the static mid occluder: two solid blobs, off the center
        mid_alpha = np.zeros((th, tw, 1), np.float32)
        mid_alpha[th // 8: 3 * th // 8, tw // 10: 4 * tw // 10] = 0.95
        mid_alpha[5 * th // 8: 7 * th // 8, 6 * tw // 10: 9 * tw // 10] = \
            0.95
        static.append(np.concatenate(
            [checker(th, tw, 7, 0.5, seed=seed + 2), mid_alpha], -1))
    near_base = checker(th, tw, 9, 1.0, seed=seed + 1)
    near_alpha = np.zeros((th, tw, 1), np.float32)
    if rich:
        near_alpha[th // 8: 7 * th // 8, tw // 8: 7 * tw // 8] = 0.9
    else:
        near_alpha[th // 4: 3 * th // 4, tw // 4: 3 * tw // 4] = 0.9

    step, lift = (0.08, 0.25) if rich else (0.15, 0.3)
    poses = []
    for v in range(n_views):
        offset = (v - (n_views - 1) / 2) * step
        pose = np.eye(4, dtype=np.float32)[:3]
        pose[0, 3] = offset
        pose[1, 3] = offset * lift
        poses.append(pose)
    poses = np.stack(poses)
    intrins = np.repeat(intrin[None], n_views, axis=0)

    videos = np.zeros((n_views, n_frames, h, w, 3), np.float32)
    for f in range(n_frames):
        phase = 2 * np.pi * f / n_frames
        # looping motion: a brightness pulse and a texture roll (and, rich,
        # a vertical roll)
        near_tex = np.concatenate(
            [near_base * (0.75 + 0.25 * np.sin(phase)), near_alpha], -1)
        shift = int(round((4 if rich else 3) * np.sin(phase)))
        near_tex = np.roll(near_tex, shift, axis=1)
        if rich:
            near_tex = np.roll(near_tex, int(round(2 * np.cos(phase))),
                               axis=0)
        for v in range(n_views):
            rgb, _ = raycast_planes(
                poses[v], intrins[v], h, w, depths, static + [near_tex],
                plane_intrin)
            videos[v, f] = rgb
    return {
        "videos": videos,
        "poses": poses,
        "intrins": intrins,
        "bds": np.array([near, far], np.float32),
        "plane_depths": depths,
        "plane_intrin": plane_intrin,
        "plane_texs_hw": (th, tw),
    }


def write_llff_dir(scene, basedir, factor=1, container="npy"):
    """Materialize a synthetic scene as an LLFF directory.  container
    "npy": ``.npy`` video stacks (no decoder needed); "tif": multi-frame
    TIFFs written by ``imageio.mimwrite`` (raises ImportError without
    imageio)."""
    if container not in ("npy", "tif"):
        raise ValueError(f"unknown container {container!r}")
    os.makedirs(os.path.join(basedir, f"videos_{factor}"), exist_ok=True)
    vids = (np.clip(scene["videos"], 0, 1) * 255).astype(np.uint8)
    for v in range(len(vids)):
        base = os.path.join(basedir, f"videos_{factor}", f"{v:04d}")
        if container == "npy":
            np.save(base + ".npy", vids[v])
        else:
            import imageio
            imageio.mimwrite(base + ".tif", list(vids[v]))
    h, w = vids.shape[2:4]
    llff_io.save_poses_bounds(
        os.path.join(basedir, "poses_bounds.npy"),
        scene["poses"], scene["intrins"], scene["bds"], (h, w))


def make_sparse_mtv(quick=False, seed=0):
    """The benchmark's synthetic sparse stage-2 MTV (recipe of
    ``bench.py:build_bench_setup``): 360x640 render, texture scale 1.1,
    D=32 planes, a 35x63 tile grid of 12x12-texel tiles, F=50 frames;
    ~20% of tiles kept in a band around two smooth surfaces plus iid
    stragglers, 30% of the kept tiles dynamic; uniform [0,1) texels.
    ``quick`` is the benchmark's small variant (90x160, D=8, F=12).

    Returns dict: geom, hw, frm_num, tile_map_static, tile_map_dyn
    (D, nth, ntw) int32, tile_hw, params {"atlas", "atlas_dyn"} (numpy
    f32), ref_intrin, near, far.
    """
    if quick:
        H, W, F, D = 90, 160, 12, 8
        verts_h, verts_w = 10, 17
    else:
        H, W, F, D = 360, 640, 50, 32
        verts_h, verts_w = 36, 64
    args = SimpleNamespace(mpi_h_scale=1.1, mpi_w_scale=1.1, mpi_d=D,
                           mpi_h_verts=verts_h, mpi_w_verts=verts_w)
    focal = 0.9 * W
    ref_intrin = np.array([[focal, 0, W / 2], [0, focal, H / 2],
                           [0, 0, 1]], np.float32)
    near, far = 2.0, 10.0
    g = MPIGeometry.create(args, H, W, np.eye(4, dtype=np.float32),
                           ref_intrin, near, far)

    rng = np.random.default_rng(seed)
    nth, ntw = g.n_tiles_h, g.n_tiles_w
    n_total = g.n_planes * nth * ntw
    ii, jj = np.meshgrid(np.arange(nth), np.arange(ntw), indexing="ij")
    depth0 = (g.n_planes / 2
              + (g.n_planes / 3) * np.sin(ii / max(nth - 1, 1) * 3.0)
              * np.cos(jj / max(ntw - 1, 1) * 2.2))
    depth1 = (g.n_planes * 0.75
              + (g.n_planes / 5) * np.cos(ii / max(nth - 1, 1) * 1.7
                                          + jj / max(ntw - 1, 1) * 2.9))
    plane = np.arange(g.n_planes)[:, None, None]
    band = (np.abs(plane - depth0[None]) <= g.n_planes / 16.0) \
        | (np.abs(plane - depth1[None]) <= g.n_planes / 32.0)
    frac_band = band.mean()
    p_extra = max(0.20 - frac_band, 0.0) / max(1e-9, 1.0 - frac_band)
    keep = (band | (rng.random(band.shape) < p_extra)).reshape(-1)
    dyn = keep & (rng.random(n_total) < 0.30)
    static = keep & ~dyn
    th, tw = g.default_tile_texels()
    tm_s = np.full(n_total, -1, np.int32)
    tm_s[static] = np.arange(static.sum())
    tm_d = np.full(n_total, -1, np.int32)
    tm_d[dyn] = np.arange(dyn.sum())
    params = {
        "atlas": rng.random((int(static.sum()), th, tw, 4),
                            dtype=np.float32),
        "atlas_dyn": rng.random((int(dyn.sum()), th, tw, F, 4),
                                dtype=np.float32),
    }
    return {"geom": g, "hw": (H, W), "frm_num": F,
            "tile_map_static": tm_s.reshape(g.n_planes, nth, ntw),
            "tile_map_dyn": tm_d.reshape(g.n_planes, nth, ntw),
            "tile_hw": (th, tw), "params": params,
            "ref_intrin": ref_intrin, "near": near, "far": far}
