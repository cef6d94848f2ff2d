"""The benchmark's inputs, made from the configuration, the traffic mix
and ``--seed``: the tile layout of the sparse MTV, its texels, the camera
rig and the uint8 training videos.  The same inputs go to the program
and to the reference.

The layout is the recipe of the repository's synthetic production-width
MTV (``bench.py:build_bench_setup``): per tile column two smooth depth
surfaces; the tiles within a band of them, plus iid stragglers up to the
configured kept share, survive the cull; a configured share of the kept
tiles is dynamic.  It is drawn from the configuration's ``layout_seed``,
so every run of a cell has the same hit profile and the same slot bound;
the texels, the videos and the epoch order come from ``--seed``.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.stage2 import geometry, ref_intrinsic


def tile_layout(scene):
    """(static map, dynamic map) (D, nth, ntw) int32, -1 where culled."""
    g = geometry(scene)
    D, nth, ntw = g.n_planes, g.nth, g.ntw
    rng = np.random.default_rng(scene["layout_seed"])
    ii, jj = np.meshgrid(np.arange(nth), np.arange(ntw), indexing="ij")
    depth0 = (D / 2 + (D / 3) * np.sin(ii / max(nth - 1, 1) * 3.0)
              * np.cos(jj / max(ntw - 1, 1) * 2.2))
    depth1 = (D * 0.75 + (D / 5) * np.cos(ii / max(nth - 1, 1) * 1.7
                                          + jj / max(ntw - 1, 1) * 2.9))
    plane = np.arange(D)[:, None, None]
    band = (np.abs(plane - depth0[None]) <= D / 16.0) \
        | (np.abs(plane - depth1[None]) <= D / 32.0)
    keep_share = scene["keep_share"]
    p_extra = max(keep_share - band.mean(), 0.0) / max(1e-9,
                                                        1.0 - band.mean())
    keep = (band | (rng.random(band.shape) < p_extra)).reshape(-1)
    dyn = keep & (rng.random(keep.size) < scene["dynamic_share"])
    static = keep & ~dyn
    tm_s = np.full(keep.size, -1, np.int32)
    tm_s[static] = np.arange(static.sum())
    tm_d = np.full(keep.size, -1, np.int32)
    tm_d[dyn] = np.arange(dyn.sum())
    return tm_s.reshape(D, nth, ntw), tm_d.reshape(D, nth, ntw)


def texels(scene, n_static, n_dyn, seed, device):
    """The atlases {"atlas": (Ns, th, tw, C), "atlas_dyn": (Nd, th, tw,
    F, C)} f32, uniform in [0, 1), made on the device from the seed."""
    th, tw = geometry(scene).tile_hw
    C, F = scene["channels"], scene["frames"]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    return {"atlas": torch.rand((n_static, th, tw, C), generator=gen,
                                device=device),
            "atlas_dyn": torch.rand((n_dyn, th, tw, F, C), generator=gen,
                                    device=device)}


def rig(scene):
    """Camera-to-world poses (V, 3, 4) of a narrow forward-facing rig
    around the reference camera (their mean pose), and the intrinsics
    (V, 3, 3) of the full frame."""
    V = scene["views"]
    poses = np.zeros((V, 3, 4), np.float32)
    poses[:, :, :3] = np.eye(3, dtype=np.float32)
    off = (np.arange(V) - (V - 1) / 2) * scene["rig_step"]
    poses[:, 0, 3] = off
    poses[:, 1, 3] = off * scene["rig_lift"]
    intr = np.repeat(ref_intrinsic(scene)[None], V, axis=0)
    return poses, intr


def train_views(scene):
    """The trained views (all but the test view) and, among them, which
    take the reference-view loss."""
    views = [v for v in range(scene["views"]) if v != scene["test_view"]]
    return views, [v in scene["ref_views"] for v in views]


def videos(scene, content, n_views, seed, device):
    """(V, F, H, W, 3) uint8 looping videos made on the device from the
    seed: per view a smooth random colour field, plus a smooth random
    amplitude times a sine over the loop with a smooth random phase.  The
    field sizes and the motion amplitude come from the traffic mix."""
    H, W, F = scene["H"], scene["W"], scene["frames"]
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 7919 + 1) % (2 ** 63))
    out = torch.empty((n_views, F, H, W, 3), dtype=torch.uint8,
                      device=device)

    def field(c, cells):
        lo = torch.rand((1, c, max(H // cells, 1), max(W // cells, 1)),
                        generator=gen, device=device)
        return torch.nn.functional.interpolate(
            lo, size=(H, W), mode="bilinear", align_corners=False)[0]

    t = torch.arange(F, dtype=torch.float32, device=device)
    for v in range(n_views):
        base = field(3, content["base_cells"])
        amp = field(3, content["motion_cells"]) * content["motion_amp"]
        phase = field(1, content["motion_cells"]) * (2 * np.pi)
        wave = torch.sin(2 * np.pi * t[:, None, None, None] / F
                         + phase[None])
        frame = (base[None] + amp[None] * wave).clamp(0.0, 1.0)
        out[v] = (frame * 255.0).round().to(torch.uint8).permute(0, 2, 3, 1)
    return out
