"""Patch-grid datasets for stage 1 and stage 2 (counterpart of
``videoloop3d_tpu/data/patches.py``; ref train_3d.py:20-95,
train_3dvid.py:22-66 and utils.py:115-134).

Host-side numpy bookkeeping: patch origins, per-item camera geometry and
the epoch order.  The trainers crop patches on the device from the
run-resident image, mask or video stacks.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np

from videoloop3d_torch.core import cameras
from videoloop3d_torch.data import video as video_io
from videoloop3d_torch.data.loopmask import compute_loopable_mask


def patch_grid(H, W, patch_size, patch_stride):
    """Patch origins covering (H, W); images are padded on bottom/right so
    every origin yields a full patch.  Returns (origins (N, 2) as (w, h),
    pad (pad_h, pad_w)).  Parity: utils.py:115-134."""
    ph, pw = patch_size
    sh, sw = patch_stride
    hs = np.arange(0, H - ph + sh, sh)
    ws = np.arange(0, W - pw + sw, sw)
    pad_h = int(hs.max() + ph - H)
    pad_w = int(ws.max() + pw - W)
    if not (sh > pad_h >= 0 and sw > pad_w >= 0):
        raise ValueError(f"patch grid {patch_size} / {patch_stride} does "
                         f"not tile a {H}x{W} image")
    gw, gh = np.meshgrid(ws, hs)
    origins = np.stack([gw.reshape(-1), gh.reshape(-1)], axis=-1)
    return origins.astype(np.int64), (pad_h, pad_w)


def _raw_hw(videos):
    """The (H, W) of the loaded views; a None entry is a view whose
    pixels another process loads (``--shard_views``)."""
    return next(v for v in videos if v is not None).shape[1:3]


class PatchSampler:
    """Origin / view bookkeeping: item i is patch origin i % n of view
    i // n (n origins per view)."""

    def __init__(self, hw, n_views, patch_size, patch_stride, poses,
                 intrins, raw_hw):
        self.h, self.w = hw
        self.v = n_views
        self.poses = np.asarray(poses, np.float32)
        intrins = np.asarray(intrins, np.float32).copy()
        sy = self.h / raw_hw[0]
        sx = self.w / raw_hw[1]
        intrins[:, 0] *= sx
        intrins[:, 1] *= sy
        self.intrins = intrins
        if self.h * self.w < patch_size[0] * patch_size[1]:
            self.patch_size = (self.h, self.w)
            self.origins = np.zeros((1, 2), np.int64)
            self.pad = (0, 0)
        else:
            self.patch_size = tuple(patch_size)
            self.origins, self.pad = patch_grid(
                self.h, self.w, patch_size, patch_stride)
        n_per_view = len(self.origins)
        self.view_index = np.repeat(np.arange(n_views), n_per_view)
        self.flat_origins = np.tile(self.origins, (n_views, 1))

    def __len__(self):
        return len(self.flat_origins)

    def item_geometry(self, item):
        w0, h0 = self.flat_origins[item]
        vi = int(self.view_index[item])
        pose = self.poses[vi]
        intrin = cameras.shift_intrinsic(self.intrins[vi], h0, w0)
        return int(w0), int(h0), vi, pose, intrin

    def iter_epoch(self, rng: np.random.Generator, shuffle=True):
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        for item in order:
            yield self[item]          # type: ignore[index]


class ImagePatchDataset(PatchSampler):
    """Stage 1: videos collapsed to single images plus 2D loopable masks,
    padded for the patch grid.  Parity: train_3d.py:20-95.

    cache_dir: the collapsed image and mask of each view are kept there
    as ``.npz``, keyed by view, resolution, pad, mode, frame count and the
    sha256 of the video bytes, so a changed video or patch grid never
    reads a stale entry.
    """

    def __init__(self, hw, videos, patch_size, patch_stride, poses, intrins,
                 mode="average", cache_dir=None):
        super().__init__(hw, len(videos), patch_size, patch_stride, poses,
                         intrins, _raw_hw(videos))
        self.images = []
        self.masks = []
        ph, pw = self.pad
        for vi, vid in enumerate(videos):
            if vid is None:            # another process's view
                self.images.append(None)
                self.masks.append(None)
                continue
            cpath = None
            if cache_dir:
                digest = hashlib.sha256(
                    np.ascontiguousarray(vid, np.uint8).tobytes()).hexdigest()
                cpath = os.path.join(
                    cache_dir, f"s1img_v{vi:02d}_{self.h}x{self.w}_pad{ph}x"
                               f"{pw}_{mode}_{vid.shape[0]}f_{digest[:32]}.npz")
                if os.path.exists(cpath):
                    with np.load(cpath) as z:
                        self.images.append(z["img"])
                        self.masks.append(z["mask"])
                    continue
            vid = video_io.resize_video(vid, self.h, self.w)
            vidf = vid.astype(np.float32) / 255.0
            img = video_io.collapse_video(vidf, mode)
            mask = compute_loopable_mask(vidf).astype(np.float32)
            img = np.pad(img, ((0, ph), (0, pw), (0, 0))).astype(np.float32)
            mask = np.pad(mask, ((0, ph), (0, pw)))
            if cpath:
                os.makedirs(cache_dir, exist_ok=True)
                tmp = cpath + ".tmp.npz"
                np.savez(tmp, img=img, mask=mask)
                os.replace(tmp, cpath)
            self.images.append(img)
            self.masks.append(mask)

    def __getitem__(self, item):
        w0, h0, vi, pose, intrin = self.item_geometry(item)
        ph, pw = self.patch_size
        out = {"wh_start": (w0, h0), "view": vi, "pose": pose,
               "intrin": intrin}
        if self.images[vi] is not None:
            # host crops for tests; the trainer crops on the device
            out["rgb"] = self.images[vi][h0:h0 + ph, w0:w0 + pw]
            out["loopmask"] = self.masks[vi][h0:h0 + ph, w0:w0 + pw]
        return out


class VideoPatchDataset(PatchSampler):
    """Stage 2: full-length uint8 videos, resized to the level and padded
    for the patch grid, and a loss config per view.  Parity:
    train_3dvid.py:22-66."""

    def __init__(self, hw, videos, patch_size, patch_stride, poses, intrins,
                 loss_configs):
        super().__init__(hw, len(videos), patch_size, patch_stride, poses,
                         intrins, _raw_hw(videos))
        if len(loss_configs) != len(videos):
            raise ValueError(f"{len(loss_configs)} loss configs for "
                             f"{len(videos)} views")
        self.loss_configs = loss_configs
        ph, pw = self.pad
        self.videos = [
            None if vid is None else
            np.pad(video_io.resize_video(vid, self.h, self.w),
                   ((0, 0), (0, ph), (0, pw), (0, 0)))
            for vid in videos]

    def __getitem__(self, item):
        w0, h0, vi, pose, intrin = self.item_geometry(item)
        return {"wh_start": (w0, h0), "view": vi, "pose": pose,
                "intrin": intrin, "losscfg": self.loss_configs[vi]}

    def get_video(self, item):
        """Host crop of one item: (F, ph, pw, 3) float32 in [0, 1]."""
        w0, h0 = item["wh_start"]
        ph, pw = self.patch_size
        crop = self.videos[item["view"]][:, h0:h0 + ph, w0:w0 + pw]
        return crop.astype(np.float32) / 255.0
