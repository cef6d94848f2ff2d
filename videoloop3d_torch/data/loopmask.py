"""2D loopable-mask heuristic (counterpart of
``videoloop3d_tpu/data/loopmask.py``, ref utils.py:337-364).

Classifies each pixel of a video as loopable / unloopable / unchanging by
tracking running min/max with rise and fall flags at half resolution,
then smooths the 3-way label and takes the argmax.  Host numpy.
"""
from __future__ import annotations

import numpy as np

from videoloop3d_torch.data import video as video_io


def _resize_img(img, h, w):
    return video_io.resize_video(img[None], h, w)[0]


def compute_loopable_mask(video, eps=15 / 255, factor=2):
    """video: (F, H, W, 3) float in [0, 1].  Returns (H, W) bool."""
    video = np.asarray(video, np.float32)
    H, W = video.shape[1:3]
    h, w = H // factor, W // factor

    first = _resize_img(video[0], h, w)
    rises = np.zeros_like(first, dtype=bool)
    falls = np.zeros_like(first, dtype=bool)
    minval = first.copy()
    maxval = first.copy()
    for frame in video[1:]:
        small = _resize_img(frame, h, w)
        minval = np.minimum(minval, small)
        maxval = np.maximum(maxval, small)
        rises |= (small - minval) > eps
        falls |= (maxval - small) > eps

    unchanging = np.all(~rises & ~falls, axis=-1)
    unloopable = np.any(rises ^ falls, axis=-1)
    loopable = ~(unchanging | unloopable)

    label = np.stack([loopable, unloopable, unchanging], axis=-1) \
        .astype(np.uint8) * 255
    label = video_io.gaussian_blur(label, 5)
    label = _resize_img(label.astype(np.float32), H, W)
    return label.argmax(axis=-1) == 0
