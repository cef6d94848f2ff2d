"""Video and image I/O (counterpart of ``videoloop3d_tpu/data/video.py``).

``.npy``/``.npz`` stacks are read and written directly; mp4/png go
through ``imageio`` when it is installed.  Without it (as on the H100
image) frames are written as ``.npy`` files instead, so the render path
needs nothing beyond numpy.  The stage-1 dataset's resize, blur and
vid2img collapse (ref train_3d.py:49-76) use ``cv2`` where it is
installed and the JAX package's numpy fallbacks otherwise, as the JAX
package does, so both give the same arrays on one machine.
"""
from __future__ import annotations

import os

import numpy as np

try:
    import imageio.v2 as imageio
    _HAS_IMAGEIO = True
except ImportError:                                  # pragma: no cover
    imageio = None
    _HAS_IMAGEIO = False

try:
    import cv2
    _HAS_CV2 = True
except ImportError:                                  # pragma: no cover
    cv2 = None
    _HAS_CV2 = False


def read_video(path):
    """Decode all frames of a video into a (F, H, W, 3) uint8 array."""
    if path.endswith(".npy"):
        arr = np.load(path)
        return np.ascontiguousarray(arr[..., :3]).astype(np.uint8)
    if path.endswith(".npz"):
        arr = np.load(path)["video"]
        return np.ascontiguousarray(arr[..., :3]).astype(np.uint8)
    if not _HAS_IMAGEIO:
        raise RuntimeError("imageio unavailable; provide .npy videos")
    frames = imageio.mimread(path, memtest=False)
    return np.stack([f[..., :3] for f in frames]).astype(np.uint8)


def read_fps(path, default=25):
    """The container's frame rate through ``cv2`` where it is installed
    (rounded down to an int, as the JAX package does); `default` for
    ``.npy``/``.npz`` stacks, without ``cv2`` or when the container
    reports none."""
    if path.endswith((".npy", ".npz")):
        return default
    if _HAS_CV2:
        cap = cv2.VideoCapture(path)
        fps = cap.get(cv2.CAP_PROP_FPS)
        cap.release()
        if fps and fps > 0:
            return int(fps)
    return default


def write_video(path, frames, fps=25, quality=8):
    """frames: (F, H, W, 3) uint8.  Falls back to a ``*_frames/``
    sequence when no mp4 encoder backend is available."""
    frames = np.asarray(frames)
    if path.endswith(".npy"):
        np.save(path, frames)
        return
    if _HAS_IMAGEIO:
        try:
            imageio.mimwrite(path, frames, fps=fps, quality=quality,
                             macro_block_size=1)
            return
        except Exception:  # noqa: BLE001 - any missing encoder backend
            pass
    framedir = os.path.splitext(path)[0] + "_frames"
    os.makedirs(framedir, exist_ok=True)
    for i, f in enumerate(frames):
        write_image(os.path.join(framedir, f"{i:04d}.png"), f)


def write_image(path, img):
    img = np.asarray(img)
    if path.endswith(".npy"):
        np.save(path, img)
        return
    if not _HAS_IMAGEIO:
        np.save(path + ".npy", img)
        return
    imageio.imwrite(path, img)


def to8b(x):
    """float [0,1] -> uint8 by multiply + truncate; uint8 passes through
    (frames quantized on the device arrive as uint8)."""
    x = np.asarray(x)
    if x.dtype == np.uint8:
        return x
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def resize_video(video, h, w):
    """(F, H, W, C) -> (F, h, w, C) bilinear (cv2 parity with the
    reference's per-frame cv2.resize, train_3d.py:50)."""
    if video.shape[1] == h and video.shape[2] == w:
        return video
    if _HAS_CV2:
        return np.stack([cv2.resize(f, (w, h), interpolation=cv2.INTER_LINEAR)
                         for f in video])
    return _bilinear_resize_np(video, h, w)


def _bilinear_resize_np(video, h, w):
    f, H, W, c = video.shape
    ys = (np.arange(h) + 0.5) * H / h - 0.5
    xs = (np.arange(w) + 0.5) * W / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    fy = np.clip(ys - y0, 0, 1)[None, :, None, None]
    fx = np.clip(xs - x0, 0, 1)[None, None, :, None]
    v = video.astype(np.float32)
    top = v[:, y0][:, :, x0] * (1 - fx) + v[:, y0][:, :, x1] * fx
    bot = v[:, y1][:, :, x0] * (1 - fx) + v[:, y1][:, :, x1] * fx
    out = top * (1 - fy) + bot * fy
    return out.astype(video.dtype)


def gaussian_blur(img, ksize):
    if _HAS_CV2:
        return cv2.GaussianBlur(img, (ksize, ksize), 0)
    # separable binomial approximation
    kernel = np.array([1.0])
    for _ in range(ksize - 1):
        kernel = np.convolve(kernel, [0.5, 0.5])
    pad = ksize // 2
    out = img.astype(np.float32)
    for axis in (0, 1):
        padded = np.pad(out, [(pad, pad) if a == axis else (0, 0)
                              for a in range(out.ndim)], mode="reflect")
        out = np.apply_along_axis(
            lambda m: np.convolve(m, kernel, mode="valid"), axis, padded)
    return out.astype(img.dtype)


def collapse_video(video, mode):
    """Collapse a (F, H, W, 3) float [0, 1] video to one image: the
    ``vid2img_mode`` table (ref train_3d.py:52-76) — average, median,
    first, dynamic[k], blur[b]."""
    vid = np.asarray(video, np.float32)
    if mode == "median":
        return np.median(vid, axis=0)
    if mode == "average":
        return vid.mean(axis=0)
    if mode == "first":
        return vid[0]
    if mode.startswith("dynamic"):
        weight = np.linalg.norm(vid - vid.mean(axis=0, keepdims=True),
                                axis=-1, keepdims=True)
        k = mode[len("dynamic"):]
        k = 1.0 if not k else float(k)
        weight = np.clip(k * weight + (1 - k), 1e-10, 999999)
        return (vid * weight).sum(axis=0) / weight.sum(axis=0)
    if mode.startswith("blur"):
        b = mode[len("blur"):]
        b = 11 if not b else int(b)
        blurred = np.stack([gaussian_blur(f, b) for f in vid])
        weight = np.linalg.norm(blurred - blurred.mean(axis=0, keepdims=True),
                                axis=-1, keepdims=True)
        weight = np.clip(weight * 3, 0.001, 3)
        return (blurred * weight).sum(axis=0) / weight.sum(axis=0)
    raise ValueError(f"unrecognized vid2img_mode={mode}")
