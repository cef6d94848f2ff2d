"""Own-data standardization: split one concatenated capture video on
black separator frames into per-view clips (counterpart of
``videoloop3d_tpu/tools/owndata_step1.py``; ref
scripts/script_owndata_step1_standardization.py:24-72).  Writes
``images/%04d.png`` (each clip's temporal average, for COLMAP) and
``videos_{factor}/%04d.mp4`` per factor through the port's
``data/video.py``, or ``%04d.npy`` where imageio is missing (the loaders
read those without a decoder).

    python -m videoloop3d_torch.tools.owndata_step1 \
        --input_path capture.mov --output_prefix data/myscene \
        [--factor 1,2] [--black_thresh 10]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from videoloop3d_torch.data import video as video_io
from videoloop3d_torch.data.video import (read_video, resize_video,
                                          write_image, write_video)


def split_on_black(frames, thresh=10):
    """Yield lists of frames separated by near-black frames."""
    clip = []
    for frame in frames:
        if frame.mean() < thresh:
            if clip:
                yield clip
            clip = []
        else:
            clip.append(frame)
    if clip:
        yield clip


def standardize(input_path, output_prefix, factors=(1, 2), black_thresh=10,
                fps=25, video_ext=None):
    """Write the clips of the capture at input_path under output_prefix
    (video_ext None: mp4, or npy without imageio); returns their number."""
    video_ext = video_ext or ("mp4" if video_io._HAS_IMAGEIO else "npy")
    frames = read_video(input_path)
    os.makedirs(os.path.join(output_prefix, "images"), exist_ok=True)
    n_clips = 0
    for clip_id, clip in enumerate(split_on_black(frames, black_thresh)):
        clip = np.stack(clip)
        avg = clip.astype(np.float64).mean(0).astype(np.uint8)
        write_image(os.path.join(output_prefix, "images",
                                 f"{clip_id:04d}.png"), avg)
        for factor in factors:
            outdir = os.path.join(output_prefix, f"videos_{factor}")
            os.makedirs(outdir, exist_ok=True)
            h, w = clip.shape[1] // factor, clip.shape[2] // factor
            vid = resize_video(clip, h, w) if factor != 1 else clip
            write_video(os.path.join(outdir, f"{clip_id:04d}.{video_ext}"),
                        vid, fps=fps)
        print(f"clip {clip_id}: {len(clip)} frames")
        n_clips += 1
    return n_clips


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input_path", required=True)
    ap.add_argument("--output_prefix", default="../data")
    ap.add_argument("--factor", default="1,2")
    ap.add_argument("--black_thresh", type=float, default=10)
    args = ap.parse_args(argv)
    factors = [int(f) for f in args.factor.split(",")]
    n = standardize(args.input_path, args.output_prefix, factors,
                    args.black_thresh)
    print(f"wrote {n} view clips to {args.output_prefix}")
    return n


if __name__ == "__main__":
    main()
