"""Linear resize of tile textures (counterpart of
``jax.image.resize(x, shape, "linear")`` as ``videoloop3d_tpu/models/mpv.py``
uses it in ``lod``).

JAX's "linear" resize is a separable contraction with one weight matrix
per resized axis: a triangle kernel, widened by 1/scale when the axis
shrinks (antialiasing), each output column normalised to sum 1.  The
matrices are built here in numpy float32 with JAX's operation order and
applied with `torch.einsum`.  ``torch.nn.functional.interpolate`` is not
used: its antialiased weights are not guaranteed to match at the edges.
"""
from __future__ import annotations

import numpy as np
import torch


def weight_matrix(in_size, out_size):
    """(in_size, out_size) float32 weights: out[j] = sum_i x[i] * W[i, j]
    (``jax._src.image.scale.compute_weight_mat`` with the triangle kernel,
    antialias on, translation 0)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = np.maximum(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale \
        - f32(0.0) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1.0)),
                       f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


# f32 bytes of input per slice of `resize_tiles`
CHUNK_BYTES = 1 << 28


def resize_tiles(x, out_hw):
    """Resize the texel axes (1, 2) of tiles x (N, th, tw, ...) to out_hw
    (nth, ntw): packed tiles, or the (D, Ht, Wt, F, C) stack of a dense
    stage-2 model.  Computes in float32 and returns x's dtype; an axis
    whose size does not change is left alone, as in JAX.  Runs over
    slices of the first axis of about CHUNK_BYTES each, so the
    temporaries stay small next to a 7 GB dense stack."""
    N, th, tw = x.shape[:3]
    nth, ntw = out_hw
    rest = x.shape[3:]
    wh = torch.from_numpy(weight_matrix(th, nth)).to(x.device) \
        if nth != th else None
    ww = torch.from_numpy(weight_matrix(tw, ntw)).to(x.device) \
        if ntw != tw else None
    k = int(np.prod(rest, dtype=np.int64))
    out = torch.empty((N, nth, ntw) + rest, dtype=x.dtype, device=x.device)
    step = max(1, CHUNK_BYTES // max(1, 4 * th * tw * k))
    for a in range(0, N, step):
        y = x[a:a + step].float().reshape(-1, th, tw, k)
        if wh is not None:
            y = torch.einsum("nhwk,hH->nHwk", y, wh)
        if ww is not None:
            y = torch.einsum("nhwk,wW->nhWk", y, ww)
        out[a:a + step] = y.reshape((-1, nth, ntw) + rest).to(x.dtype)
    return out
