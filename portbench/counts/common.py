"""Shared arithmetic of the counts (from ``chip_smoke.py``)."""
from __future__ import annotations


def decode_ops(decoder, C):
    """Operations to decode one texel sample: 4 sigmoids of 4 operations,
    3 mask products and the alpha select (20); the rgb_sh decoder adds a
    multiply-add per SH coefficient of the three colours."""
    return 20 + (2 * (C - 1) if decoder == "rgb_sh" else 0)


def composite_ops(s, backward):
    """The fused stage-2 function's operations (``chip_smoke.py:
    fused_s2_ops``) on s's slots: n_sp slot-pixels, n_dyn of them dynamic,
    F frames, both smoothness terms on, sparsity and disparity off; the
    decode per `decode_ops`."""
    F = s.F
    n = s.n_sp * F
    n_stat = s.n_sp - s.n_dyn
    ch = 3 + 1                      # rgb and alpha smoothness
    dec = decode_ops(s.decoder, s.C)
    decode = dec * (s.n_dyn * F + n_stat)
    if not backward:
        return decode + n * (10 + 6 * ch)
    return (decode + n * (2 + 6 + 10 + 10 * ch)
            + (dec - 4) * s.n_dyn * F + 4 * n_stat * F + (dec - 4) * n_stat)


def nn_search_ops(plan, C, passes):
    """The least operations of one K11 column (``chip_smoke.py:
    nn_search_ops``): the Gram of the patches, or where fewer that of the
    footprint frames summed along the band, plus the row statistics."""
    (pt, ph, pw), st = plan.psz, plan.strides[0]
    ntx, nty = plan.grid[:2]
    cpp = C * ph * pw
    nfx, nfy = (ntx - 1) * st + pt, (nty - 1) * st + pt
    patches = 2 * ntx * nty * cpp * pt + passes * (ntx + nty) * cpp * pt
    frames = (2 * nfx * nfy * cpp + (pt - 1) * ntx * nty
              + passes * (nfx + nfy) * cpp
              + passes // 2 * (pt - 1) * (ntx + nty))
    return min(patches, frames)
