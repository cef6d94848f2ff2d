"""The first designs of K5 (at C != 4), K24, K26 and K27, kept beside
their redesigns for comparison only.

``chip_smoke.py`` and the card tests call these to hold each redesign bit
for bit against the design it replaced and to time both; no path of the
port calls them, and they add to no launch count.  Each takes the
arguments of its wrapper and returns what that wrapper returns.
"""
from __future__ import annotations

import torch

from videoloop3d_torch import kernels
from videoloop3d_torch.losses.swd import _grid


def sort_keys(v):
    """csrc/swd_mask.cu:f2key in torch: the order-preserving keys of f32
    values (-0 as +0) as int32 bits, K27's output format."""
    u = v.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    u = torch.where(u == 0x80000000, torch.zeros_like(u), u)
    k = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    return (k - ((k >= 2 ** 31).long() << 32)).to(torch.int32)


def sample_dense_first(atlas, mask, x, y):
    """K5's first design at any C, one thread per (sample, channel)
    (csrc/sample_dense.cu:vl3d_sample_dense_per_channel), with
    `render.sample.sample_dense_fwd`'s arguments: (feats, mask feats or
    None)."""
    B, D, h, w = x.shape
    _, Ht, Wt, C = atlas.shape
    out = torch.empty((B, D, h, w, C), dtype=torch.float32, device=x.device)
    out_m = None if mask is None else torch.empty(
        (B, D, h, w, 1), dtype=torch.float32, device=x.device)
    err = kernels.library().vl3d_sample_dense_per_channel(
        atlas.data_ptr(), None if mask is None else mask.data_ptr(),
        x.data_ptr(), y.data_ptr(), B, D, h * w, Ht, Wt, C, out.data_ptr(),
        None if out_m is None else out_m.data_ptr(),
        kernels.stream_ptr(x.device))
    kernels.check_launch("sample_dense (first design)", err)
    return out, out_m


def swd_mask_sort_first(o, gather, payload):
    """K27's first design: per-pass histograms of 2,048-key tiles, their
    scan, and a scatter straight into device memory
    (csrc/swd_mask.cu:vl3d_swd_mask_sort_first), with
    `losses.swd.swd_mask_sort`'s arguments: (keys, payload or None)."""
    P, n = o.shape[0], gather.shape[0]
    keys = torch.empty((P, n), dtype=torch.int32, device=o.device)
    alt = torch.empty_like(keys)
    pay = torch.empty_like(keys) if payload else None
    pay_alt = torch.empty_like(keys) if payload else None
    hist = torch.empty((P, 256, -(-n // 2048)), dtype=torch.int32,
                       device=o.device)
    err = kernels.library().vl3d_swd_mask_sort_first(
        o.data_ptr(), o[0].numel(), gather.data_ptr(), P, n, keys.data_ptr(),
        alt.data_ptr(), None if pay is None else pay.data_ptr(),
        None if pay_alt is None else pay_alt.data_ptr(), hist.data_ptr(),
        kernels.stream_ptr(o.device))
    kernels.check_launch("swd_mask_sort (first design)", err)
    return keys, pay


def swd_project_first(v, rand, psz, strides):
    """K24's first design: 64 x 64 tiles of 4 x 4 outputs, 32 entries
    staged at a time in one buffer (csrc/swd.cu:vl3d_swd_project_first),
    with `losses.swd.swd_project`'s arguments: (P, ch * cw, cf) f32."""
    cf, ch, cw = _grid(v.shape, psz, strides)
    P = rand.shape[0]
    out = torch.empty((P, ch * cw, cf), dtype=torch.float32, device=v.device)
    err = kernels.library().vl3d_swd_project_first(
        v.data_ptr(), rand.data_ptr(), *v.shape, *psz[:2], *strides[:2], P,
        out.data_ptr(), kernels.stream_ptr(v.device))
    kernels.check_launch("swd_project (first design)", err)
    return out


def swd_project_grad_first(gx, rand, shape, psz, strides):
    """K26's first design: the first design's GEMM into a (cf ch cw, d)
    scratch, folded w-fastest (csrc/swd.cu:vl3d_swd_project_grad_first),
    with `losses.swd.swd_project_grad`'s arguments: (C, T, H, W) f32."""
    cf, ch, cw = _grid(shape, psz, strides)
    scratch = torch.empty((cf * ch * cw, rand.shape[1]), dtype=torch.float32,
                          device=gx.device)
    out = torch.empty(tuple(shape), dtype=torch.float32, device=gx.device)
    err = kernels.library().vl3d_swd_project_grad_first(
        gx.data_ptr(), rand.data_ptr(), *shape, *psz[:2], *strides[:2],
        rand.shape[0], scratch.data_ptr(), out.data_ptr(),
        kernels.stream_ptr(gx.device))
    kernels.check_launch("swd_project_grad (first design)", err)
    return out
