"""Hit-compaction of the sparse plane sweep: kernel K13 `compact_sweep`
(``csrc/compact.cu``: a block of 32 pixels and all planes, the hits as
bit words, each slot written once, `compact_layout`), its plain version,
and the per-level slot bound (counterpart of
``videoloop3d_tpu/render/compact.py``, ``--compact_hits``).

After the cull only a few of a pixel's D planes land on a kept tile.
`compact_sweep` compacts the plane axis per pixel down to a bound S: slot
s of a pixel holds its s-th farthest hit plane (planes and slots are
stored far first), empty slots hold k = -1, and a pixel with more than S
hits drops its farthest ones.  The gathers, the decode, the composite and
the regularizers of the training render then run at (S, h, w).  The tile
samplers (``render/sample.py:sample_tiles``) scatter their gradient
straight from the slot layout, so the port needs neither the JAX
package's one-hot selection matrix nor `expand_cotangent`;
`expand_cotangent_plain` is kept for the tests, which compare the port's
slot gradient with the JAX formulation.

`slot_bound` is the JAX package's static per-pixel hit bound over a set
of views (the hit test at the pixel grid and at four jittered principal
points, ORed, plus a margin), evaluated with K1 (its plain version on the
CPU).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from videoloop3d_torch import kernels
from videoloop3d_torch.render import renderer as R


class CompactedSweep(NamedTuple):
    """Per-slot compacted sample arrays, each (S, h, w)."""
    k_s: torch.Tensor       # int32 packed static tile (-1 = none)
    k_d: torch.Tensor       # int32 packed dynamic tile (-1 = none)
    fu: torch.Tensor        # f32 in-tile fractions
    fv: torch.Tensor
    valid: torch.Tensor     # bool frustum mask
    zview: torch.Tensor     # f32 view-space depth


def _slots(k_s, k_d, n_slots):
    """(slot index (D, h, w) int64, kept (D, h, w) bool) of every plane:
    a hit plane's slot is S - (hits at it and nearer planes)."""
    hit = (k_s >= 0) | (k_d >= 0)
    rnc = torch.flip(torch.cumsum(torch.flip(hit.long(), [0]), 0), [0])
    slot = n_slots - rnc
    return slot, hit & (slot >= 0)


def compact_sweep_plain(k_s, k_d, fu, fv, valid, zview, n_slots):
    """Plain version of K13.  k_s, k_d (D, h, w) int32 (-1 = miss); fu, fv,
    zview (D, h, w) f32; valid (D, h, w) bool; planes far first.  Returns a
    `CompactedSweep` of (S, h, w) slots."""
    D, h, w = k_s.shape
    S = int(n_slots)
    slot, keep = _slots(k_s, k_d, S)
    pix = torch.arange(h * w, device=k_s.device).expand(D, h * w)
    dst = (slot.reshape(D, -1) * (h * w) + pix)[keep.reshape(D, -1)]
    sel = keep.reshape(D, -1)

    def compact(x, empty):
        out = torch.full((S * h * w,), empty, dtype=x.dtype, device=x.device)
        out[dst] = x.reshape(D, -1)[sel]
        return out.view(S, h, w)

    return CompactedSweep(compact(k_s, -1), compact(k_d, -1), compact(fu, 0.0),
                          compact(fv, 0.0), compact(valid, False),
                          compact(zview, 0.0))


# K13's block (csrc/compact.cu:compact_layout): 32 pixels (a warp's lanes)
# and all planes, 4 warps; at most K13_MAX_PLANES planes and slots
_K13_PIX, _K13_WARPS = 32, 4
K13_MAX_PLANES = 256
COMPACT_LAYOUT_KEYS = ("pix", "threads", "words", "smem")


def compact_layout(D, S):
    """K13's layout for D planes and S slots, as a dict: `pix` pixels a
    block, `threads` a block, `words` bit words of 32 planes a pixel and
    `smem` dynamic shared bytes (a hit word a plane, the pixels' words
    and their hit counts at the nearer words, and the slot table of S x
    pix entries of k_s, k_d, fu, fv, zview and valid, 21 bytes each)."""
    words = -(-D // 32)
    return dict(pix=_K13_PIX, threads=32 * _K13_WARPS, words=words,
                smem=4 * D + 8 * 32 * words + 21 * S * _K13_PIX)


def kernel_compact_layout(D, S):
    """K13's layout as csrc/compact.cu computes it (vl3d_compact_layout;
    needs the CUDA library), keyed as `compact_layout`."""
    out = (ctypes.c_longlong * len(COMPACT_LAYOUT_KEYS))()
    kernels.library().vl3d_compact_layout(D, S, out)
    return dict(zip(COMPACT_LAYOUT_KEYS, out))


def compact_sweep(k_s, k_d, fu, fv, valid, zview, n_slots):
    """K13: compact the (D, h, w) per-plane sample arrays of one view to
    (S, h, w) slots.  Same arguments and result as `compact_sweep_plain`;
    inputs must be contiguous and on one device, at most K13_MAX_PLANES
    planes and slots (more raise, on the CPU too)."""
    dev = k_s.device
    kernels.check_tensor("compact_sweep.k_s", k_s, dev, dtype=torch.int32)
    if k_s.dim() != 3:
        raise ValueError(f"compact_sweep.k_s: shape {tuple(k_s.shape)}, "
                         "expected (D, h, w)")
    kernels.check_tensor("compact_sweep.k_d", k_d, dev, dtype=torch.int32,
                         shape=k_s.shape)
    for name, t, dt in (("fu", fu, torch.float32), ("fv", fv, torch.float32),
                        ("valid", valid, torch.bool),
                        ("zview", zview, torch.float32)):
        kernels.check_tensor(f"compact_sweep.{name}", t, dev, dtype=dt,
                             shape=k_s.shape)
    D, h, w = k_s.shape
    S = int(n_slots)
    if max(D, S) > K13_MAX_PLANES:
        raise ValueError(f"compact_sweep: {D} planes, {S} slots; limit "
                         f"{K13_MAX_PLANES}")
    if dev.type == "cpu":
        return compact_sweep_plain(k_s, k_d, fu, fv, valid, zview, n_slots)
    shape = (S, h, w)
    o_ks = torch.empty(shape, dtype=torch.int32, device=dev)
    o_kd = torch.empty(shape, dtype=torch.int32, device=dev)
    o_fu, o_fv, o_z = (torch.empty(shape, dtype=torch.float32, device=dev)
                       for _ in range(3))
    o_valid = torch.empty(shape, dtype=torch.bool, device=dev)
    err = kernels.library().vl3d_compact_sweep(
        k_s.data_ptr(), k_d.data_ptr(), fu.data_ptr(), fv.data_ptr(),
        valid.data_ptr(), zview.data_ptr(), D, h * w, S, o_ks.data_ptr(),
        o_kd.data_ptr(), o_fu.data_ptr(), o_fv.data_ptr(), o_valid.data_ptr(),
        o_z.data_ptr(), kernels.stream_ptr(dev))
    kernels.LAUNCHES["compact_sweep"] += 1
    kernels.check_launch("compact_sweep", err)
    return CompactedSweep(o_ks, o_kd, o_fu, o_fv, o_valid, o_z)


def expand_cotangent_plain(k_s, k_d, ct, n_slots):
    """(S, h, w, ...) slot cotangents -> (D, h, w, ...) plane layout (the
    transpose of the selection, ``videoloop3d_tpu/render/compact.py:
    expand_cotangent``): each kept hit plane receives its slot's
    cotangent, every other plane zero.  k_s, k_d are the (D, h, w)
    per-plane indices the slots were compacted from.  For the tests."""
    D, h, w = k_s.shape
    S = int(n_slots)
    slot, keep = _slots(k_s, k_d, S)
    pix = torch.arange(h * w, device=ct.device).view(1, h, w)
    src = (slot.clamp(0, S - 1) * (h * w) + pix).reshape(-1)
    flat = ct.reshape((S * h * w,) + ct.shape[3:])
    full = flat[src].reshape((D, h, w) + ct.shape[3:])
    mask = keep.view(keep.shape + (1,) * (ct.dim() - 3))
    return torch.where(mask, full, torch.zeros((), dtype=ct.dtype,
                                               device=ct.device))


def slot_bound(geom, tile_map_static, tile_map_dyn, extrins, intrins, h, w,
               jitter_px=0.55, margin=2):
    """Static per-pixel hit bound S for a set of views at (h, w).

    Evaluates the hit test (K1's tile lookup, a hit where either packed
    index is >= 0 and the sample is valid) at the pixel grid AND with the
    principal point moved by (+-jitter_px, +-jitter_px) (the trainer's
    +-0.5 px intrinsic noise can carry a sample across a tile edge), ORs
    the five, and returns ``min(D, max_hits + margin)``.

    extrins (V, 4, 4) relative to the reference camera; intrins (V, 3, 3)
    at the (h, w) resolution (patches are integer crops of this grid).
    Tile maps are (D, nth, ntw) int32 tensors (the model's); the work
    runs on their device, one K1 call per view."""
    maps = (tile_map_static, tile_map_dyn)
    device = tile_map_static.device
    D = geom.n_planes
    jit = [(0.0, 0.0), (-jitter_px, -jitter_px), (-jitter_px, jitter_px),
           (jitter_px, -jitter_px), (jitter_px, jitter_px)]
    mx = 0
    for ext, intr in zip(np.asarray(extrins), np.asarray(intrins)):
        Ks = []
        for dy, dx in jit:
            K = torch.as_tensor(np.asarray(intr, np.float32)).clone()
            K[0, 2] += dx
            K[1, 2] += dy
            Ks.append(K)
        K = torch.stack(Ks).to(device)
        E = torch.as_tensor(np.asarray(ext, np.float32), device=device)
        G = R.homographies(geom, E.expand(len(jit), 4, 4), K).contiguous()
        coords, k_s, k_d, _, _ = R.warp_lookup(
            G, *maps, h, w, (geom.mpi_h, geom.mpi_w), geom.tile_span)
        hits = (((k_s >= 0) | (k_d >= 0)) & coords.valid).any(dim=0)
        mx = max(mx, int(hits.sum(dim=0).max()))
    return int(min(D, mx + margin))
