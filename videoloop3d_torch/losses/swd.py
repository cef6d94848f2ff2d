"""Sliced-Wasserstein 3-D patch loss, the "swd" looping loss (counterpart of
``videoloop3d_tpu/losses/swd.py``; ref utils_vid.py:145-203).

x and y (C, T, H, W) in [0, 1] are mapped to [-1, 1] and projected with
`num_proj` random (C, pt, p, p) filters, normalised by their std over the
projections: a VALID conv3d at strides (st, s, s) (the intended order; the
reference passes them swapped).  Each (projection, spatial location)
column of the result is a distribution over time: the shorter side's
columns are brought to the other's length (`_match_lengths`), both are
sorted, and the loss is the mean L1 between the sorted columns.  Its
gradient flows into x through the sort (ties in index order, as
``jnp.sort``'s) and |.| (+1 at 0, as ``jnp.abs``'s); y carries none.

Three kernels live here, each beside its plain PyTorch version:

* K24 `swd_project` (``csrc/swd.cu``): the projection, an implicit GEMM
  written in K25's column layout (P, ch cw, cf);
* K25 `swd_sort_l1`: the stable sort of every column (order-preserving
  keys through a bitonic network, NaNs last), the L1 and its gradient in
  x's columns, summed in a fixed order;
* K26 `swd_project_grad`: that gradient taken back through the projection
  into x, deterministic.

The mask branch (JAX :79-93: each projection is one row over all its
patches, y's patches touching the mask repeated ``mask_patches_factor``
times) has two more, `swd_mask_sort_l1` (``csrc/swd_mask.cu``):

* K27 `swd_mask_sort`: a per-row stable LSD radix sort of the rows
  (10^5-10^6 entries, beyond K25's 1,024), read from K24's layout through
  an index map, with the matched index as the payload of x's row: one
  upsweep counts every pass's digits as the rows load, then each pass
  ranks a tile once, stages it in shared memory in digit order and writes
  its digit runs coalesced, at offsets from a decoupled look-back;
* K28 `swd_mask_l1`: the L1 over ranks and its gradient, routed back
  through the payload and summed over the copies of `_match_lengths`: a
  block a row keeps the row's signs as bits in shared memory, placed in
  the gradient's order (`swd_mask_l1_layout`).

`_SwdLoss` chains them (K24 twice, then K25, or K27 twice and K28, and
K26 in the backward).  The projections and the permutation of
`_match_lengths` are draws (`swd_draws`): from a torch.Generator in the
trainer, from the JAX package's key in the tests.  No command line passes
a mask (JAX ``train/stage2.py:171``); the API does.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from videoloop3d_torch import kernels
from videoloop3d_torch.losses.patch_nn import (extract_patches_3d,
                                               fold_patches_3d)

# K25 sorts a column of at most this many matched entries (up to 64 in
# registers, longer ones in shared memory: csrc/swd.cu kNetSlots)
_MAX_SORT_LEN = 1024
# columns to one of K25's partial sums (csrc/swd.cu kSortWarps)
_SORT_COLS_PER_BLOCK = 8
# the most copies of an x entry K28's first design sums
# (csrc/swd_mask.cu kMaxReps); the redesign takes any number
_MASK_MAX_REPS = 64
# K24/K26's GEMM tile (csrc/swd.cu kBM = kBN): its columns and block count
# are 32-bit
_GEMM_TILE = 128


def mask_patch_columns(mask, patch_size, patcht_size, stride, stridet,
                       n_frames=None):
    """Which patch columns touch the mask (host numpy).  mask (T, H, W),
    or (H, W) with n_frames (broadcast over time), nonzero = masked.
    Returns a bool array over the (cf, ch, cw) patch grid, flattened in
    that order (ref utils_vid.py:189-194: any mask pixel inside the
    patch), from the box sums of the mask's integral volume (the same
    decision as a loop over the patches, at the full mask shapes' cost of
    a few array passes)."""
    mask = np.asarray(mask) > 0
    if mask.ndim == 2:
        mask = np.broadcast_to(mask[None], (n_frames or 1,) + mask.shape)
    T, H, W = mask.shape
    cf = (T - patcht_size) // stridet + 1 if T >= patcht_size else 1
    ch = (H - patch_size) // stride + 1
    cw = (W - patch_size) // stride + 1
    csum = np.zeros((T + 1, H + 1, W + 1), np.int64)
    csum[1:, 1:, 1:] = mask.cumsum(0).cumsum(1).cumsum(2)
    f0 = np.arange(cf) * stridet
    f1 = np.minimum(f0 + patcht_size, T)
    i0 = np.arange(ch) * stride
    i1 = i0 + patch_size
    j0 = np.arange(cw) * stride
    j1 = j0 + patch_size
    F0, I0, J0 = np.ix_(f0, i0, j0)
    F1, I1, J1 = np.ix_(f1, i1, j1)
    box = (csum[F1, I1, J1] - csum[F0, I1, J1] - csum[F1, I0, J1]
           - csum[F1, I1, J0] + csum[F0, I0, J1] + csum[F0, I1, J0]
           + csum[F1, I0, J0] - csum[F0, I0, J0])
    return (box > 0).reshape(cf * ch * cw)


def match_plan(n_a, n_b):
    """`_match_lengths` of columns n_a and n_b long: None when equal, else
    (tiled, deficit): the shorter side is tiled as often as it fits whole
    (tiled entries), then `deficit` entries picked by a permutation of the
    tiled column are appended."""
    if n_a == n_b:
        return None
    short, long_ = min(n_a, n_b), max(n_a, n_b)
    tiled = long_ // short * short
    return tiled, long_ - tiled


def swd_draws(gen, num_proj, C, pt, p, n_short):
    """The random inputs of one `swd_3d_loss`, drawn from the
    torch.Generator gen on its device: "rand", the raw standard-normal
    projections (num_proj, C, pt, p, p), and "perm", a permutation of the
    n_short entries of the tiled shorter column (`match_plan`'s tiled), or
    None when no entry is missing.  The JAX package draws both from one
    key: jax.random.normal(key, shape) and jax.random.permutation(key,
    n_short)."""
    rand = torch.randn((num_proj, C, pt, p, p), generator=gen,
                       device=gen.device)
    perm = torch.randperm(n_short, generator=gen, device=gen.device) \
        if n_short else None
    return {"rand": rand, "perm": perm}


def swd_n_short(n_x, n_y):
    """The length of `swd_draws`' permutation for columns n_x and n_y long
    (0 when none is needed)."""
    plan = match_plan(n_x, n_y)
    return plan[0] if plan and plan[1] > 0 else 0


def _match_maps(n_x, n_y, perm, device):
    """The index maps of `_match_lengths`: (map_x, map_y), each None or an
    int32 tensor of the matched length selecting the shorter side's
    entries (tiled, then perm[:deficit] of the tiled column)."""
    plan = match_plan(n_x, n_y)
    if plan is None:
        return None, None
    tiled, deficit = plan
    short = min(n_x, n_y)
    idx = torch.arange(tiled, device=device) % short
    if deficit:
        if perm is None or perm.numel() < deficit:
            raise ValueError(f"swd: {deficit} entries to pad need a "
                             f"permutation of {tiled} (swd_draws)")
        idx = torch.cat([idx, perm[:deficit].to(device).long() % short])
    idx = idx.to(torch.int32).contiguous()
    return (idx, None) if n_x < n_y else (None, idx)


def match_inverse(map_a, n_a):
    """The inverse of a match map of the n_a-long side: (start (n_a + 1)
    int32, order (n) int32), each source's copies r listed ascending in
    order[start[src]:start[src + 1]].  None for no map.  K25 sums a
    source's gradient over them."""
    if map_a is None:
        return None
    m = map_a.long()
    order = torch.sort(m, stable=True).indices
    start = torch.zeros(n_a + 1, dtype=torch.long, device=m.device)
    start[1:] = torch.cumsum(torch.bincount(m, minlength=n_a), 0)
    return (start.to(torch.int32).contiguous(),
            order.to(torch.int32).contiguous())


def _match_lengths(a, b, perm):
    """Columns of the shorter (rows, n) matrix tiled and padded to the
    other's length (ref utils_vid.py:29-49), as the JAX package's."""
    map_a, map_b = _match_maps(a.shape[1], b.shape[1], perm, a.device)
    if map_a is not None:
        a = a[:, map_a.long()]
    if map_b is not None:
        b = b[:, map_b.long()]
    return a, b


def normalized_projections(rand):
    """(P, d) f32: the raw draws divided by their std over the projections
    (ddof 0, as jnp.std), when there is more than one."""
    rand = rand.float()
    P = rand.shape[0]
    if P > 1:
        mean = torch.mean(rand, dim=0, keepdim=True)
        std = torch.sqrt(torch.mean((rand - mean) ** 2, dim=0, keepdim=True))
        rand = rand / std
    return rand.reshape(P, -1).contiguous()


def _grid(shape, psz, strides):
    (pt, p, _), (st, s, _) = psz, strides
    _, T, H, W = shape
    return (T - pt) // st + 1, (H - p) // s + 1, (W - p) // s + 1


# ---------------------------------------------------------------------------
# plain versions of K24, K25 and K26
# ---------------------------------------------------------------------------

def swd_project_plain(v, rand, psz, strides):
    """Plain version of K24: v (C, T, H, W) f32, rand (P, d) ->
    (P, ch * cw, cf) f32, the patches extracted and multiplied by rand."""
    patches = extract_patches_3d(v, psz, strides)       # (cf, ch, cw, d)
    cf, ch, cw, d = patches.shape
    out = torch.matmul(rand, patches.reshape(-1, d).T)  # (P, cf ch cw)
    return out.reshape(rand.shape[0], cf, ch * cw).transpose(1, 2) \
        .contiguous()


def sort_l1_cols_plain(a, b, map_a, map_b):
    """The sorted-column L1 of the (rows, na) and (rows, nb) matrices a and
    b matched through the index maps: (loss, gradient in a (rows, na)).
    The sort is stable; the gradient of an entry is sign+(sa - sb) / N at
    its rank (+1 at 0), summed over its copies."""
    am = a[:, map_a.long()] if map_a is not None else a
    bm = b[:, map_b.long()] if map_b is not None else b
    sa, ia = torch.sort(am, dim=1, stable=True)
    sb, _ = torch.sort(bm, dim=1, stable=True)
    d = sa - sb
    count = np.float32(d.numel())
    loss = torch.sum(d.abs()) / float(count)
    inv = float(np.float32(1.0) / count)
    gs = torch.where(d >= 0, inv, -inv).to(torch.float32)
    gm = torch.empty_like(am).scatter_(1, ia, gs)
    if map_a is None:
        return loss, gm
    ga = torch.zeros_like(a)
    return loss, ga.index_add_(1, map_a.long(), gm)


def swd_sort_l1_plain(ox, oy, map_x, map_y):
    """Plain version of K25: ox (P, L, cfx), oy (P, L, cfy) f32 projection
    columns, map_x / map_y from `_match_maps`.  Returns (loss, gx (P, L,
    cfx))."""
    loss, g = sort_l1_cols_plain(ox.reshape(-1, ox.shape[2]),
                                 oy.reshape(-1, oy.shape[2]), map_x, map_y)
    return loss, g.reshape(ox.shape)


def swd_project_grad_plain(gx, rand, shape, psz, strides):
    """Plain version of K26: gx (P, ch * cw, cf), rand (P, d) -> the
    gradient in x (C, T, H, W) f32: 2 * the patch gradients rand^T gx
    folded back (overlap-add)."""
    C, T, H, W = shape
    cf, ch, cw = _grid(shape, psz, strides)
    G = torch.einsum("plf,pq->flq", gx, rand)            # (cf, L, d)
    G = G.reshape((cf, ch, cw, C) + tuple(psz))
    return 2.0 * fold_patches_3d(G, (T, H, W), strides)


# ---------------------------------------------------------------------------
# K24, K25 and K26
# ---------------------------------------------------------------------------

def _check_gemm_limits(name, rows, cols):
    """Raise unless K24/K26's tiled GEMM takes a rows x cols output: cols
    below 2^31 - 128 and fewer than 2^31 tiles of 128 x 128."""
    tiles = -(-rows // _GEMM_TILE) * -(-cols // _GEMM_TILE)
    if cols > 2 ** 31 - 1 - _GEMM_TILE or tiles >= 2 ** 31:
        raise ValueError(f"{name}: a {rows} x {cols} product is beyond the "
                         "kernel's 32-bit columns and tile count")


def swd_project(v, rand, psz, strides):
    """K24: the projection columns (P, ch * cw, cf) f32 of v (C, T, H, W)
    f32 contiguous under rand (P, d) f32 (`swd_project_plain`'s
    function); every output sums its d products in one fixed order."""
    kernels.check_tensor("swd_project.v", v, v.device, dtype=torch.float32)
    kernels.check_tensor("swd_project.rand", rand, v.device,
                         dtype=torch.float32,
                         shape=(rand.shape[0], v.shape[0] * int(np.prod(psz))))
    if v.dim() != 4 or v.numel() >= 2 ** 31:
        raise ValueError(f"swd_project: v {tuple(v.shape)} must be (C, T, "
                         "H, W) with fewer than 2^31 elements")
    if v.device.type == "cpu":
        return swd_project_plain(v, rand, psz, strides)
    cf, ch, cw = _grid(v.shape, psz, strides)
    P = rand.shape[0]
    _check_gemm_limits("swd_project", P, cf * ch * cw)
    out = torch.empty((P, ch * cw, cf), dtype=torch.float32, device=v.device)
    err = kernels.library().vl3d_swd_project(
        v.data_ptr(), rand.data_ptr(), *v.shape, *psz[:2], *strides[:2], P,
        out.data_ptr(), kernels.stream_ptr(v.device))
    kernels.LAUNCHES["swd_project"] += 1
    kernels.check_launch("swd_project", err)
    return out


def swd_sort_l1(ox, oy, map_x, map_y):
    """K25: (loss () f32, gx (P, L, cfx) f32) of the columns ox (P, L, cfx)
    and oy (P, L, cfy) matched through map_x / map_y
    (`swd_sort_l1_plain`'s function; the loss summed in a fixed order,
    no atomics; NaNs sort last).  The matched length is at most 1,024:
    up to 64 the keyed network runs in registers, beyond it in shared
    memory."""
    dev = ox.device
    n = _check_sort_l1("swd_sort_l1", ox, oy, map_x, map_y)
    if dev.type == "cpu":
        return swd_sort_l1_plain(ox, oy, map_x, map_y)
    ncols = ox.shape[0] * ox.shape[1]
    inv = match_inverse(map_x, ox.shape[2])
    partial = torch.empty(-(-ncols // _SORT_COLS_PER_BLOCK),
                          dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    gx = torch.empty_like(ox)
    err = kernels.library().vl3d_swd_sort_l1(
        ox.data_ptr(), oy.data_ptr(), ncols, ox.shape[2], oy.shape[2], n,
        map_x.data_ptr() if map_x is not None else None,
        map_y.data_ptr() if map_y is not None else None,
        *((inv[0].data_ptr(), inv[1].data_ptr()) if inv else (None, None)),
        float(np.float32(ncols * n)), partial.data_ptr(), loss.data_ptr(),
        gx.data_ptr(), kernels.stream_ptr(dev))
    kernels.LAUNCHES["swd_sort_l1"] += 1
    kernels.check_launch("swd_sort_l1", err)
    return loss, gx


def _check_sort_l1(name, ox, oy, map_x, map_y):
    """Raise unless K25 takes these columns; returns the matched length."""
    dev = ox.device
    kernels.check_tensor(f"{name}.ox", ox, dev, dtype=torch.float32)
    kernels.check_tensor(f"{name}.oy", oy, dev, dtype=torch.float32,
                         shape=ox.shape[:2] + (oy.shape[2],))
    n = max(ox.shape[2], oy.shape[2])
    for key, m in (("map_x", map_x), ("map_y", map_y)):
        if m is not None:
            kernels.check_tensor(f"{name}.{key}", m, dev, dtype=torch.int32,
                                 shape=(n,))
    if dev.type != "cpu" and n > _MAX_SORT_LEN:
        raise ValueError(f"{name}: columns of {n} entries (the kernel "
                         f"takes at most {_MAX_SORT_LEN})")
    return n


def swd_project_grad(gx, rand, shape, psz, strides):
    """K26: the gradient (C, T, H, W) f32 of the loss in x (v = 2 x - 1)
    from K25's gx (P, ch * cw, cf) and rand (P, d)
    (`swd_project_grad_plain`'s function), summed in a fixed order with
    no atomics; a (d, cf ch cw rounded up to 4) f32 scratch holds the
    patch gradients, patch column fastest."""
    dev = gx.device
    cf, ch, cw = _grid(shape, psz, strides)
    P = rand.shape[0]
    kernels.check_tensor("swd_project_grad.gx", gx, dev, dtype=torch.float32,
                         shape=(P, ch * cw, cf))
    kernels.check_tensor("swd_project_grad.rand", rand, dev,
                         dtype=torch.float32,
                         shape=(P, shape[0] * int(np.prod(psz))))
    if dev.type == "cpu":
        return swd_project_grad_plain(gx, rand, shape, psz, strides)
    if int(np.prod(shape)) >= 2 ** 31:
        raise ValueError(f"swd_project_grad: shape {tuple(shape)} has 2^31 "
                         "elements or more")
    _check_gemm_limits("swd_project_grad", rand.shape[1], cf * ch * cw)
    lib = kernels.library()
    scratch = torch.empty(
        lib.vl3d_swd_project_grad_scratch(*shape, *psz[:2], *strides[:2]),
        dtype=torch.float32, device=dev)
    out = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
    err = lib.vl3d_swd_project_grad(
        gx.data_ptr(), rand.data_ptr(), *shape, *psz[:2], *strides[:2], P,
        scratch.data_ptr(), out.data_ptr(), kernels.stream_ptr(dev))
    kernels.LAUNCHES["swd_project_grad"] += 1
    kernels.check_launch("swd_project_grad", err)
    return out


def _conv_order_map(e, L, cf):
    """Offsets in a K24 (L, cf) projection row of the conv-order entries e
    (e = f L + l, the JAX package's (cf, ch cw) flattening), int32."""
    return ((e % L) * cf + e // L).to(torch.int32).contiguous()


def swd_mask_plan(n_x, n_y, order, perm, L, cfx, cfy, device):
    """The mask branch's index maps for rows of n_x (x, conv order) and
    n_y = len(order) (y, mask order) entries: {"n", "gather_x",
    "gather_y" (n int32 offsets into K24's rows), "tiled", "deficit",
    "invp" (the inverse of the deficit's permutation, int32, or None)}."""
    map_x, map_y = _match_maps(n_x, n_y, perm, device)
    n = max(n_x, n_y)
    ar = torch.arange(n, device=device)
    e_x = map_x.long() if map_x is not None else ar
    e_y = order.to(device)[map_y.long() if map_y is not None else ar]
    plan = {"n": n, "gather_x": _conv_order_map(e_x, L, cfx),
            "gather_y": _conv_order_map(e_y, L, cfy), "tiled": n,
            "deficit": 0, "invp": None}
    if map_x is not None:
        tiled, deficit = match_plan(n_x, n_y)
        plan.update(tiled=tiled, deficit=deficit)
        if deficit:
            p = perm.to(device).long()
            invp = torch.empty_like(p)
            invp[p] = torch.arange(p.numel(), device=device)
            plan["invp"] = invp.to(torch.int32).contiguous()
    return plan


def invp_in_grad_order(invp, L, cfx):
    """K28's inverse permutation in the order of its gradient: within each
    tiling q, entry e = f L + l of x's conv order moved to K24's l cf + f
    (invp_t[q n_x + l cf + f] = invp[q n_x + f L + l]), int32."""
    return invp.view(-1, cfx, L).transpose(1, 2).contiguous().view(-1)


def swd_mask_sort_l1_plain(ox, oy, order, perm):
    """Plain version of K27 + K28: ox (P, L, cfx), oy (P, L, cfy) f32
    projection columns (K24's layout), order the mask order of y's conv-
    order entries, perm `swd_draws`' permutation.  Each projection's
    rows, x in conv order and y in mask order, matched, sorted (stable),
    mean |sx - sy|.  Returns (loss, gx (P, L, cfx))."""
    P, L, cf = ox.shape
    cols_x = ox.transpose(1, 2).reshape(P, -1)          # (cf, L) order
    cols_y = oy.transpose(1, 2).reshape(P, -1)[:, order.to(ox.device)]
    map_x, map_y = _match_maps(cols_x.shape[1], cols_y.shape[1], perm,
                               ox.device)
    loss, g = sort_l1_cols_plain(cols_x, cols_y, map_x, map_y)
    return loss, g.reshape(P, cf, L).transpose(1, 2).contiguous()


def swd_mask_sort(o, gather, payload):
    """K27: the P rows of o (P, L, cf) f32 read through gather (n int32
    offsets into a row), each sorted stably.  Returns (keys (P, n) int32
    holding the sorted order-preserving keys, payload (P, n) int32 of the
    matched indices in sorted order, or None)."""
    dev = o.device
    kernels.check_tensor("swd_mask_sort.o", o, dev, dtype=torch.float32)
    kernels.check_tensor("swd_mask_sort.gather", gather, dev,
                         dtype=torch.int32)
    P = o.shape[0]
    n = gather.shape[0]
    if n >= 2 ** 30:
        raise ValueError(f"swd_mask_sort: rows of {n} entries (< 2^30)")
    keys = torch.empty((P, n), dtype=torch.int32, device=dev)
    alt = torch.empty_like(keys)
    pay = torch.empty_like(keys) if payload else None
    pay_alt = torch.empty_like(keys) if payload else None
    lib = kernels.library()
    scratch = torch.empty(lib.vl3d_swd_mask_sort_scratch(P, n),
                          dtype=torch.uint8, device=dev)
    err = lib.vl3d_swd_mask_sort(
        o.data_ptr(), o[0].numel(), gather.data_ptr(), P, n, keys.data_ptr(),
        alt.data_ptr(), None if pay is None else pay.data_ptr(),
        None if pay_alt is None else pay_alt.data_ptr(), scratch.data_ptr(),
        kernels.stream_ptr(dev))
    kernels.LAUNCHES["swd_mask_sort"] += 1
    kernels.check_launch("swd_mask_sort", err)
    return keys, pay


# K28's routes (csrc/swd_mask.cu:l1_layout): a block a row, its sign bits
# in shared memory; the bits in device memory
MASK_L1_ROUTES = ("block", "global")
SWD_MASK_L1_LAYOUT_KEYS = ("route", "threads", "words", "smem", "blocks",
                           "scratch")
_L1_THREADS = 1024
# the bit words a block keeps in shared memory: the H100's 227 KB a block
# less the kernel's static shared memory
_L1_CAP_WORDS = (227 * 1024 - 1024) // 4
# the H100's SMs, and the fewest keys a block of the global route takes
_L1_FILL_BLOCKS = 132
_L1_CHUNK = 1024 * 4 * 4


def swd_mask_l1_layout(P, n):
    """K28's plan for P rows of n keys (csrc/swd_mask.cu:l1_layout): the
    `route` (a name of MASK_L1_ROUTES): one block a row where the row's n
    sign bits (`words` u32) fit one block's shared memory and the P rows
    reach every SM of the H100; else the bits in device memory
    (`scratch`: P rows of `words` u32) and blocks / P blocks a row, twice
    the SMs' count in all where the rows have chunks of 16,384 keys for
    them.  `threads` a block, `smem` its dynamic shared bytes, `blocks` in
    all.  Raises unless 0 < n < 2^30."""
    if not (P > 0 and 0 < n < 2 ** 30):
        raise ValueError(f"swd_mask_l1: {P} rows of {n} keys (n < 2^30)")
    words = -(-n // 32)
    if words <= _L1_CAP_WORDS and P >= _L1_FILL_BLOCKS:
        return dict(route="block", threads=_L1_THREADS, words=words,
                    smem=4 * words, blocks=P, scratch=0)
    per_row = min(-(-2 * _L1_FILL_BLOCKS // P), -(-n // _L1_CHUNK))
    return dict(route="global", threads=_L1_THREADS, words=words, smem=0,
                blocks=P * per_row, scratch=P * words)


def kernel_swd_mask_l1_layout(P, n):
    """K28's plan as csrc/swd_mask.cu computes it (vl3d_swd_mask_l1_layout;
    needs the CUDA library), keyed as `swd_mask_l1_layout`; None where the
    kernel refuses the shape."""
    out = (ctypes.c_longlong * len(SWD_MASK_L1_LAYOUT_KEYS))()
    if kernels.library().vl3d_swd_mask_l1_layout(P, n, out):
        return None
    lay = dict(zip(SWD_MASK_L1_LAYOUT_KEYS, out))
    lay["route"] = MASK_L1_ROUTES[lay["route"]]
    return lay


def _check_mask_l1(name, kx, ix, ky, L, cfx):
    """Raise unless K28 (or its first design) takes these rows; returns
    (P, n, n_x)."""
    dev = kx.device
    P, n = kx.shape
    for key, t in (("kx", kx), ("ix", ix), ("ky", ky)):
        kernels.check_tensor(f"{name}.{key}", t, dev, dtype=torch.int32,
                             shape=(P, n))
    return P, n, L * cfx


def swd_mask_l1(kx, ix, ky, plan, L, cfx):
    """K28: (loss () f32, gx (P, L, cfx) f32) from K27's sorted rows kx
    (with its payload ix) and ky under `swd_mask_plan`'s plan.  A block
    (or several, `swd_mask_l1_layout`) streams a row once, sums its |d| in
    double in a fixed order and keeps the signs as bits placed in gx's
    order; then each entry sums its copies' signs in increasing matched
    index, no atomics: the first design's gradient bit for bit
    (`first_designs.swd_mask_l1_first`), its loss within a near tie's 1
    ulp."""
    dev = kx.device
    P, n, n_x = _check_mask_l1("swd_mask_l1", kx, ix, ky, L, cfx)
    lay = swd_mask_l1_layout(P, n)
    count = np.float32(P * n)
    bits = torch.empty(lay["scratch"], dtype=torch.int32, device=dev) \
        if lay["scratch"] else None
    partial = torch.empty(lay["blocks"], dtype=torch.float64, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    gx = torch.empty((P, L, cfx), dtype=torch.float32, device=dev)
    invp = plan["invp"]
    invp_t = None if invp is None else invp_in_grad_order(invp, L, cfx)
    err = kernels.library().vl3d_swd_mask_l1(
        kx.data_ptr(), ky.data_ptr(), ix.data_ptr(), P, n, n_x, L, cfx,
        plan["tiled"], plan["deficit"],
        None if invp_t is None else invp_t.data_ptr(),
        float(np.float32(1.0) / count), float(count),
        None if bits is None else bits.data_ptr(), partial.data_ptr(),
        loss.data_ptr(), gx.data_ptr(), kernels.stream_ptr(dev))
    kernels.LAUNCHES["swd_mask_l1"] += 1
    kernels.check_launch("swd_mask_l1", err)
    return loss, gx


def swd_mask_sort_l1(ox, oy, order, perm):
    """The mask branch's sorted-row L1 and its gradient: K27 on x's row
    (with the payload) and on y's, then K28 (`swd_mask_sort_l1_plain` on
    CPU tensors).  Arguments and results as the plain version's."""
    dev = ox.device
    kernels.check_tensor("swd_mask_sort_l1.ox", ox, dev, dtype=torch.float32)
    kernels.check_tensor("swd_mask_sort_l1.oy", oy, dev, dtype=torch.float32,
                         shape=ox.shape[:2] + (oy.shape[2],))
    if dev.type == "cpu":
        return swd_mask_sort_l1_plain(ox, oy, order, perm)
    P, L, cfx = ox.shape
    plan = swd_mask_plan(L * cfx, int(order.numel()), order, perm, L, cfx,
                         oy.shape[2], dev)
    kx, ix = swd_mask_sort(ox, plan["gather_x"], True)            # K27
    ky, _ = swd_mask_sort(oy, plan["gather_y"], False)            # K27
    return swd_mask_l1(kx, ix, ky, plan, L, cfx)                  # K28


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

class _SwdLoss(torch.autograd.Function):
    """loss = mean |sort(K24(2x - 1)) - sort(K24(2y - 1))| over the matched
    columns (K25); backward: K26 of K25's gradient, times the incoming
    gradient.  With `order` (the mask branch) each projection is one row
    over all its patches, y's patches taken in that order (K27, K28)."""

    @staticmethod
    def forward(ctx, x, y, rand, perm, psz, strides, order):
        vx = (x.detach().float() * 2 - 1).contiguous()
        vy = (y.detach().float() * 2 - 1).contiguous()
        if order is None:
            ox = swd_project(vx, rand, psz, strides)
            oy = swd_project(vy, rand, psz, strides)
            map_x, map_y = _match_maps(ox.shape[2], oy.shape[2], perm,
                                       ox.device)
            loss, gx = swd_sort_l1(ox, oy, map_x, map_y)
        else:
            ox = swd_project(vx, rand, psz, strides)
            oy = swd_project(vy, rand, psz, strides)
            loss, gx = swd_mask_sort_l1(ox, oy, order, perm)   # K27, K28
        ctx.save_for_backward(gx, rand)
        ctx.geom = (tuple(x.shape), psz, strides)
        return loss

    @staticmethod
    def backward(ctx, grad):
        gx, rand = ctx.saved_tensors
        shape, psz, strides = ctx.geom
        g = swd_project_grad(gx, rand, shape, psz, strides)
        return g * grad, None, None, None, None, None, None


def swd_3d_loss(x, y, *, draws, patch_size=7, patcht_size=7, stride=1,
                stridet=1, num_proj=256, mask=None, mask_patches_factor=1,
                **_):
    """x, y (C, T, H, W) in [0, 1]; gradients flow into x only.  draws:
    `swd_draws`' {"rand", "perm"}.  mask (host numpy (T, H, W) or (H, W),
    optional): y's patches touching it are duplicated mask_patches_factor
    times before the sort over all patches of a projection (K27, K28)."""
    if y.requires_grad:
        raise ValueError("swd_3d_loss: y is the target; it takes no "
                         "gradient")
    rand = draws["rand"]
    if tuple(rand.shape) != (num_proj, x.shape[0], patcht_size, patch_size,
                             patch_size):
        raise ValueError(f"swd_3d_loss: projections {tuple(rand.shape)} do "
                         f"not match num_proj {num_proj} and the patch")
    rand = normalized_projections(rand.to(x.device))
    psz = (patcht_size, patch_size, patch_size)
    strides = (stridet, stride, stride)
    order = None
    if mask is not None:
        sel = mask_patch_columns(mask, patch_size, patcht_size, stride,
                                 stridet, n_frames=y.shape[1])
        cf, ch, cw = _grid(y.shape, psz, strides)
        if sel.shape[0] != cf * ch * cw:
            raise ValueError(f"swd_3d_loss: mask grid {sel.shape[0]} != "
                             f"{cf * ch * cw} patches of y")
        order = torch.from_numpy(np.concatenate(
            [np.nonzero(~sel)[0]]
            + [np.nonzero(sel)[0]] * mask_patches_factor))
    perm = draws.get("perm")
    return _SwdLoss.apply(x, y, rand, perm, psz, strides, order)
