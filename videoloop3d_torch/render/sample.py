"""Bilinear gathers from plane and tile textures (counterpart of
``videoloop3d_tpu/render/sample.py`` and of the samplers of
``videoloop3d_tpu/render/adjoint.py``).

Eleven kernels live here, each beside its plain PyTorch version:

* K2 `bilinear_tiles` — packed (N, th, tw, C) tiles (``csrc/bilinear_tiles.cu``):
  one thread a sample at C = 4; at other C a block finds a run of
  samples' corners once and sweeps its outputs in output order
  (`bilinear_tiles_layout`);
* K9 `bilinear_tiles_grad` — K2's gradient into the packed tiles: at
  C = 4 one 128-bit atomic a corner (``csrc/bilinear_tiles.cu``), at other
  C K10's deterministic binned gather at F = 1
  (``csrc/bilinear_tiles_tilemajor.cu``, `static_grad_layout`); under a
  bf16 gather dtype K2 rounds each f32 texel to bf16 and K9 each f32 sum
  (a rounding pass at C = 4, inside the gather otherwise), where the JAX
  package casts the static atlas;
* K3 `bilinear_tiles_tilemajor` — tile-major frame-stacked (N, th, tw, F, C)
  tiles, read at a frame subset ``ts`` (``csrc/bilinear_tiles_tilemajor.cu``):
  one thread a (sample, frame) at C = 4; at other C a block finds a run of
  samples' corners once and sweeps their F x C outputs in output order
  (`tiles_tilemajor_layout`);
* K10 `bilinear_tiles_tilemajor_grad` — K3's gradient (all frames) into
  the tile-major tiles (``csrc/bilinear_tiles_tilemajor.cu``): the
  samples binned by tile with K17's stable sort, one gather a (tile, slice
  of the F x C row) that writes every texel once (`tiles_grad_layout`),
  deterministic; under a bf16 gather dtype K3 rounds each f32 texel and
  K10 each f32 gradient sum to bf16 inside the kernels, where the JAX
  package casts the dynamic atlas;
* K5/K6 `sample_dense` — the dense stage-1 plane sampler and its atlas
  gradient (``csrc/sample_dense.cu``), a `torch.autograd.Function`, at
  any channel count C (one float4 per texel at the direct decoder's
  C = 4; otherwise K5 finds a block's corners once per sample and sweeps
  its (sample, channel) outputs in output order);
* K16 `bilinear_planes_tilemajor` — the dense stage-2 sampler of the
  frame-stacked (D, Ht, Wt, F, C) planes, read at a frame subset ``ts``,
  and K17 `bilinear_planes_tilemajor_grad`, its gradient over all frames
  (``csrc/bilinear_planes_tilemajor.cu``); `sample_planes_tilemajor` is
  their `torch.autograd.Function` on the f32 stack at a gather dtype:
  under bf16 K16 rounds each texel and K17 each f32 gradient sum to bf16
  inside the kernel, where the JAX package casts the stack (no copy or
  cast of the stack here).  K17 bins the samples by texel tile and
  writes every texel once (`planes_grad_layout`), deterministic.
  Corners outside the plane read zero, as in K5;
* K22 `sample_dense_coord_grad` and K23 `bilinear_tiles_coord_grad` — the
  gradients of K5's and K2's samples with respect to their coordinates
  (``--optimize_geo_start``: the vertex warp trains through them; JAX
  takes them by autodiff of `bilinear_planes` and `bilinear_tiles`).
  They launch only when the coordinates require grad, so the routes
  without the vertex warp launch what they did.  K22 at C != 4 stages a
  warp's cotangents and terms in shared memory, each sample's channels
  then summed in order (`dense_coord_grad_layout`).  K23 writes every
  sample (no fill), at C = 4 with vector loads.

`sample_tiles` is the `torch.autograd.Function` of K2/K9 (4-D tiles) and
of K3/K10 (5-D tiles), on samples of any layout: the (D, h, w) plane
sweep or the (S, h, w) hit-compacted slots of ``render/compact.py``
(``--compact_hits``; the counterpart of the JAX package's
``adjoint.py:make_tile_adjoint_compacted``, whose backward expands the
slot cotangent to the plane layout first: K9/K10 scatter straight from
the slots, the same gradient, with nothing for dropped planes).  Its
gradient is accumulated in f32 and rounded once to the gather dtype, as
the JAX package's per-tile adjoint does
(``adjoint.py:_packed_tile_grad``, ``.astype(tiles_dtype)``); under
``--fp16`` that is one rounding to bf16, with both atlases read in f32:
each texel rounded inside K2 and K3, each gradient sum in K9 (its
rounding pass at C = 4, inside its gather otherwise) and inside K10.

`sample_dense` has the semantics of the JAX package's `bilinear_planes`
(its plain version here is `bilinear_planes_plain`): align-corners
coordinates, every corner outside the plane read as zero, no clamping of
the coordinates themselves.  The packed-tile samplers below clamp instead.

Semantics are the JAX package's: align-corners texel coordinates,
u, v clamped to the tile, the +1 corners clamped to the tile (where the
TPU version reads a neighbouring texel with weight exactly 0), zeros
where the tile index is < 0, bf16 texels widened to f32 and lerped in
f32, f32 output.  Samples with k < 0 read nothing, so their (possibly
non-finite) coordinates never index memory.

A wrapper runs the plain version for CPU tensors and launches the kernel
for CUDA tensors; nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from videoloop3d_torch import kernels

_TEXEL_DTYPES = (torch.float32, torch.bfloat16)


def _corners(tile_idx, u, v, th, tw):
    """Clamped integer corners and fractions (shared by both plain
    versions).  Invalid samples (k < 0) are pointed at texel (0, 0)."""
    valid = tile_idx >= 0
    k = tile_idx.clamp(min=0).long()
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    u = torch.where(valid, u.clamp(0.0, tw - 1.0), zero)
    v = torch.where(valid, v.clamp(0.0, th - 1.0), zero)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu, fv = u - u0, v - v0
    u0i, v0i = u0.long(), v0.long()
    u1i = (u0i + 1).clamp(max=tw - 1)
    v1i = (v0i + 1).clamp(max=th - 1)
    return valid, k, u0i, u1i, v0i, v1i, fu, fv


def _lerp(a, b, f):
    return a * (1 - f) + b * f


def bilinear_tiles_plain(tiles, tile_idx, u, v, gather_dtype=None):
    """Plain version of K2.  tiles (N, th, tw, C); tile_idx, u, v (...);
    the texels first cast to gather_dtype (None: as they are).  Returns
    (values (..., C) f32 (f64 for f64 tiles), valid (...) bool)."""
    if gather_dtype is not None:
        tiles = tiles.to(gather_dtype)
    N, th, tw, C = tiles.shape
    dtype = torch.promote_types(tiles.dtype, torch.float32)
    if N == 0:
        return (torch.zeros(tile_idx.shape + (C,), dtype=dtype,
                            device=tiles.device), tile_idx >= 0)
    valid, k, u0i, u1i, v0i, v1i, fu, fv = _corners(tile_idx, u, v, th, tw)
    fu, fv = fu[..., None], fv[..., None]

    def tex(vi, ui):
        return tiles[k, vi, ui].to(dtype)

    top = _lerp(tex(v0i, u0i), tex(v0i, u1i), fu)
    bot = _lerp(tex(v1i, u0i), tex(v1i, u1i), fu)
    values = _lerp(top, bot, fv)
    return torch.where(valid[..., None], values, 0.0), valid


def bilinear_tiles_tilemajor_plain(tiles, tile_idx, u, v, ts=None,
                                   gather_dtype=None):
    """Plain version of K3.  tiles (N, th, tw, F_all, C); ts (F_sel,)
    int frame indices or None for all frames; the texels first cast to
    gather_dtype (None: as they are; the ``astype(gather_dtype)`` of the
    JAX ``models/mpv.py``).  Returns (values (..., F_sel, C) f32, valid
    (...) bool)."""
    if ts is not None:
        tiles = tiles.index_select(3, ts.long())
    if gather_dtype is not None:
        tiles = tiles.to(gather_dtype)
    N, th, tw, F, C = tiles.shape
    if N == 0:
        return (torch.zeros(tile_idx.shape + (F, C), dtype=torch.float32,
                            device=tiles.device), tile_idx >= 0)
    valid, k, u0i, u1i, v0i, v1i, fu, fv = _corners(tile_idx, u, v, th, tw)
    fu, fv = fu[..., None, None], fv[..., None, None]

    def tex(vi, ui):
        return tiles[k, vi, ui].float()

    top = _lerp(tex(v0i, u0i), tex(v0i, u1i), fu)
    bot = _lerp(tex(v1i, u0i), tex(v1i, u1i), fu)
    values = _lerp(top, bot, fv)
    return torch.where(valid[..., None, None], values, 0.0), valid


def _check_samples(name, tiles, tile_idx, u, v):
    dev = tiles.device
    kernels.check_tensor(f"{name}.tiles", tiles, dev, dtype=_TEXEL_DTYPES)
    kernels.check_tensor(f"{name}.tile_idx", tile_idx, dev,
                         dtype=torch.int32)
    kernels.check_tensor(f"{name}.u", u, dev, dtype=torch.float32,
                         shape=tile_idx.shape)
    kernels.check_tensor(f"{name}.v", v, dev, dtype=torch.float32,
                         shape=tile_idx.shape)


# K2 at C != 4 (csrc/bilinear_tiles.cu:bilinear_tiles_sweep_kernel): a
# block's threads, the largest channel count, and the layout's keys
SWEEP_THREADS = 256
SWEEP_MAX_C = 1024
BILINEAR_TILES_LAYOUT_KEYS = ("samples", "blocks", "threads", "smem")


def bilinear_tiles_layout(n, C):
    """K2's layout at C != 4 for n samples of C channels
    (csrc/bilinear_tiles.cu:sweep_layout): `samples` a block, 256 x
    ceil(4 / C) (a multiple of 4, and at least one float4 of outputs a
    thread); `blocks`; `threads` a block; `smem`, the block's dynamic
    shared bytes (each sample's four corner offsets, int4, and fu, fv,
    float2).  Raises beyond its limits: 1 <= C <= 1,024, n >= 0, at most
    2^31 - 1 blocks."""
    if not 1 <= C <= SWEEP_MAX_C or n < 0:
        raise ValueError(f"bilinear_tiles_layout: C = {C} (1 to "
                         f"{SWEEP_MAX_C}), n = {n}")
    samples = SWEEP_THREADS * -(-4 // C)
    blocks = -(-n // samples)
    if blocks > 2 ** 31 - 1:
        raise ValueError(f"bilinear_tiles_layout: {n} samples need "
                         f"{blocks} blocks")
    return dict(samples=samples, blocks=blocks, threads=SWEEP_THREADS,
                smem=samples * (16 + 8))


def kernel_bilinear_tiles_layout(n, C):
    """K2's layout at C != 4 as csrc/bilinear_tiles.cu computes it
    (vl3d_bilinear_tiles_layout; needs the CUDA library), keyed as
    `bilinear_tiles_layout`; None where the kernel refuses it."""
    out = (ctypes.c_longlong * len(BILINEAR_TILES_LAYOUT_KEYS))()
    if kernels.library().vl3d_bilinear_tiles_layout(n, C, out):
        return None
    return dict(zip(BILINEAR_TILES_LAYOUT_KEYS, out))


# K3 at C != 4 (csrc/bilinear_tiles_tilemajor.cu:
# bilinear_tiles_tilemajor_sweep_kernel): the outputs a block takes at
# least, its samples at most, its shared-memory limit (no opt-in), and
# the layout's keys
TILEMAJOR_BLOCK_OUTPUTS = 32 * 4 * SWEEP_THREADS
TILEMAJOR_MAX_SAMPLES = 1024
TILEMAJOR_SMEM_LIMIT = 48 * 1024
TILES_TILEMAJOR_LAYOUT_KEYS = BILINEAR_TILES_LAYOUT_KEYS


def tiles_tilemajor_layout(n, F_sel, C):
    """K3's layout at C != 4 for n samples of F_sel x C outputs
    (csrc/bilinear_tiles_tilemajor.cu:tilemajor_layout): `samples` a
    block, the least multiple of 4 whose F_sel x C outputs reach
    `TILEMAJOR_BLOCK_OUTPUTS` (32 sweeps of 4 outputs a thread), at most
    1,024; `blocks`; `threads` a block; `smem`, the block's dynamic shared
    bytes (each sample's four corner offsets, int4, and fu, fv, float2;
    then F_sel frame offsets, int).  Raises beyond its limits: 1 <= C <=
    1,024, F_sel >= 1 (up to what 48 KB of shared memory holds), n >= 0,
    at most 2^31 - 1 blocks."""
    if not 1 <= C <= SWEEP_MAX_C or F_sel < 1 or n < 0:
        raise ValueError(f"tiles_tilemajor_layout: C = {C} (1 to "
                         f"{SWEEP_MAX_C}), F_sel = {F_sel}, n = {n}")
    row = F_sel * C
    samples = min(4 * -(-TILEMAJOR_BLOCK_OUTPUTS // (4 * row)),
                  TILEMAJOR_MAX_SAMPLES)
    blocks = -(-n // samples)
    smem = samples * (16 + 8) + 4 * F_sel
    if blocks > 2 ** 31 - 1 or smem > TILEMAJOR_SMEM_LIMIT:
        raise ValueError(f"tiles_tilemajor_layout: {n} samples of {F_sel} "
                         f"frames need {blocks} blocks and {smem} shared "
                         f"bytes (limits 2^31 - 1, {TILEMAJOR_SMEM_LIMIT})")
    return dict(samples=samples, blocks=blocks, threads=SWEEP_THREADS,
                smem=smem)


def kernel_tiles_tilemajor_layout(n, F_sel, C):
    """K3's layout at C != 4 as csrc/bilinear_tiles_tilemajor.cu computes
    it (vl3d_bilinear_tiles_tilemajor_layout; needs the CUDA library),
    keyed as `tiles_tilemajor_layout`; None where the kernel refuses it."""
    out = (ctypes.c_longlong * len(TILES_TILEMAJOR_LAYOUT_KEYS))()
    if kernels.library().vl3d_bilinear_tiles_tilemajor_layout(n, F_sel, C,
                                                              out):
        return None
    return dict(zip(TILES_TILEMAJOR_LAYOUT_KEYS, out))


def bilinear_tiles(tiles, tile_idx, u, v, gather_dtype=None):
    """K2: sample packed tiles.  tiles (N, th, tw, C) f32/bf16; tile_idx
    (...) int32 in [-1, N); u, v (...) f32 texel coordinates in the tile.
    With f32 tiles and a bf16 gather_dtype each texel is rounded to bf16
    in registers (bit for bit the samples of ``tiles.to(torch.bfloat16)``;
    no copy is made).  At C = 4 one thread a sample; at other C a block
    finds a run of samples' corners once and sweeps its outputs in output
    order (`bilinear_tiles_layout`; tiles of fewer than 2^31 elements),
    the same bits.  Returns (values (..., C) f32, valid (...) bool =
    tile_idx >= 0)."""
    _check_samples("bilinear_tiles", tiles, tile_idx, u, v)
    gather_dtype = tiles.dtype if gather_dtype is None else gather_dtype
    _check_gather_dtype("bilinear_tiles", gather_dtype)
    if tiles.device.type == "cpu":
        return bilinear_tiles_plain(tiles, tile_idx, u, v, gather_dtype)
    N, th, tw, C = tiles.shape
    if C != 4:
        bilinear_tiles_layout(tile_idx.numel(), C)
        if tiles.numel() >= 2 ** 31:
            raise ValueError(f"bilinear_tiles: {tiles.numel()} texel "
                             "elements at C != 4 (32-bit offsets)")
    if N == 0:
        return (torch.zeros(tile_idx.shape + (C,), dtype=torch.float32,
                            device=tiles.device), tile_idx >= 0)
    out = launch_tiles("vl3d_bilinear_tiles", tiles, tile_idx, u, v,
                       gather_dtype)
    kernels.LAUNCHES["bilinear_tiles"] += 1
    return out


def launch_tiles(entry, tiles, tile_idx, u, v, gather_dtype):
    """Call the library's `entry` (vl3d_bilinear_tiles or its first
    design) on checked CUDA inputs with N > 0.  Returns (values, valid)."""
    N, th, tw, C = tiles.shape
    out = torch.empty(tile_idx.shape + (C,), dtype=torch.float32,
                      device=tiles.device)
    bf16 = tiles.dtype == torch.bfloat16
    err = getattr(kernels.library(), entry)(
        tiles.data_ptr(), int(bf16),
        int(not bf16 and gather_dtype == torch.bfloat16),
        tile_idx.data_ptr(), u.data_ptr(), v.data_ptr(), tile_idx.numel(),
        N, th, tw, C, out.data_ptr(), kernels.stream_ptr(tiles.device))
    kernels.check_launch(entry, err)
    return out, tile_idx >= 0


def bilinear_tiles_grad_plain(ct, tile_idx, u, v, tiles_shape,
                              gather_dtype=None):
    """Plain version of K9: the gradient of `bilinear_tiles_plain` with
    respect to tiles of tiles_shape (N, th, tw, C) for the cotangent ct
    (..., C), as a direct scatter (``index_add_``) of each valid sample's
    four corner weights; with a bf16 gather_dtype each sum is rounded to
    bf16 (and widened back).  Returns the gradient in ct's dtype."""
    N, th, tw, C = tiles_shape
    grad = torch.zeros((N * th * tw, C), dtype=ct.dtype, device=ct.device)
    if N == 0:
        return grad.view(tiles_shape)
    valid, k, u0i, u1i, v0i, v1i, fu, fv = _corners(tile_idx, u, v, th, tw)
    sel = valid.reshape(-1)
    ct = ct.reshape(-1, C)[sel]
    k, u0i, u1i, v0i, v1i = (t.reshape(-1)[sel]
                             for t in (k, u0i, u1i, v0i, v1i))
    fu = fu.reshape(-1)[sel].to(ct.dtype)
    fv = fv.reshape(-1)[sel].to(ct.dtype)
    for vi, wv in ((v0i, 1 - fv), (v1i, fv)):
        for ui, wu in ((u0i, 1 - fu), (u1i, fu)):
            grad.index_add_(0, (k * th + vi) * tw + ui,
                            ct * (wv * wu)[:, None])
    if gather_dtype == torch.bfloat16:
        grad = grad.to(torch.bfloat16).to(ct.dtype)
    return grad.view(tiles_shape)


def _check_grad(name, ct, tile_idx, u, v, tail):
    dev = ct.device
    kernels.check_tensor(f"{name}.tile_idx", tile_idx, dev, dtype=torch.int32)
    kernels.check_tensor(f"{name}.ct", ct, dev, dtype=torch.float32,
                         shape=tile_idx.shape + tuple(tail))
    for key, t in (("u", u), ("v", v)):
        kernels.check_tensor(f"{name}.{key}", t, dev, dtype=torch.float32,
                             shape=tile_idx.shape)


def bilinear_tiles_grad(ct, tile_idx, u, v, tiles_shape, gather_dtype=None):
    """K9: the gradient of `bilinear_tiles` with respect to tiles of
    tiles_shape (N, th, tw, C) for the f32 cotangent ct (..., C).  Samples
    with tile_idx < 0 add nothing.  At C = 4 the kernel zero-fills the
    gradient, then each corner adds its 4 products with one vector
    atomic; with a bf16 gather_dtype each f32 sum of the tiles that
    samples read is then rounded to bf16 and stored widened, in place
    (the gradient of the f32 atlas through ``.to(torch.bfloat16)``; the
    other tiles are zeros).  At other C the samples are binned by tile
    and each tile with samples gathered once (`static_grad_layout`),
    every texel written once in a fixed order, rounded to bf16 inside the
    gather under a bf16 gather_dtype: the same bits on every call.
    Returns a (N, th, tw, C) f32 tensor (accumulated in f32 whatever the
    tiles' dtype)."""
    N, th, tw, C = tiles_shape
    _check_grad("bilinear_tiles_grad", ct, tile_idx, u, v, (C,))
    gather_dtype = torch.float32 if gather_dtype is None else gather_dtype
    _check_gather_dtype("bilinear_tiles_grad", gather_dtype)
    dev = ct.device
    if dev.type == "cpu":
        return bilinear_tiles_grad_plain(ct, tile_idx, u, v, tiles_shape,
                                         gather_dtype)
    if N == 0:
        return torch.zeros(tiles_shape, dtype=torch.float32, device=dev)
    grad = torch.empty(tiles_shape, dtype=torch.float32, device=dev)
    rnd = gather_dtype == torch.bfloat16
    if C == 4:
        flags = torch.empty(N, dtype=torch.uint8, device=dev) if rnd \
            else None
        err = kernels.library().vl3d_bilinear_tiles_grad(
            ct.data_ptr(), tile_idx.data_ptr(), u.data_ptr(), v.data_ptr(),
            tile_idx.numel(), N, th, tw, C, _vec_width(C, ct, grad),
            int(rnd), None if flags is None else flags.data_ptr(),
            grad.data_ptr(), kernels.stream_ptr(dev))
    else:
        D = tiles_grad_planes(tile_idx.shape)
        n = tile_idx.numel() // D
        vec = _vec_width(C, ct)
        lay = static_grad_layout(D, n, N, th, tw, C, vec)
        if lay["smem"] > _SMEM_LIMIT or n >= _I32 or lay["nk1"] >= _I32:
            raise ValueError(
                f"bilinear_tiles_grad: {lay['smem']} B of shared memory a "
                f"block (limit {_SMEM_LIMIT}), {n} samples a plane and "
                f"{lay['nk1']} keys (limit 2^31 each)")
        scratch = torch.empty(lay["scratch"], dtype=torch.uint8, device=dev)
        err = kernels.library().vl3d_bilinear_tiles_grad_gather(
            ct.data_ptr(), tile_idx.data_ptr(), u.data_ptr(), v.data_ptr(),
            D, n, N, th, tw, C, vec, int(rnd), scratch.data_ptr(),
            lay["scratch"], grad.data_ptr(), kernels.stream_ptr(dev))
    kernels.LAUNCHES["bilinear_tiles_grad"] += 1
    kernels.check_launch("bilinear_tiles_grad", err)
    return grad


def round_bf16_(t, flags=None):
    """K9's rounding pass on its own: each value of the contiguous f32
    CUDA tensor t (N, ...) rounded to bf16 (to nearest even) and widened,
    in place; with flags (N,) uint8 only the rows whose flag is set (for
    the card's checks against ``.to(torch.bfloat16).float()``; adds to no
    launch count).  Returns t."""
    kernels.check_tensor("round_bf16_", t, t.device, dtype=torch.float32)
    if flags is not None:
        kernels.check_tensor("round_bf16_.flags", flags, t.device,
                             dtype=torch.uint8, shape=t.shape[:1])
    err = kernels.library().vl3d_round_bf16(
        t.data_ptr(), t.numel(), None if flags is None else flags.data_ptr(),
        t[0].numel() if t.dim() else 1, kernels.stream_ptr(t.device))
    kernels.check_launch("round_bf16_", err)
    return t


def _clip_grad(u, hi):
    """d clip(u, 0, hi) / du as ``jax.grad`` gives it: 1 inside, 0.5 at
    exactly 0 and hi (``jnp.clip``'s maximum and minimum split a tie), 0
    outside."""
    half = torch.full_like(u, 0.5)
    inside = ((u > 0) & (u < hi)).to(u.dtype)
    return torch.where((u == 0) | (u == hi), half, inside)


def bilinear_tiles_coord_grad_plain(ct, tiles, tile_idx, u, v):
    """Plain version of K23: the gradient of sum(ct * bilinear_tiles(tiles,
    tile_idx, u, v)) with respect to u and v, as JAX's autodiff of its
    quad-packed `bilinear_tiles` gives it: the clip's 0.5 at the tile
    edges, and corners read at the flat texel indices r, r+1, r+tw,
    r+tw+1 of the packed tiles (zero past the end), so at u = tw-1 the +1
    corner is the next row's first texel.  Returns (g_u, g_v) f32, zero
    where tile_idx < 0."""
    N, th, tw, C = tiles.shape
    valid = tile_idx >= 0
    if N == 0:
        zero = torch.zeros(tile_idx.shape, dtype=ct.dtype, device=ct.device)
        return zero, zero.clone()
    k = tile_idx.clamp(0, N - 1).long()
    uu, vv = u.clamp(0.0, tw - 1.0), v.clamp(0.0, th - 1.0)
    u0, v0 = torch.floor(uu), torch.floor(vv)
    fu, fv = (uu - u0)[..., None], (vv - v0)[..., None]
    r = (k * th + v0.long()) * tw + u0.long()
    flat = torch.cat([tiles.reshape(N * th * tw, C).float(),
                      tiles.new_zeros((tw + 1, C), dtype=torch.float32)])
    t00, t01, t10, t11 = (flat[r + off] for off in (0, 1, tw, tw + 1))
    g_fu = (ct * ((1 - fv) * (t01 - t00) + fv * (t11 - t10))).sum(-1)
    g_fv = (ct * ((1 - fu) * (t10 - t00) + fu * (t11 - t01))).sum(-1)
    g_u = torch.where(valid, _clip_grad(u, tw - 1.0) * g_fu, 0.0)
    g_v = torch.where(valid, _clip_grad(v, th - 1.0) * g_fv, 0.0)
    return g_u, g_v


def bilinear_tiles_coord_grad(ct, tiles, tile_idx, u, v):
    """K23: the gradient of `bilinear_tiles` with respect to u and v for
    the f32 cotangent ct (..., C) of its values, on packed (N, th, tw, C)
    f32 or bf16 tiles (semantics of `bilinear_tiles_coord_grad_plain`,
    which runs on CPU tensors).  The kernel writes every sample, zeros
    where tile_idx < 0, so nothing is filled first; at C = 4 a hit's
    corners and cotangent row are read as vectors, bit for bit the first
    design's sums.  Returns (g_u, g_v) (...) f32."""
    _check_samples("bilinear_tiles_coord_grad", tiles, tile_idx, u, v)
    N, th, tw, C = tiles.shape
    dev = tiles.device
    kernels.check_tensor("bilinear_tiles_coord_grad.ct", ct, dev,
                         dtype=torch.float32, shape=tile_idx.shape + (C,))
    if dev.type == "cpu":
        return bilinear_tiles_coord_grad_plain(ct, tiles, tile_idx, u, v)
    if N == 0:
        zero = torch.zeros(tile_idx.shape, dtype=torch.float32, device=dev)
        return zero, zero.clone()
    g_u = torch.empty(tile_idx.shape, dtype=torch.float32, device=dev)
    g_v = torch.empty(tile_idx.shape, dtype=torch.float32, device=dev)
    launch_coord_grad("vl3d_bilinear_tiles_coord_grad", ct, tiles, tile_idx,
                      u, v, g_u, g_v)
    kernels.LAUNCHES["bilinear_tiles_coord_grad"] += 1
    return g_u, g_v


def launch_coord_grad(entry, ct, tiles, tile_idx, u, v, g_u, g_v):
    """Call the library's `entry` (vl3d_bilinear_tiles_coord_grad or its
    first design) on checked CUDA inputs with N > 0, into g_u, g_v."""
    N, th, tw, C = tiles.shape
    err = getattr(kernels.library(), entry)(
        tiles.data_ptr(), int(tiles.dtype == torch.bfloat16), ct.data_ptr(),
        tile_idx.data_ptr(), u.data_ptr(), v.data_ptr(), tile_idx.numel(),
        N, th, tw, C, g_u.data_ptr(), g_v.data_ptr(),
        kernels.stream_ptr(tiles.device))
    kernels.check_launch(entry, err)


def bilinear_tiles_tilemajor_grad_plain(ct, tile_idx, u, v, tiles_shape,
                                        gather_dtype=None):
    """Plain version of K10: the gradient of
    `bilinear_tiles_tilemajor_plain` (all frames) with respect to tiles of
    tiles_shape (N, th, tw, F, C) for the cotangent ct (..., F, C): K9's
    plain scatter with one (F * C)-wide row per texel; with a bf16
    gather_dtype each sum is rounded to bf16 (and widened back)."""
    N, th, tw, F, C = tiles_shape
    flat = bilinear_tiles_grad_plain(ct.reshape(tile_idx.shape + (F * C,)),
                                     tile_idx, u, v, (N, th, tw, F * C))
    if gather_dtype == torch.bfloat16:
        flat = flat.to(torch.bfloat16).to(ct.dtype)
    return flat.view(tiles_shape)


# K10's gather, mirrored by csrc/bilinear_tiles_tilemajor.cu:tiles_grad_layout
_TG_GROUPS = 4                 # texel (row, column) parities
_TG_MAX_COLS = 32              # vectors of a slice
_TG_ACC_BUDGET = 65536         # accumulator bytes a block
_TG_BATCH = 64                 # samples decoded and staged at a time
TG_MAX_PLANES = 128            # sort planes (the samples' leading index)


def tiles_grad_planes(shape):
    """The planes K10 sorts its samples in for tile indices of `shape`:
    the leading index (the slots or planes of an (S, h, w) sweep) where
    there is one of at most TG_MAX_PLANES, else one plane of all
    samples."""
    return shape[0] if len(shape) > 1 and 0 < shape[0] <= TG_MAX_PLANES \
        else 1


def tiles_grad_layout(D, n, N, th, tw, F, C, vec):
    """K10's layout for D planes of n samples and (N, th, tw, F, C) tiles,
    vec floats a column (4, 2 or 1), as a dict: nk1 keys (the N tiles and
    the sentinel of samples with k < 0); `passes` 8-bit digits of the
    sentinel; `ntiles` sort blocks of _SORT_TILE samples a plane; the F x C
    row as `ncols` vectors in `nslices` slices of `slice_cols` (as many as
    keep a tile's accumulators of a slice within _TG_ACC_BUDGET bytes, at
    most _TG_MAX_COLS); `threads` a block, one per (texel parity class,
    column) rounded to warps; a block's dynamic shared bytes `smem` (a
    batch of _TG_BATCH decoded samples: index; the tile's accumulators;
    the batch's cotangent rows of the slice; its four texel slots and four
    weights; each plane's range start and running start); the `scratch`
    bytes (keys and payloads twice, the digit counts, the key offsets,
    each 256-byte aligned; then each tile's number of samples, the number
    of tiles with samples and their list)."""
    ncols = F * C // vec
    col_bytes = 4 * th * tw * vec
    max_cols = min(max(_TG_ACC_BUDGET // col_bytes, 1), _TG_MAX_COLS)
    nslices = -(-ncols // max_cols)
    slice_cols = -(-ncols // nslices) if nslices else 0
    threads = max(-(-(_TG_GROUPS * slice_cols) // 32) * 32, 32)
    b = (8 * _TG_BATCH + -(-col_bytes * slice_cols // 16) * 16
         + 4 * _TG_BATCH * slice_cols * vec + 32 * _TG_BATCH + 4 * (2 * D + 1))
    ntiles = -(-n // _SORT_TILE)
    nk1 = N + 1
    return dict(
        nk1=nk1, passes=-(-max(N.bit_length(), 1) // 8), ntiles=ntiles,
        ncols=ncols, nslices=nslices, slice_cols=slice_cols, threads=threads,
        smem=-(-b // 16) * 16,
        scratch=4 * _align256(D * n * 4) + _align256(D * 256 * ntiles * 4)
        + _align256(D * nk1 * 4) + _align256(4 * (2 * N + 1)))


# the keys of tiles_grad_layout, in the order vl3d_tiles_grad_layout
# returns them
TILES_GRAD_LAYOUT_KEYS = ("nk1", "passes", "ntiles", "ncols", "nslices",
                          "slice_cols", "threads", "smem", "scratch")

# K9's gather at C != 4, mirrored by
# csrc/bilinear_tiles_tilemajor.cu:static_grad_layout
STATIC_GRAD_LAYOUT_KEYS = TILES_GRAD_LAYOUT_KEYS + ("zero_vec",)


def static_grad_layout(D, n, N, th, tw, C, vec):
    """K9's layout at C != 4: `tiles_grad_layout` at F = 1 (the packed
    (N, th, tw, C) tiles have the tile-major layout of one frame), a
    block's shared memory grown by a batch's class masks (_TG_BATCH
    ints: which corners of each sample fall in each parity class), and
    `zero_vec` floats a store of the empty tiles' zero fill (4 where a
    tile's th tw C floats allow, else vec)."""
    lay = tiles_grad_layout(D, n, N, th, tw, 1, C, vec)
    lay["smem"] += 4 * _TG_BATCH
    lay["zero_vec"] = 4 if th * tw * C % 4 == 0 else vec
    return lay


def kernel_static_grad_layout(D, n, N, th, tw, C, vec):
    """K9's layout at C != 4 as csrc/bilinear_tiles_tilemajor.cu computes
    it (vl3d_static_grad_layout; needs the CUDA library), keyed as
    `static_grad_layout`."""
    out = (ctypes.c_longlong * len(STATIC_GRAD_LAYOUT_KEYS))()
    kernels.library().vl3d_static_grad_layout(D, n, N, th, tw, C, vec, out)
    return dict(zip(STATIC_GRAD_LAYOUT_KEYS, out))


def kernel_tiles_grad_layout(D, n, N, th, tw, F, C, vec):
    """K10's layout as csrc/bilinear_tiles_tilemajor.cu computes it
    (vl3d_tiles_grad_layout; needs the CUDA library), keyed as
    `tiles_grad_layout`, for the checks that the two agree."""
    out = (ctypes.c_longlong * len(TILES_GRAD_LAYOUT_KEYS))()
    kernels.library().vl3d_tiles_grad_layout(D, n, N, th, tw, F, C, vec, out)
    return dict(zip(TILES_GRAD_LAYOUT_KEYS, out))


def bilinear_tiles_tilemajor_grad(ct, tile_idx, u, v, tiles_shape,
                                  gather_dtype=None):
    """K10: the gradient of `bilinear_tiles_tilemajor` over all frames
    with respect to tiles of tiles_shape (N, th, tw, F, C) for the f32
    cotangent ct (..., F, C) (the plain version on CPU tensors).  Samples
    with tile_idx < 0 add nothing.  With a bf16 gather_dtype each texel's
    f32 sum is rounded to bf16 and stored widened (the gradient of the f32
    atlas through ``.to(torch.bfloat16)``).  Returns a (N, th, tw, F, C)
    f32 tensor, every texel written (zero where no sample reads);
    deterministic: the samples are binned by tile (`tiles_grad_layout`)
    and each texel summed in the samples' order by one block; the tiles
    that no sample reads are zero-filled."""
    N, th, tw, F, C = tiles_shape
    _check_grad("bilinear_tiles_tilemajor_grad", ct, tile_idx, u, v, (F, C))
    gather_dtype = torch.float32 if gather_dtype is None else gather_dtype
    _check_gather_dtype("bilinear_tiles_tilemajor_grad", gather_dtype)
    dev = ct.device
    if dev.type == "cpu":
        return bilinear_tiles_tilemajor_grad_plain(ct, tile_idx, u, v,
                                                   tiles_shape, gather_dtype)
    if N == 0:
        return torch.zeros(tiles_shape, dtype=torch.float32, device=dev)
    D = tiles_grad_planes(tile_idx.shape)
    n = tile_idx.numel() // D
    vec = _vec_width(F * C, ct)
    lay = tiles_grad_layout(D, n, N, th, tw, F, C, vec)
    if lay["smem"] > _SMEM_LIMIT or n >= _I32 or lay["nk1"] >= _I32:
        raise ValueError(
            f"bilinear_tiles_tilemajor_grad: {lay['smem']} B of shared "
            f"memory a block (limit {_SMEM_LIMIT}), {n} samples a plane and "
            f"{lay['nk1']} keys (limit 2^31 each)")
    grad = torch.empty(tiles_shape, dtype=torch.float32, device=dev)
    scratch = torch.empty(lay["scratch"], dtype=torch.uint8, device=dev)
    err = kernels.library().vl3d_bilinear_tiles_tilemajor_grad(
        ct.data_ptr(), tile_idx.data_ptr(), u.data_ptr(), v.data_ptr(), D, n,
        N, th, tw, F, C, vec, int(gather_dtype == torch.bfloat16),
        scratch.data_ptr(), lay["scratch"], grad.data_ptr(),
        kernels.stream_ptr(dev))
    kernels.LAUNCHES["bilinear_tiles_tilemajor_grad"] += 1
    kernels.check_launch("bilinear_tiles_tilemajor_grad", err)
    return grad


class _TileSample(torch.autograd.Function):
    """K2 forward and K9 backward on 4-D tiles, K3 (all frames) and K10 on
    5-D tiles (the plain versions on CPU tensors). The gradient is
    accumulated in f32 and rounded once to the gather dtype.  Tiles are read
    at the gather dtype: f32 tiles gathered as bf16 have each texel rounded
    in K2 or K3 and each gradient sum in K9 or K10, and their gradient is
    returned in f32 with no cast in either direction; bf16 tiles are read as
    they are, their f32 gradient cast to bf16. The tile indices get no
    gradient; u and v get K23's where they require grad (4-D tiles: the
    vertex warp of the stage-1 sparse phase; on f32 tiles gathered as bf16
    K23 reads a bf16 copy, the texels K2 sampled)."""

    @staticmethod
    def forward(ctx, tiles, tile_idx, u, v, gather_dtype):
        u, v = u.detach(), v.detach()
        coords = ctx.needs_input_grad[2] or ctx.needs_input_grad[3]
        if coords and tiles.dim() != 4:
            raise NotImplementedError(
                "coordinate gradients of tile-major (N, th, tw, F, C) tiles")
        coord_tiles = None
        if coords:
            coord_tiles = tiles.detach().to(gather_dtype).contiguous()
        ctx.save_for_backward(tile_idx, u, v, coord_tiles)
        ctx.shape, ctx.dtype, ctx.gather = tiles.shape, tiles.dtype, \
            gather_dtype
        if tiles.dim() == 4:
            out, valid = bilinear_tiles(tiles.detach(), tile_idx, u, v,
                                        gather_dtype)
        else:
            out, valid = bilinear_tiles_tilemajor(tiles.detach(), tile_idx,
                                                  u, v, None, gather_dtype)
        ctx.mark_non_differentiable(valid)
        return out, valid

    @staticmethod
    def backward(ctx, g, _):
        tile_idx, u, v, tiles = ctx.saved_tensors
        g = g.contiguous()
        grad = g_u = g_v = None
        if ctx.needs_input_grad[0]:
            if len(ctx.shape) == 4:
                # bf16 tiles: the f32 sums, cast below
                grad = bilinear_tiles_grad(
                    g, tile_idx, u, v, ctx.shape,
                    ctx.gather if ctx.dtype == torch.float32 else None)
            else:
                grad = bilinear_tiles_tilemajor_grad(g, tile_idx, u, v,
                                                     ctx.shape, ctx.gather)
            if grad.dtype != ctx.dtype:
                grad = grad.to(ctx.dtype)
        if tiles is not None:
            g_u, g_v = bilinear_tiles_coord_grad(g, tiles, tile_idx, u, v)
        return grad, None, g_u, g_v, None


def sample_tiles(tiles, tile_idx, u, v, gather_dtype=None):
    """K2/K9 on packed (N, th, tw, C) tiles, K3/K10 on tile-major
    (N, th, tw, F, C) tiles (all frames): the samples, differentiable in
    the f32 or bf16 tiles.  gather_dtype (None: the tiles' own): f32
    tiles with bf16 round each texel in K2 or K3 and each gradient sum in
    K9 or K10, bit for bit the samples and gradient of
    ``tiles.to(torch.bfloat16)``, with no copy of the tiles.  Returns
    (values (..., C) or (..., F, C) f32, valid (...) bool)."""
    gather_dtype = tiles.dtype if gather_dtype is None else gather_dtype
    _check_gather_dtype("sample_tiles", gather_dtype)
    return _TileSample.apply(tiles, tile_idx, u, v, gather_dtype)


def bilinear_tiles_tilemajor(tiles, tile_idx, u, v, ts=None,
                             gather_dtype=None):
    """K3: sample tile-major frame-stacked tiles at frames ``ts``.
    tiles (N, th, tw, F_all, C) f32/bf16; ts (F_sel,) int32 or None
    (all frames).  With an f32 tiles and a bf16 gather_dtype each texel is
    rounded to bf16 in registers (bit for bit the samples of
    ``tiles.to(torch.bfloat16)``; no copy is made).  At C = 4 one thread
    a (sample, frame); at other C a block finds a run of samples' corners
    once and sweeps their F_sel x C outputs in output order
    (`tiles_tilemajor_layout`; tiles of fewer than 2^31 elements), the
    same bits.  Returns (values (..., F_sel, C) f32, valid (...))."""
    _check_samples("bilinear_tiles_tilemajor", tiles, tile_idx, u, v)
    gather_dtype = tiles.dtype if gather_dtype is None else gather_dtype
    _check_gather_dtype("bilinear_tiles_tilemajor", gather_dtype)
    N, th, tw, F_all, C = tiles.shape
    if ts is not None:
        kernels.check_tensor("bilinear_tiles_tilemajor.ts", ts, tiles.device,
                             dtype=torch.int32)
    if tiles.device.type == "cpu":
        return bilinear_tiles_tilemajor_plain(tiles, tile_idx, u, v, ts,
                                              gather_dtype)
    F_sel = F_all if ts is None else ts.numel()
    if C != 4 and F_sel > 0:
        tiles_tilemajor_layout(tile_idx.numel(), F_sel, C)
        if tiles.numel() >= 2 ** 31:
            raise ValueError(f"bilinear_tiles_tilemajor: {tiles.numel()} "
                             "texel elements at C != 4 (32-bit offsets)")
    if N == 0 or F_sel == 0:
        return (torch.zeros(tile_idx.shape + (F_sel, C), dtype=torch.float32,
                            device=tiles.device), tile_idx >= 0)
    out = launch_tilemajor("vl3d_bilinear_tiles_tilemajor", tiles, tile_idx,
                           u, v, ts, gather_dtype)
    kernels.LAUNCHES["bilinear_tiles_tilemajor"] += 1
    return out


def launch_tilemajor(entry, tiles, tile_idx, u, v, ts, gather_dtype):
    """Call the library's `entry` (vl3d_bilinear_tiles_tilemajor or its
    first design) on checked CUDA inputs with N > 0 and at least one frame.
    Returns (values, valid)."""
    N, th, tw, F_all, C = tiles.shape
    F_sel = F_all if ts is None else ts.numel()
    out = torch.empty(tile_idx.shape + (F_sel, C), dtype=torch.float32,
                      device=tiles.device)
    bf16 = tiles.dtype == torch.bfloat16
    err = getattr(kernels.library(), entry)(
        tiles.data_ptr(), int(bf16),
        int(not bf16 and gather_dtype == torch.bfloat16),
        tile_idx.data_ptr(), u.data_ptr(), v.data_ptr(),
        None if ts is None else ts.data_ptr(), tile_idx.numel(), N, th, tw,
        F_all, F_sel, C, out.data_ptr(), kernels.stream_ptr(tiles.device))
    kernels.check_launch(entry, err)
    return out, tile_idx >= 0


def _dense_corners(tex, x, y):
    """The four corner texels (v00, v01, v10, v11), each (B, D, ..., C)
    and zero outside the texture, and the fractions (fx, fy) (B, D, ...,
    1) of `bilinear_planes_plain`."""
    D, Ht, Wt, C = tex.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    # clamp in float before the int conversion: a far-off coordinate
    # becomes -2 or the size, both of whose corners are outside
    x0i = x0.clamp(-2, Wt).long()
    y0i = y0.clamp(-2, Ht).long()
    flat = tex.reshape(D * Ht * Wt, C)
    base = torch.arange(D, device=x.device).view(
        (1, D) + (1,) * (x.dim() - 2)) * (Ht * Wt)

    def corner(xi, yi):
        inside = (xi >= 0) & (xi < Wt) & (yi >= 0) & (yi < Ht)
        idx = base + yi.clamp(0, Ht - 1) * Wt + xi.clamp(0, Wt - 1)
        return flat[idx] * inside[..., None].to(tex.dtype)

    return (corner(x0i, y0i), corner(x0i + 1, y0i), corner(x0i, y0i + 1),
            corner(x0i + 1, y0i + 1), fx, fy)


def bilinear_planes_plain(tex, x, y):
    """Plain version of K5: sample per-plane textures tex (D, Ht, Wt, C)
    at texel coordinates x, y (B, D, ...) (align-corners; plane d of the
    coordinates reads plane d of tex).  Every corner outside the texture
    reads zero.  Returns (B, D, ..., C) in tex's dtype."""
    v00, v01, v10, v11, fx, fy = _dense_corners(tex, x, y)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def bilinear_planes_coord_grad_plain(g, tex, x, y):
    """Plain version of K22 for one texture: the gradient of
    sum(g * bilinear_planes_plain(tex, x, y)) with respect to x and y
    (the fractions' derivative; the corners' masks and floors are
    constant).  g (B, D, ..., C).  Returns (g_x, g_y) f32."""
    v00, v01, v10, v11, fx, fy = (t.float() for t in
                                  _dense_corners(tex, x, y))
    g_x = (g * ((1 - fy) * (v01 - v00) + fy * (v11 - v10))).sum(-1)
    g_y = (g * ((1 - fx) * (v10 - v00) + fx * (v11 - v01))).sum(-1)
    return g_x, g_y


def bilinear_planes_grad_plain(g, x, y, tex_shape):
    """Plain version of K6: the gradient of `bilinear_planes_plain` with
    respect to a texture of shape tex_shape, for the cotangent g
    (B, D, ..., C), through autograd (the function is linear in the
    texture, so the texture's values do not matter)."""
    tex = torch.zeros(tex_shape, dtype=g.dtype, device=g.device,
                      requires_grad=True)
    with torch.enable_grad():
        vals = bilinear_planes_plain(tex, x, y)
        (grad,) = torch.autograd.grad(vals, tex, g)
    return grad


def _check_dense(name, atlas, atlas_mask, x, y, dtype=torch.float32):
    dev = atlas.device
    kernels.check_tensor(f"{name}.atlas", atlas, dev, dtype=dtype)
    if atlas.dim() != 4:
        raise ValueError(f"{name}.atlas: shape {tuple(atlas.shape)}, "
                         "expected (D, Ht, Wt, C)")
    D, Ht, Wt, _ = atlas.shape
    if atlas_mask is not None:
        kernels.check_tensor(f"{name}.atlas_mask", atlas_mask, dev,
                             dtype=atlas.dtype, shape=(D, Ht, Wt, 1))
    kernels.check_tensor(f"{name}.x", x, dev, dtype=torch.float32)
    kernels.check_tensor(f"{name}.y", y, dev, dtype=torch.float32,
                         shape=x.shape)
    if x.dim() != 4 or x.shape[1] != D:
        raise ValueError(f"{name}.x: shape {tuple(x.shape)}, expected "
                         f"(B, {D}, h, w)")
    if dev.type == "cuda" and atlas.shape[-1] == 4 and atlas.data_ptr() % 16:
        raise ValueError(f"{name}.atlas: not 16-byte aligned (the C = 4 "
                         "kernel reads one float4 per texel)")


def sample_dense_fwd(atlas, atlas_mask, x, y):
    """K5 without autograd: the samples of `sample_dense` for
    gradient-free inputs (plain version on CPU tensors).  Returns (feats
    (B, D, h, w, C), mask_feats (B, D, h, w, 1) or None)."""
    _check_dense("sample_dense", atlas, atlas_mask, x, y)
    if atlas.device.type == "cpu":
        return (bilinear_planes_plain(atlas, x, y),
                None if atlas_mask is None
                else bilinear_planes_plain(atlas_mask, x, y))
    B, D, h, w = x.shape
    _, Ht, Wt, C = atlas.shape
    if C != 4 and D * Ht * Wt + Wt >= 2 ** 31 - 1:
        raise ValueError(f"sample_dense.atlas: {D * Ht * Wt} texels (the "
                         "C != 4 kernel indexes texels in 32 bits)")
    out = torch.empty((B, D, h, w, C), dtype=torch.float32,
                      device=atlas.device)
    out_m = None if atlas_mask is None else torch.empty(
        (B, D, h, w, 1), dtype=torch.float32, device=atlas.device)
    err = kernels.library().vl3d_sample_dense(
        atlas.data_ptr(), None if atlas_mask is None else atlas_mask.data_ptr(),
        x.data_ptr(), y.data_ptr(), B, D, h * w, Ht, Wt, C, out.data_ptr(),
        None if out_m is None else out_m.data_ptr(),
        kernels.stream_ptr(atlas.device))
    kernels.LAUNCHES["sample_dense"] += 1
    kernels.check_launch("sample_dense", err)
    return out, out_m


def sample_dense_grad(g, g_mask, x, y, atlas_shape, mask_shape=None):
    """K6: the gradients of `sample_dense` with respect to an atlas of
    atlas_shape and, when g_mask is given, a mask atlas of mask_shape,
    for the cotangents g (B, D, h, w, C) and g_mask (B, D, h, w, 1)
    (plain version on CPU tensors).  At C = 4 each corner's four channels
    go in one 128-bit atomic.  Returns (g_atlas, g_mask_atlas or None),
    zero where no sample reads."""
    if x.device.type == "cpu":
        return (bilinear_planes_grad_plain(g, x, y, atlas_shape),
                None if g_mask is None
                else bilinear_planes_grad_plain(g_mask, x, y, mask_shape))
    B, D, h, w = x.shape
    _, Ht, Wt, C = atlas_shape
    dev = x.device
    kernels.check_tensor("sample_dense_grad.g", g, dev, dtype=torch.float32,
                         shape=(B, D, h, w, C))
    if g_mask is not None:
        kernels.check_tensor("sample_dense_grad.g_mask", g_mask, dev,
                             dtype=torch.float32, shape=(B, D, h, w, 1))
    g_atlas = torch.zeros(atlas_shape, dtype=torch.float32, device=dev)
    g_m = None if g_mask is None else torch.zeros(
        (D, Ht, Wt, 1), dtype=torch.float32, device=dev)
    err = kernels.library().vl3d_sample_dense_grad(
        g.data_ptr(), None if g_mask is None else g_mask.data_ptr(),
        x.data_ptr(), y.data_ptr(), B, D, h * w, Ht, Wt, C, g_atlas.data_ptr(),
        None if g_m is None else g_m.data_ptr(), kernels.stream_ptr(dev))
    kernels.LAUNCHES["sample_dense_grad"] += 1
    kernels.check_launch("sample_dense_grad", err)
    return g_atlas, g_m


# K22's staged kernel (csrc/sample_dense.cu:coord_grad_staged_kernel): a
# block's threads (and samples), a warp's samples, the most channels a
# pass stages, the largest channel count, and the layout's keys
COORD_GRAD_THREADS = 256
COORD_GRAD_GROUP = 32
COORD_GRAD_CHUNK = 16
COORD_GRAD_MAX_C = 1024
DENSE_COORD_GRAD_LAYOUT_KEYS = ("samples", "blocks", "threads", "chunk",
                                "smem")


def dense_coord_grad_staged(C, dtype):
    """Whether K22 runs its staged kernel at C channels of `dtype` texels:
    everywhere but C = 4 and bf16 texels at C % 4 != 0, which keep the
    first design (csrc/sample_dense.cu:vl3d_sample_dense_coord_grad)."""
    return C != 4 and (dtype == torch.float32 or C % 4 == 0)


def dense_coord_grad_layout(n, C, D, Ht, Wt):
    """K22's staged layout for n samples of a (D, Ht, Wt, C) atlas
    (csrc/sample_dense.cu:coord_grad_layout): 256 `samples` a block, a
    warp's 32 staged on their own; `blocks`; `threads` a block; `chunk`,
    the channels a pass stages (at most 16; a larger C takes several
    passes); `smem`, the block's dynamic shared bytes (an int4 slot a
    sample, then, for each warp, g_c and the two terms of each staged
    (channel, sample) at a sample stride of 33 words).  Raises beyond its
    limits: 1 <= C <= 1,024, n >= 0, at most 2^31 - 1 blocks, D Ht Wt + Wt
    below 2^31 - 1 (32-bit texel indices)."""
    if (not 1 <= C <= COORD_GRAD_MAX_C or n < 0
            or D * Ht * Wt + Wt >= 2 ** 31 - 1):
        raise ValueError(f"dense_coord_grad_layout: C = {C} (1 to "
                         f"{COORD_GRAD_MAX_C}), n = {n}, {D * Ht * Wt} "
                         "texels (32-bit indices)")
    blocks = -(-n // COORD_GRAD_THREADS)
    if blocks > 2 ** 31 - 1:
        raise ValueError(f"dense_coord_grad_layout: {n} samples need "
                         f"{blocks} blocks")
    chunk = min(C, COORD_GRAD_CHUNK)
    warps = COORD_GRAD_THREADS // COORD_GRAD_GROUP
    return dict(samples=COORD_GRAD_THREADS, blocks=blocks,
                threads=COORD_GRAD_THREADS, chunk=chunk,
                smem=16 * COORD_GRAD_THREADS
                + warps * 12 * chunk * (COORD_GRAD_GROUP + 1))


def kernel_dense_coord_grad_layout(n, C, D, Ht, Wt):
    """K22's staged layout as csrc/sample_dense.cu computes it
    (vl3d_sample_dense_coord_grad_layout; needs the CUDA library), keyed
    as `dense_coord_grad_layout`; None where the kernel refuses it."""
    out = (ctypes.c_longlong * len(DENSE_COORD_GRAD_LAYOUT_KEYS))()
    if kernels.library().vl3d_sample_dense_coord_grad_layout(n, C, D, Ht, Wt,
                                                             out):
        return None
    return dict(zip(DENSE_COORD_GRAD_LAYOUT_KEYS, out))


def sample_dense_coord_grad(g, g_mask, atlas, atlas_mask, x, y):
    """K22: the gradient of `sample_dense`'s samples with respect to their
    coordinates x, y (B, D, h, w) f32, for the cotangents g (B, D, h, w, C)
    and, with the loop-mask atlas, g_mask (B, D, h, w, 1): one sum over
    the C + 1 channels (JAX samples the mask as channel C of one source).
    atlas (D, Ht, Wt, C) and atlas_mask (D, Ht, Wt, 1) or None, f32 or bf16
    (plain version on CPU tensors).  At C = 4 one thread a sample; at
    other C (`dense_coord_grad_staged`) each warp stages its 32 samples'
    cotangents and terms in shared memory and each lane sums its sample's
    channels in order (`dense_coord_grad_layout`), the same bits.  Returns
    (g_x, g_y) f32."""
    dev = x.device
    check_dense_coord_grad("sample_dense_coord_grad", g, g_mask, atlas,
                           atlas_mask, x, y)
    if dev.type == "cpu":
        g_x, g_y = bilinear_planes_coord_grad_plain(g, atlas, x, y)
        if atlas_mask is not None:
            m_x, m_y = bilinear_planes_coord_grad_plain(g_mask, atlas_mask,
                                                        x, y)
            g_x, g_y = g_x + m_x, g_y + m_y
        return g_x, g_y
    D, Ht, Wt, C = atlas.shape
    if dense_coord_grad_staged(C, atlas.dtype):
        dense_coord_grad_layout(x.numel(), C, D, Ht, Wt)
    g_x, g_y = launch_dense_coord_grad("vl3d_sample_dense_coord_grad", g,
                                       g_mask, atlas, atlas_mask, x, y)
    kernels.LAUNCHES["sample_dense_coord_grad"] += 1
    return g_x, g_y


def check_dense_coord_grad(name, g, g_mask, atlas, atlas_mask, x, y):
    """Raise unless K22's arguments are as `sample_dense_coord_grad`
    takes them."""
    dev = x.device
    _check_dense(name, atlas, atlas_mask, x, y, _TEXEL_DTYPES)
    kernels.check_tensor(f"{name}.g", g, dev, dtype=torch.float32,
                         shape=x.shape + (atlas.shape[-1],))
    if (g_mask is None) != (atlas_mask is None):
        raise ValueError(f"{name}: pass the mask atlas and its cotangent "
                         "together")
    if g_mask is not None:
        kernels.check_tensor(f"{name}.g_mask", g_mask, dev,
                             dtype=torch.float32, shape=x.shape + (1,))


def launch_dense_coord_grad(entry, g, g_mask, atlas, atlas_mask, x, y):
    """Call the library's `entry` (vl3d_sample_dense_coord_grad, its first
    design or its staged kernel) on checked CUDA inputs.  Returns (g_x,
    g_y)."""
    dev = x.device
    B, D, h, w = x.shape
    _, Ht, Wt, C = atlas.shape
    g_x = torch.empty(x.shape, dtype=torch.float32, device=dev)
    g_y = torch.empty(x.shape, dtype=torch.float32, device=dev)
    err = getattr(kernels.library(), entry)(
        atlas.data_ptr(),
        None if atlas_mask is None else atlas_mask.data_ptr(),
        int(atlas.dtype == torch.bfloat16), g.data_ptr(),
        None if g_mask is None else g_mask.data_ptr(), x.data_ptr(),
        y.data_ptr(), B, D, h * w, Ht, Wt, C, g_x.data_ptr(), g_y.data_ptr(),
        kernels.stream_ptr(dev))
    kernels.check_launch(entry, err)
    return g_x, g_y


class _SampleDense(torch.autograd.Function):
    """K5 forward, K6 backward (the plain versions on CPU tensors).  The
    coordinates get K22's gradient where they require grad (the vertex
    warp); otherwise nothing is saved or launched for them, as in the JAX
    VJP."""

    @staticmethod
    def forward(ctx, atlas, atlas_mask, x, y):
        x, y = x.detach(), y.detach()
        atlas = atlas.detach()
        atlas_mask = None if atlas_mask is None else atlas_mask.detach()
        coords = ctx.needs_input_grad[2] or ctx.needs_input_grad[3]
        ctx.save_for_backward(x, y, atlas if coords else None,
                              atlas_mask if coords else None)
        ctx.shapes = (atlas.shape,
                      None if atlas_mask is None else atlas_mask.shape)
        out, out_m = sample_dense_fwd(atlas, atlas_mask, x, y)
        return (out,) if out_m is None else (out, out_m)

    @staticmethod
    def backward(ctx, g, g_m=None):
        x, y, atlas, atlas_mask = ctx.saved_tensors
        shape, mshape = ctx.shapes
        g = g.contiguous()
        g_m = None if mshape is None else g_m.contiguous()
        g_atlas = g_mask = g_x = g_y = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            g_atlas, g_mask = sample_dense_grad(g, g_m, x, y, shape, mshape)
        if atlas is not None:
            g_x, g_y = sample_dense_coord_grad(g, g_m, atlas, atlas_mask, x,
                                               y)
        return g_atlas, g_mask, g_x, g_y


def sample_dense(atlas, atlas_mask, x, y):
    """K5/K6: sample the dense (D, Ht, Wt, C) f32 atlas and, when given,
    the (D, Ht, Wt, 1) loop-mask atlas at texel coordinates x, y
    (B, D, h, w) f32.  Differentiable in both atlases (K6 on CUDA) and,
    where they require grad, in the coordinates (K22).

    Returns (feats (B, D, h, w, C), mask_feats (B, D, h, w, 1) or None).
    """
    outs = _SampleDense.apply(atlas, atlas_mask, x, y)
    return outs[0], (outs[1] if atlas_mask is not None else None)


def _plane_corners(x, y, Ht, Wt):
    """The four corners of `bilinear_planes_tilemajor_plain`: fractions
    (fx, fy) and, per corner (x0, y0), (x0 + 1, y0), (x0, y0 + 1),
    (x0 + 1, y0 + 1), its (inside mask, in-plane texel index)."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx, fy = x - x0, y - y0
    # clamp in float before the int conversion: a far-off coordinate
    # becomes -2 or the size, both of whose corners are outside
    x0i = x0.clamp(-2, Wt).long()
    y0i = y0.clamp(-2, Ht).long()
    corners = []
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0i + dx, y0i + dy
            inside = (xi >= 0) & (xi < Wt) & (yi >= 0) & (yi < Ht)
            corners.append((inside, yi.clamp(0, Ht - 1) * Wt
                            + xi.clamp(0, Wt - 1)))
    return fx, fy, corners


def bilinear_planes_tilemajor_plain(tex, x, y, ts=None, gather_dtype=None):
    """Plain version of K16 (JAX ``render/sample.py:bilinear_planes_
    tilemajor`` with the frame gather ``dyn[..., ts, :]`` and the
    ``astype(gather_dtype)`` of ``models/mpv.py``): sample the frame-stacked
    plane textures tex (D, Ht, Wt, F_all, C) f32/bf16 at align-corners
    texel coordinates x, y (D, ...) (plane d of the coordinates reads plane
    d of tex), at frames ts (F_sel,) int or all frames, the texels first
    cast to gather_dtype (None: as they are).  Each corner outside the
    plane reads zero; texels are widened to f32 and lerped in f32.
    Returns (D, ..., F_sel, C) f32."""
    if ts is not None:
        tex = tex.index_select(3, ts.long())
    if gather_dtype is not None:
        tex = tex.to(gather_dtype)
    D, Ht, Wt, F, C = tex.shape
    xs, ys = x.reshape(D, -1), y.reshape(D, -1)
    fx, fy, corners = _plane_corners(xs, ys, Ht, Wt)
    fx, fy = fx[..., None, None], fy[..., None, None]
    flat = tex.reshape(D, Ht * Wt, F, C)
    planes = torch.arange(D, device=x.device)[:, None]
    v00, v01, v10, v11 = (
        torch.where(inside[..., None, None], flat[planes, idx].float(), 0.0)
        for inside, idx in corners)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return (top * (1 - fy) + bot * fy).reshape(x.shape + (F, C))


def bilinear_planes_tilemajor_grad_plain(ct, x, y, tex_shape,
                                         gather_dtype=None):
    """Plain version of K17: the gradient of
    `bilinear_planes_tilemajor_plain` (all frames) with respect to a
    texture of tex_shape (D, Ht, Wt, F, C) for the cotangent ct (D, ...,
    F, C), as a direct scatter (``index_add_``) of each corner inside the
    plane; with a bf16 gather_dtype each sum is rounded to bf16 (and
    widened back).  Returns the gradient in ct's dtype."""
    D, Ht, Wt, F, C = tex_shape
    xs, ys = x.reshape(D, -1), y.reshape(D, -1)
    ct = ct.reshape(D, xs.shape[1], F * C)
    grad = torch.zeros((D * Ht * Wt, F * C), dtype=ct.dtype, device=ct.device)
    fx, fy, corners = _plane_corners(xs, ys, Ht, Wt)
    fx, fy = fx.to(ct.dtype), fy.to(ct.dtype)
    wx0, wy0 = 1 - fx, 1 - fy
    weights = (wy0 * wx0, wy0 * fx, fy * wx0, fy * fx)
    base = torch.arange(D, device=ct.device)[:, None] * (Ht * Wt)
    for (inside, idx), wgt in zip(corners, weights):
        grad.index_add_(0, (base + idx)[inside],
                        (ct * wgt[..., None])[inside])
    if gather_dtype == torch.bfloat16:
        grad = grad.to(torch.bfloat16).to(ct.dtype)
    return grad.view(tex_shape)


# K17's tiling, mirrored by csrc/bilinear_planes_tilemajor.cu:grad_layout
_BIN_H, _BIN_W = 4, 8          # texels of a tile
_SORT_TILE = 2048              # keys a sort block
_GATHER_MAX_THREADS = 128      # vectors of a slice
_SMEM_LIMIT = 232448           # an H100 block's shared memory
_I32 = 2 ** 31


def _align256(b):
    return -(-b // 256) * 256


def planes_grad_layout(D, n, Ht, Wt, F, C, vec):
    """K17's layout for D planes of n samples and a (D, Ht, Wt, F, C)
    texture, vec floats a column (4, 2 or 1), as a dict: the (nty, ntx)
    texel tiles of _BIN_H x _BIN_W a plane; the (nby, nbx) bins, one row and
    column more (x0 = -1 or y0 = -1 bins to tile -1); nk1 keys a plane (4
    classes a bin, then the sentinel of samples with no corner on the
    plane); `passes` 8-bit digits of the sentinel; `ntiles` sort blocks of
    _SORT_TILE samples a plane; the F x C row as `ncols` vectors in
    `nslices` slices of `slice_cols` (one thread each, `threads` a block
    rounded to warps); a block's dynamic shared bytes `smem` (the tile's
    accumulators, then a batch of `threads` decoded samples: index, four
    texel slots, four weights); the `scratch` bytes (keys and payloads
    twice, the digit counts, the key offsets, each 256-byte aligned)."""
    nty, ntx = -(-Ht // _BIN_H), -(-Wt // _BIN_W)
    nby, nbx = nty + 1, ntx + 1
    sentinel = nby * nbx * 4
    ntiles = -(-n // _SORT_TILE)
    ncols = F * C // vec
    nslices = -(-ncols // _GATHER_MAX_THREADS)
    slice_cols = -(-ncols // nslices) if nslices else 0
    threads = -(-slice_cols // 32) * 32
    return dict(
        bin_h=_BIN_H, bin_w=_BIN_W, nty=nty, ntx=ntx, nby=nby, nbx=nbx,
        nk1=sentinel + 1, passes=-(-sentinel.bit_length() // 8),
        ntiles=ntiles, ncols=ncols, nslices=nslices, slice_cols=slice_cols,
        threads=threads,
        smem=4 * (_BIN_H * _BIN_W * slice_cols * vec + 9 * threads),
        scratch=4 * _align256(D * n * 4) + _align256(D * 256 * ntiles * 4)
        + _align256(D * (sentinel + 1) * 4))


# the keys of planes_grad_layout, in the order vl3d_planes_grad_layout
# returns them
PLANES_GRAD_LAYOUT_KEYS = ("nty", "ntx", "nby", "nbx", "nk1", "passes",
                           "ntiles", "ncols", "nslices", "slice_cols",
                           "threads", "smem", "scratch")


def kernel_planes_grad_layout(D, n, Ht, Wt, F, C, vec):
    """K17's layout as csrc/bilinear_planes_tilemajor.cu computes it
    (vl3d_planes_grad_layout; needs the CUDA library), keyed as
    `planes_grad_layout`, for the checks that the two agree."""
    out = (ctypes.c_longlong * len(PLANES_GRAD_LAYOUT_KEYS))()
    kernels.library().vl3d_planes_grad_layout(D, n, Ht, Wt, F, C, vec, out)
    return dict(zip(PLANES_GRAD_LAYOUT_KEYS, out))


def _vec_width(width, *tensors):
    """The widest of 4, 2, 1 floats that divides `width` elements and at
    whose size every tensor's storage is aligned."""
    for v in (4, 2, 1):
        if width % v == 0 and all(
                t.data_ptr() % (v * t.element_size()) == 0 for t in tensors):
            return v
    return 1


def _sweep_image_width(x, F_sel, C):
    """The image width K16 tiles its samples by (0: in their order): for
    (D, h, w) coordinates whose samples each fill a warp with their
    outputs (F_sel C / 4 >= 32 vectors: the training patch's 50 frames),
    a block takes an 8 x 32 tile of the image, so that the row neighbours
    that share texel rows are read in one L1; at 10 frames a sample (the
    eval chunk) consecutive samples of a row in a block were measured
    faster."""
    return x.shape[-1] if x.dim() == 3 and F_sel * C >= 128 else 0


def _check_planes(name, tex, x, y):
    dev = tex.device
    kernels.check_tensor(f"{name}.tex", tex, dev, dtype=_TEXEL_DTYPES)
    if tex.dim() != 5:
        raise ValueError(f"{name}.tex: shape {tuple(tex.shape)}, expected "
                         "(D, Ht, Wt, F, C)")
    kernels.check_tensor(f"{name}.x", x, dev, dtype=torch.float32)
    kernels.check_tensor(f"{name}.y", y, dev, dtype=torch.float32,
                         shape=x.shape)
    if x.dim() < 1 or x.shape[0] != tex.shape[0]:
        raise ValueError(f"{name}.x: shape {tuple(x.shape)}, expected "
                         f"({tex.shape[0]}, ...)")


def _check_gather_dtype(name, gather_dtype):
    if gather_dtype not in _TEXEL_DTYPES:
        raise TypeError(f"{name}: gather dtype {gather_dtype}, expected one "
                        f"of {_TEXEL_DTYPES}")


def bilinear_planes_tilemajor(tex, x, y, ts=None, gather_dtype=None):
    """K16: sample the frame-stacked plane textures tex (D, Ht, Wt, F_all,
    C) f32/bf16 at texel coordinates x, y (D, ...) f32, at frames ts
    (F_sel,) int32 or all frames (the plain version on CPU tensors).  With
    an f32 tex and a bf16 gather_dtype each texel is rounded to bf16 in
    registers (bit for bit the samples of ``tex.to(torch.bfloat16)``; no
    copy of the stack is made).  Returns (D, ..., F_sel, C) f32."""
    _check_planes("bilinear_planes_tilemajor", tex, x, y)
    gather_dtype = tex.dtype if gather_dtype is None else gather_dtype
    _check_gather_dtype("bilinear_planes_tilemajor", gather_dtype)
    D, Ht, Wt, F_all, C = tex.shape
    if ts is not None:
        kernels.check_tensor("bilinear_planes_tilemajor.ts", ts, tex.device,
                             dtype=torch.int32)
    if tex.device.type == "cpu":
        return bilinear_planes_tilemajor_plain(tex, x, y, ts, gather_dtype)
    F_sel = F_all if ts is None else ts.numel()
    if Ht * Wt * F_all * C >= _I32 or 256 * F_sel * C >= _I32:
        raise ValueError(f"bilinear_planes_tilemajor: a plane of "
                         f"{Ht * Wt * F_all * C} elements or {F_sel} x {C} "
                         "outputs a sample; the kernel indexes a plane and "
                         "a block's 256 samples in 32 bits (< 2^31)")
    out = torch.empty(x.shape + (F_sel, C), dtype=torch.float32,
                      device=tex.device)
    bf16 = tex.dtype == torch.bfloat16
    img_w = _sweep_image_width(x, F_sel, C)
    # all frames: a texel's F x C row is one frame of F C channels to the
    # kernel (contiguous in the stack and in the output alike)
    fa, fs, ch = (F_all, F_sel, C) if ts is not None else (1, 1, F_all * C)
    vec = _vec_width(ch, tex) if ts is None else (
        4 if _vec_width(C, tex) == 4 else 1)
    err = kernels.library().vl3d_bilinear_planes_tilemajor(
        tex.data_ptr(), int(bf16),
        int(not bf16 and gather_dtype == torch.bfloat16), x.data_ptr(),
        y.data_ptr(), None if ts is None else ts.data_ptr(), D,
        x.numel() // D, img_w, Ht, Wt, fa, fs, ch, vec, out.data_ptr(),
        kernels.stream_ptr(tex.device))
    kernels.LAUNCHES["bilinear_planes_tilemajor"] += 1
    kernels.check_launch("bilinear_planes_tilemajor", err)
    return out


def bilinear_planes_tilemajor_grad(ct, x, y, tex_shape, gather_dtype=None):
    """K17: the gradient of `bilinear_planes_tilemajor` over all frames
    with respect to an f32 texture of tex_shape (D, Ht, Wt, F, C) for the
    f32 cotangent ct (D, ..., F, C) (the plain version on CPU tensors).
    With a bf16 gather_dtype each texel's f32 sum is rounded to bf16 and
    stored widened (the gradient of the f32 atlas through
    ``.to(torch.bfloat16)``).  Returns a (D, Ht, Wt, F, C) f32 tensor, every
    texel written (zero where no sample reads); deterministic."""
    D, Ht, Wt, F, C = tex_shape
    dev = ct.device
    kernels.check_tensor("bilinear_planes_tilemajor_grad.x", x, dev,
                         dtype=torch.float32)
    kernels.check_tensor("bilinear_planes_tilemajor_grad.y", y, dev,
                         dtype=torch.float32, shape=x.shape)
    kernels.check_tensor("bilinear_planes_tilemajor_grad.ct", ct, dev,
                         dtype=torch.float32, shape=x.shape + (F, C))
    if x.shape[0] != D:
        raise ValueError(f"bilinear_planes_tilemajor_grad: {x.shape[0]} "
                         f"coordinate planes for {D} texture planes")
    gather_dtype = torch.float32 if gather_dtype is None else gather_dtype
    _check_gather_dtype("bilinear_planes_tilemajor_grad", gather_dtype)
    if dev.type == "cpu":
        return bilinear_planes_tilemajor_grad_plain(ct, x, y, tex_shape,
                                                    gather_dtype)
    n = x.numel() // D
    vec = _vec_width(F * C, ct)
    lay = planes_grad_layout(D, n, Ht, Wt, F, C, vec)
    if lay["smem"] > _SMEM_LIMIT or n >= _I32 or lay["nk1"] >= _I32:
        raise ValueError(
            f"bilinear_planes_tilemajor_grad: {lay['smem']} B of shared "
            f"memory a block (limit {_SMEM_LIMIT}), {n} samples a plane and "
            f"{lay['nk1']} keys a plane (limit 2^31 each)")
    grad = torch.empty(tex_shape, dtype=torch.float32, device=dev)
    scratch = torch.empty(lay["scratch"], dtype=torch.uint8, device=dev)
    err = kernels.library().vl3d_bilinear_planes_tilemajor_grad(
        ct.data_ptr(), x.data_ptr(), y.data_ptr(), D, n, Ht, Wt, F, C, vec,
        int(gather_dtype == torch.bfloat16), scratch.data_ptr(),
        lay["scratch"], grad.data_ptr(), kernels.stream_ptr(dev))
    kernels.LAUNCHES["bilinear_planes_tilemajor_grad"] += 1
    kernels.check_launch("bilinear_planes_tilemajor_grad", err)
    return grad


class _PlaneSample(torch.autograd.Function):
    """K16 forward (all frames), K17 backward (the plain versions on CPU
    tensors), both at the gather dtype: the f32 atlas is read and its
    gradient returned in f32 with no cast in either direction (under a
    bf16 gather, each texel rounded to bf16 in K16 and each gradient sum
    rounded once to bf16 in K17); a bf16 texture takes the rounded sums as
    they are.  The coordinates get no gradient."""

    @staticmethod
    def forward(ctx, tex, x, y, gather_dtype):
        ctx.save_for_backward(x, y)
        ctx.shape, ctx.dtype, ctx.gather = tex.shape, tex.dtype, gather_dtype
        return bilinear_planes_tilemajor(tex.detach(), x, y, None,
                                         gather_dtype)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        grad = bilinear_planes_tilemajor_grad(g.contiguous(), x, y, ctx.shape,
                                              ctx.gather)
        if ctx.dtype != grad.dtype:
            grad = grad.to(ctx.dtype)
        return grad, None, None, None


def sample_planes_tilemajor(tex, x, y, ts=None, gather_dtype=None):
    """K16/K17: the samples of the dense (D, Ht, Wt, F, C) f32 or bf16
    frame-stacked texture at texel coordinates x, y (D, ...) f32, its
    texels taken at gather_dtype (None: tex's own; an f32 tex with bf16
    rounds each texel in K16 and each gradient sum in K17, bit for bit the
    samples and gradient of ``tex.to(torch.bfloat16)``), differentiable in
    the texture over all frames (ts None); a frame subset ts (F_sel,) int32
    is for renders without gradient (eval; K16 alone, which refuses a
    texture that requires grad).  Returns (D, ..., F_sel, C) f32."""
    gather_dtype = tex.dtype if gather_dtype is None else gather_dtype
    if ts is None:
        return _PlaneSample.apply(tex, x, y, gather_dtype)
    return bilinear_planes_tilemajor(tex, x, y, ts, gather_dtype)
