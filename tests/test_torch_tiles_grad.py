"""K10 as redesigned for the card, and K3's f32-read-as-bf16 mode, emulated
on the host from the layout of ``render/sample.py`` (the CUDA kernels of
``csrc/bilinear_tiles_tilemajor.cu`` do not run on the CPU).

K10's emulation follows the kernel step by step: each sample's key (its
tile min(k, N - 1), the sentinel N where k < 0), the stable LSD radix sort
of each plane (the samples' leading index, `tiles_grad_planes`; bins.cuh's
8-bit digits, per-tile counts, their digit-major scan and the scatter in
index order, `test_torch_planes_grad._radix_sort`), the key offsets, and
for every (tile, slice of the F x C row) its per-plane ranges in plane
order, the decoded corners and weights (u and v clamped as in K3), each
parity class's thread adding the corners of its texels in bin order and
q = 0..3 (each product and sum rounded once in f32), and the write of every
texel, zeros included, rounded to bf16 in the rounding mode.  It is held
within 1e-6 * max|g| of the plain version and of ``jax.vjp`` through the
JAX package's ``make_tile_adjoint`` (5-D tiles) at C = 4, 13 and 36; a ones
cotangent with unit weights counts each (sample, corner) exactly once, by
one group; k past the last tile is clamped and k < 0 with non-finite u, v
adds nothing; the rounding mode is ``.to(bfloat16).to(float32)`` of the
same sums.  K3's f32-as-bf16 mode, emulated per (sample, frame), is bit
for bit K3's samples of the bf16 copy, and `sample_tiles` on the f32 atlas
at the bf16 gather dtype gives the old chain's samples and gradient bits
with no copy or cast in autograd.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_planes_grad import _radix_sort
from test_torch_stage1_sparse import _tile_setup
from videoloop3d_tpu.render import adjoint as ADJ
from videoloop3d_torch.render import sample as S

F32 = np.float32


def _corners(u, v, th, tw):
    """K3's / K10's corners of one sample: (texel (v_i, u_i) of q = 0..3,
    their weights) with u, v clamped to the tile (NaN to 0, as fmaxf)."""
    uu = F32(min(max(np.nan_to_num(u, nan=0.0), 0.0), tw - 1.0))
    vv = F32(min(max(np.nan_to_num(v, nan=0.0), 0.0), th - 1.0))
    u0, v0 = np.floor(uu), np.floor(vv)
    fu, fv = F32(uu - u0), F32(vv - v0)
    u0i, v0i = int(u0), int(v0)
    u1i, v1i = min(u0i + 1, tw - 1), min(v0i + 1, th - 1)
    wu0, wv0 = F32(1) - fu, F32(1) - fv
    return ([(v0i, u0i), (v0i, u1i), (v1i, u0i), (v1i, u1i)],
            [wv0 * wu0, wv0 * fu, fv * wu0, fv * fu])


def emulate_k10(ct, k, u, v, shape, vec, round_bf16=False, unit=False):
    """K10 on the host: (the (N, th, tw, F, C) f32 gradient, the adds of
    each (tile, texel), the writes of each element, the adds by each
    parity class's threads of each sample's corners (D n, 4)).  unit:
    every weight 1 (the adds counted with a ones cotangent)."""
    N, th, tw, F, C = shape
    FC, T = F * C, th * tw
    D = S.tiles_grad_planes(k.shape)
    n = k.size // D
    ks, us, vs = k.reshape(D, n), u.reshape(D, n), v.reshape(D, n)
    cts = ct.reshape(D * n, FC)
    lay = S.tiles_grad_layout(D, n, N, th, tw, F, C, vec)
    keys = np.where(ks < 0, N, np.minimum(ks, N - 1)).astype(np.uint32)
    perms, offs = [], []
    for d in range(D):
        skeys, perm = _radix_sort(keys[d], lay)
        np.testing.assert_array_equal(perm,
                                      np.argsort(keys[d], kind="stable"))
        perms.append(perm)
        offs.append(np.searchsorted(skeys, np.arange(lay["nk1"]), "left"))
    grad = np.full((N, T, FC), np.nan, F32)
    adds = np.zeros((N, T), np.int64)
    writes = np.zeros((N, T, FC), np.int64)
    by_group = np.zeros((D * n, 4), np.int64)
    for t in range(N):
        # the bin's ranges in plane order: the samples in index order
        entries = np.concatenate([d * n + perms[d][offs[d][t]:offs[d][t + 1]]
                                  for d in range(D)]).astype(np.int64)
        dec = [_corners(us.reshape(-1)[s], vs.reshape(-1)[s], th, tw)
               for s in entries]
        for sl in range(lay["nslices"]):
            c0 = sl * lay["slice_cols"]
            cols = min(lay["slice_cols"], lay["ncols"] - c0)
            span = slice(c0 * vec, (c0 + cols) * vec)
            acc = np.zeros((T, cols * vec), F32)
            for g in range(4):
                for s, (cs, ws) in zip(entries, dec):
                    row = cts[s, span]
                    for q in range(4):
                        vi, ui = cs[q]
                        if (vi & 1) * 2 + (ui & 1) != g:
                            continue
                        w = F32(1) if unit else F32(ws[q])
                        acc[vi * tw + ui] = acc[vi * tw + ui] + row * w
                        if sl == 0:
                            adds[t, vi * tw + ui] += 1
                            by_group[s, q] += 1
            if round_bf16 and len(entries):
                acc = torch.from_numpy(acc).to(torch.bfloat16).float().numpy()
            grad[t, :, span] = acc
            writes[t, :, span] += 1
    return grad.reshape(shape), adds, writes, by_group


def _vec(F, C):
    return next(x for x in (4, 2, 1) if F * C % x == 0)


CHANNELS = {"c4_f5": (4, 5), "c13_f3": (13, 3), "c36_f2": (36, 2)}


@pytest.mark.parametrize("case", ["partial", "edges", "oblique"])
@pytest.mark.parametrize("ch", list(CHANNELS))
def test_k10_binned_gather_emulated(ch, case):
    """The emulated gather writes every texel once, zeros included (zero
    where the plain version's sum is), and is within 1e-6 * max|g| of the
    plain version and of jax.vjp through make_tile_adjoint, on the sparse
    geometry of tests/test_torch_stage1_sparse.py (partial culling, samples
    clamped at the tile edges, an oblique view) at C = 4, 13 and 36."""
    C, F = CHANNELS[ch]
    geom, tile_map, k, u, v, M, tiles, _, hw = _tile_setup(case, seed=5)
    N, th, tw = tiles.shape[:3]
    rng = np.random.default_rng(C)
    ct = rng.standard_normal(k.shape + (F, C)).astype(F32)
    shape = (N, th, tw, F, C)
    got, _, writes, _ = emulate_k10(ct, k, u, v, shape, _vec(F, C))
    assert (writes == 1).all()
    tk, tu, tv, tct = (torch.from_numpy(a) for a in (k, u, v, ct))
    plain = S.bilinear_tiles_tilemajor_grad_plain(tct, tk, tu, tv,
                                                  shape).numpy()
    scale = np.abs(plain).max()
    assert scale > 0 and (plain == 0).any()
    assert np.abs(got - plain).max() <= 1e-6 * scale
    assert (got[plain == 0] == 0).all()
    samp = ADJ.make_tile_adjoint(ADJ.tile_positions(tile_map),
                                 geom.tile_span,
                                 ADJ.tile_window_for(geom, hw))
    jk, ju, jv = (jnp.asarray(a) for a in (k, u, v))
    jt = jnp.zeros(shape, jnp.float32)
    _, vjp = jax.vjp(lambda t: samp(t, jk, ju, jv, M)[0], jt)
    jg = np.asarray(vjp(jnp.asarray(ct))[0])
    assert np.abs(got - jg).max() <= 1e-6 * np.abs(jg).max()


def _index_order_sums(ct, k, u, v, shape):
    """Each texel's sum taken straight in the samples' index order, then
    q = 0..3, each product and sum rounded once in f32: the order the bins
    must give the gather."""
    N, th, tw, F, C = shape
    g = np.zeros((N, th * tw, F * C), F32)
    kf, uf, vf = k.reshape(-1), u.reshape(-1), v.reshape(-1)
    cf = ct.reshape(kf.size, F * C)
    for s in np.flatnonzero(kf >= 0):
        t = min(kf[s], N - 1)
        cs, ws = _corners(uf[s], vf[s], th, tw)
        for (vi, ui), w in zip(cs, ws):
            g[t, vi * tw + ui] = g[t, vi * tw + ui] + cf[s] * F32(w)
    return g.reshape(shape)


TILES = {"tile_12x12": (12, 12), "tile_5x7": (5, 7)}


@pytest.mark.parametrize("case", ["partial", "edges"] + list(TILES))
def test_k10_sums_in_index_order(case):
    """The gather's sums are bit for bit each texel's sum in the samples'
    index order, then q = 0..3: the stable bins concatenated in plane order
    list a tile's samples by index, and the texel parity classes keep each
    texel's adds in one thread; on the 21 x 18 tiles of the sparse
    geometry and on small synthetic ones (the shipped 12 x 12)."""
    if case in TILES:
        rng = np.random.default_rng(8)
        N, (th, tw) = 5, TILES[case]
        k = rng.integers(-1, N + 1, (3, 10, 12)).astype(np.int32)
        u = rng.uniform(-1.0, tw + 1.0, k.shape).astype(F32)
        v = rng.uniform(-1.0, th + 1.0, k.shape).astype(F32)
        k = np.minimum(k, N - 1)
    else:
        _, _, k, u, v, _, tiles, _, _ = _tile_setup(case, seed=8)
        N, th, tw = tiles.shape[:3]
    ct = np.random.default_rng(2).standard_normal(k.shape + (3, 4)).astype(
        F32)
    shape = (N, th, tw, 3, 4)
    got, _, _, _ = emulate_k10(ct, k, u, v, shape, 4)
    want = _index_order_sums(ct, k, u, v, shape)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_k10_counts_each_corner_once():
    """With a ones cotangent and unit weights every (sample, corner) of a
    sample with k >= 0 is added exactly once, by the class of its texel,
    and each texel's sum is its number of corners (twice a texel
    where u or v clamps at the far edge, as K3 reads it twice); samples
    with k < 0 add nothing."""
    _, _, k, u, v, _, tiles, _, _ = _tile_setup("edges", seed=2)
    N, th, tw = tiles.shape[:3]
    F, C = 2, 4
    ones = np.ones(k.shape + (F, C), F32)
    got, adds, _, by_group = emulate_k10(ones, k, u, v, (N, th, tw, F, C), 4,
                                         unit=True)
    hit = k.reshape(-1) >= 0
    assert (by_group[hit] == 1).all() and not by_group[~hit].any()
    want = np.zeros((N, th * tw), np.int64)
    for s in np.flatnonzero(hit):
        cs, _ = _corners(u.reshape(-1)[s], v.reshape(-1)[s], th, tw)
        for vi, ui in cs:
            want[min(k.reshape(-1)[s], N - 1), vi * tw + ui] += 1
    np.testing.assert_array_equal(adds, want)
    assert (want >= 2).any() and (want == 0).any()
    np.testing.assert_array_equal(
        got.reshape(N, th * tw, F * C),
        np.broadcast_to(want[..., None].astype(F32), (N, th * tw, F * C)))


def test_k10_clamps_past_the_last_tile_and_skips_misses():
    """k past the last tile adds into tile N - 1 (the first design's
    clamp: the plain version on k clamped); k < 0 with NaN and infinite u,
    v adds nothing: the result is finite and equal to the result with
    those samples' coordinates zeroed."""
    _, _, k, u, v, _, tiles, _, _ = _tile_setup("partial", seed=7)
    N, th, tw = tiles.shape[:3]
    F, C = 3, 4
    k = k.copy()
    hits = np.flatnonzero(k.reshape(-1) >= 0)
    k.reshape(-1)[hits[:15]] = N + np.arange(15)
    miss = k < 0
    u2, v2 = u.copy(), v.copy()
    u2[miss], v2[miss] = np.nan, np.inf
    ct = np.random.default_rng(1).standard_normal(k.shape + (F, C)).astype(
        F32)
    shape = (N, th, tw, F, C)
    got, _, _, _ = emulate_k10(ct, k, u2, v2, shape, 4)
    assert np.isfinite(got).all()
    u0, v0 = np.where(miss, 0, u), np.where(miss, 0, v)
    ref, _, _, _ = emulate_k10(ct, k, u0.astype(F32), v0.astype(F32), shape,
                               4)
    np.testing.assert_array_equal(got, ref)
    tk = torch.from_numpy(np.minimum(k, N - 1))
    plain = S.bilinear_tiles_tilemajor_grad_plain(
        torch.from_numpy(ct), tk, torch.from_numpy(u), torch.from_numpy(v),
        shape).numpy()
    assert np.abs(got - plain).max() <= 1e-6 * np.abs(plain).max()


@pytest.mark.parametrize("ch", ["c4_f5", "c13_f3"])
def test_k10_rounding_mode(ch):
    """The rounding mode writes the f32 sums rounded once to bf16 (to
    nearest even) and widened: bit for bit ``.to(bfloat16).to(float32)``
    of the f32 mode's result; within one bf16 step of the plain version's
    rounded sums (the sums' order differs)."""
    C, F = CHANNELS[ch]
    _, _, k, u, v, _, tiles, _, _ = _tile_setup("oblique", seed=9)
    N, th, tw = tiles.shape[:3]
    ct = np.random.default_rng(C).standard_normal(k.shape + (F, C)).astype(
        F32)
    shape = (N, th, tw, F, C)
    f32, _, _, _ = emulate_k10(ct, k, u, v, shape, _vec(F, C))
    rnd, _, _, _ = emulate_k10(ct, k, u, v, shape, _vec(F, C),
                               round_bf16=True)
    np.testing.assert_array_equal(
        rnd, torch.from_numpy(f32).to(torch.bfloat16).float().numpy())
    ref = S.bilinear_tiles_tilemajor_grad_plain(
        *(torch.from_numpy(a) for a in (ct, k, u, v)), shape,
        torch.bfloat16)
    mag = torch.maximum(torch.from_numpy(rnd).abs(), ref.abs())
    step = torch.ldexp(torch.ones_like(mag), torch.frexp(mag)[1] - 8)
    assert ((torch.from_numpy(rnd) - ref).abs() <= step).all()


def emulate_k3(tiles, k, u, v, ts, round_bf16):
    """bilinear_tiles_tilemajor_kernel on the host, one (sample, frame) at a
    time: the four corner texels of frame ts[f] (f32 or bf16 widened;
    rounded to bf16 first in the rounding mode) lerped in K3's order."""
    N, th, tw, F_all, C = tiles.shape
    tex = tiles.float()
    if round_bf16:
        tex = tex.to(torch.bfloat16).float()
    tex = tex.numpy()
    frames = range(F_all) if ts is None else [min(max(f, 0), F_all - 1)
                                              for f in ts]
    out = np.zeros(k.shape + (len(frames), C), F32)
    for idx in np.ndindex(k.shape):
        if k[idx] < 0:
            continue
        t = min(k[idx], N - 1)
        cs, _ = _corners(u[idx], v[idx], th, tw)
        uu = F32(min(max(u[idx], 0.0), tw - 1.0))
        vv = F32(min(max(v[idx], 0.0), th - 1.0))
        fu, fv = F32(uu - np.floor(uu)), F32(vv - np.floor(vv))
        for j, fr in enumerate(frames):
            c = [tex[t, vi, ui, fr] for vi, ui in cs]
            top = c[0] * (F32(1) - fu) + c[1] * fu
            bot = c[2] * (F32(1) - fu) + c[3] * fu
            out[idx + (j,)] = top * (F32(1) - fv) + bot * fv
    return out


@pytest.mark.parametrize("ts", [None, [3, 0, 9, 3]], ids=["all", "ts"])
@pytest.mark.parametrize("C", [4, 13])
def test_k3_f32_read_as_bf16(C, ts):
    """K3's rounding mode (f32 texels rounded to bf16 in registers) is bit
    for bit K3's samples of the bf16 copy and of the plain version at the
    bf16 gather dtype, all frames and a frame subset with a repeat and an
    index past the stack (clamped)."""
    _, _, k, u, v, _, tiles, _, _ = _tile_setup("edges", seed=C)
    N, th, tw = tiles.shape[:3]
    rng = np.random.default_rng(C)
    tex = torch.from_numpy(rng.standard_normal((N, th, tw, 6, C)).astype(F32))
    got = emulate_k3(tex, k, u, v, ts, True)
    copy = emulate_k3(tex.to(torch.bfloat16), k, u, v, ts, False)
    np.testing.assert_array_equal(got.view(np.int32), copy.view(np.int32))
    tts = None if ts is None else torch.tensor(np.clip(ts, 0, 5),
                                               dtype=torch.int32)
    tk, tu, tv = (torch.from_numpy(a) for a in (k, u, v))
    plain, _ = S.bilinear_tiles_tilemajor(tex, tk, tu, tv, tts,
                                          torch.bfloat16)
    np.testing.assert_array_equal(got, plain.numpy())


def test_sample_tiles_gathers_the_f32_atlas_as_bf16():
    """`sample_tiles(atlas_f32, ..., gather_dtype=bf16)` on 5-D tiles: the
    samples bit for bit those of the old ``atlas.to(bf16)`` input, the
    gradient an f32 tensor bit for bit the old chain's (the f32 sum
    rounded to bf16 and widened by the copy's backward), with the atlas
    itself the sampler's input (no copy in the graph); 4-D tiles the same
    way (K2's rounding mode and K9's rounding pass)."""
    _, _, k, u, v, _, tiles, _, _ = _tile_setup("partial", seed=4)
    N, th, tw = tiles.shape[:3]
    rng = np.random.default_rng(3)
    shape = (N, th, tw, 5, 4)
    tk, tu, tv = (torch.from_numpy(a) for a in (k, u, v))
    ct = torch.from_numpy(rng.standard_normal(k.shape + (5, 4)).astype(F32))
    atlas = torch.from_numpy(rng.standard_normal(shape).astype(F32))
    new = atlas.clone().requires_grad_(True)
    vals, _ = S.sample_tiles(new, tk, tu, tv, torch.bfloat16)
    assert vals.grad_fn.next_functions[0][0].variable is new
    (vals * ct).sum().backward()
    old = atlas.clone().requires_grad_(True)
    ovals, _ = S.sample_tiles(old.to(torch.bfloat16), tk, tu, tv)
    (ovals * ct).sum().backward()
    assert torch.equal(vals, ovals)
    assert new.grad.dtype == old.grad.dtype == torch.float32
    assert torch.equal(new.grad, old.grad)
    packed = atlas[..., 0, :].contiguous()
    new4 = packed.clone().requires_grad_(True)
    vals4, _ = S.sample_tiles(new4, tk, tu, tv, torch.bfloat16)
    assert vals4.grad_fn.next_functions[0][0].variable is new4
    (vals4 * ct[..., 0, :]).sum().backward()
    old4 = packed.clone().requires_grad_(True)
    ovals4, _ = S.sample_tiles(old4.to(torch.bfloat16), tk, tu, tv)
    (ovals4 * ct[..., 0, :]).sum().backward()
    assert torch.equal(vals4, ovals4)
    assert torch.equal(new4.grad, old4.grad)


@pytest.mark.parametrize("args,want", [
    # the shipped stage-2 patch at its slot bound: D = 15 slots of 180 x
    # 320 samples, 4,257 dynamic tiles of 12 x 12 texels, 50 frames
    ((15, 57600, 4257, 12, 12, 50, 4, 4), (2, 25, 128, 2)),
    ((29, 57600, 4257, 12, 12, 50, 4, 4), (2, 25, 128, 2)),
    ((15, 57600, 4257, 12, 12, 50, 13, 2), (11, 30, 128, 2)),
    ((15, 57600, 4257, 12, 12, 50, 36, 4), (17, 27, 128, 2)),
    # a tile past the accumulator budget takes one column a slice
    ((1, 100, 10, 64, 64, 50, 4, 4), (50, 1, 32, 1)),
    ((1, 1, 1, 2, 2, 1, 3, 1), (1, 3, 32, 1)),
    ((3, 5000, 70000, 6, 7, 6, 4, 4), (1, 6, 32, 3)),
])
def test_tiles_grad_layout(args, want):
    """The layout at the shipped shapes and at the limits: slices of at
    most 32 vectors, four parity classes a column, shared memory within an
    H100 block's (two blocks an SM at the shipped C = 4), the passes of
    the sentinel N, the scratch of bins.cuh."""
    lay = S.tiles_grad_layout(*args)
    assert (lay["nslices"], lay["slice_cols"], lay["threads"],
            lay["passes"]) == want
    assert lay["nslices"] * lay["slice_cols"] >= lay["ncols"]
    assert lay["smem"] <= S._SMEM_LIMIT
    if args[6] == 4 and args[3] == 12:
        assert 233472 // (lay["smem"] + 1024) >= 2
    D, n, N = args[:3]
    assert lay["scratch"] >= 4 * D * n * 4 + D * (N + 1) * 4
    assert S.tiles_grad_planes((15, 180, 320)) == 15
    assert S.tiles_grad_planes((200, 4)) == 1
    assert S.tiles_grad_planes((6,)) == 1
