"""K9 (the static tiles' gradient) as redesigned for the card, K2's
f32-read-as-bf16 mode and K9's rounding pass, emulated on the host (the
CUDA kernels of ``csrc/bilinear_tiles.cu`` and
``csrc/bilinear_tiles_tilemajor.cu`` do not run on the CPU), and
`sample_tiles` on the packed f32 atlas at the bf16 gather dtype.

K9 at C != 4 is K10's deterministic binned gather at F = 1
(`render/sample.py:static_grad_layout`): its emulation sorts each plane's
keys with bins.cuh's stable radix sort, walks each tile's bin in plane
order, and adds each sample's corners of each parity class in q order,
each product and sum rounded once in f32; it is held within 1e-6 *
max|g| of the plain version and of ``jax.vjp`` at C = 8, 13 and 36, and
its rounding mode is its f32 sums' ``.to(bfloat16).float()`` bit for bit.
The emulation of the atomic route below stays for C = 4 (the direct
decoder's route) and for the atomic route kept beside the gather.

K9's emulation follows the kernel per sample: k < 0 adds nothing, u and v
clamped, the four corner weights, and for every corner the C products
added kV at a time (kV of `render/sample.py:_vec_width`: 4 at C = 4 and
36, 1 at C = 13), the samples in a shuffled order (atomics add in no
fixed order).  It is held within 1e-6 * max|g| of the plain version and
of ``jax.vjp`` through the JAX package's ``make_tile_adjoint`` (4-D
tiles), and a ones cotangent with unit weights counts each (sample,
corner, channel) once.  The rounding pass is an f32 -> bf16 round to
nearest even on the bits, as ``__float2bfloat16_rn``: bit for bit
``.to(torch.bfloat16).float()`` on ties, infinities, NaNs and
subnormals, and the same bits when only the tiles that samples read
(the scatter's flags) are rounded.  K2's rounding mode (each f32 texel rounded to bf16 before the
lerps) is bit for bit K2's samples of the bf16 copy.  Through
`sample_tiles`, the f32 atlas at the bf16 gather dtype gives the old
chain's samples and gradient bits (``atlas.to(bf16)``, its backward's cast
and widening) with the atlas itself the sampler's input, and stays within
one bf16 step of JAX's ``astype(bfloat16)`` route.

K2 at C != 4 as redesigned for the card (bilinear_tiles_sweep_kernel)
is emulated in its order too: a block's samples' corners found once
(`render/sample.py:bilinear_tiles_layout`), then the block's outputs
swept four at a time, a thread's (sample, channel) stepped by a carry;
every output visited once and bit-equal to the plain version in the f32,
bf16 and f32-rounded-to-bf16 texel modes, within 1e-6 of JAX's
``bilinear_tiles``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_planes_grad import _radix_sort
from test_torch_stage1_sparse import _tile_setup
from test_torch_tiles_grad import _corners
from videoloop3d_tpu.render import adjoint as ADJ
from videoloop3d_tpu.render import sample as JS
from videoloop3d_torch.render import sample as S

F32 = np.float32


def emulate_k9(ct, k, u, v, shape, vec, seed=0, unit=False):
    """bilinear_tiles_grad_kernel<vec> on the host: (the (N, th, tw, C)
    f32 sums, the adds of each element).  The samples in a shuffled order
    (np.add.at adds one at a time in that order, each an f32 rounding);
    each corner's C products as C / vec vector adds.  unit: every weight
    1."""
    N, th, tw, C = shape
    grad = np.zeros((N, th, tw, C), F32)
    adds = np.zeros((N, th, tw, C), np.int64)
    order = np.random.default_rng(seed).permutation(k.size)
    kf, uf, vf = (a.reshape(-1)[order] for a in (k, u, v))
    cts = ct.reshape(-1, C)[order]
    sel = kf >= 0
    t = np.minimum(kf[sel], N - 1)
    uu = np.clip(np.nan_to_num(uf[sel], nan=0.0), 0, tw - 1).astype(F32)
    vv = np.clip(np.nan_to_num(vf[sel], nan=0.0), 0, th - 1).astype(F32)
    u0, v0 = np.floor(uu), np.floor(vv)
    fu, fv = (uu - u0).astype(F32), (vv - v0).astype(F32)
    u0i, v0i = u0.astype(np.int64), v0.astype(np.int64)
    u1i, v1i = np.minimum(u0i + 1, tw - 1), np.minimum(v0i + 1, th - 1)
    wu0, wv0 = F32(1) - fu, F32(1) - fv
    corners = ((v0i, u0i, wv0 * wu0), (v0i, u1i, wv0 * fu),
               (v1i, u0i, fv * wu0), (v1i, u1i, fv * fu))
    g = cts[sel]
    for c0 in range(0, C, vec):
        for vi, ui, w in corners:
            w = np.ones_like(w) if unit else w.astype(F32)
            np.add.at(grad[..., c0:c0 + vec], (t, vi, ui),
                      g[:, c0:c0 + vec] * w[:, None])
            np.add.at(adds[..., c0:c0 + vec], (t, vi, ui), 1)
    return grad, adds


def emulate_k9_gather(ct, k, u, v, shape, vec, round_bf16=False):
    """K9's gather at C != 4 on the host (tiles_grad_gather_kernel<kV, _,
    true>): (the (N, th, tw, C) f32 gradient, the writes of each element,
    the adds of each parity class's threads).  Each sample's key (its tile
    min(k, N - 1), the sentinel N where k < 0), the stable LSD radix sort
    of each plane, each tile's bin in plane order; for every sample its
    class mask (which of its corners q fall in each texel parity class),
    and each class's threads adding their corners in q order, each texel's
    sum in bin order then q (the only order a texel sees, its owner being
    one thread a column); every texel written once, rounded to bf16 in
    the rounding mode."""
    N, th, tw, C = shape
    T = th * tw
    D = S.tiles_grad_planes(k.shape)
    n = k.size // D
    lay = S.static_grad_layout(D, n, N, th, tw, C, vec)
    assert lay["nslices"] == 1 and lay["slice_cols"] * vec == C
    ks, us, vs = k.reshape(D, n), u.reshape(-1), v.reshape(-1)
    cts = ct.reshape(D * n, C)
    keys = np.where(ks < 0, N, np.minimum(ks, N - 1)).astype(np.uint32)
    perms, offs = [], []
    for d in range(D):
        skeys, perm = _radix_sort(keys[d], lay)
        perms.append(perm)
        offs.append(np.searchsorted(skeys, np.arange(lay["nk1"]), "left"))
    grad = np.full((N, T, C), np.nan, F32)
    writes = np.zeros((N, T, C), np.int64)
    by_class = np.zeros(4, np.int64)
    for t in range(N):
        entries = np.concatenate([d * n + perms[d][offs[d][t]:offs[d][t + 1]]
                                  for d in range(D)]).astype(np.int64)
        acc = np.zeros((T, C), F32)
        for s_ in entries:
            cs, ws = _corners(us[s_], vs[s_], th, tw)
            mask = 0
            for q, (vi, ui) in enumerate(cs):
                mask |= 1 << (4 * ((vi & 1) * 2 + (ui & 1)) + q)
            for g in range(4):
                cm = (mask >> (4 * g)) & 15
                for q in range(4):
                    if cm >> q & 1:
                        vi, ui = cs[q]
                        acc[vi * tw + ui] = acc[vi * tw + ui] \
                            + cts[s_] * F32(ws[q])
                        by_class[g] += 1
        if round_bf16 and len(entries):
            acc = round_bf16_bits(acc)
        grad[t] = acc
        writes[t] += 1
    return grad.reshape(shape), writes, by_class


def round_bf16_bits(x):
    """f32 -> bf16 (round to nearest, ties to even) -> f32 on the bits;
    NaNs stay NaN (quieted)."""
    b = x.astype(F32).view(np.uint32).astype(np.uint64)
    lsb = (b >> 16) & 1
    r = ((b + 0x7FFF + lsb) & 0xFFFF0000).astype(np.uint32)
    r = np.where(np.isnan(x), (b.astype(np.uint32) | 0x00400000)
                 & 0xFFFF0000, r)
    return r.astype(np.uint32).view(F32)


def emulate_k2(tiles, k, u, v, round_bf16):
    """bilinear_tiles_kernel<T, kRound> on the host, one sample at a time:
    the four corner texels (widened; rounded to bf16 first in the
    rounding mode) lerped in K2's order."""
    N, th, tw, C = tiles.shape
    tex = tiles.float()
    if round_bf16:
        tex = torch.from_numpy(round_bf16_bits(tex.numpy()))
    tex = tex.numpy()
    out = np.zeros(k.shape + (C,), F32)
    for idx in np.ndindex(k.shape):
        if k[idx] < 0:
            continue
        t = min(k[idx], N - 1)
        cs, _ = _corners(u[idx], v[idx], th, tw)
        uu = F32(min(max(u[idx], 0.0), tw - 1.0))
        vv = F32(min(max(v[idx], 0.0), th - 1.0))
        fu, fv = F32(uu - np.floor(uu)), F32(vv - np.floor(vv))
        c = [tex[t, vi, ui] for vi, ui in cs]
        top = c[0] * (F32(1) - fu) + c[1] * fu
        bot = c[2] * (F32(1) - fu) + c[3] * fu
        out[idx] = top * (F32(1) - fv) + bot * fv
    return out


def _jax_grad(case, tiles, ct, k, u, v, bf16=False):
    """jax.vjp through make_tile_adjoint on 4-D tiles (with the JAX
    model's ``astype(bfloat16)`` in front under bf16)."""
    geom, tile_map, _, _, _, M, _, _, hw = _tile_setup(case, seed=5)
    samp = ADJ.make_tile_adjoint(ADJ.tile_positions(tile_map),
                                 geom.tile_span,
                                 ADJ.tile_window_for(geom, hw))
    jk, ju, jv = (jnp.asarray(a) for a in (k, u, v))

    def f(t):
        return samp(t.astype(jnp.bfloat16) if bf16 else t, jk, ju, jv,
                    M)[0]
    vals, vjp = jax.vjp(f, jnp.asarray(tiles))
    return np.asarray(vals), np.asarray(vjp(jnp.asarray(ct))[0])


@pytest.mark.parametrize("case", ["partial", "edges", "oblique"])
@pytest.mark.parametrize("C", [4, 13, 36])
def test_k9_vector_atomics_emulated(C, case):
    """The atomic route's vector width (4 floats at C = 4, K9's route
    there, and at 36, 1 at 13: the route kept beside the gather); each
    (sample, corner, channel) added once, by one vector add, as often per
    element as the first design's scalar adds; the sums in shuffled order
    within 1e-6 * max|g| of the plain version and of jax.vjp through
    make_tile_adjoint."""
    _, _, k, u, v, _, tiles, _, _ = _tile_setup(case, seed=5)
    N, th, tw = tiles.shape[:3]
    shape = (N, th, tw, C)
    rng = np.random.default_rng(C)
    ct = rng.standard_normal(k.shape + (C,)).astype(F32)
    tct = torch.from_numpy(ct)
    grad = torch.zeros(shape)
    vec = S._vec_width(C, tct, grad)
    assert vec == (1 if C % 4 else 4)
    got, _ = emulate_k9(ct, k, u, v, shape, vec, seed=C)
    tk, tu, tv = (torch.from_numpy(a) for a in (k, u, v))
    plain = S.bilinear_tiles_grad_plain(tct, tk, tu, tv, shape).numpy()
    scale = np.abs(plain).max()
    assert scale > 0
    assert np.abs(got - plain).max() <= 1e-6 * scale
    _, jg = _jax_grad(case, np.zeros(shape, F32), ct, k, u, v)
    assert np.abs(got - jg).max() <= 1e-6 * np.abs(jg).max()
    ones, adds = emulate_k9(np.ones_like(ct), k, u, v, shape, vec,
                            unit=True)
    _, scalar_adds = emulate_k9(ct, k, u, v, shape, 1)
    np.testing.assert_array_equal(ones, adds.astype(F32))
    np.testing.assert_array_equal(adds, scalar_adds)
    assert adds.sum() == 4 * C * int((k >= 0).sum())


def test_k9_rounding_pass_bits():
    """The rounding pass's f32 -> bf16 -> f32 is bit for bit
    ``.to(torch.bfloat16).float()``: random sums, exact ties (even and
    odd), the largest finite values, infinities, subnormals, zeros of
    both signs; NaNs stay NaN.  The plain K9 at the bf16 gather dtype is
    its f32 sums so rounded, and so is the kernel's pass over the tiles
    its scatter flagged (the others are zeros)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096).astype(F32) * F32(3e3)
    bits = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    ties = (bits & 0xFFFF0000) | 0x8000
    special = np.array([0.0, -0.0, np.inf, -np.inf, 3.4028235e38,
                        -3.4028235e38, 1e-40, -1e-45, 1.17549435e-38],
                       F32)
    for a in (x, bits.view(F32), ties.view(F32), special):
        want = torch.from_numpy(a).to(torch.bfloat16).float().numpy()
        got = round_bf16_bits(a)
        nan = np.isnan(a)
        np.testing.assert_array_equal(np.isnan(got), nan)
        np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                      want[~nan].view(np.uint32))
    _, _, k, u, v, _, tiles, ct, _ = _tile_setup("partial", seed=5)
    tk, tu, tv, tct = (torch.from_numpy(a) for a in (k, u, v, ct))
    f32 = S.bilinear_tiles_grad(tct, tk, tu, tv, tiles.shape)
    rnd = S.bilinear_tiles_grad(tct, tk, tu, tv, tiles.shape,
                                torch.bfloat16)
    assert rnd.dtype == torch.float32
    np.testing.assert_array_equal(rnd.numpy().view(np.uint32),
                                  round_bf16_bits(f32.numpy()).view(
                                      np.uint32))
    # the kernel rounds only the tiles the scatter flagged (min(k, N - 1)
    # of the samples with k >= 0): the others hold zeros, which round to
    # themselves
    N = tiles.shape[0]
    flagged = np.zeros(N, bool)
    flagged[np.minimum(k[k >= 0], N - 1)] = True
    assert (~flagged).any() and not f32.numpy()[~flagged].any()
    part = f32.numpy().copy()
    part[flagged] = round_bf16_bits(part[flagged])
    np.testing.assert_array_equal(part.view(np.uint32),
                                  rnd.numpy().view(np.uint32))


@pytest.mark.parametrize("C", [4, 13])
@pytest.mark.parametrize("case", ["partial", "edges"])
def test_k2_f32_read_as_bf16(case, C):
    """K2's rounding mode is bit for bit K2's samples of the bf16 copy and
    of the plain version at the bf16 gather dtype (clamped edges, k < 0)."""
    _, _, k, u, v, _, tiles, _, _ = _tile_setup(case, seed=C)
    N, th, tw = tiles.shape[:3]
    tex = torch.from_numpy(np.random.default_rng(C).standard_normal(
        (N, th, tw, C)).astype(F32))
    got = emulate_k2(tex, k, u, v, True)
    copy = emulate_k2(tex.to(torch.bfloat16), k, u, v, False)
    np.testing.assert_array_equal(got.view(np.int32), copy.view(np.int32))
    tk, tu, tv = (torch.from_numpy(a) for a in (k, u, v))
    plain, _ = S.bilinear_tiles(tex, tk, tu, tv, torch.bfloat16)
    np.testing.assert_array_equal(got, plain.numpy())


@pytest.mark.parametrize("case", ["partial", "oblique"])
def test_sample_tiles_static_atlas_as_bf16(case):
    """`sample_tiles(atlas_f32, ..., gather_dtype=bf16)` on packed 4-D
    tiles: the samples bit for bit those of ``atlas.to(bf16)``, the
    gradient an f32 tensor bit for bit the old chain's (the f32 sum
    rounded to bf16 and widened by the copy's backward), the atlas itself
    the sampler's input; the samples within 1e-6 and the gradient within
    one bf16 step (the sums' order differs) of JAX's route, the astype
    to bf16 of mpv.py:284 in front of make_tile_adjoint."""
    _, _, k, u, v, _, tiles, ct, _ = _tile_setup(case, seed=5)
    tk, tu, tv, tct = (torch.from_numpy(a) for a in (k, u, v, ct))
    atlas = torch.from_numpy(tiles) * 3.0
    new = atlas.clone().requires_grad_(True)
    vals, _ = S.sample_tiles(new, tk, tu, tv, torch.bfloat16)
    assert vals.grad_fn.next_functions[0][0].variable is new
    (vals * tct).sum().backward()
    old = atlas.clone().requires_grad_(True)
    ovals, _ = S.sample_tiles(old.to(torch.bfloat16), tk, tu, tv)
    (ovals * tct).sum().backward()
    assert torch.equal(vals, ovals)
    assert new.grad.dtype == old.grad.dtype == torch.float32
    assert torch.equal(new.grad, old.grad)
    jvals, jg = _jax_grad(case, atlas.numpy(), ct, k, u, v, bf16=True)
    np.testing.assert_allclose(vals.detach().numpy(), jvals, rtol=0,
                               atol=1e-6)
    g = new.grad.numpy()
    mag = np.maximum(np.abs(g), np.abs(jg))
    step = np.ldexp(np.ones_like(mag), np.frexp(mag)[1] - 8)
    assert (np.abs(g - jg) <= step).all()


@pytest.mark.parametrize("case", ["partial", "edges", "oblique"])
@pytest.mark.parametrize("C", [8, 13, 36])
def test_k9_binned_gather_emulated(C, case):
    """K9 at C != 4, emulated in the gather's order: every texel written
    once, zeros included (zero where the plain version's sum is), each
    (sample, corner) added once by one class, within 1e-6 * max|g| of the
    plain version and of jax.vjp through make_tile_adjoint, on the sparse
    geometry of tests/test_torch_stage1_sparse.py (partial culling,
    samples clamped at the tile edges, an oblique view); in the rounding
    mode the f32 sums rounded to bf16 bit for bit, and the plain version's
    rounding within one bf16 step of it."""
    _, _, k, u, v, _, tiles, _, _ = _tile_setup(case, seed=5)
    N, th, tw = tiles.shape[:3]
    shape = (N, th, tw, C)
    rng = np.random.default_rng(C)
    ct = rng.standard_normal(k.shape + (C,)).astype(F32)
    vec = S._vec_width(C, torch.from_numpy(ct))
    got, writes, by_class = emulate_k9_gather(ct, k, u, v, shape, vec)
    assert (writes == 1).all()
    assert by_class.sum() == 4 * int((k >= 0).sum())
    tk, tu, tv, tct = (torch.from_numpy(a) for a in (k, u, v, ct))
    plain = S.bilinear_tiles_grad_plain(tct, tk, tu, tv, shape).numpy()
    scale = np.abs(plain).max()
    assert scale > 0 and (plain == 0).any()
    assert np.abs(got - plain).max() <= 1e-6 * scale
    assert (got[plain == 0] == 0).all()
    if case == "partial":
        _, jg = _jax_grad(case, np.zeros(shape, F32), ct, k, u, v)
        assert np.abs(got - jg).max() <= 1e-6 * np.abs(jg).max()
    rnd, _, _ = emulate_k9_gather(ct, k, u, v, shape, vec, round_bf16=True)
    want = torch.from_numpy(got).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(rnd.view(np.uint32), want.view(np.uint32))
    pr = S.bilinear_tiles_grad(tct, tk, tu, tv, shape, torch.bfloat16).numpy()
    mag = np.maximum(np.abs(pr), np.abs(rnd))
    step = np.ldexp(np.ones_like(mag), np.frexp(mag)[1] - 8)
    assert (np.abs(pr - rnd) <= step).all()


@pytest.mark.parametrize("args,want", [
    # phase 38's static atlas at the shipped patch's slot bound: D = 15
    # slots of 180 x 320 samples, 9,786 tiles of 12 x 12 texels
    ((15, 57600, 9786, 12, 12, 13, 1), (13, 64, 13760, 4)),
    ((15, 57600, 9786, 12, 12, 36, 4), (9, 64, 32896, 4)),
    ((15, 57600, 9786, 12, 12, 8, 4), (2, 32, 9600, 4)),
    # the stage-1 sparse route: one plane of all samples
    ((1, 1843200, 14112, 16, 16, 13, 1), (13, 64, 19472, 4)),
    # odd tiles: a tile's floats not a multiple of 4
    ((3, 5000, 70, 5, 7, 13, 1), (13, 64, 8000, 1)),
])
def test_static_grad_layout(args, want):
    """K9's layout at C != 4 (mirrored by the kernel's
    vl3d_static_grad_layout, checked on the card): K10's at F = 1, its
    shared memory grown by a batch's class masks, the empty tiles' zero
    fill in float4 where a tile's floats allow."""
    D, n, N, th, tw, C, vec = args
    lay = S.static_grad_layout(*args)
    base = S.tiles_grad_layout(D, n, N, th, tw, 1, C, vec)
    assert (lay["slice_cols"], lay["threads"], lay["smem"],
            lay["zero_vec"]) == want
    assert lay["smem"] == base["smem"] + 4 * 64 <= S._SMEM_LIMIT
    assert {k: lay[k] for k in base if k != "smem"} == {
        k: base[k] for k in base if k != "smem"}
    assert tuple(lay) == S.STATIC_GRAD_LAYOUT_KEYS
    assert lay["nslices"] == 1 and lay["threads"] >= 4 * lay["slice_cols"]


def _k2_sweep(count, C, threads):
    """The (output, sample, channel) triples of one block's sweep over its
    count x C outputs, as bilinear_tiles_sweep_kernel's threads visit
    them: thread t starts at output 4 t (its one division), takes the four
    outputs from there channel by channel (the sample advancing where the
    channel wraps), and steps by 4 x threads outputs with a carry."""
    step = 4 * threads
    ds, dk = divmod(step, C)
    total = count * C
    o = 4 * np.arange(threads)
    s, c = np.divmod(o, C)
    visits = []
    while (o < total).any():
        ss, cc = s.copy(), c.copy()
        for e in range(4):
            live = o + e < total
            visits.append(np.stack([o[live] + e, ss[live], cc[live]], 1))
            cc = cc + 1
            ss = np.where(cc == C, ss + 1, ss)
            cc = np.where(cc == C, 0, cc)
        o = o + step
        s, c = s + ds, c + dk
        s = np.where(c >= C, s + 1, s)
        c = np.where(c >= C, c - C, c)
    return np.concatenate(visits)


def emulate_k2_sweep(tex, k, u, v):
    """bilinear_tiles_sweep_kernel on the host, tex the (N, th, tw, C) f32
    texels as the kernel widens (and, in the rounding mode, rounds) them:
    per sample its four corners' element offsets at channel 0 (-1 for a
    miss) and fu, fv; per block of `bilinear_tiles_layout` samples the
    sweep of its outputs, each the three f32 lerps of the four texels at
    its channel, a miss zero.  Returns (values (n, C), visits of each
    output)."""
    N, th, tw, C = tex.shape
    n = k.size
    lay = S.bilinear_tiles_layout(n, C)
    hit = k >= 0
    tile = np.minimum(k, N - 1)
    uu = np.fmin(np.fmax(np.where(hit, u, 0), F32(0)), F32(tw - 1))
    vv = np.fmin(np.fmax(np.where(hit, v, 0), F32(0)), F32(th - 1))
    u0, v0 = np.floor(uu), np.floor(vv)
    fu, fv = (uu - u0).astype(F32), (vv - v0).astype(F32)
    u0i, v0i = u0.astype(np.int64), v0.astype(np.int64)
    u1i, v1i = np.minimum(u0i + 1, tw - 1), np.minimum(v0i + 1, th - 1)
    r0, r1 = (tile * th + v0i) * tw, (tile * th + v1i) * tw
    q = np.stack([(r0 + u0i) * C, (r0 + u1i) * C, (r1 + u0i) * C,
                  (r1 + u1i) * C], 1)
    q[~hit, 0] = -1
    flat = tex.reshape(-1)
    out = np.full((n, C), np.nan, F32)
    visits = np.zeros((n, C), np.int64)
    sweeps = {}
    for first in range(0, n, lay["samples"]):
        count = min(lay["samples"], n - first)
        if count not in sweeps:
            sweeps[count] = _k2_sweep(count, C, lay["threads"])
        o, s, c = sweeps[count].T
        assert np.array_equal(o, s * C + c)
        s = s + first
        miss = q[s, 0] < 0

        def texel(j):
            return flat[np.where(miss, 0, q[s, j] + c)]
        top = _lerp(texel(0), texel(1), fu[s])
        bot = _lerp(texel(2), texel(3), fu[s])
        out[s, c] = np.where(miss, F32(0), _lerp(top, bot, fv[s]))
        np.add.at(visits, (s, c), 1)
    return out, visits


def _lerp(a, b, f):
    """csrc/common.cuh lerp_rn in f32, one rounding per operation."""
    return a * (F32(1) - f) + b * f


@pytest.mark.parametrize("mode", ["f32", "bf16", "f32_as_bf16"])
@pytest.mark.parametrize("C", [1, 2, 3, 5, 8, 12, 13, 36, 37])
def test_bilinear_tiles_sweep_emulated(C, mode):
    """K2's redesign at C != 4 emulated on the host (corners once per
    sample, each block's outputs swept in output order; about 10.7
    blocks of samples) with misses (their coordinates NaN), k past the
    last tile (clamped), coordinates below 0 and beyond tw - 1 / th - 1,
    whole numbers and the tile's last texel: every output visited once,
    bit-equal to the plain version in each texel mode (f32; bf16; f32
    texels rounded to bf16 before the lerps) and, in f32, within 1e-6 of
    JAX's bilinear_tiles on the same numpy inputs (k clamped for both:
    the plain version and JAX index k as it is; JAX's misses at u = v =
    0, since it multiplies their lerps by 0)."""
    rng = np.random.default_rng(100 + C)
    N, th, tw = 29, 12, 12
    n = int(10.7 * S.bilinear_tiles_layout(1, C)["samples"])
    tiles = rng.standard_normal((N, th, tw, C)).astype(F32)
    k = rng.integers(-1, N, n).astype(np.int32)
    u = rng.uniform(-0.5, tw - 0.5, n).astype(F32)
    v = rng.uniform(-0.5, th - 0.5, n).astype(F32)
    k[::53] = N + 3
    u[1::7], v[2::7] = -2.5, -0.75
    u[3::7], v[4::7] = tw + 1.5, th + 0.25
    u[5::11], v[5::11] = np.floor(u[5::11]), np.floor(v[5::11])
    u[6::13], v[6::13] = tw - 1, th - 1
    u[k < 0], v[k < 0] = np.nan, np.nan
    assert (k < 0).sum() > 50 and (k >= N).sum() > 10
    tt = torch.from_numpy(tiles)
    if mode == "f32":
        src, gather, tex = tt, None, tiles
    elif mode == "bf16":
        src, gather = tt.to(torch.bfloat16), None
        tex = src.float().numpy()
    else:
        src, gather, tex = tt, torch.bfloat16, round_bf16_bits(tiles)
    got, visits = emulate_k2_sweep(tex, k, u, v)
    assert (visits == 1).all()
    kc = np.minimum(k, N - 1)
    tk, tu, tv = (torch.from_numpy(a) for a in (kc, u, v))
    plain, valid = S.bilinear_tiles(src, tk, tu, tv, gather)
    np.testing.assert_array_equal(got.view(np.int32),
                                  plain.numpy().view(np.int32))
    assert not got[k < 0].any() and valid.numpy().sum() == (k >= 0).sum()
    if mode == "f32":
        # JAX multiplies a miss's lerps by 0: finite coordinates there
        ju, jv_ = (jnp.asarray(np.where(k < 0, F32(0), a)) for a in (u, v))
        jv, _ = JS.bilinear_tiles(jnp.asarray(tiles), jnp.asarray(kc), ju,
                                  jv_)
        np.testing.assert_allclose(got, np.asarray(jv), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,C,want", [
    # phase 38's static atlas at the shipped patch's 15 slots
    (864000, 13, (256, 3375, 256, 6144)),
    (864000, 36, (256, 3375, 256, 6144)),
    (864000, 8, (256, 3375, 256, 6144)),
    # the sparse stage-1 route: 32 planes of a 180 x 320 patch
    (1843200, 13, (256, 7200, 256, 6144)),
    # a float4 of outputs a thread where C < 4
    (1000, 1, (1024, 1, 256, 24576)),
    (1025, 2, (512, 3, 256, 12288)),
    (513, 3, (512, 2, 256, 12288)),
    (0, 37, (256, 0, 256, 6144)),
    (7, 1024, (256, 1, 256, 6144)),
])
def test_bilinear_tiles_layout(n, C, want):
    """K2's layout at C != 4 (mirrored by the kernel's
    vl3d_bilinear_tiles_layout, checked on the card): 256 samples a block,
    or 512 / 1024 at C < 4; 24 shared bytes a sample; its limits raise."""
    lay = S.bilinear_tiles_layout(n, C)
    assert tuple(lay) == S.BILINEAR_TILES_LAYOUT_KEYS
    assert tuple(lay.values()) == want
    assert lay["samples"] % 4 == 0 and lay["samples"] * C >= 4 * 256


@pytest.mark.parametrize("n,C", [(10, 0), (10, 1025), (-1, 13),
                                 (256 * 2 ** 31, 13)])
def test_bilinear_tiles_layout_limits(n, C):
    with pytest.raises(ValueError, match="bilinear_tiles_layout"):
        S.bilinear_tiles_layout(n, C)
