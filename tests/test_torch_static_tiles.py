"""K9 (the static tiles' gradient) as redesigned for the card, K2's
f32-read-as-bf16 mode and K9's rounding pass, emulated on the host (the
CUDA kernels of ``csrc/bilinear_tiles.cu`` do not run on the CPU), and
`sample_tiles` on the packed f32 atlas at the bf16 gather dtype.

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
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_stage1_sparse import _tile_setup
from test_torch_tiles_grad import _corners
from videoloop3d_tpu.render import adjoint as ADJ
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
    """The vector width of the kernel (4 floats at C = 4 and 36, 1 at
    13); each (sample, corner, channel) added once, by one vector add, as
    often per element as the first design's scalar adds; the sums in
    shuffled order within 1e-6 * max|g| of the plain version and of
    jax.vjp through make_tile_adjoint."""
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
