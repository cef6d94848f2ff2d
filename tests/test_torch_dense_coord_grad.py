"""K22 at C != 4 (the dense sampler's coordinate gradient for the SH and
NeX decoders) as redesigned for the card, emulated on the host (the CUDA
kernel of ``csrc/sample_dense.cu`` does not run on the CPU).

coord_grad_staged_kernel is emulated in its order: each warp of a block
takes 32 consecutive samples; lane t finds sample t's corners once (the
texel of corner (x0, y0), the four in-texture bits, fx, fy) and the
loop-mask channel's terms; the warp sweeps its samples' (sample, four
channels) items in output order, a lane's items stepped by a carry (two
items a lane at a time on the vector route, where C % 4 == 0; one on the
scalar route, a sample's last item holding C % 4 channels), in passes of
`render/sample.py:dense_coord_grad_layout`'s chunk of channels; each
channel's g_c and its two terms go to three planes of shared memory at a
sample stride of 33 words, every entry written once a pass before any is
read; lane t then runs its sample's chain in channel order and the
mask's term last.  Out-of-texture corners read zero, and their texels are
never read.  The result equals the first design's per-sample order bit for
bit (each FMA emulated in float64 and rounded once to f32), in f32 and in
bf16 texels widened, with samples on texel lines, on the rim, outside the
plane and at NaN coordinates; and is within 1e-5 * max|g| of ``jax.grad``
of the JAX package's ``bilinear_planes``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoloop3d_tpu.render import sample as JS
from videoloop3d_torch.render import sample as S

F32 = np.float32
GROUP = S.COORD_GRAD_GROUP
LD = GROUP + 1


def _fma(a, b, c):
    """fmaf on f32 values: the product exact in float64, the sum rounded
    once to f32 (through float64, whose extra rounding changes an f32
    result only at an exact f32 tie, which these inputs never meet)."""
    return F32(np.float64(a) * np.float64(b) + np.float64(c))


def _terms(v00, v01, v10, v11, fx, fy):
    """coord_terms: the x and y terms of one channel, the first design's
    contraction, each other operation rounded once in f32."""
    wx0, wy0 = F32(1) - fx, F32(1) - fy
    dx = _fma(wy0, F32(v01 - v00), F32(fy * F32(v11 - v10)))
    dy = _fma(wx0, F32(v10 - v00), F32(fx * F32(v11 - v01)))
    return dx, dy


def _corners(x, y, Ht, Wt):
    """corners_of: (x0, y0, fx, fy, the four in-texture bits)."""
    xf, yf = np.floor(x), np.floor(y)
    fx, fy = F32(x - xf), F32(y - yf)
    # fmaxf/fminf: a NaN yields the other operand
    x0 = int(np.fmin(np.fmax(xf, F32(-2)), F32(Wt)))
    y0 = int(np.fmin(np.fmax(yf, F32(-2)), F32(Ht)))
    xin = (0 <= x0 < Wt, 0 <= x0 + 1 < Wt)
    yin = (0 <= y0 < Ht, 0 <= y0 + 1 < Ht)
    bits = [xin[0] and yin[0], xin[1] and yin[0], xin[0] and yin[1],
            xin[1] and yin[1]]
    return x0, y0, fx, fy, bits


class _Texels:
    """The atlas read as the kernels read it: flat (D Ht Wt C) elements,
    an out-of-texture corner zero without a read."""

    def __init__(self, atlas):
        self.flat = atlas.reshape(-1)
        self.C = atlas.shape[-1]

    def corner(self, row, on, k):
        return self.flat[row * self.C + k] if on else F32(0)


def first_design(atlas, mask, g, gm, x, y):
    """sample_dense_coord_grad_kernel on the host: one sample a thread,
    its channels in order, the mask's term last.  Returns (gx, gy)."""
    D, Ht, Wt, C = atlas.shape
    P = x.shape[2] * x.shape[3]
    xs, ys = x.reshape(-1), y.reshape(-1)
    tex = _Texels(atlas)
    mtex = None if mask is None else _Texels(mask)
    n = xs.size
    gx, gy = np.zeros(n, F32), np.zeros(n, F32)
    for idx in range(n):
        d = (idx // P) % D
        x0, y0, fx, fy, on = _corners(xs[idx], ys[idx], Ht, Wt)
        row0 = (d * Ht + y0) * Wt + x0
        rows = (row0, row0 + 1, row0 + Wt, row0 + Wt + 1)
        sx = sy = F32(0)
        for k in range(C):
            v = [tex.corner(r, b, k) for r, b in zip(rows, on)]
            dx, dy = _terms(*v, fx, fy)
            sx, sy = _fma(g[idx, k], dx, sx), _fma(g[idx, k], dy, sy)
        if mtex is not None:
            v = [mtex.corner(r, b, 0) for r, b in zip(rows, on)]
            dx, dy = _terms(*v, fx, fy)
            sx, sy = _fma(gm[idx], dx, sx), _fma(gm[idx], dy, sy)
        gx[idx], gy[idx] = sx, sy
    return gx, gy


def emulate_staged(atlas, mask, g, gm, x, y, vec):
    """coord_grad_staged_kernel on the host, warp by warp in its order
    (see the module docstring); `vec`: the vector route's two items a
    lane.  Returns (gx, gy) and the layout.  Fails on a read of an entry
    of shared memory not written in the same pass, on an entry written
    twice, and on an output written other than once."""
    D, Ht, Wt, C = atlas.shape
    P = x.shape[2] * x.shape[3]
    xs, ys = x.reshape(-1), y.reshape(-1)
    n = xs.size
    lay = S.dense_coord_grad_layout(n, C, D, Ht, Wt)
    chunk, threads = lay["chunk"], lay["threads"]
    kU = 2 if vec else 1
    flat = atlas.reshape(-1)
    mflat = None if mask is None else mask.reshape(-1)
    gx, gy = np.full(n, np.nan, F32), np.full(n, np.nan, F32)
    writes = np.zeros(n, np.int64)
    for b in range(lay["blocks"]):
        for w in range(threads // GROUP):
            first = b * threads + w * GROUP
            if first >= n:
                continue
            count = min(GROUP, n - first)
            slot, mterm = [], []
            for t in range(count):
                idx = first + t
                d = (idx // P) % D
                x0, y0, fx, fy, on = _corners(xs[idx], ys[idx], Ht, Wt)
                row0 = (d * Ht + y0) * Wt + x0
                slot.append((row0, on, fx, fy))
                if mflat is not None:
                    rows = (row0, row0 + 1, row0 + Wt, row0 + Wt + 1)
                    v = [mflat[r] if o else F32(0) for r, o in zip(rows, on)]
                    mterm.append((gm[idx],) + _terms(*v, fx, fy))
            sx, sy = np.zeros(count, F32), np.zeros(count, F32)
            for c0 in range(0, C, chunk):
                kc = min(chunk, C - c0)
                cv = -(-kc // 4)
                total = count * cv
                ds, dq = GROUP // cv, GROUP - (GROUP // cv) * cv
                stage = np.full((3, chunk * LD), np.nan, F32)
                wrote = np.zeros(chunk * LD, np.int64)
                for t in range(GROUP):
                    s, q = t // cv, t % cv
                    for o in range(t, total, kU * GROUP):
                        for u in range(kU):
                            if o + u * GROUP < total:
                                row0, on, fx, fy = slot[s]
                                k0 = c0 + 4 * q
                                nk = min(4, C - k0)
                                if vec:
                                    assert nk == 4
                                base = row0 * C + k0
                                offs = (0, C, Wt * C, Wt * C + C)
                                for j in range(nk):
                                    v = [flat[base + f + j] if b_ else F32(0)
                                         for f, b_ in zip(offs, on)]
                                    dx, dy = _terms(*v, fx, fy)
                                    e = (4 * q + j) * LD + s
                                    stage[:, e] = (g[first + s, k0 + j], dx,
                                                   dy)
                                    wrote[e] += 1
                            q += dq
                            s += ds
                            if q >= cv:
                                q -= cv
                                s += 1
                assert wrote.max() == 1
                for t in range(count):
                    for k in range(kc):
                        e = k * LD + t
                        assert wrote[e] == 1
                        gk = stage[0, e]
                        sx[t] = _fma(gk, stage[1, e], sx[t])
                        sy[t] = _fma(gk, stage[2, e], sy[t])
            for t in range(count):
                if mterm:
                    m, dx, dy = mterm[t]
                    sx[t], sy[t] = _fma(m, dx, sx[t]), _fma(m, dy, sy[t])
                gx[first + t], gy[first + t] = sx[t], sy[t]
                writes[first + t] += 1
    assert (writes == 1).all()
    return gx, gy, lay


def _case(C, bf16, seed, B=1, D=3, h=7, w=13, Ht=9, Wt=11):
    """An atlas (f32, or rounded to bf16 and widened), the loop-mask
    atlas, cotangents and coordinates with samples on texel columns and
    rows, on the rim (x = 0, Wt - 1), outside the plane on each side,
    far off and NaN."""
    rng = np.random.default_rng(seed)
    atlas = rng.standard_normal((D, Ht, Wt, C)).astype(F32)
    mask = rng.standard_normal((D, Ht, Wt, 1)).astype(F32)
    if bf16:
        atlas, mask = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                       for a in (atlas, mask))
    x = rng.uniform(-2.5, Wt + 1.5, (B, D, h, w)).astype(F32)
    y = rng.uniform(-2.5, Ht + 1.5, (B, D, h, w)).astype(F32)
    x[:, :, 0] = np.round(x[:, :, 0])             # on texel columns
    y[:, :, 1] = np.round(y[:, :, 1])             # on texel rows
    x[:, :, 2, :3] = [0.0, Wt - 1.0, -1.0]        # the rim and just off it
    y[:, :, 3, :2] = [Ht - 1.0, -0.5]
    x[:, :, 4, :1] = 1e9                          # far off the plane
    x[:, :, 5, :1] = np.nan
    n = B * D * h * w
    g = rng.standard_normal((n, C)).astype(F32)
    gm = rng.standard_normal(n).astype(F32)
    return atlas, mask, g, gm, x, y


@pytest.mark.parametrize("mask", [False, True], ids=["rgba", "loop_mask"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("C", [1, 3, 8, 13, 17, 36, 37])
def test_staged_coord_grad_emulated(C, bf16, mask):
    """The staged kernel's order (vector route where C % 4 == 0, scalar
    otherwise; passes of 16 channels past C = 16) emulated on the host:
    bit for bit the first design's per-sample order, and within 1e-5 *
    max|g| of jax.grad of bilinear_planes (the mask as JAX's channel C)
    and of K22's plain version."""
    atlas, amask, g, gm, x, y = _case(C, bf16, 100 + C)
    m, cm = (amask, gm) if mask else (None, None)
    gx, gy, lay = emulate_staged(atlas, m, g, gm if mask else None, x, y,
                                 vec=C % 4 == 0)
    assert lay["chunk"] == min(C, 16)
    fx, fy = first_design(atlas, m, g, cm, x, y)
    np.testing.assert_array_equal(gx.view(np.int32), fx.view(np.int32))
    np.testing.assert_array_equal(gy.view(np.int32), fy.view(np.int32))
    B, D, h, w = x.shape
    tex = np.concatenate([atlas, amask], -1) if mask else atlas
    ct = (np.concatenate([g, gm[:, None]], -1) if mask else g).reshape(
        B, D, h * w, -1)
    ok = np.isfinite(x).reshape(B, D, h * w)

    def jf(xx, yy):
        vals = jnp.stack([JS.bilinear_planes(jnp.asarray(tex),
                                             xx[b].reshape(D, -1),
                                             yy[b].reshape(D, -1))[0]
                          for b in range(B)])
        return jnp.sum(vals * ct)
    jgx, jgy = (np.asarray(a).reshape(B, D, h * w) for a in jax.grad(
        jf, (0, 1))(jnp.asarray(x), jnp.asarray(y)))
    t = [torch.from_numpy(a) for a in (atlas, amask, x, y)]
    pgx, pgy = S.sample_dense_coord_grad(
        torch.from_numpy(g).view(B, D, h, w, C),
        torch.from_numpy(gm).view(B, D, h, w, 1) if mask else None,
        t[0], t[1] if mask else None, t[2], t[3])
    for got, ref, plain in ((gx, jgx, pgx), (gy, jgy, pgy)):
        got = got.reshape(B, D, h * w)
        scale = np.abs(ref[ok]).max()
        assert scale > 0
        assert np.abs(got[ok] - ref[ok]).max() <= 1e-5 * scale
        plain = plain.numpy().reshape(B, D, h * w)
        assert np.abs(got[ok] - plain[ok]).max() <= 1e-5 * scale
        # at a NaN x every corner is outside: g_x is 0 and g_y NaN, as in
        # the plain version
        np.testing.assert_array_equal(np.isnan(got), np.isnan(plain))
    assert np.isnan(gy.reshape(B, D, h * w)[~ok]).all()
    assert not gx.reshape(B, D, h * w)[~ok].any()


def test_staged_coord_grad_reads_no_outside_texel():
    """A sample whose corners all lie outside the plane reads no texel: an
    atlas of NaN gives 0 there (every corner zeroed), and the samples of
    a fully outside warp read nothing."""
    atlas, amask, g, gm, x, y = _case(8, False, 7, w=16)
    x[...] = -5.0
    x[0, 0, 0, :4] = 3.25
    y[0, 0, 0, :4] = 2.5
    atlas[...] = np.nan
    gx, gy, _ = emulate_staged(atlas, amask, g, gm, x, y, vec=True)
    outside = np.ones(x.size, bool)
    outside[:4] = False
    assert not gx[outside].any() and not gy[outside].any()
    assert np.isnan(gx[:4]).all()


@pytest.mark.parametrize("n,C,want", [
    # phase 37: 32 planes x 180 x 320 samples of the 576 x 1024 atlas
    (1843200, 13, (256, 7200, 256, 13, 45280)),
    (1843200, 36, (256, 7200, 256, 16, 54784)),
    (1843200, 8, (256, 7200, 256, 8, 29440)),
    (1843200, 5, (256, 7200, 256, 5, 19936)),
    (1843200, 1, (256, 7200, 256, 1, 7264)),
    (1843200, 1024, (256, 7200, 256, 16, 54784)),
    (257, 13, (256, 2, 256, 13, 45280)),
    (0, 36, (256, 0, 256, 16, 54784)),
])
def test_dense_coord_grad_layout(n, C, want):
    """K22's staged layout (mirrored by the kernel's
    vl3d_sample_dense_coord_grad_layout, checked on the card): 256
    samples a block, passes of at most 16 channels, the shared memory of
    the slots and each warp's three planes, within the card's 227 KB a
    block (232,448 bytes) and, at 16 channels, three blocks an SM."""
    lay = S.dense_coord_grad_layout(n, C, 32, 576, 1024)
    assert tuple(lay) == S.DENSE_COORD_GRAD_LAYOUT_KEYS
    assert tuple(lay.values()) == want
    assert lay["smem"] == 16 * 256 + 8 * 12 * lay["chunk"] * 33 <= 232448
    assert 3 * lay["smem"] <= 228 * 1024


@pytest.mark.parametrize("n,C,D,Ht,Wt", [
    (10, 0, 1, 4, 4), (10, 1025, 1, 4, 4), (-1, 13, 1, 4, 4),
    (10, 13, 2048, 1024, 1024), (10, 13, 1, 2 ** 31 - 2, 1),
    (256 * 2 ** 31, 13, 1, 4, 4)])
def test_dense_coord_grad_layout_limits(n, C, D, Ht, Wt):
    with pytest.raises(ValueError, match="dense_coord_grad_layout"):
        S.dense_coord_grad_layout(n, C, D, Ht, Wt)


@pytest.mark.parametrize("C,dtype,staged", [
    (4, torch.float32, False), (4, torch.bfloat16, False),
    (13, torch.float32, True), (13, torch.bfloat16, False),
    (36, torch.float32, True), (36, torch.bfloat16, True),
    (8, torch.bfloat16, True), (37, torch.bfloat16, False)])
def test_dense_coord_grad_route(C, dtype, staged):
    """K22 runs its staged kernel everywhere but at C = 4 and on bf16
    texels at C % 4 != 0, where the first design stays."""
    assert S.dense_coord_grad_staged(C, dtype) == staged


def test_dense_coord_grad_wrapper_checks_layout_on_cuda_only():
    """On CPU tensors K22 runs its plain version at any channel count; the
    layout's limits bind the card's launch only (1,025 channels here)."""
    C = 1025
    atlas = torch.ones((1, 3, 3, C))
    x = torch.full((1, 1, 2, 2), 0.5)
    g = torch.ones((1, 1, 2, 2, C))
    gx, gy = S.sample_dense_coord_grad(g, None, atlas, None, x, x)
    assert tuple(gx.shape) == (1, 1, 2, 2) and not gx.any() and not gy.any()
