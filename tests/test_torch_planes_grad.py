"""K16 and K17 as redesigned for the card, emulated on the host from the
layout of ``render/sample.py`` (the CUDA kernels of
``csrc/bilinear_planes_tilemajor.cu`` do not run on the CPU), and the
dense sampler's gather-dtype semantics on the CPU.

K17's emulation follows the kernel step by step: each sample's bin key
(the texel tile of its top-left corner on the grid extended by one tile
row and column, times 4 plus its edge class), the stable LSD radix sort a
plane (8-bit digits; per-tile digit counts, their digit-major scan, the
scatter in index order), the key offsets, and for every (plane, texel
tile, slice of the F x C row) its own bin and the three halo ranges, the
decoded corners and weights, the accumulation in the kernel's order
(each product and sum rounded once in f32) and the write of every texel,
zeros included.  It is held to the plain version within 1e-6 * max|g| on
coordinates that cross and land on every plane edge and lie far off, on
planes whose sides are not multiples of the tile, at C = 4 and 13 and F = 6
and 50; a ones cotangent with unit weights counts each in-plane (sample,
corner) exactly once.  K16's emulation sweeps a block's (sample, frame,
vector) outputs in the kernel's order and equals the plain version bit
for bit, with the frame subset and with f32 texels rounded to bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_stage2_dense import _edge_coords
from videoloop3d_tpu.render import sample as JS
from videoloop3d_torch.render import sample as S

SWEEP_THREADS = 256     # csrc/bilinear_planes_tilemajor.cu:kSweepThreads
SORT_THREADS = 256      # :kSortThreads; a sort block ranks rounds of these


def _corner0(v, size):
    """corner0 of the kernel in f32: floor, fraction, the floor clamped in
    float to [-2, size] (NaN-ignoring, as fminf/fmaxf) and converted."""
    v0 = np.floor(v)
    frac = (v - v0).astype(np.float32)
    return np.fmin(np.fmax(v0, -2.0), float(size)).astype(np.int64), frac


def _bin_keys(x, y, lay, Ht, Wt):
    """bin_key_kernel: (D, n) uint32 keys, the sentinel nk1 - 1 where no
    corner lies on the plane."""
    bh, bw = lay["bin_h"], lay["bin_w"]
    x0, _ = _corner0(x, Wt)
    y0, _ = _corner0(y, Ht)
    on = (x0 >= -1) & (x0 < Wt) & (y0 >= -1) & (y0 < Ht)
    lc = (x0 + bw) % bw == bw - 1
    lr = (y0 + bh) % bh == bh - 1
    cls = np.where(lc, np.where(lr, 2, 1), np.where(lr, 3, 0))
    key = (((y0 + bh) // bh) * lay["nbx"] + (x0 + bw) // bw) * 4 + cls
    return np.where(on, key, lay["nk1"] - 1).astype(np.uint32)


def _radix_sort(keys, lay):
    """The stable LSD radix sort of one plane's keys as the kernels run it:
    for each 8-bit digit, bin_hist_kernel's per-tile counts, bin_scan_
    kernel's exclusive scan in (digit, tile) order and bin_scatter_kernel's
    ranks (a tile in rounds of SORT_THREADS keys, by index within a round,
    the round's counts carried to the next).  Returns (sorted keys, the
    samples' indices in that order)."""
    n = len(keys)
    tile = SORT_THREADS * 8
    ntiles = lay["ntiles"]
    pay = np.arange(n)
    for p in range(lay["passes"]):
        dig = ((keys >> (8 * p)) & 255).astype(np.int64)
        hist = np.zeros((256, ntiles), np.int64)
        for t in range(ntiles):
            hist[:, t] = np.bincount(dig[t * tile:(t + 1) * tile],
                                     minlength=256)
        offs = (np.cumsum(hist.reshape(-1)) - hist.reshape(-1)).reshape(
            256, ntiles)
        k2, p2 = np.empty_like(keys), np.empty_like(pay)
        for t in range(ntiles):
            base = offs[:, t].copy()
            for r0 in range(t * tile, min((t + 1) * tile, n), SORT_THREADS):
                rd = dig[r0:r0 + SORT_THREADS]
                for j, d in enumerate(rd):
                    pos = base[d] + int((rd[:j] == d).sum())
                    k2[pos], p2[pos] = keys[r0 + j], pay[r0 + j]
                base += np.bincount(rd, minlength=256)
        keys, pay = k2, p2
    return keys, pay


def _emulate_k17(ct, x, y, tex_shape, vec, unit=False):
    """K17 on the host: (f32 sums (D, Ht, Wt, F, C), the number of adds
    per texel, the number of writes per element).  unit: every weight 1
    (the adds counted with a ones cotangent)."""
    D, Ht, Wt, F, C = tex_shape
    FC = F * C
    xs, ys = x.reshape(D, -1), y.reshape(D, -1)
    n = xs.shape[1]
    cts = ct.reshape(D, n, FC)
    lay = S.planes_grad_layout(D, n, Ht, Wt, F, C, vec)
    bh, bw = lay["bin_h"], lay["bin_w"]
    T = bh * bw
    keys = _bin_keys(xs, ys, lay, Ht, Wt)
    grad = np.full((D, Ht, Wt, FC), np.nan, np.float32)
    adds = np.zeros((D, Ht, Wt), np.int64)
    writes = np.zeros((D, Ht, Wt, FC), np.int64)
    for d in range(D):
        skeys, perm = _radix_sort(keys[d], lay)
        np.testing.assert_array_equal(perm,
                                      np.argsort(keys[d], kind="stable"))
        off = np.searchsorted(skeys, np.arange(lay["nk1"]), "left")
        for ty in range(lay["nty"]):
            for tx in range(lay["ntx"]):
                # own bin: classes 0-3; left: 1-2; up: 2-3; upper left: 2
                ranges = []
                for by, bx, lo, hi in ((ty + 1, tx + 1, 0, 4),
                                       (ty + 1, tx, 1, 3),
                                       (ty, tx + 1, 2, 4), (ty, tx, 2, 3)):
                    k = (by * lay["nbx"] + bx) * 4
                    ranges.append(perm[off[k + lo]:off[k + hi]])
                entries = np.concatenate(ranges)
                x_lo, y_lo = tx * bw, ty * bh
                for sl in range(lay["nslices"]):
                    c0 = sl * lay["slice_cols"]
                    cols = min(lay["slice_cols"], lay["ncols"] - c0)
                    span = slice(c0 * vec, (c0 + cols) * vec)
                    acc = np.zeros((T, cols * vec), np.float32)
                    for s in entries:
                        x0, fx = _corner0(xs[d, s], Wt)
                        y0, fy = _corner0(ys[d, s], Ht)
                        wx0 = np.float32(1) - fx
                        wy0 = np.float32(1) - fy
                        ws = (wy0 * wx0, wy0 * fx, fy * wx0, fy * fx)
                        for q in range(4):
                            xi, yi = x0 + (q & 1), y0 + (q >> 1)
                            if not (0 <= xi < Wt and 0 <= yi < Ht
                                    and x_lo <= xi < x_lo + bw
                                    and y_lo <= yi < y_lo + bh):
                                continue
                            t = (yi - y_lo) * bw + (xi - x_lo)
                            w = np.float32(1) if unit else np.float32(ws[q])
                            acc[t] = acc[t] + cts[d, s, span] * w
                            if sl == 0:
                                adds[d, yi, xi] += 1
                    for t in range(T):
                        xi, yi = x_lo + t % bw, y_lo + t // bw
                        if xi < Wt and yi < Ht:
                            grad[d, yi, xi, span] = acc[t]
                            writes[d, yi, xi, span] += 1
    return grad.reshape(tex_shape), adds, writes


def _inputs(D, Ht, Wt, F, C, n, seed):
    rng = np.random.default_rng(seed)
    x, y = _edge_coords(rng, D, n, Ht, Wt)
    x[:, 24:28] = [1e9, -4e12, Wt + 3.0, -2.5]         # far off the plane
    y[:, 28:32] = [-1e9, 4e12, Ht + 3.0, -2.5]
    ct = rng.standard_normal((D, n, F, C)).astype(np.float32)
    return x, y, ct


GRAD_CASES = {
    # (D, Ht, Wt, F, C, n): sides that are and are not multiples of the
    # 4 x 8 tile, F C a multiple of 4 (float4 columns, one or more slices),
    # of 2 only, and odd
    "c4_f6_13x19": (2, 13, 19, 6, 4, 160),
    "c4_f50_16x24": (2, 16, 24, 50, 4, 140),
    "c13_f6_10x21": (2, 10, 21, 6, 13, 150),
    "c13_f50_9x17": (1, 9, 17, 50, 13, 120),
    "c13_f5_11x9": (1, 11, 9, 5, 13, 90),
    # more than 255 keys (two radix passes) and two sort tiles a plane
    "c4_f2_40x72_two_passes": (1, 40, 72, 2, 4, 2500),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_k17_binned_gather_emulated(case):
    """The emulated gather writes every texel once, zeros included, and is
    within 1e-6 * max|g| of the plain version; its sort is the stable
    argsort of the keys (checked inside); the rounding mode is one bf16
    step or less from the plain version's rounded sums."""
    D, Ht, Wt, F, C, n = GRAD_CASES[case]
    x, y, ct = _inputs(D, Ht, Wt, F, C, n, seed=len(case))
    shape = (D, Ht, Wt, F, C)
    vec = next(v for v in (4, 2, 1) if F * C % v == 0)
    lay = S.planes_grad_layout(D, n, Ht, Wt, F, C, vec)
    assert lay["passes"] == (2 if "two_passes" in case else 1)
    assert lay["ntiles"] == (2 if "two_passes" in case else 1)
    got, _, writes = _emulate_k17(ct, x, y, shape, vec)
    assert (writes == 1).all()
    tx, ty, tct = (torch.from_numpy(a) for a in (x, y, ct))
    plain = S.bilinear_planes_tilemajor_grad_plain(tct, tx, ty, shape)
    scale = float(plain.abs().max())
    assert scale > 0
    assert np.abs(got - plain.numpy()).max() <= 1e-6 * scale
    assert (got[plain.numpy() == 0] == 0).all()
    # the rounding mode: the sums rounded to bf16 (to nearest even)
    rounded = torch.from_numpy(got).to(torch.bfloat16).float()
    ref = S.bilinear_planes_tilemajor_grad_plain(tct, tx, ty, shape,
                                                 torch.bfloat16)
    mag = torch.maximum(rounded.abs(), ref.abs())
    step = torch.ldexp(torch.ones_like(mag), torch.frexp(mag)[1] - 8)
    assert ((rounded - ref).abs() <= step).all()


@pytest.mark.parametrize("case", ["c4_f6_13x19", "c13_f6_10x21"])
def test_k17_counts_each_corner_once(case):
    """With a ones cotangent and unit weights every in-plane (sample,
    corner) is added exactly once: the own bin and the three halo ranges
    neither miss nor repeat a corner."""
    D, Ht, Wt, F, C, n = GRAD_CASES[case]
    x, y, _ = _inputs(D, Ht, Wt, F, C, n, seed=3)
    ones = np.ones((D, n, F, C), np.float32)
    vec = next(v for v in (4, 2, 1) if F * C % v == 0)
    got, adds, _ = _emulate_k17(ones, x, y, (D, Ht, Wt, F, C), vec,
                                unit=True)
    want = np.zeros((D, Ht, Wt), np.int64)
    for d in range(D):
        x0, _ = _corner0(x[d], Wt)
        y0, _ = _corner0(y[d], Ht)
        for q in range(4):
            xi, yi = x0 + (q & 1), y0 + (q >> 1)
            inside = (xi >= 0) & (xi < Wt) & (yi >= 0) & (yi < Ht)
            np.add.at(want[d], (yi[inside], xi[inside]), 1)
    np.testing.assert_array_equal(adds, want)
    assert want.sum() > 0 and (want == 0).any()
    np.testing.assert_array_equal(got, np.broadcast_to(
        want[..., None, None].astype(np.float32), got.shape))


def test_k17_layout_limits():
    """The layout at the shipped dense stage-2 shapes and at the widest
    channel count: slices of at most 128 vectors, shared memory far inside
    the H100's 227 KB, two 8-bit passes for the 396 x 704 planes."""
    lay = S.planes_grad_layout(32, 57600, 396, 704, 50, 4, 4)
    assert (lay["nty"], lay["ntx"], lay["passes"]) == (99, 88, 2)
    assert (lay["nslices"], lay["slice_cols"], lay["threads"]) == (1, 50, 64)
    assert lay["smem"] == 4 * (32 * 200 + 9 * 64)
    wide = S.planes_grad_layout(32, 57600, 396, 704, 50, 36, 4)
    assert (wide["nslices"], wide["slice_cols"], wide["threads"]) == \
        (4, 113, 128)
    assert wide["smem"] <= S._SMEM_LIMIT // 3
    odd = S.planes_grad_layout(32, 57600, 396, 704, 50, 13, 2)
    assert odd["ncols"] == 325 and odd["nslices"] * odd["slice_cols"] >= 325


def _sweep_blocks(n_total, n, img_w):
    """planes_sweep_kernel's blocks as arrays of their samples, in the
    order a block's threads take them: SWEEP_THREADS consecutive samples,
    or with the image width an 8 x 32 tile of each plane's image, row
    major (cut at the image's edges)."""
    if not img_w:
        for s0 in range(0, n_total, SWEEP_THREADS):
            yield np.arange(s0, min(s0 + SWEEP_THREADS, n_total))
        return
    img_h = n // img_w
    for d in range(n_total // n):
        for r0 in range(0, img_h, 8):
            for c0 in range(0, img_w, 32):
                rows = np.arange(r0, min(r0 + 8, img_h))
                cols = np.arange(c0, min(c0 + 32, img_w))
                yield (d * n + rows[:, None] * img_w + cols).reshape(-1)


def _emulate_k16(tex, x, y, ts, gather_bf16, img_w):
    """planes_sweep_kernel on the host: each block's samples
    (`_sweep_blocks`), their corners once, then the block's (sample, frame,
    vector) items in output order; each item reads its four corners' kV
    channels of frame ts[f] (zero off the plane), rounded to bf16 when f32
    texels are gathered as bf16, and lerps them.  Returns (D, ..., F_sel,
    C) f32 and the number of writes per output."""
    D, Ht, Wt, F_all, C = tex.shape
    flat = tex.reshape(-1).float()
    if gather_bf16 and tex.dtype == torch.float32:
        flat = flat.to(torch.bfloat16).float()
    flat = flat.numpy()
    xs, ys = x.reshape(-1), y.reshape(-1)
    n_total, n = xs.size, xs.size // D
    F_out, C_out = (F_all if ts is None else len(ts)), C
    if ts is None:
        # the wrapper's all-frames call: one frame of F C channels, vectors
        # of 4 or 2 where F C allows
        F_all, C = 1, F_all * C
        kv = next(v for v in (4, 2, 1) if C % v == 0)
    else:
        kv = 4 if C % 4 == 0 else 1
    F_sel = F_all if ts is None else len(ts)
    nv, row = C // kv, F_all * C
    out = np.zeros((n_total, F_sel, C), np.float32)
    writes = np.zeros(out.shape, np.int64)
    for s in _sweep_blocks(n_total, n, img_w):
        x0, fx = _corner0(xs[s], Wt)
        y0, fy = _corner0(ys[s], Ht)
        r = []
        for q in range(4):
            xi, yi = x0 + (q & 1), y0 + (q >> 1)
            inside = (xi >= 0) & (xi < Wt) & (yi >= 0) & (yi < Ht)
            r.append(np.where(inside, yi * Wt + xi, -1))
        plane = (s // n) * Ht * Wt * row
        i = np.arange(len(s) * F_sel * nv)
        sl = i // (F_sel * nv)
        f = (i % (F_sel * nv)) // nv
        cv = i % nv
        fr = f if ts is None else np.clip(np.asarray(ts)[f], 0, F_all - 1)
        off = fr * C + cv * kv
        for c in range(kv):
            v = [np.where(r[q][sl] >= 0,
                          flat[plane[sl] + np.maximum(r[q][sl], 0) * row
                               + off + c], np.float32(0))
                 for q in range(4)]
            fxs, fys = fx[sl], fy[sl]
            top = v[0] * (np.float32(1) - fxs) + v[1] * fxs
            bot = v[2] * (np.float32(1) - fxs) + v[3] * fxs
            out[s[sl], f, cv * kv + c] = top * (np.float32(1) - fys) \
                + bot * fys
            writes[s[sl], f, cv * kv + c] += 1
    return (out.reshape(x.shape + (F_out, C_out)),
            writes.reshape((n_total, F_out, C_out)))


@pytest.mark.parametrize("CF", [(4, 6), (13, 10), (4, 40), (13, 5)],
                         ids=["c4_f6", "c13_f10_tiles", "c4_f40_tiles",
                              "c13_f5"])
@pytest.mark.parametrize("ts", [None, [4, 0, 2, 2, 9]], ids=["all", "ts"])
@pytest.mark.parametrize("mode", ["f32", "bf16", "f32_as_bf16"])
def test_k16_sweep_emulated(CF, ts, mode):
    """The emulated sweep writes every output once and equals the plain
    version bit for bit: f32 and bf16 texels, f32 texels rounded to bf16
    (equal to the plain samples of ``tex.to(torch.bfloat16)``), all frames
    and a frame subset with a repeat and an index past the stack (clamped),
    over more than one block: consecutive samples, or, where the wrapper
    takes the image's 8 x 32 tiles (`_sweep_image_width`: 128 outputs or
    more a sample), tiles cut at the image's edges; over all frames
    vectors of 4 and of 2 (F C = 65: 1) along the F x C row, over a
    subset of frames along C."""
    C, F = CF
    D, Ht, Wt, h, w = 2, 13, 19, 15, 40
    rng = np.random.default_rng(C + F)
    x, y = _edge_coords(rng, D, h * w, Ht, Wt)
    x[:, 24:26] = [1e9, -4e12]
    x, y = x.reshape(D, h, w), y.reshape(D, h, w)
    tex = torch.from_numpy(rng.standard_normal((D, Ht, Wt, F, C))
                           .astype(np.float32))
    if mode == "bf16":
        tex = tex.to(torch.bfloat16)
    gather = torch.bfloat16 if mode != "f32" else None
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    F_sel = F if ts is None else len(ts)
    img_w = S._sweep_image_width(tx, F_sel, C)
    # tiles at 130 and 160 outputs a sample; not at 24 or 65, nor at 5
    # frames
    assert img_w == (w if ts is None and F * C > 100 else 0)
    got, writes = _emulate_k16(tex, x, y, ts, gather is not None, img_w)
    assert (writes == 1).all()
    tts = None if ts is None else torch.tensor(np.clip(ts, 0, F - 1),
                                               dtype=torch.int32)
    want = S.bilinear_planes_tilemajor_plain(tex, tx, ty, tts, gather)
    np.testing.assert_array_equal(got, want.numpy())
    if mode == "f32_as_bf16":
        np.testing.assert_array_equal(
            want.numpy(), S.bilinear_planes_tilemajor_plain(
                tex.to(torch.bfloat16), tx, ty, tts).numpy())


@pytest.mark.parametrize("ts", [None, [4, 0, 2]], ids=["all", "ts"])
def test_gather_dtype_semantics(ts):
    """`sample_planes_tilemajor(atlas_f32, x, y, gather_dtype=bf16)`: the
    samples bit for bit those of the old ``atlas_f32.to(bf16)`` input, the
    gradient an f32 tensor bit for bit equal to the plain f32 sum rounded
    once to bf16, with no cast in autograd, and within 2^-7 * max|g| of
    JAX's gradient through ``astype(bfloat16)`` (JAX adds in bf16)."""
    D, Ht, Wt, F, C, n = 3, 24, 32, 6, 4, 200
    rng = np.random.default_rng(11)
    tex = rng.standard_normal((D, Ht, Wt, F, C)).astype(np.float32)
    x, y = _edge_coords(rng, D, n, Ht, Wt)
    ct = rng.standard_normal((D, n, F, C)).astype(np.float32)
    tx, ty, tct = (torch.from_numpy(a) for a in (x, y, ct))
    tts = None if ts is None else torch.tensor(ts, dtype=torch.int32)
    atlas = torch.from_numpy(tex).requires_grad_(True)
    if ts is not None:
        with torch.no_grad():
            got = S.sample_planes_tilemajor(atlas.detach(), tx, ty, tts,
                                            torch.bfloat16)
            old = S.sample_planes_tilemajor(atlas.detach().to(torch.bfloat16),
                                            tx, ty, tts)
        assert torch.equal(got, old)
        return
    vals = S.sample_planes_tilemajor(atlas, tx, ty, None, torch.bfloat16)
    old = S.sample_planes_tilemajor(atlas.detach().to(torch.bfloat16), tx, ty)
    assert torch.equal(vals, old)
    assert vals.grad_fn.next_functions[0][0].variable is atlas
    (vals * tct).sum().backward()
    plain = S.bilinear_planes_tilemajor_grad_plain(tct, tx, ty, tex.shape)
    assert atlas.grad.dtype == torch.float32
    assert torch.equal(atlas.grad, plain.to(torch.bfloat16).float())

    def jfwd(t):
        return JS.bilinear_planes_tilemajor(t.astype(jnp.bfloat16),
                                            jnp.asarray(x), jnp.asarray(y))[0]

    jv, vjp = jax.vjp(jfwd, jnp.asarray(tex))
    jg = np.asarray(vjp(jnp.asarray(ct))[0])
    assert jg.dtype == np.float32
    assert np.abs(vals.detach().numpy() - np.asarray(jv)).max() <= 1e-6
    assert np.abs(atlas.grad.numpy() - jg).max() <= \
        2.0 ** -7 * np.abs(jg).max()
