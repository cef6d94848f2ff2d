"""K3 at C != 4 (the dynamic tiles' sampler of the SH and NeX decoders)
and K23 (the packed-tile sampler's coordinate gradient) as redesigned for
the card, emulated on the host (the CUDA kernels of
``csrc/bilinear_tiles_tilemajor.cu`` and ``csrc/bilinear_tiles.cu`` do not
run on the CPU).

K3's sweep (bilinear_tiles_tilemajor_sweep_kernel) is emulated in its
order: a block of `render/sample.py:tiles_tilemajor_layout` samples finds
each one's corners once (the four corner texels' element offsets at frame
0, fu, fv; a miss flagged) and stages the frame offsets ts[f] C, then its
threads sweep the block's count x F_sel x C outputs four at a time, a
thread's (sample, frame, channel) stepped by a carry.  Every output is
visited once and is bit-equal to the plain version in the f32, bf16 and
f32-rounded-to-bf16 texel modes, with ts None, a permuted subset with a
repeat and a contiguous run, and, in f32, within 1e-6 of JAX's
``bilinear_tiles_tilemajor`` on ``dyn[..., ts, :]``.

K23's C = 4 route (coord_grad_c4_kernel) is emulated per thread: one
sample a thread, k read first (a miss writes its zeros and reads nothing
more), a hit's u, v, cotangent row and corners (the corners past the last
texel zero), the first design's per-channel sums in c order, and no fill:
every sample written once, bit-equal to the first design's order, within
1e-5 * max|g| of ``jax.grad`` of ``bilinear_tiles``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_static_tiles import round_bf16_bits
from videoloop3d_tpu.render import sample as JS
from videoloop3d_torch.render import sample as S

F32 = np.float32


def _lerp(a, b, f):
    """csrc/common.cuh lerp_rn in f32, one rounding per operation."""
    return a * (F32(1) - f) + b * f


def _k3_sweep(count, F_sel, C, threads):
    """The (output, sample, frame, channel) of each output of one block's
    sweep over its count x F_sel x C outputs, as
    bilinear_tiles_tilemajor_sweep_kernel's threads visit them: thread t
    starts at output 4 t (its one division), takes four outputs from there,
    each advanced from the last by a carry over channels then frames then
    samples, and steps by 4 x threads outputs to its next four with a
    carry of that step."""
    row = F_sel * C
    step = 4 * threads
    js, jj = divmod(step, row)
    jf, jc = divmod(jj, C)
    total = count * row
    o = 4 * np.arange(threads)
    s = o // row
    f = (o - s * row) // C
    c = o - s * row - f * C
    visits = []
    while (o < total).any():
        ss, ff, cc = s.copy(), f.copy(), c.copy()
        for e in range(4):
            live = o + e < total
            visits.append(np.stack([o[live] + e, ss[live], ff[live],
                                    cc[live]], 1))
            cc = cc + 1
            ff = np.where(cc == C, ff + 1, ff)
            cc = np.where(cc == C, 0, cc)
            ss = np.where(ff == F_sel, ss + 1, ss)
            ff = np.where(ff == F_sel, 0, ff)
        s, f, c = s + js, f + jf, c + jc
        f = np.where(c >= C, f + 1, f)
        c = np.where(c >= C, c - C, c)
        s = np.where(f >= F_sel, s + 1, s)
        f = np.where(f >= F_sel, f - F_sel, f)
        o = o + step
    return np.concatenate(visits)


def emulate_k3_sweep(tex, k, u, v, ts):
    """bilinear_tiles_tilemajor_sweep_kernel on the host, tex the (N, th,
    tw, F_all, C) f32 texels as the kernel widens (and, in the rounding
    mode, rounds) them: per sample its four corners' element offsets at
    frame 0 (-1 for a miss) and fu, fv; per block of
    `tiles_tilemajor_layout` samples the sweep of its outputs, each the
    three f32 lerps of the four texels at its frame and channel, a miss
    zero.  Returns (values (n, F_sel, C), visits of each output)."""
    N, th, tw, F_all, C = tex.shape
    F_sel = F_all if ts is None else len(ts)
    n = k.size
    lay = S.tiles_tilemajor_layout(n, F_sel, C)
    fr = (np.arange(F_sel) if ts is None
          else np.clip(np.asarray(ts), 0, F_all - 1)) * C
    hit = k >= 0
    tile = np.minimum(k, N - 1)
    uu = np.fmin(np.fmax(np.where(hit, u, 0), F32(0)), F32(tw - 1))
    vv = np.fmin(np.fmax(np.where(hit, v, 0), F32(0)), F32(th - 1))
    u0, v0 = np.floor(uu), np.floor(vv)
    fu, fv = (uu - u0).astype(F32), (vv - v0).astype(F32)
    u0i, v0i = u0.astype(np.int64), v0.astype(np.int64)
    u1i, v1i = np.minimum(u0i + 1, tw - 1), np.minimum(v0i + 1, th - 1)
    r0, r1 = (tile * th + v0i) * tw, (tile * th + v1i) * tw
    texel = F_all * C
    q = np.stack([(r0 + u0i) * texel, (r0 + u1i) * texel,
                  (r1 + u0i) * texel, (r1 + u1i) * texel], 1)
    q[~hit, 0] = -1
    assert q.max() < 2 ** 31
    flat = tex.reshape(-1)
    out = np.full((n, F_sel, C), np.nan, F32)
    visits = np.zeros((n, F_sel, C), np.int64)
    sweeps = {}
    for first in range(0, n, lay["samples"]):
        count = min(lay["samples"], n - first)
        if count not in sweeps:
            sweeps[count] = _k3_sweep(count, F_sel, C, lay["threads"])
        o, s, f, c = sweeps[count].T
        assert np.array_equal(o, (s * F_sel + f) * C + c)
        s = s + first
        miss = q[s, 0] < 0
        off = fr[f] + c

        def texel_at(j):
            return flat[np.where(miss, 0, q[s, j] + off)]
        top = _lerp(texel_at(0), texel_at(1), fu[s])
        bot = _lerp(texel_at(2), texel_at(3), fu[s])
        out[s, f, c] = np.where(miss, F32(0), _lerp(top, bot, fv[s]))
        np.add.at(visits, (s, f, c), 1)
    return out, visits


def _k3_case(C, F_all, ts_case, seed):
    """Tiles (N, 12, 12, F_all, C) and about 3.3 blocks of samples with
    misses (their coordinates NaN), k past the last tile, coordinates off
    the tile and whole numbers; ts None, a permuted subset with a repeat,
    or a contiguous run."""
    rng = np.random.default_rng(seed)
    N, th, tw = 23, 12, 12
    ts = {"all": None,
          "subset": [F_all - 1, 0, 3, 3, 1],
          "run": list(range(2, F_all - 1))}[ts_case]
    F_sel = F_all if ts is None else len(ts)
    n = int(3.3 * S.tiles_tilemajor_layout(1, F_sel, C)["samples"])
    tiles = rng.standard_normal((N, th, tw, F_all, C)).astype(F32)
    k = rng.integers(-1, N, n).astype(np.int32)
    u = rng.uniform(-0.5, tw - 0.5, n).astype(F32)
    v = rng.uniform(-0.5, th - 0.5, n).astype(F32)
    k[::37] = N + 2
    u[1::7], v[2::7] = -2.5, -0.75
    u[3::7], v[4::7] = tw + 1.5, th + 0.25
    u[5::11], v[5::11] = np.floor(u[5::11]), np.floor(v[5::11])
    u[6::13], v[6::13] = tw - 1, th - 1
    k[:2] = -1
    u[k < 0], v[k < 0] = np.nan, np.nan
    assert (k < 0).sum() >= 2 and (k >= N).sum() >= 2
    return tiles, k, u, v, ts


@pytest.mark.parametrize("ts_case", ["all", "subset", "run"])
@pytest.mark.parametrize("mode", ["f32", "bf16", "f32_as_bf16"])
@pytest.mark.parametrize("C", [1, 2, 3, 5, 8, 13, 36, 37])
def test_tilemajor_sweep_emulated(C, mode, ts_case):
    """K3's redesign at C != 4 emulated on the host at F_all = 7: every
    output visited once, bit-equal to the plain version in each texel
    mode (f32; bf16; f32 texels rounded to bf16 before the lerps) and, in
    f32, within 1e-6 of JAX's bilinear_tiles_tilemajor on dyn[..., ts, :]
    (k clamped for both: the plain version and JAX index k as it is;
    JAX's misses at u = v = 0, since it multiplies their lerps by 0)."""
    tiles, k, u, v, ts = _k3_case(C, 7, ts_case, 200 + C)
    N = tiles.shape[0]
    tt = torch.from_numpy(tiles)
    if mode == "f32":
        src, gather, tex = tt, None, tiles
    elif mode == "bf16":
        src, gather = tt.to(torch.bfloat16), None
        tex = src.float().numpy()
    else:
        src, gather, tex = tt, torch.bfloat16, round_bf16_bits(tiles)
    got, visits = emulate_k3_sweep(tex, k, u, v, ts)
    assert (visits == 1).all()
    kc = np.minimum(k, N - 1)
    tk, tu, tv = (torch.from_numpy(a) for a in (kc, u, v))
    tts = None if ts is None else torch.tensor(ts, dtype=torch.int32)
    plain, valid = S.bilinear_tiles_tilemajor(src, tk, tu, tv, tts, gather)
    np.testing.assert_array_equal(got.view(np.int32),
                                  plain.numpy().view(np.int32))
    assert not got[k < 0].any() and valid.numpy().sum() == (k >= 0).sum()
    if mode == "f32":
        ju, jv_ = (jnp.asarray(np.where(k < 0, F32(0), a)) for a in (u, v))
        jt = jnp.asarray(tiles if ts is None else tiles[..., ts, :])
        jv, _ = JS.bilinear_tiles_tilemajor(jt, jnp.asarray(kc), ju, jv_)
        np.testing.assert_allclose(got, np.asarray(jv), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,F_sel,C,want", [
    # phase 38: the dynamic atlas at the shipped patch's 15 slots, 50
    # frames, at the SH decoders' channel counts
    (864000, 50, 13, (52, 16616, 256, 1448)),
    (864000, 50, 36, (20, 43200, 256, 680)),
    # an SH eval chunk: 32 planes x 360 x 640, 10 frames
    (7372800, 10, 13, (256, 28800, 256, 6184)),
    (7372800, 10, 36, (92, 80140, 256, 2248)),
    # small rows: 1,024 samples a block
    (5000, 1, 1, (1024, 5, 256, 24580)),
    (3, 7, 5, (940, 1, 256, 22588)),
    (0, 50, 13, (52, 0, 256, 1448)),
    # the most frames 48 KB holds at four samples a block
    (9, 12264, 1024, (4, 3, 256, 49152)),
])
def test_tiles_tilemajor_layout(n, F_sel, C, want):
    """K3's layout at C != 4 (mirrored by the kernel's
    vl3d_bilinear_tiles_tilemajor_layout, checked on the card): the least
    multiple of 4 samples whose outputs reach 32 sweeps of the block, at
    most 1,024; 24 shared bytes a sample and 4 a frame."""
    lay = S.tiles_tilemajor_layout(n, F_sel, C)
    assert tuple(lay) == S.TILES_TILEMAJOR_LAYOUT_KEYS
    assert tuple(lay.values()) == want
    assert lay["samples"] % 4 == 0
    assert (lay["samples"] * F_sel * C >= S.TILEMAJOR_BLOCK_OUTPUTS
            or lay["samples"] == S.TILEMAJOR_MAX_SAMPLES)
    assert lay["smem"] == 24 * lay["samples"] + 4 * F_sel <= 48 * 1024


@pytest.mark.parametrize("n,F_sel,C", [(10, 50, 0), (10, 50, 1025),
                                       (10, 0, 13), (-1, 50, 13),
                                       (9, 12265, 1024),
                                       (52 * 2 ** 31, 50, 13)])
def test_tiles_tilemajor_layout_limits(n, F_sel, C):
    with pytest.raises(ValueError, match="tiles_tilemajor_layout"):
        S.tiles_tilemajor_layout(n, F_sel, C)


def test_tilemajor_wrapper_checks_layout_on_cuda_only():
    """On CPU tensors K3 runs its plain version at any channel count; the
    layout's limits bind the card's launch only (a C of 1,025 samples
    here)."""
    tiles = torch.zeros((2, 3, 3, 2, 1025))
    k = torch.zeros((4,), dtype=torch.int32)
    u = torch.full((4,), 0.5)
    out, valid = S.bilinear_tiles_tilemajor(tiles, k, u, u)
    assert tuple(out.shape) == (4, 2, 1025) and valid.all()


# --- K23 --------------------------------------------------------------


def _k23_first(tex, ct, k, u, v, idx):
    """K23's first design for sample idx (bilinear_tiles_coord_grad_kernel):
    the clamp, the flat-index corners r, r+1, r+tw, r+tw+1 (zero past the
    end), the per-channel sums in c order, each operation rounded in f32;
    (g_u, g_v), zeros for a miss."""
    N, th, tw, C = tex.shape
    if k[idx] < 0:
        return F32(0), F32(0)
    flat = tex.reshape(N * th * tw, C)
    tile = min(int(k[idx]), N - 1)
    uu = F32(min(max(np.nan_to_num(u[idx], nan=0.0), 0.0), tw - 1.0))
    vv = F32(min(max(np.nan_to_num(v[idx], nan=0.0), 0.0), th - 1.0))
    u0, v0 = np.floor(uu), np.floor(vv)
    fu, fv = F32(uu - u0), F32(vv - v0)
    r = (tile * th + int(v0)) * tw + int(u0)
    t = [flat[q] if q < N * th * tw else np.zeros(C, F32)
         for q in (r, r + 1, r + tw, r + tw + 1)]
    su = sv = F32(0)
    for c in range(C):
        g = ct[idx, c]
        su = su + g * ((F32(1) - fv) * (t[1][c] - t[0][c])
                       + fv * (t[3][c] - t[2][c]))
        sv = sv + g * ((F32(1) - fu) * (t[2][c] - t[0][c])
                       + fu * (t[3][c] - t[1][c]))

    def clip_grad(x, hi):
        if x == 0 or x == hi:
            return F32(0.5)
        return F32(1) if 0 < x < hi else F32(0)
    return (clip_grad(u[idx], F32(tw - 1)) * su,
            clip_grad(v[idx], F32(th - 1)) * sv)


def emulate_k23_c4(tex, ct, k, u, v, threads=256):
    """coord_grad_c4_kernel on the host: block b, thread t takes sample
    b threads + t; every sample of both outputs written once, by the first
    design's per-sample arithmetic (a miss's zeros too, its u, v and
    cotangent unread), into outputs that start as NaN (no fill).  Returns
    (g_u, g_v, writes, the samples whose u, v were read)."""
    n = k.size
    gu = np.full(n, np.nan, F32)
    gv = np.full(n, np.nan, F32)
    writes = np.zeros(n, np.int64)
    read = np.zeros(n, bool)
    for b in range(-(-n // threads)):
        for t in range(threads):
            idx = b * threads + t
            if idx >= n:
                break
            read[idx] = k[idx] >= 0
            gu[idx], gv[idx] = _k23_first(tex, ct, k, u, v, idx)
            writes[idx] += 1
    return gu, gv, writes, read


def _k23_case(n, seed, bf16=False):
    """Packed (5, 4, 6, 4) tiles and n samples: misses (NaN coordinates),
    k past the last tile, u and v on the tile's edges (the clip's 0.5) and
    off the tile, the last tile's far corner (the corners past the end)."""
    rng = np.random.default_rng(seed)
    N, th, tw, C = 5, 4, 6, 4
    tiles = rng.standard_normal((N, th, tw, C)).astype(F32)
    if bf16:
        tiles = torch.from_numpy(tiles).to(torch.bfloat16).float().numpy()
    k = rng.integers(-1, N, n).astype(np.int32)
    u = rng.uniform(-1.0, tw, n).astype(F32)
    v = rng.uniform(-1.0, th, n).astype(F32)
    u[::9], v[1::9] = 0.0, 0.0
    u[2::9], v[3::9] = tw - 1.0, th - 1.0
    u[4::17], v[4::17], k[4::17] = tw - 1.0, th - 1.0, N - 1
    k[5::23] = N + 1
    k[6::10] = -1
    u[k < 0], v[k < 0] = np.nan, np.nan
    ct = rng.standard_normal((n, C)).astype(F32)
    return tiles, ct, k, u, v


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 300, 1024, 2100])
def test_coord_grad_c4_emulated(n, bf16):
    """K23's C = 4 route emulated on the host: every sample written once
    (no fill), each bit-equal to the first design's order, the misses
    zero with their NaN coordinates unread; within 1e-5 * max|g| of K23's
    plain version and of jax.grad of bilinear_tiles (k clamped for both,
    JAX's misses at u = v = 0)."""
    tiles, ct, k, u, v = _k23_case(n, 40 + n, bf16)
    N = tiles.shape[0]
    gu, gv, writes, read = emulate_k23_c4(tiles, ct, k, u, v)
    assert (writes == 1).all()
    assert np.array_equal(read, k >= 0) and np.isfinite(u[read]).all()
    first = np.array([_k23_first(tiles, ct, k, u, v, i) for i in range(n)],
                     F32).reshape(n, 2)
    np.testing.assert_array_equal(gu.view(np.int32),
                                  first[:, 0].copy().view(np.int32))
    np.testing.assert_array_equal(gv.view(np.int32),
                                  first[:, 1].copy().view(np.int32))
    assert not gu[k < 0].any() and not gv[k < 0].any()
    kc = np.minimum(k, N - 1)
    # JAX's misses and the plain version's at u = v = 0 (both index with
    # the clamped coordinates of every sample)
    ju, jv_ = (np.where(k < 0, F32(0), a) for a in (u, v))
    t = [torch.from_numpy(a) for a in (ct, tiles, kc, ju, jv_)]
    pu, pv = S.bilinear_tiles_coord_grad(*t)

    def jf(uu, vv):
        vals, _ = JS.bilinear_tiles(jnp.asarray(tiles), jnp.asarray(kc), uu,
                                    vv)
        return jnp.sum(vals * ct)
    jgu, jgv = (np.asarray(a) for a in jax.grad(jf, (0, 1))(
        jnp.asarray(ju), jnp.asarray(jv_)))
    for got, plain, ref in ((gu, pu, jgu), (gv, pv, jgv)):
        scale = np.abs(ref).max()
        assert scale > 0
        assert np.abs(got - plain.numpy()).max() <= 1e-5 * scale
        assert np.abs(got - ref).max() <= 1e-5 * scale
