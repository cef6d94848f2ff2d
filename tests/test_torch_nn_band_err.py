"""K19 (the eval's selected-patch error) as redesigned for the card,
emulated on the host from ``losses/patch_nn.py:nn_band_err_layout`` (the
CUDA kernel of ``csrc/nn_band_err.cu`` does not run on the CPU).

The emulation follows nn_band_err_unit_kernel block by block: a block a
(crop, row, tile of `tw` neighbouring columns); its units (j, q, g),
column j of the tile, a channel q of the d = C ph pw and the g-th range
of `span` source patches, thread t taking units t, t + threads, ...;
each unit's f32 chain over its patches i and their frames k in (i, k)
order of |tar[sel_j[i] st + k, q] - src[i st + k, q]|, the sliding window
reading each source frame once (one load a patch after the first pt -
1), a thread's units added in turn, a shuffle-down tree in each warp,
the warps' sums in order (a partial a block), then the first design's
crop sums over a crop's blocks (256 strided chains, a halving tree).  Its per-crop sums must be within
1e-6 relative of `nn_band_err_plain` and of a float64 sum of the same
terms, and the same bits twice, at small crops at the eval's (p, s, pt)
triples (st = 1), at pt = 1 and at st = 2 (the generic loop), in both
directions.  The layout's units cover every (channel, patch) once.  JAX's
`sel_err` is the reference of ``tests/test_torch_eval.py`` and
``tests/test_torch_patch_nn.py`` (unchanged).
"""
import numpy as np
import pytest
import torch

from videoloop3d_torch.losses import patch_nn as PN

F32 = np.float32


def _patches(v, plan):
    """(crops, nh * nw, T, d) f32: the per-frame patches of every crop."""
    return np.stack([PN._frame_patches(c, plan).numpy()
                     for c in PN._crops(v, plan)])


def _crop_sums(partial):
    """crop_sums_kernel: 256 strided f32 chains over a crop's columns, then
    the halving tree.  partial (crops, columns)."""
    n, ncols = partial.shape
    acc = np.zeros((n, 256), F32)
    for c0 in range(0, ncols, 256):
        chunk = partial[:, c0:c0 + 256]
        acc[:, :chunk.shape[1]] = acc[:, :chunk.shape[1]] + chunk
    s = 128
    while s:
        acc[:, :s] = acc[:, :s] + acc[:, s:2 * s]
        s //= 2
    return acc[:, 0]


def emulate_k19(x, y, plan, nn, reverse=False, tw=-1):
    """nn_band_err_unit_kernel block by block (see the module docstring).
    Returns ((n_crops,) f32 sums, terms of each (column, channel, patch, k),
    source loads of each (column, channel, frame))."""
    (pt, _, _), (st, _, _) = plan.psz, plan.strides
    ntx, nty, nh, nw = plan.grid
    src, tar = PN._fitted(x, y, plan)
    if reverse:
        src, tar = tar, src
    ns = nty if reverse else ntx
    A, B = _patches(src, plan), _patches(tar, plan)
    n_crops, ncols, _, d = A.shape
    lay = PN.nn_band_err_layout(plan, x.shape[0], reverse, tw)
    span, units, nthr = lay["span"], lay["units"], lay["threads"]
    tw, tiles = lay["tw"], lay["tiles"]
    sel = nn.numpy().reshape(n_crops * ncols, ns).astype(np.int64)
    A = A.reshape(n_crops * ncols, -1, d)
    B = B.reshape(n_crops * ncols, -1, d)
    # blocks (crop, row, tile) in launch order; a unit's column index
    nb = n_crops * nh * tiles
    blk = np.arange(nb)
    crop, rem = blk // (nh * tiles), blk % (nh * tiles)
    row, col0 = rem // tiles, (rem % tiles) * tw
    u = np.arange(units)
    q, r = u % d, u // d
    j, g = r % tw, r // tw
    col = col0[:, None] + j[None]                      # (blocks, units)
    on_col = col < nw
    cidx = crop[:, None] * ncols + row[:, None] * nw + np.minimum(col, nw - 1)
    i0 = g * span
    i1 = np.minimum(ns, i0 + span)
    uacc = np.zeros((nb, units), F32)
    terms = np.zeros((n_crops * ncols, d, max(ns, 1), pt), np.int64)
    loads = np.zeros((n_crops * ncols, d, A.shape[1]), np.int64)
    window = lay["window"] == pt and pt > 1
    qq = np.broadcast_to(q[None], cidx.shape)
    for step in range(span):
        i = i0 + step
        on = (i < i1)[None] & on_col
        ic = np.broadcast_to(np.minimum(i, max(ns - 1, 0))[None], cidx.shape)
        if window:
            # the window's loads: frames i0 .. i0 + pt - 2 first, then one
            # a patch
            new = [ic + pt - 1] if step else [ic + k for k in range(pt)]
            for f in new:
                np.add.at(loads, (cidx[on], qq[on], f[on]), 1)
        for k in range(pt):
            a = A[cidx, ic * st + k, qq]
            b = B[cidx, sel[cidx, ic] * st + k, qq]
            t = np.abs(b - a)
            uacc = np.where(on, uacc + t, uacc)
            np.add.at(terms, (cidx[on], qq[on], ic[on], k), 1)
            if not window:
                np.add.at(loads, (cidx[on], qq[on], (ic * st + k)[on]), 1)
    # a thread's units in turn
    tacc = np.zeros((nb, nthr), F32)
    for m in range(lay["per_thread"]):
        uu = np.arange(nthr) + m * nthr
        ok = uu < units
        tacc[:, ok] = tacc[:, ok] + uacc[:, uu[ok]]
    # the shuffle-down tree in each warp (lane 0's value), the warps in order
    v = tacc.reshape(nb, nthr // 32, 32)
    for o in (16, 8, 4, 2, 1):
        v = v.copy()
        v[..., :32 - o] = v[..., :32 - o] + v[..., o:]
    wsum = v[..., 0]
    part = wsum[:, 0].copy()
    for w in range(1, wsum.shape[1]):
        part = part + wsum[:, w]
    return _crop_sums(part.reshape(n_crops, nh * tiles)), terms, loads


def _inputs(C, T, H, W, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 0.3, (C, T, H, W)).astype(F32)
    y = rng.normal(0.4, 0.3, (C, T + 2, H, W)).astype(F32)
    return torch.from_numpy(x), torch.from_numpy(y)


# (patch, spatial stride, pt, st), (C, Tx, H, W), macro block: the eval's
# three scales at st = 1, pt = 1, and st = 2 (the generic loop)
CASES = {"p5s2pt7st1": ((5, 2, 7, 1), (3, 13, 16, 19), 11),
         "p11s4pt5st1": ((11, 4, 5, 1), (3, 11, 19, 23), 15),
         "p17s6pt3st1": ((17, 6, 3, 1), (3, 9, 29, 23), 23),
         "p5s2pt1st1": ((5, 2, 1, 1), (3, 6, 16, 17), 9),
         "p5s2pt3st2": ((5, 2, 3, 2), (3, 11, 16, 17), 9)}


@pytest.mark.parametrize("tw", [-1, 1, 4], ids=["tw_layout", "tw1", "tw4"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("case", list(CASES))
def test_nn_band_err_emulated(case, reverse, tw):
    """The emulated redesign within 1e-6 relative of the plain version and
    of a float64 sum, the same bits twice, with the layout's tile, one
    column a block and 4 (a partial last tile where nw % 4 != 0); every
    (column, channel, patch, k) term summed once; in the window each
    source value loaded once a unit (span + pt - 1 loads for span * pt
    terms)."""
    (p, s, pt, st), (C, Tx, H, W), macro = CASES[case]
    x, y = _inputs(C, Tx, H, W, list(CASES).index(case))
    plan = PN.lowmem_plan(Tx, y.shape[1], H, W, (pt, p, p), (st, s, s),
                          macro)
    assert len(plan.hs) * len(plan.ws) > 1
    rows, cols = PN.nn_band_argmin_plain(x, y, plan, both_directions=True)
    nn = cols if reverse else rows
    got, terms, loads = emulate_k19(x, y, plan, nn, reverse, tw)
    again, _, _ = emulate_k19(x, y, plan, nn, reverse, tw)
    assert got.tobytes() == again.tobytes()
    want = PN.nn_band_err_plain(x, y, plan, nn, reverse).numpy()
    f64 = PN.nn_band_err_plain(x, y, plan, nn, reverse,
                               torch.float64).numpy()
    assert (np.abs(got - want) <= 1e-6 * np.abs(want)).all()
    assert (np.abs(got - f64) <= 1e-6 * np.abs(f64)).all()
    assert (terms == 1).all()
    lay = PN.nn_band_err_layout(plan, C, reverse, tw)
    ns = plan.grid[1] if reverse else plan.grid[0]
    if lay["window"]:
        # each unit loads its patches' frames once: len + pt - 1
        lens = [min(ns, g0 + lay["span"]) - g0
                for g0 in range(0, ns, lay["span"])]
        assert (loads.sum(2) == sum(n + pt - 1 for n in lens)).all()
        assert loads[:, :, :(ns - 1) * st + pt].min() >= 1
    else:
        assert loads.sum() == terms.sum()
    # the wrapper on the CPU is the plain version
    assert torch.equal(PN.nn_band_err(x, y, plan, nn, reverse),
                       PN.nn_band_err_plain(x, y, plan, nn, reverse))


# the first design's longest f32 chain at the eval's scales: ns pt d / 256
# terms a thread, 48 x 3 x 867 / 256 at p17
FIRST_LONGEST_CHAIN = 488
EVAL_LAYOUTS = {
    (5, 2, 7, 1): dict(threads=320, groups=1, span=44, units=600,
                       per_thread=2, chain=308, window=7, tw=8, tiles=4,
                       fw=19, stage=1, smem=59676),
    (11, 4, 5, 1): dict(threads=512, groups=1, span=46, units=1452,
                        per_thread=3, chain=230, window=5, tw=4, tiles=4,
                        fw=23, stage=0, smem=3900),
    (17, 6, 3, 1): dict(threads=448, groups=1, span=48, units=867,
                        per_thread=2, chain=144, window=3, tw=1, tiles=9,
                        fw=17, stage=0, smem=3788)}


@pytest.mark.parametrize("scale", list(EVAL_LAYOUTS),
                         ids=[f"p{p}" for p, _, _, _ in EVAL_LAYOUTS])
def test_nn_band_err_layout_eval(scale):
    """K19's blocks on the eval pair (3 x 50 x 280 x 560, macro block 65),
    both directions: 8 / 4 / 1 columns a block, warps of threads within
    512 covering the units, the longest chain within the first design's
    longest (ns pt d / 256 terms, 488 at p17), the target staged at p5
    only, and the Loop Quality seam's (2 (pt - 1) source frames) blocks."""
    p, s, pt, st = scale
    plan = PN.lowmem_plan(50, 50, 280, 560, (pt, p, p), (st, s, s), 65)
    for reverse in (False, True):
        lay = PN.nn_band_err_layout(plan, 3, reverse)
        assert lay == EVAL_LAYOUTS[scale]
        assert lay["threads"] % 32 == 0 and lay["threads"] <= 512
        assert lay["threads"] * lay["per_thread"] >= lay["units"]
        ns, d = plan.grid[0], 3 * p * p
        assert lay["units"] == lay["groups"] * lay["tw"] * d
        assert lay["tiles"] * lay["tw"] >= plan.grid[3]
        assert lay["fw"] == (lay["tw"] - 1) * s + p
        assert lay["groups"] * lay["span"] >= ns
        assert lay["chain"] <= FIRST_LONGEST_CHAIN
    seam = PN.lowmem_plan(2 * (pt - 1), 50, 280, 560, (pt, p, p),
                          (st, s, s), 65)
    lay = PN.nn_band_err_layout(seam, 3)
    assert lay["span"] * lay["groups"] >= seam.grid[0]
    assert lay["window"] == pt


def test_nn_band_err_layout_modes_and_limits():
    """stage 0 never stages, stage 1 stages where the window fits the
    card's 227 KB (p17's 173 KB does, two columns' 235 KB not), the default
    only up to 64 KB; pt
    outside 3, 5, 7 or st > 1 takes the generic loop; K19 takes every
    (d, ns) the first design took (4 (2 d + ns + 256) <= 48 KB) and raises
    beyond 4 (d + ns + 32) > 227 KB, on the CPU too."""
    plan = PN.lowmem_plan(50, 50, 280, 560, (3, 17, 17), (1, 6, 6), 65)
    assert PN.nn_band_err_layout(plan, 3, stage=0)["stage"] == 0
    staged = PN.nn_band_err_layout(plan, 3, stage=1)
    assert staged["stage"] == 1 and staged["smem"] == 3788 + 4 * 50 * 867
    assert PN.nn_band_err_layout(plan, 3)["stage"] == 0
    assert PN.nn_band_err_layout(plan, 3, tw=2, stage=1)["stage"] == 0
    big = PN.lowmem_plan(50, 50, 280, 560, (3, 35, 35), (1, 6, 6), 65)
    assert PN.nn_band_err_layout(big, 3, stage=1)["stage"] == 0
    for pt, st, want in ((1, 1, 0), (3, 2, 0), (4, 1, 0), (5, 1, 5)):
        pl = PN.lowmem_plan(20, 20, 40, 40, (pt, 5, 5), (st, 2, 2), 17)
        assert PN.nn_band_err_layout(pl, 3)["window"] == want
    # the first design's largest patch dim at 2 temporal patches
    d_first = (48 * 1024 // 4 - 2 - 256) // 2
    p = int(np.sqrt(d_first / 3))
    assert 4 * (2 * 3 * p * p + 2 + 256) <= 48 * 1024
    x, y = _inputs(3, 2, p, p, 0)
    plan = PN.lowmem_plan(2, 2, p, p, (1, p, p), (1, 1, 1), p)
    nn = torch.zeros((1, 1, 2), dtype=torch.int32)
    assert PN.nn_band_err(x, y[:, :2].contiguous(), plan, nn).shape == (1,)
    lay = PN.nn_band_err_layout(plan, 3)
    assert lay["threads"] <= 512 and lay["per_thread"] > 1
    p = 140                                    # d = 58,800
    x, y = _inputs(3, 1, p, p, 0)
    plan = PN.lowmem_plan(1, 1, p, p, (1, p, p), (1, 1, 1), p)
    with pytest.raises(ValueError, match="limits"):
        PN.nn_band_err(x, y[:, :1].contiguous(), plan, torch.zeros((1, 1, 1),
                                                      dtype=torch.int32))
