"""K12 as redesigned for the card (csrc/nn_fold.cu:nn_fold_tile_kernel),
emulated on the host from the layout of ``losses/patch_nn.py`` (the CUDA
kernel does not run on the CPU).

The emulation follows the kernel block by block: one output row h, 32
neighbouring w (a warp's lanes) and `tb` neighbouring t
(`nn_fold_layout`); the block's y at those pixels staged once, widened to
f32, `cg` channels at a time; the (crop, ih) rows covering h and the
(crop, iw) columns covering any of the 32 w, listed in crop order; the
indices of those columns at the block's temporal patches staged once;
each lane's list of the (row, column) pairs covering it; then for each t
the terms in the first design's order (crops row-major, ih, iw, it),
every lane taking only the columns that cover it, read from the staged
copies, the sums in f32, and the division by the product of
the patches covering t, h and w (the plan's fold weight, not a count kept
in the loop).

It is held bit for bit to an emulation of the first design (each voxel's
terms visited in the same order, with the count kept in the loop), the
layout's bounds hold for every block, the count equals `plan.weight`
(clipped at 1e-10), and the output is within 1e-6 of the plain version
(`nn_fold_plain`) and of the JAX package's fold (`extract_patches_3d`,
`take_along_axis`, `fold_patches_3d`, the crops' overlap-add and the
division by the weight).  Coverage: the shipped ref view's patches
(3 x 11 x 11 at stride 1/4) and the other view's (3 x 3 x 3 at 1/2) on
macro-block plans whose crops overlap, a plan with voxels that no patch
covers, the parent mode at f = 2 and 3 (gpnn_down's full-resolution
crops), f32 and bf16 y.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoloop3d_tpu.losses import patch_nn as J
from videoloop3d_torch.losses import patch_nn as PN

F32 = np.float32
LANES = 32


def _cover(pos, p, s, n, m):
    """The patch indices covering pos (csrc/nn_fold.cu's loop bounds)."""
    first = max(0, -(-(pos - p + 1) // s))
    return range(first, first + PN.n_span(pos, pos, p, s, n, m))


def _listed(starts, lo, hi, p, s, n, m):
    """list_patches: the (crop, index) entries covering some position of
    [lo, hi], in crop order."""
    out = []
    for a, a0 in enumerate(starts):
        k = PN.n_span(lo - a0, hi - a0, p, s, n, m)
        if k:
            first = max(0, -(-(max(lo - a0, 0) - p + 1) // s))
            out += [(a, first + q) for q in range(k)]
    return out


def emulate_blocked(y, nn, plan, parent):
    """K12's redesign.  y (C, Ty, H, W) f32 (bf16 widened); nn (n_crops,
    nh nw / parent^2, ntx) int.  Returns (C, ft, fh, fw) f32."""
    C, Ty = y.shape[:2]
    (pt, ph, pw), (st, sh, sw) = plan.psz, plan.strides
    mh, mw = plan.crop_hw
    ntx, _, nh, nw = plan.grid
    ft, fh, fw = plan.fit
    lay = PN.nn_fold_layout(plan, C, Ty)
    tb, cg = lay["tb"], lay["cg"]
    assert lay["smem"] <= 232448
    gw = nw // parent
    grid = nn.reshape(len(plan.hs), len(plan.ws), nh // parent, gw, ntx)
    out = np.full((C, ft, fh, fw), np.nan, F32)
    for h in range(fh):
        rows = _listed(plan.hs, h, h, ph, sh, nh, mh)
        assert len(rows) <= lay["rmax"]
        ch = sum(PN.n_span(h - h0, h - h0, ph, sh, nh, mh) for h0 in plan.hs)
        for x0 in range(0, fw, LANES):
            x1 = min(x0 + LANES, fw) - 1
            w = np.arange(x0, x1 + 1)
            cols = _listed(plan.ws, x0, x1, pw, sw, nw, mw)
            assert len(cols) <= lay["qmax"]
            cw = np.array([sum(PN.n_span(v - w0, v - w0, pw, sw, nw, mw)
                               for w0 in plan.ws) for v in w])
            # each lane's list of covering (row, column) pairs
            assert len(rows) * cw.max() <= lay["pmax"]
            for t0 in range(0, ft, tb):
                t1 = min(t0 + tb, ft) - 1
                it0 = max(0, -(-(t0 - pt + 1) // st))
                nt = PN.n_span(t0, t1, pt, st, ntx, ft)
                assert nt <= lay["ntmax"]
                staged = np.array(
                    [[[grid[a, b, ih // parent, iw // parent, it0 + k]
                       for k in range(nt)] for b, iw in cols]
                     for a, ih in rows], np.int64).reshape(len(rows),
                                                           len(cols), nt)
                for c0 in range(0, C, cg):
                    ys = y[c0:c0 + cg, :, h, x0:x1 + 1]    # the staged y
                    for t in range(t0, t1 + 1):
                        its = _cover(t, pt, st, ntx, ft)
                        acc = np.zeros((len(ys), len(w)), F32)
                        # crops a, then b (in list order), then ih, iw, it
                        for a in dict.fromkeys(a for a, _ in rows):
                            for b in dict.fromkeys(b for b, _ in cols):
                                ww = w - plan.ws[b]
                                for r in (r for r, e in enumerate(rows)
                                          if e[0] == a):
                                    for q in (q for q, e in enumerate(cols)
                                              if e[0] == b):
                                        iw = cols[q][1]
                                        lanes = np.flatnonzero(
                                            (ww >= iw * sw)
                                            & (ww < iw * sw + pw)
                                            & (ww < mw))
                                        for it in its:
                                            frame = staged[r, q, it - it0] \
                                                * st + (t - it * st)
                                            acc[:, lanes] = acc[:, lanes] \
                                                + ys[:, frame, lanes]
                        count = len(its) * ch * cw
                        div = np.where(count > 0, count, 1e-10).astype(F32)
                        out[c0:c0 + cg, t, h, x0:x1 + 1] = acc / div
    return out


def emulate_first(y, nn, plan, parent):
    """K12's first design: every voxel's terms in the order crops
    row-major, ih, iw, it (the global lexicographic order of the terms
    visits each voxel's in that order), the count kept in the loop.
    Returns (y2x, count)."""
    C = y.shape[0]
    (pt, ph, pw), (st, sh, sw) = plan.psz, plan.strides
    ntx, _, nh, nw = plan.grid
    ft, fh, fw = plan.fit
    gw = nw // parent
    grid = nn.reshape(len(plan.hs), len(plan.ws), nh // parent, gw, ntx)
    acc = np.zeros((C, ft, fh, fw), F32)
    count = np.zeros((ft, fh, fw), np.int64)
    for a, h0 in enumerate(plan.hs):
        for b, w0 in enumerate(plan.ws):
            for ih in range(nh):
                hr = slice(h0 + ih * sh, h0 + ih * sh + ph)
                for iw in range(nw):
                    wr = slice(w0 + iw * sw, w0 + iw * sw + pw)
                    for it in range(ntx):
                        sel = grid[a, b, ih // parent, iw // parent, it]
                        for t in range(it * st, it * st + pt):
                            frame = sel * st + (t - it * st)
                            acc[:, t, hr, wr] = acc[:, t, hr, wr] \
                                + y[:, frame, hr, wr]
                            count[t, hr, wr] += 1
    div = np.where(count > 0, count, 1e-10).astype(F32)
    return acc / div[None], count


def _jax_fold(y, nn, plan, parent):
    """The JAX package's fold of the selected patches: per crop,
    extract_patches_3d, take_along_axis with the (parent-expanded) indices
    and fold_patches_3d, the crops added, divided by the weight."""
    nn = PN.parent_indices(torch.from_numpy(nn), plan, parent).numpy()
    C = y.shape[0]
    ft, fh, fw = plan.fit
    mh, mw = plan.crop_hw
    ntx = plan.grid[0]
    jy = jnp.asarray(y)[:, :plan.fit_ty, :fh, :fw]
    y2x = jnp.zeros((C, ft, fh, fw), jnp.float32)
    ci = 0
    for h0 in plan.hs:
        for w0 in plan.ws:
            Yp = J.extract_patches_3d(jy[..., h0:h0 + mh, w0:w0 + mw],
                                      plan.psz, plan.strides)
            nty, nh, nw = Yp.shape[:3]
            dim = int(np.prod(Yp.shape[3:]))
            Yf = Yp.reshape(nty, nh * nw, dim).transpose(1, 0, 2)
            sel = jnp.take_along_axis(Yf, jnp.asarray(nn[ci])[..., None],
                                      axis=1)
            sel = sel.transpose(1, 0, 2).reshape((ntx, nh, nw)
                                                 + Yp.shape[3:])
            y2x = y2x.at[..., h0:h0 + mh, w0:w0 + mw].add(
                J.fold_patches_3d(sel, (ft, mh, mw), plan.strides))
            ci += 1
    return np.asarray(y2x / jnp.asarray(plan.weight)[None])


def _gap_plan():
    """Two by two crops of 11 x 11 (3 x 5 x 5 patches at 1/2/2) that leave
    rows 11-16 and columns 11-12 of the fitted extent uncovered."""
    psz, strides = (3, 5, 5), (1, 2, 2)
    ft, fh, fw = 8, 28, 24
    hs, ws = (0, 17), (0, 13)
    weight = np.zeros((ft, fh, fw), F32)
    w_crop = PN.fold_weight((ft, 11, 11), psz, strides)
    for h0 in hs:
        for w0 in ws:
            weight[:, h0:h0 + 11, w0:w0 + 11] += w_crop
    return PN.CropPlan(psz, strides, hs, ws, (11, 11), (ft, fh, fw), 7,
                       np.clip(weight, 1e-10, None))


# (C, Tx, Ty, H, W, patch size, strides, macro block) of lowmem plans
# whose crops overlap; the shipped views' patch sizes and strides
PLANS = {"ref_view": (3, 12, 10, 40, 70, (3, 11, 11), (1, 4, 4), 27),
         "other_view": (3, 9, 8, 29, 45, (3, 3, 3), (1, 2, 2), 13)}


def _case(name, dtype, seed=0):
    if name == "gap":
        plan, C, Ty, H, W = _gap_plan(), 3, 7, 28, 24
    else:
        C, Tx, Ty, H, W, psz, strides, macro = PLANS[name]
        plan = PN.lowmem_plan(Tx, Ty, H, W, psz, strides, macro)
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(rng.random((C, Ty, H, W)).astype(F32)).to(dtype)
    ntx, nty, nh, nw = plan.grid
    nn = rng.integers(0, nty, (len(plan.hs) * len(plan.ws), nh * nw, ntx))
    return plan, y, nn.astype(np.int32)


def _check(plan, y, nn, parent):
    yf = y.float().numpy()
    got = emulate_blocked(yf, nn, plan, parent)
    first, count = emulate_first(yf, nn, plan, parent)
    assert np.array_equal(got.view(np.int32), first.view(np.int32))
    assert np.array_equal(np.clip(count, 1e-10, None).astype(F32),
                          plan.weight)
    plain = PN.nn_fold_plain(y, torch.from_numpy(nn), plan, parent).numpy()
    assert np.abs(got - plain).max() <= 1e-6
    assert np.abs(got - _jax_fold(yf, nn, plan, parent)).max() <= 1e-6
    return count


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["ref_view", "other_view", "gap"])
def test_blocked_fold_equals_first_design(case, dtype):
    """Both views' patch sizes on overlapping crops, and a plan with
    uncovered voxels (count 0: 0 / 1e-10 = 0)."""
    plan, y, nn = _case(case, dtype)
    if case != "gap":
        assert len(plan.hs) > 1 and len(plan.ws) > 1
    count = _check(plan, y, nn, 1)
    assert (count == 0).any() == (case == "gap")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("factor", [2, 3])
def test_blocked_fold_parent_mode(factor, dtype):
    """gpnn_down's full-resolution crops, each f x f patch columns taking
    their parent's index; border voxels no patch covers."""
    Tx, Ty, H, W = 9, 7, 46, 61
    low, full, _ = PN.down_plans(Tx, Ty, H, W, (3, 3, 3), (1, 2, 2), 11,
                                 factor)
    rng = np.random.default_rng(factor)
    y = torch.from_numpy(rng.random((3, Ty, H, W)).astype(F32)).to(dtype)
    nn = rng.integers(0, low.grid[1], (len(low.hs) * len(low.ws),
                                       low.grid[2] * low.grid[3],
                                       low.grid[0])).astype(np.int32)
    count = _check(full, y, nn, factor)
    assert (count == 0).any()


def test_blocked_fold_in_shrunken_blocks(monkeypatch):
    """A block smaller than the fitted extent: with the shared memory cut
    to 8,000 bytes the 5-channel ref-view case takes 8 t a block (two t
    blocks) and 2 channels at a time (groups of 2, 2 and 1), as a long
    video does at the real limit."""
    monkeypatch.setattr(PN, "_FOLD_SMEM_LIMIT", 8000)
    C, Tx, Ty, H, W, psz, strides, macro = PLANS["ref_view"]
    plan = PN.lowmem_plan(Tx, Ty, H, W, psz, strides, macro)
    lay = PN.nn_fold_layout(plan, 5, Ty)
    assert (lay["tb"], lay["cg"]) == (8, 2) and plan.fit[0] > 8
    rng = np.random.default_rng(5)
    y = torch.from_numpy(rng.random((5, Ty, H, W)).astype(F32))
    ntx, nty, nh, nw = plan.grid
    nn = rng.integers(0, nty, (len(plan.hs) * len(plan.ws), nh * nw, ntx))
    _check(plan, y, nn.astype(np.int32), 1)


@pytest.mark.parametrize("view,want", [
    ("ref", dict(tb=52, cg=3, rmax=6, qmax=16, pmax=36, ntmax=50,
                 smem=43184)),
    ("other", dict(tb=52, cg=3, rmax=4, qmax=18, pmax=12, ntmax=50,
                   smem=35312)),
    ("down", dict(tb=52, cg=3, rmax=6, qmax=17, pmax=36, ntmax=50,
                  smem=44392))])
def test_layout_at_the_shipped_shapes(view, want):
    """The stage-2 patch (180 x 320, y of 50 frames, x loop-padded to 52):
    the ref view, the other view and gpnn_down's parent plan at f = 2
    stage a row's 32 pixels of all 3 channels and 50 frames (19.2 KB) and
    every t's indices in one block."""
    if view == "down":
        plan = PN.down_plans(52, 50, 180, 320, (3, 11, 11), (1, 4, 4), 65,
                             2)[1]
    else:
        psz, st = {"ref": ((3, 11, 11), (1, 4, 4)),
                   "other": ((3, 3, 3), (1, 2, 2))}[view]
        plan = PN.lowmem_plan(52, 50, 180, 320, psz, st, 65)
    assert PN.nn_fold_layout(plan, 3, 50) == want


@pytest.mark.parametrize("T,tb,cg", [(500, 125, 3), (600, 8, 2), (900, 8, 1),
                                     (1300, 8, 1), (2000, None, None)])
def test_layout_shrinks_to_fit(T, tb, cg):
    """Long videos (3 x 11 x 11 patches at 1/4/4): the t a block halve
    down to 8, then the channels staged at once, until the block fits the
    shared memory; at 2,000 frames a block's y alone does not fit (the
    kernel refuses the launch)."""
    plan = PN.lowmem_plan(T, T, 40, 60, (3, 11, 11), (1, 4, 4), 27)
    lay = PN.nn_fold_layout(plan, 3, T)
    if tb is None:
        assert lay["smem"] > 232448 and 4 * T * 32 > 232448 - 4096
    else:
        assert (lay["tb"], lay["cg"]) == (tb, cg)
        assert lay["smem"] <= 232448
