"""K15 as redesigned for the card (csrc/fused_s2.cu:
fused_s2_bwd_tile_kernel), emulated on the host from the layout of
``render/fused.py`` (the CUDA kernel does not run on the CPU).

The emulation follows the kernel block by block: a tile of
BWD_TILE_W x BWD_TILE_H pixels with a one-pixel halo; the slot table (the
flags of every (slot, halo pixel) and the static samples' sigmoids, each
decoded once a block); the frames in chunks of `fc`
(`fused_s2_bwd_layout`); sweep A's T_in for every slot and item from the
table (a dynamic sample's alpha recomputed); sweep B far -> near with the
chunk's dynamic samples of the tile and halo decoded once a slot, each
item's own and neighbours' values read from the table or the chunk, the
smoothness gradients of a static pixel with static neighbours taken from
a per-slot table (computed once from the static sigmoids); a
static slot's raw cotangents parked and added in frame order onto a
running sum carried from chunk to chunk, the mask and the sigmoid's
derivative applied after the last chunk.  Each product and sum rounds
once in f32, as the kernel's intrinsics do.

It is held bit for bit to an emulation of the first design's schedule
(one thread per (pixel, frame), T_in per item, every sample and
neighbour decoded per frame, the frame-0 thread's sum in frame order)
on the same sigmoids, within 2e-5 * max|g| of the plain version
(`fused_composite_bwd_plain`, which sums the frames with `torch.sum`)
and of `jax.vjp` of the JAX package's `fused_composite`, over all 16
flag combinations, S < D and S = D, h and w that are not multiples of
the tile, F = 1, 5, 23 and 50, and S = 128 where the layout cuts the
chunk to one frame to fit the shared memory.  It also counts the
decodes: each static (slot, pixel) at most three times (its own block
and the halos of two neighbours), each dynamic (slot, pixel, frame)
likewise in sweep B, and its alpha once more in sweep A; every output
written once.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoloop3d_tpu.render import fused as JF
from videoloop3d_torch.render import fused as FU

F32 = np.float32
TW, TH = FU.BWD_TILE_W, FU.BWD_TILE_H
FLAGS = list(itertools.product([False, True], repeat=4))


def _flag_id(f):
    return "".join(c if on else "-" for c, on in zip("sraD", f))


def _inputs(S, h, w, F, seed):
    rng = np.random.default_rng(seed)
    vals_s = (2 * rng.standard_normal((S, h, w, 4))).astype(F32)
    vals_d = (2 * rng.standard_normal((S, h, w, F, 4))).astype(F32)
    m_s, hit_d, m_d = (rng.random((S, h, w)) < p for p in (0.7, 0.4, 0.6))
    # whole slots static or dynamic, as the compacted sweeps hold them
    hit_d[0] = False
    hit_d[-1] = True
    dinv = rng.random((S, h, w)).astype(F32)
    cts = (rng.standard_normal((h, w, F, 3)).astype(F32),
           rng.standard_normal((h, w, F)).astype(F32),
           rng.standard_normal((h, w, F)).astype(F32),
           rng.standard_normal(3).astype(F32))
    return (vals_s, m_s, vals_d, hit_d, m_d), dinv, cts


def _sigmoid(v):
    """The decode's sigmoids, computed once for every sample: both
    emulations read the same values."""
    return torch.sigmoid(torch.from_numpy(v)).numpy()


def _sign(x):
    return np.where(x > 0, F32(1), np.where(x < 0, F32(-1), F32(0)))


def _smooth(x, nb, g_dx, g_dy):
    """csrc/fused_s2.cu:smooth_grad; nb = ((has, value) for left, right,
    up, down)."""
    (hl, xl), (hr, xr), (hu, xu), (hd, xd) = nb
    sw = (np.where(hl, _sign(x - xl), F32(0))
          - np.where(hr, _sign(xr - x), F32(0)))
    sh = (np.where(hu, _sign(x - xu), F32(0))
          - np.where(hd, _sign(xd - x), F32(0)))
    return g_dx * sw + g_dy * sh


class _Scalars:
    """The kernel's launch scalars and the regularizers' coefficients."""

    def __init__(self, cfg, S, h, w, F, g_regs):
        n = FU._norms(cfg, S, h, w, F)
        self.cfg = cfg
        self.sp_eps = F32(cfg.sp_eps)
        self.sp_norm = F32(n["n_pix"] * n["sqrt_planes"])
        self.gscal = g_regs
        z = F32(0)
        self.g_rs_dx = g_regs[1] / F32(n["n_rgb_dx"]) if cfg.use_rgb_smooth \
            else z
        self.g_rs_dy = g_regs[1] / F32(n["n_rgb_dy"]) if cfg.use_rgb_smooth \
            else z
        self.g_as_dx = g_regs[2] / F32(n["n_dx"]) if cfg.use_a_smooth else z
        self.g_as_dy = g_regs[2] / F32(n["n_dy"]) if cfg.use_a_smooth else z

    def sparsity(self, l1, l2):
        """(a_coef, b_coef) of each item."""
        if not self.cfg.use_sparsity:
            return F32(0), F32(0)
        l2r = np.sqrt(l2)
        l2c = np.fmax(l2r, self.sp_eps)
        scale = self.gscal[0] / self.sp_norm
        a_coef = scale / l2c
        b_coef = np.where(l2r >= self.sp_eps,
                          (scale * l1) / ((l2c * l2c)
                                          * np.fmax(l2r, self.sp_eps)),
                          F32(0))
        return a_coef, b_coef


def _masked(sg, vm):
    """decode()'s masked rgb and alpha from the sigmoids (..., 4)."""
    m = np.where(vm, F32(1), F32(0))[..., None]
    return np.concatenate([sg[..., :3] * m,
                           np.where(vm, sg[..., 3], F32(0))[..., None]], -1)


def _smooth4(sc, cv, nbs):
    """csrc/fused_s2.cu:smooth4: the four channels' smoothness gradients
    (..., 4) from the masked values and the neighbours' (has, values)."""
    return np.stack(
        [_smooth(cv[..., ch], [(hn, v[..., ch]) for hn, v in nbs],
                 sc.g_rs_dx if ch < 3 else sc.g_as_dx,
                 sc.g_rs_dy if ch < 3 else sc.g_as_dy) for ch in range(4)],
        -1)


def _item(sc, cv, go, ga, gd, dv, Ts, dT, coef, nbs, smc=None):
    """One slot step of sweep B for an array of items: (d_rgb (..., 3),
    da, dT).  cv the masked values, go (..., 3), nbs the four neighbours'
    (has, masked values); smc (mask, values (..., 4)): where mask holds,
    the smoothness gradients are taken from values (the kernel's table of
    static neighbourhoods)."""
    cfg = sc.cfg
    g_i = ((cv[..., 0] * go[..., 0] + cv[..., 1] * go[..., 1])
           + cv[..., 2] * go[..., 2]) + ga
    if cfg.want_disp:
        g_i = g_i + dv * gd
    a = cv[..., 3]
    bw = a * Ts
    da = Ts * (g_i - dT)
    dT = a * g_i + (F32(1) - a) * dT
    d = [bw * go[..., 0], bw * go[..., 1], bw * go[..., 2]]
    if cfg.use_sparsity:
        da = (da + coef[0] * _sign(a)) - coef[1] * a
    if cfg.use_rgb_smooth or cfg.use_a_smooth:
        sm = _smooth4(sc, cv, nbs)
        if smc is not None:
            sm = np.where(smc[0][..., None], smc[1], sm)
        if cfg.use_rgb_smooth:
            d = [d[ch] + sm[..., ch] for ch in range(3)]
        if cfg.use_a_smooth:
            da = da + sm[..., 3]
    return np.stack(d, -1), da, dT


def _derivative(d_rgb, da, sg, vm):
    """The mask and the sigmoid's derivative, in the kernel's order."""
    m = np.where(vm, F32(1), F32(0))
    rgb = (d_rgb * m[..., None]) * (sg[..., :3] * (F32(1) - sg[..., :3]))
    a = (np.where(vm, da, F32(0)) * sg[..., 3]) * (F32(1) - sg[..., 3])
    return np.concatenate([rgb, a[..., None]], -1)


def emulate_tile(cfg, ins, dinv, cts, sig_s, sig_d, counts):
    """K15's redesign, block by block.  counts: dict of decode counters
    ("static" (S, h, w), "dynamic" (S, h, w, F), "alpha" (S, h, w, F))."""
    vals_s, m_s, vals_d, hit_d, m_d = ins
    g_out, g_asum, g_disp, g_regs = cts
    S, h, w, F, _ = vals_d.shape
    sc = _Scalars(cfg, S, h, w, F, g_regs)
    fc = FU.fused_s2_bwd_layout(S, F)["fc"]
    n_chunks = -(-F // fc)
    d_s = np.full((S, h, w, 4), np.nan, F32)
    d_d = np.full((S, h, w, F, 4), np.nan, F32)
    hh, hw_ = np.meshgrid(np.arange(TH + 2), np.arange(TW + 2), indexing="ij")
    corner = ((hh == 0) | (hh == TH + 1)) & ((hw_ == 0) | (hw_ == TW + 1))
    for i0 in range(0, h, TH):
        for j0 in range(0, w, TW):
            ii, jj = i0 + hh - 1, j0 + hw_ - 1
            valid = ~corner & (ii >= 0) & (ii < h) & (jj >= 0) & (jj < w)
            ic, jc = np.clip(ii, 0, h - 1), np.clip(jj, 0, w - 1)
            # the slot table: flags and the static samples' sigmoids
            dyn = hit_d[:, ic, jc] & valid
            vm = np.where(dyn, m_d[:, ic, jc], m_s[:, ic, jc]) & valid
            sdec = sig_s[:, ic, jc]                    # (S, TH+2, TW+2, 4)
            for s in range(S):
                np.add.at(counts["static"][s], (ii[valid & ~dyn[s]],
                                                jj[valid & ~dyn[s]]), 1)
            own = (slice(None), slice(1, TH + 1), slice(1, TW + 1))
            oi, oj = ic[own[1:]], jc[own[1:]]          # (TH, TW)
            in_img = valid[own[1:]]
            has = [(jj[own[1:]] > 0), (jj[own[1:]] + 1 < w),
                   (ii[own[1:]] > 0), (ii[own[1:]] + 1 < h)]
            shifts = [(slice(1, TH + 1), slice(0, TW)),
                      (slice(1, TH + 1), slice(2, TW + 2)),
                      (slice(0, TH), slice(1, TW + 1)),
                      (slice(2, TH + 2), slice(1, TW + 1))]
            run = np.zeros((S, TH, TW, 4), F32)
            for c in range(n_chunks):
                f0 = c * fc
                nf = min(fc, F - f0)
                fr = slice(f0, f0 + nf)
                go = g_out[oi, oj, fr]                 # (TH, TW, nf, 3)
                ga, gd = g_asum[oi, oj, fr], g_disp[oi, oj, fr]
                # sweep A
                T = np.ones((TH, TW, nf), F32)
                l1 = np.zeros_like(T)
                l2 = np.zeros_like(T)
                tin = [None] * S
                for s in range(S - 1, -1, -1):
                    dy_o, vm_o = dyn[s][own[1:]], vm[s][own[1:]]
                    a = np.where(dy_o[..., None], sig_d[s, oi, oj, fr, 3],
                                 sdec[s][own[1:]][..., 3][..., None])
                    a = np.where(vm_o[..., None], a, F32(0))
                    counts["alpha"][s, oi[dy_o], oj[dy_o], fr] += \
                        in_img[dy_o][:, None]
                    tin[s] = T
                    T = T * (F32(1) - a)
                    if cfg.use_sparsity:
                        l1 = l1 + np.abs(a)
                        l2 = l2 + a * a
                coef = sc.sparsity(l1, l2)
                # sweep B
                dT = np.zeros((TH, TW, nf), F32)
                for s in range(S):
                    dec = sig_d[s, ic, jc, fr]         # (TH+2, TW+2, nf, 4)
                    np.add.at(counts["dynamic"][s],
                              (ii[valid & dyn[s]], jj[valid & dyn[s]]),
                              np.eye(F, dtype=np.int64)[fr].sum(0))
                    src = np.where(dyn[s][..., None, None], dec,
                                   sdec[s][:, :, None, :])
                    mv = _masked(src, vm[s][..., None])
                    nbs = [(hn[..., None], mv[sl]) for hn, sl in
                           zip(has, shifts)]
                    # the table of static neighbourhoods: the smoothness
                    # gradients of the static sigmoids, once a slot
                    st_mv = _masked(sdec[s], vm[s])        # (TH+2, TW+2, 4)
                    con = in_img & ~dyn[s][own[1:]]
                    for hn, sl in zip(has, shifts):
                        con &= ~(hn & dyn[s][sl])
                    smc = _smooth4(sc, st_mv[own[1:]],
                                   [(hn, st_mv[sl])
                                    for hn, sl in zip(has, shifts)])
                    d_rgb, da, dT = _item(
                        sc, mv[own[1:]], go, ga, gd,
                        dinv[s, oi, oj][..., None], tin[s], dT, coef, nbs,
                        (con[..., None], smc[:, :, None, :]))
                    dy_o, vm_o = dyn[s][own[1:]], vm[s][own[1:]]
                    out_d = np.where(
                        dy_o[..., None, None],
                        _derivative(d_rgb, da, src[own[1:]],
                                    vm_o[..., None]), F32(0))
                    d_d[s, oi[in_img], oj[in_img], fr] = out_d[in_img]
                    # the static frame sum, in frame order
                    park = np.concatenate([d_rgb, da[..., None]], -1)
                    acc = run[s] if c else np.zeros((TH, TW, 4), F32)
                    for q in range(nf):
                        acc = acc + park[:, :, q]
                    run[s] = acc
                    if c == n_chunks - 1:
                        out_s = np.where(
                            dy_o[..., None], F32(0),
                            _derivative(acc[..., :3], acc[..., 3],
                                        sdec[s][own[1:]], vm_o))
                        d_s[s, oi[in_img], oj[in_img]] = out_s[in_img]
    return d_s, d_d


def emulate_first(cfg, ins, dinv, cts, sig_s, sig_d):
    """K15's first design: every (pixel, frame) at once, each sample and
    its four neighbours decoded per frame, T_in per item, the static frame
    sum in frame order."""
    vals_s, m_s, vals_d, hit_d, m_d = ins
    g_out, g_asum, g_disp, g_regs = cts
    S, h, w, F, _ = vals_d.shape
    sc = _Scalars(cfg, S, h, w, F, g_regs)
    hd = hit_d[..., None]
    vmk = np.where(hit_d, m_d, m_s)[..., None]           # (S, h, w, 1)
    sg = np.where(hd[..., None], sig_d, sig_s[:, :, :, None, :])
    cv = _masked(sg, vmk)                                # (S, h, w, F, 4)
    T = np.ones((h, w, F), F32)
    l1, l2 = np.zeros_like(T), np.zeros_like(T)
    tin = [None] * S
    for s in range(S - 1, -1, -1):
        a = cv[s, ..., 3]
        tin[s] = T
        T = T * (F32(1) - a)
        if cfg.use_sparsity:
            l1 = l1 + np.abs(a)
            l2 = l2 + a * a
    coef = sc.sparsity(l1, l2)
    jx, ix = np.arange(w)[None, :, None], np.arange(h)[:, None, None]
    has = [jx > 0, jx + 1 < w, ix > 0, ix + 1 < h]
    d_s = np.zeros((S, h, w, 4), F32)
    d_d = np.zeros((S, h, w, F, 4), F32)
    dT = np.zeros((h, w, F), F32)
    for s in range(S):
        x = cv[s]
        pad = np.zeros((h + 2, w + 2, F, 4), F32)
        pad[1:-1, 1:-1] = x
        nbs = [(has[0], pad[1:-1, :-2]), (has[1], pad[1:-1, 2:]),
               (has[2], pad[:-2, 1:-1]), (has[3], pad[2:, 1:-1])]
        d_rgb, da, dT = _item(sc, x, g_out, g_asum, g_disp,
                              dinv[s][..., None], tin[s], dT, coef, nbs)
        d_d[s] = np.where(hd[s][..., None],
                          _derivative(d_rgb, da, sig_d[s], vmk[s]), F32(0))
        park = np.concatenate([d_rgb, da[..., None]], -1)
        acc = np.zeros((h, w, 4), F32)
        for f in range(F):
            acc = acc + park[:, :, f]
        d_s[s] = np.where(hd[s], F32(0),
                          _derivative(acc[..., :3], acc[..., 3], sig_s[s],
                                      vmk[s][..., 0]))
    return d_s, d_d


def _check(flags, S, D, h, w, F, seed, jax_too=True):
    cfg = FU.FusedCfg(D, *flags)
    ins, dinv, cts = _inputs(S, h, w, F, seed)
    sig_s, sig_d = _sigmoid(ins[0]), _sigmoid(ins[2])
    counts = {"static": np.zeros((S, h, w), np.int64),
              "dynamic": np.zeros((S, h, w, F), np.int64),
              "alpha": np.zeros((S, h, w, F), np.int64)}
    t_s, t_d = emulate_tile(cfg, ins, dinv, cts, sig_s, sig_d, counts)
    assert not np.isnan(t_s).any() and not np.isnan(t_d).any()
    f_s, f_d = emulate_first(cfg, ins, dinv, cts, sig_s, sig_d)
    assert np.array_equal(t_s.view(np.int32), f_s.view(np.int32))
    assert np.array_equal(t_d.view(np.int32), f_d.view(np.int32))

    hit = ins[3]
    stat, dyn = counts["static"], counts["dynamic"]
    assert (stat[~hit] >= 1).all() and stat.max() <= 3 and not stat[hit].any()
    assert (dyn[hit] >= 1).all() and dyn.max() <= 3 and not dyn[~hit].any()
    assert np.array_equal(counts["alpha"], np.broadcast_to(
        hit[..., None], counts["alpha"].shape).astype(np.int64))

    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in ins]
    p_s, p_d = FU.fused_composite_bwd_plain(
        cfg, *t, torch.from_numpy(dinv), *(torch.from_numpy(c) for c in cts))
    for got, ref in ((t_s, p_s.numpy()), (t_d, p_d.numpy())):
        assert np.abs(got - ref).max() <= 2e-5 * np.abs(ref).max()
    if not jax_too:
        return
    jcfg = JF.FusedCfg(D, *flags)
    jm = [jnp.asarray(ins[i]) for i in (1, 3, 4)]

    def jfun(a, b):
        return JF.fused_composite(jcfg, a, jm[0], b, jm[1], jm[2],
                                  jnp.asarray(dinv))

    (_, _, _, jregs), vjp = jax.vjp(jfun, jnp.asarray(ins[0]),
                                    jnp.asarray(ins[2]))
    g_regs = cts[3]
    jct = {k: jnp.asarray(g_regs[i]) for i, k in enumerate(FU.REG_NAMES)
           if k in jregs}
    jg_s, jg_d = vjp((jnp.asarray(cts[0]), jnp.asarray(cts[1]),
                      jnp.asarray(cts[2]) if flags[3] else None, jct))
    for got, ref in ((t_s, np.asarray(jg_s)), (t_d, np.asarray(jg_d))):
        assert np.abs(got - ref).max() <= 2e-5 * np.abs(ref).max()


@pytest.mark.parametrize("n_slots", [6, 10], ids=["S<D", "S=D"])
@pytest.mark.parametrize("flags", FLAGS, ids=[_flag_id(f) for f in FLAGS])
def test_tile_schedule_every_flag_set(flags, n_slots):
    """Every flag combination at S < D and S = D on a 13 x 17 patch (not
    multiples of the 8 x 4 tile) over 5 frames (one chunk)."""
    _check(flags, n_slots, 10, 13, 17, 5, sum(flags) + n_slots)


@pytest.mark.parametrize("F", [1, 23, 50])
@pytest.mark.parametrize("flags", [(True, True, True, True),
                                   (False, True, True, False)],
                         ids=["sraD", "-ra-"])
def test_tile_schedule_frame_chunks(flags, F):
    """F = 1 (chunks of one frame), 23 (three chunks of 8, the last of
    7) and 50 (five chunks of 10): the static sums carried from chunk to
    chunk keep the frame order."""
    assert FU.fused_s2_bwd_layout(7, F)["fc"] == {1: 1, 23: 8, 50: 10}[F]
    _check(flags, 7, 32, 9, 11, F, F, jax_too=F < 50)


def test_tile_schedule_at_the_slot_limit():
    """S = 128 (the kernel's limit): the layout cuts the chunk to one
    frame to fit the shared memory, so three frames take three chunks."""
    lay = FU.fused_s2_bwd_layout(128, 3)
    assert lay["fc"] == 1 and lay["smem"] <= FU.BWD_SMEM_LIMIT
    _check((True, True, True, True), 128, 128, 5, 9, 3, 0, jax_too=False)


@pytest.mark.parametrize("S,F,fc", [(15, 50, 10), (29, 50, 10), (32, 50, 9),
                                    (128, 50, 1), (128, 1, 1), (1, 1, 1),
                                    (15, 1024, 10), (7, 9, 9), (7, 23, 8)])
def test_layout(S, F, fc):
    """The shipped shapes' layout (S = 15 and 29 slots at 50 frames: chunks
    of 10, 320 threads; D = 32 planes: chunks of 9, so that two blocks
    share an SM) and the limits; every layout fits the shared memory, and
    up to S = 32 two blocks fit an SM (three at S = 15)."""
    lay = FU.fused_s2_bwd_layout(S, F)
    assert lay["fc"] == fc and lay["threads"] == TW * TH * fc
    assert lay["smem"] <= FU.BWD_SMEM_LIMIT
    per_sm = 233472 // (lay["smem"] + 1024)
    if S <= 32:
        assert per_sm >= (3 if S == 15 else 2)
